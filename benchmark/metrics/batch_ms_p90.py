"""90th percentile of the host-clock intervals between consecutive
host_finish returns in the window (the overlapped loop's batch time)."""

import sys

from ..yardstick import stats


def read(run):
    done = run.window.batch_done
    gaps = [1e3 * (b - a) for a, b in zip(done, done[1:])]
    print(f"batch_ms_p90: {len(gaps)} intervals", file=sys.stderr)
    return stats.percentile(gaps, 90) if len(gaps) >= 20 else None
