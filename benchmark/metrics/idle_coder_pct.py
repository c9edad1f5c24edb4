"""The share of the card's idle time in the traced window that the host
spends coding: the gaps between the profiler's device events (as
yardstick/stats.idle_gaps finds them) that lie inside the program's
fin.coder spans, each span put on the profiler's clock with the
recorder's to_profiler_ns."""

from ..yardstick import stats
from ._recorder import recorder, window


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint
    [start, end) intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    tr = recorder()
    coder = window(run, "host", "fin.coder")
    if tr is None or not coder or not run.trace.device_events:
        return None
    t0 = tr.to_profiler_ns(int(run.window.t0 * 1e9))
    t1 = tr.to_profiler_ns(int(run.window.t_end * 1e9))
    busy = [(max(s, t0), min(e, t1)) for _, s, e in run.trace.device_events
            if e > t0 and s < t1]
    gaps = stats.idle_gaps(busy, t0, t1)
    idle = sum(e - s for s, e in gaps)
    spans = sorted((tr.to_profiler_ns(r.start_ns), tr.to_profiler_ns(r.end_ns))
                   for r in coder)
    return 100.0 * _overlap(gaps, spans) / idle if idle > 0 else None
