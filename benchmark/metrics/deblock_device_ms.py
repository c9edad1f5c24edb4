"""Device time of a batch's deblock and casts on the card: the busy
union of the profiler's device events inside each dev.deblock span of
the traced window, the mean over its batches.

The span is a pair of CUDA events around the deblock's enqueue; its
length is device time.  While a profiler is on, the program runs a MARK
kernel on the stream just before the span's first event and numbers the
span with it (n: the n-th marker since recording started), so the span
starts on the profiler's device timeline where the n-th marker ends: no
host stamp is mapped onto the device's clock.  Only the device events
inside the span count, so the stream's wait for the host enqueue does
not."""

import bisect

from ..yardstick import stats
from ._recorder import recorder, window


def read(run):
    tr = recorder()
    spans = [r for r in window(run, "device", "dev.deblock") if r.n]
    if tr is None or not spans or not run.trace.device_events:
        return None
    marks = sorted((s, e) for name, s, e in run.trace.device_events
                   if tr.MARK in name)
    work = sorted((s, e) for name, s, e in run.trace.device_events
                  if tr.MARK not in name)
    starts = [s for s, _ in work]
    longest = max((e - s for s, e in work), default=0)
    total = 0
    for r in spans:
        if r.n > len(marks):
            return None
        lo = marks[r.n - 1][1]
        hi = lo + r.end_ns - r.start_ns
        a = bisect.bisect_left(starts, lo - longest)
        b = bisect.bisect_left(starts, hi)
        total += stats.busy_union([(max(s, lo), min(e, hi))
                                   for s, e in work[a:b] if e > lo])
    return total / len(spans) / 1e6
