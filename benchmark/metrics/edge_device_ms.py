"""Device time of a batch's edge strip on the card: the busy union of the
profiler's wf_edge_kernel events inside each dev.edge span of the traced
window, the mean over its batches; nothing where the frame has no strip.
Only the chain kernel's events count: the copy stream's D2H of the
previous batch runs beside the span and is not the strip's work.

Read as deblock_device_ms reads dev.deblock: the program numbers each span
with the MARK kernel it runs just before the span's first event, so the
span starts on the profiler's device timeline where that marker ends, and
its length is the span's own (a pair of CUDA events)."""

import bisect

from ..yardstick import stats
from ._recorder import recorder, window


def read(run):
    tr = recorder()
    spans = [r for r in window(run, "device", "dev.edge") if r.n]
    if tr is None or not spans or not run.trace.device_events:
        return None
    marks = sorted((s, e) for name, s, e in run.trace.device_events
                   if tr.MARK in name)
    work = sorted((s, e) for name, s, e in run.trace.device_events
                  if "wf_edge_kernel" in name)
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
