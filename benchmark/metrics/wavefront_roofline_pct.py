"""The wavefront kernel's share of its roofline: the frozen work count's
least time (yardstick/workcount.py), summed over the traced window's
plane calls, over the profiler's device time of the wf_plane_kernel
events."""

from ..yardstick import workcount


def read(run):
    if run.trace is None:
        return None
    kern = sum(e - s for name, s, e in run.trace.device_events
               if "wf_plane_kernel" in name) / 1e9
    if kern <= 0:
        return None
    least = sum(workcount.least_seconds(*call, run.bit_depth)
                for call in run.window.plane_calls)
    return 100.0 * least / kern
