"""The edge strip kernel's share of its roofline: the frozen work count's
least time (yardstick/edgecount.py), summed over the traced window's
chain launches (the pipeline's edge_calls), over the profiler's device
time of the wf_edge_kernel events; nothing where the window ran none."""

from ..yardstick import edgecount


def read(run):
    calls = getattr(run.window, "edge_calls", None)
    if run.trace is None or not calls:
        return None
    kern = sum(e - s for name, s, e in run.trace.device_events
               if "wf_edge_kernel" in name) / 1e9
    if kern <= 0:
        return None
    least = sum(edgecount.least_seconds(*call, run.bit_depth)
                for call in calls)
    return 100.0 * least / kern
