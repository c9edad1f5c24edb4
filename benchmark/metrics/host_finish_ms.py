"""Host time of one IntraEncoder.host_finish call (the D2H wait, the
native coder on its threads, OBU assembly), the mean over the traced
window's calls."""


def read(run):
    if run.trace is None:
        return None
    spans = run.window.spans.get("host_finish", [])
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None
