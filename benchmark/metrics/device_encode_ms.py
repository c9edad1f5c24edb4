"""Host time of one IntraEncoder.device_encode call (H2D, RD tables, the
two kernel launches, deblock; it does not wait for the device), the mean
over the traced window's calls."""


def read(run):
    if run.trace is None:
        return None
    spans = run.window.spans.get("device_encode", [])
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None
