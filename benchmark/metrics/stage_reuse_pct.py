"""The share of device_encode calls that staged their batch into a host
slot that already existed (the slots reused, not made): the program's
stage.reused counter (a sample of 0 or 1 a call) over the traced
window's calls (its enc.stage spans), in %."""

from ._recorder import total, window


def read(run):
    reused = total(run, "stage.reused")
    calls = len(window(run, "host", "enc.stage"))
    return 100.0 * reused / calls if reused is not None and calls else None
