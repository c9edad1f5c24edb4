"""Host time of device_encode's uploads of a batch (pin_memory and the
non-blocking H2D, one enc.upload span a plane: luma, then chroma after
the luma launch): the window's enc.upload spans summed over its calls."""

from ._recorder import per_call_ms


def read(run):
    return per_call_ms(run, "enc.upload")
