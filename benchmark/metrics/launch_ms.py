"""Host time of device_encode's two encode_plane_wavefront calls (RD
tables and their CdfContext, the kernel launches; one enc.launch span a
plane): the window's enc.launch spans summed over its calls."""

from ._recorder import per_call_ms


def read(run):
    return per_call_ms(run, "enc.launch")
