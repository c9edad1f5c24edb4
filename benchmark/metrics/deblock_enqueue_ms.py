"""Host time of device_encode's deblock enqueue (the two
deblock_plane_uniform calls and the casts to pixels): the program's
enc.deblock span, the mean over the traced window's calls."""

from ._recorder import mean_ms


def read(run):
    return mean_ms(run, "enc.deblock")
