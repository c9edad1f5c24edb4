"""Host time of device_encode's edge strip enqueue (the two chain kernel
launches of an m = 12 frame's bottom SB row): the program's enc.edge span,
the mean over the traced window's calls; nothing where the frame has no
strip (or the program no such span)."""

from ._recorder import mean_ms


def read(run):
    return mean_ms(run, "enc.edge")
