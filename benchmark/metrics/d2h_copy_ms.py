"""Host time of host_finish's six copies of the device outputs to
pageable host memory (and the kernel's error word): the program's
fin.d2h span, the mean over the traced window's calls."""

from ._recorder import mean_ms


def read(run):
    return mean_ms(run, "fin.d2h")
