"""Host time of host_finish's coding (the candidate tables, the CDF set,
the main thread's wait on the coder pool's frames): the program's
fin.coder span, the mean over the traced window's calls."""

from ._recorder import mean_ms


def read(run):
    return mean_ms(run, "fin.coder")
