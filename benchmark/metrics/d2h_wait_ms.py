"""Host time host_finish waits for its batch's device work before the
copies (a CUDA event recorded at the end of device_encode, in traced runs
only): the program's fin.wait span, the mean over the traced window's
calls."""

from ._recorder import mean_ms


def read(run):
    return mean_ms(run, "fin.wait")
