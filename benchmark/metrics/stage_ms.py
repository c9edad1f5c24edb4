"""Host time of device_encode's staging of a batch (np.stack and the
bottom edge pad of its luma and chroma planes): the program's enc.stage
span, the mean over the traced window's calls."""

from ._recorder import mean_ms


def read(run):
    return mean_ms(run, "enc.stage")
