"""Host time of host_finish's OBU assembly (frame headers, the key frame
OBUs, the capped re-encode when set): the program's fin.obu span, the
mean over the traced window's calls."""

from ._recorder import mean_ms


def read(run):
    return mean_ms(run, "fin.obu")
