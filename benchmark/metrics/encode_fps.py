"""Frames whose payloads host_finish returned in the window, over the
window's seconds (first batch queued to the last return counted)."""


def read(run):
    w = run.window
    return w.frames / (w.t_end - w.t0)
