"""The share of frames whose native coder call began before host_finish
was entered for their batch (the coder pool working through the next
batch's enqueue): the program's coder.ahead counter over the traced
window, over its coder.frame spans (one a frame), in %."""

from ._recorder import total, window


def read(run):
    ahead = total(run, "coder.ahead")
    frames = len(window(run, "host", "coder.frame"))
    return 100.0 * ahead / frames if ahead is not None and frames else None
