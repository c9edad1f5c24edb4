"""Thread time of the native tile coder (ec/native.py encode_tile_intra
over native/tile_coder.c) a frame: its calls in the traced window, timed
on the coder threads and summed, over the frames coded."""


def read(run):
    t = run.window.coder_s
    return 1e3 * sum(t) / len(t) if run.trace is not None and t else None
