"""The native tile coder's symbol rate on one thread: the program's
coder.symbols counter (each binary and multi-symbol code of
native/tile_coder.c) over the traced window, over the summed seconds of
its coder.frame spans (one a frame, on the coder threads)."""

from ._recorder import total, window


def read(run):
    n = total(run, "coder.symbols")
    secs = sum(r.end_ns - r.start_ns
               for r in window(run, "host", "coder.frame")) / 1e9
    return n / secs if n and secs > 0 else None
