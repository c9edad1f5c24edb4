"""The least time of an edge strip kernel launch (``wf_edge_kernel``, the
chain of the bottom SB row of an m = 12 plane): a frozen count of its
int32 operations and bytes, against workcount's peaks.

The launch codes, on each of B planes of width w, the bottom SB row's
big blocks (32x32 luma, 16x16 chroma) over one 32 (16) pixel row and the
strip's small blocks (16x16 luma, 8x8 chroma) over the 16 (8) in-frame
rows below them; every candidate of every block runs the normative chain
on every pixel, counted as workcount counts the plane kernel's (the 1D
networks of the block's size over their n values, plus 30 operations a
pixel), with the 8-point networks counted the same way.  The bytes: the
source read once (1 byte a pixel at 8 bits, 2 at 10), the int32 levels and
recon written once.

Frozen from the port's ``cuda/edge_kernel.py::edge_work``; the program's
copy may change, this one does not.
"""

from __future__ import annotations

from . import workcount as wc

NET_OPS = {**wc.NET_OPS, ("dct", 8, "fwd"): 70, ("dct", 8, "inv"): 102,
           ("adst", 8, "fwd"): 111, ("adst", 8, "inv"): 143}


def ops_per_pixel(n: int, kinds) -> float:
    return sum((NET_OPS[(ck, n, "fwd")] + NET_OPS[(rk, n, "fwd")] +
                NET_OPS[(rk, n, "inv")] + NET_OPS[(ck, n, "inv")]) / n +
               wc.PIXEL_OPS for rk, ck in kinds)


def work(big: int, B: int, w: int, chroma: bool, bd: int) -> tuple:
    """(int32 operations, bytes) of one launch on B planes of width w
    (big = 32 luma, 16 chroma)."""
    kinds = wc.CHROMA_KINDS if chroma else wc.LUMA_KINDS
    s = big // 2
    ops = (ops_per_pixel(big, kinds) * B * big * w +
           ops_per_pixel(s, kinds) * B * s * w)
    px = B * (big + s) * w
    return int(ops), px * ((1 if bd == 8 else 2) + 4 + 4)


def least_seconds(big: int, B: int, w: int, chroma: bool, bd: int) -> float:
    ops, nbytes = work(big, B, w, chroma, bd)
    return max(ops / wc.INT32_OPS_PER_S, nbytes / wc.HBM_BYTES_PER_S)
