"""The least time of a flat wavefront kernel call: a frozen count of its
int32 operations and bytes, against a stated peak.

Every candidate of every block runs the normative chain on every pixel:
the forward column and row networks, the inverse row and column networks
(operations per 1D network below, counted from the spec's butterfly
networks: a butterfly 2 multiplies, 2 adds and a shift; an add 1, 3 with
the inverse's clamp; a negation 1; a pass-through 0), over the network's n
values, plus an estimated 30 operations a pixel for prediction, residual,
quantization, dequantization, reconstruction and the squared error.  The
bytes are the source read once (1 byte a pixel at 8 bits, 2 at 10), the
int32 levels and recon written once, and a mode index a block.

Frozen from the port's ``cuda/wavefront_kernel.py::work`` (the counts
agree for the flat intra forms); the program's copy may change, this one
does not.

The peak: NVIDIA publishes no int32 rate for the H100, so it is taken as
64 int32 lanes an SM x 132 SMs (H100 SXM) x 1.98 GHz, the SXM part's
highest boost clock: 16.7 Tops/s, an assumption.  HBM: 3.35 TB/s, NVIDIA's
data sheet.
"""

from __future__ import annotations

NET_OPS = {("dct", 16, "fwd"): 190, ("dct", 16, "inv"): 286,
           ("adst", 16, "fwd"): 279, ("adst", 16, "inv"): 375,
           ("dct", 32, "fwd"): 482, ("dct", 32, "inv"): 738}
PIXEL_OPS = 30
# (row kind, column kind) of each candidate's transform: luma codes
# DCT_DCT; chroma the tx type its uv mode implies (DC .. PAETH)
LUMA_KINDS = (("dct", "dct"),) * 13
_T = {0: ("dct", "dct"), 1: ("dct", "adst"), 2: ("adst", "dct"),
      3: ("adst", "adst")}
CHROMA_KINDS = tuple(_T[t] for t in (0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3))

INT32_OPS_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def ops_per_pixel(bs: int, kinds) -> float:
    return sum((NET_OPS[(ck, bs, "fwd")] + NET_OPS[(rk, bs, "fwd")] +
                NET_OPS[(rk, bs, "inv")] + NET_OPS[(ck, bs, "inv")]) / bs +
               PIXEL_OPS for rk, ck in kinds)


def work(bs: int, B: int, h: int, w: int, chroma: bool, bd: int) -> tuple:
    """(int32 operations, bytes) of one plane call of B planes h x w."""
    px = B * h * w
    ops = ops_per_pixel(bs, CHROMA_KINDS if chroma else LUMA_KINDS) * px
    nbytes = px * ((1 if bd == 8 else 2) + 4 + 4) + 4 * px // (bs * bs)
    return int(ops), nbytes


def least_seconds(bs: int, B: int, h: int, w: int, chroma: bool,
                  bd: int) -> float:
    ops, nbytes = work(bs, B, h, w, chroma, bd)
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
