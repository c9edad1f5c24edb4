"""AV1 loop restoration - Wiener and self-guided (SGR) filters, spec §7.17.

Counterpart of ``svtav1_tpu/ops/restoration.py``; reference EbRestoration.c
(selfguided_restoration_* :668-955, svt_apply_selfguided_restoration_c
:958) and convolve.c:57-145 (Wiener convolve add-src).  The SGR box sums
are 2D cumulative-sum differences (int64 here: the JAX package's int32
cumsums wrap over a large plane, and their differences come out the same);
everything else keeps the JAX package's int32 arithmetic.  Every function
takes leading batch dimensions, and the per-window parameters (the SGR
projection weights, the Wiener taps) may be tensors with those dimensions,
so windows of one shape filter in one call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import upload

SGRPROJ_SGR_BITS = 8
SGRPROJ_SGR = 1 << SGRPROJ_SGR_BITS
SGRPROJ_RST_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
BORDER = 3  # SGRPROJ_BORDER_VERT/HORZ

# (r0, r1), (s0, s1) with s the normative mtable values
# (EbRestoration.c:85-103)
SGR_PARAMS = [
    ((2, 1), (140, 3236)), ((2, 1), (112, 2158)), ((2, 1), (93, 1618)),
    ((2, 1), (80, 1438)), ((2, 1), (70, 1295)), ((2, 1), (58, 1177)),
    ((2, 1), (47, 1079)), ((2, 1), (37, 996)), ((2, 1), (30, 925)),
    ((2, 1), (25, 863)), ((0, 1), (-1, 2589)), ((0, 1), (-1, 1618)),
    ((0, 1), (-1, 1177)), ((0, 1), (-1, 925)), ((2, 0), (56, -1)),
    ((2, 0), (22, -1)),
]

# x / (x + 1) in Q8 for z = 0..255 (x_by_xplus1, EbRestoration.c)
X_BY_XPLUS1 = np.array([
    1, 128, 171, 192, 205, 213, 219, 224, 228, 230, 233, 235, 236, 238, 239,
    240, 241, 242, 243, 243, 244, 244, 245, 245, 246, 246, 247, 247, 247, 247,
    248, 248, 248, 248, 249, 249, 249, 249, 249, 250, 250, 250, 250, 250, 250,
    250, 251, 251, 251, 251, 251, 251, 251, 251, 251, 251, 252, 252, 252, 252,
    252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 252, 253, 253,
    253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253,
    253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 253, 254, 254, 254,
    254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
    254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
    254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
    254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
    254, 254, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    256,
], np.int32)

ONE_BY_X = np.array([4096, 2048, 1365, 1024, 819, 683, 585, 512, 455, 410,
                     372, 341, 315, 293, 273, 256, 241, 228, 216, 205, 195,
                     186, 178, 171, 164], np.int32)

FILTER_BITS = 7
WIENER_ROUND0 = 3


@lru_cache(maxsize=None)
def _x_by_xplus1(device) -> torch.Tensor:
    return upload(X_BY_XPLUS1, device)


def _rpot(x, b):
    return (x + (1 << (b - 1))) >> b if b > 0 else x


def _boxsum(x, r):
    """Full-window (2r+1)^2 box sums; x [..., H, W] -> [..., H-2r, W-2r]."""
    c = torch.cumsum(torch.cumsum(x.to(torch.int64), -1), -2)
    c = torch.nn.functional.pad(c, (1, 0, 1, 0))
    n = 2 * r + 1
    return (c[..., n:, n:] - c[..., n:, :-n] - c[..., :-n, n:] +
            c[..., :-n, :-n]).to(torch.int32)


def _sgr_ab(dgd_ext, r, s, bit_depth):
    """A/B guidance over positions [-1..h+1) x [-1..w+1) of the interior.

    dgd_ext [..., h+2*BORDER, w+2*BORDER] int32 -> A, B [..., h+2, w+2]."""
    n = (2 * r + 1) * (2 * r + 1)
    bs_b = _boxsum(dgd_ext, r)
    bs_a = _boxsum(dgd_ext * dgd_ext, r)
    o = BORDER - 1 - r
    H = dgd_ext.shape[-2] - 2 * BORDER
    W = dgd_ext.shape[-1] - 2 * BORDER
    A0 = bs_a[..., o:o + H + 2, o:o + W + 2]
    B0 = bs_b[..., o:o + H + 2, o:o + W + 2]
    a = _rpot(A0, 2 * (bit_depth - 8)) if bit_depth > 8 else A0
    b = _rpot(B0, bit_depth - 8) if bit_depth > 8 else B0
    p = torch.clamp(a * n - b * b, min=0)
    # z = round2(p * s, 20) with the multiply split to stay in int32
    hi = p >> 10
    lo = p & 1023
    t = lo * s + (1 << (SGRPROJ_MTABLE_BITS - 1))
    z = (hi * s + (t >> 10)) >> 10
    A = _x_by_xplus1(dgd_ext.device)[torch.clamp(z, max=255).to(torch.int64)]
    B = _rpot((SGRPROJ_SGR - A) * B0 * int(ONE_BY_X[n - 1]),
              SGRPROJ_RECIP_BITS)
    return A, B


def _sgr_filter_r2(dgd_ext, s, bit_depth):
    """Fast (r=2) path: A/B on odd interior rows, 5-neighbour blends."""
    A, B = _sgr_ab(dgd_ext, 2, s, bit_depth)   # [..., h+2, w+2], idx0 = -1
    H = dgd_ext.shape[-2] - 2 * BORDER
    W = dgd_ext.shape[-1] - 2 * BORDER
    dgd = dgd_ext[..., BORDER:BORDER + H, BORDER:BORDER + W]
    out = torch.empty(dgd.shape, dtype=torch.int32, device=dgd.device)
    ne, no = (H + 1) // 2, H // 2

    def rows(M, start, n):
        return M[..., start:start + 2 * n:2, :]

    def blend(up, dn):
        c = (up[..., 1:W + 1] + dn[..., 1:W + 1]) * 6
        return c + (up[..., :W] + dn[..., :W] + up[..., 2:] + dn[..., 2:]) * 5

    # even rows i: A/B rows i-1 and i+1 (A index i and i+2)
    a_e = blend(rows(A, 0, ne), rows(A, 2, ne))
    b_e = blend(rows(B, 0, ne), rows(B, 2, ne))
    out[..., 0::2, :] = _rpot(a_e * dgd[..., 0::2, :] + b_e,
                              SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
    # odd rows i: A/B row i (A index i+1)
    ce_a, ce_b = rows(A, 2, no), rows(B, 2, no)
    a_o = ce_a[..., 1:W + 1] * 6 + (ce_a[..., :W] + ce_a[..., 2:]) * 5
    b_o = ce_b[..., 1:W + 1] * 6 + (ce_b[..., :W] + ce_b[..., 2:]) * 5
    out[..., 1::2, :] = _rpot(a_o * dgd[..., 1::2, :] + b_o,
                              SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS)
    return out


def _sgr_filter_r1(dgd_ext, s, bit_depth):
    """Full-resolution (r=1) path: 3x3 cross blend weights 4/3."""
    A, B = _sgr_ab(dgd_ext, 1, s, bit_depth)
    H = dgd_ext.shape[-2] - 2 * BORDER
    W = dgd_ext.shape[-1] - 2 * BORDER
    dgd = dgd_ext[..., BORDER:BORDER + H, BORDER:BORDER + W]

    def w3(M):
        c = M[..., 1:H + 1, 1:W + 1]
        n4 = (c + M[..., 1:H + 1, :W] + M[..., 1:H + 1, 2:] +
              M[..., :H, 1:W + 1] + M[..., 2:, 1:W + 1]) * 4
        n3 = (M[..., :H, :W] + M[..., :H, 2:] + M[..., 2:, :W] +
              M[..., 2:, 2:]) * 3
        return n4 + n3

    return _rpot(w3(A) * dgd + w3(B), SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)


def apply_sgr(dgd_ext, eps: int, xqd0, xqd1, bit_depth: int = 8):
    """Self-guided restoration of the interior of dgd_ext [..., h+6, w+6]
    (3-pixel borders) -> restored [..., h, w] int32.  xqd0/xqd1 are ints
    or int32 tensors that broadcast against [..., h, w]."""
    (r0, r1), (s0, s1) = SGR_PARAMS[eps]
    H = dgd_ext.shape[-2] - 2 * BORDER
    W = dgd_ext.shape[-1] - 2 * BORDER
    x = dgd_ext.to(torch.int32)
    dgd = x[..., BORDER:BORDER + H, BORDER:BORDER + W]
    u = dgd << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if r0 == 0:
        xq0, xq1 = 0, (1 << SGRPROJ_PRJ_BITS) - xqd1
    elif r1 == 0:
        xq0, xq1 = xqd0, 0
    else:
        xq0 = xqd0
        xq1 = (1 << SGRPROJ_PRJ_BITS) - xq0 - xqd1
    if r0 > 0:
        v = v + xq0 * (_sgr_filter_r2(x, s0, bit_depth) - u)
    if r1 > 0:
        v = v + xq1 * (_sgr_filter_r1(x, s1, bit_depth) - u)
    w = _rpot(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return torch.clamp(w, 0, (1 << bit_depth) - 1)


def wiener_filter(src_ext, filter_x, filter_y, bd: int = 8):
    """Wiener restoration of the interior of src_ext [..., h+6, w+6]
    (3-pixel borders) with 7-tap filters; filter_x / filter_y [..., 7 or 8]
    (tap 7, if present, is 0; the centre tap excludes the +128 add-src
    term), one filter per leading index or one for all."""
    x = src_ext.to(torch.int32)
    H = x.shape[-2] - 2 * BORDER
    W = x.shape[-1] - 2 * BORDER
    round1 = 2 * FILTER_BITS - WIENER_ROUND0
    tap = lambda f, k: f[..., k, None, None]
    taps = lambda f: (f.to(torch.int32) if torch.is_tensor(f) else
                      upload(np.asarray(f, np.int32), x.device))

    fx = taps(filter_x)
    hsum = sum(tap(fx, k) * x[..., :, k:k + W] for k in range(7))
    hsum = hsum + (x[..., :, 3:3 + W] << FILTER_BITS) + \
        (1 << (bd + FILTER_BITS - 1))
    limit = (1 << (bd + 1 + FILTER_BITS - WIENER_ROUND0)) - 1
    im = torch.clamp(_rpot(hsum, WIENER_ROUND0), 0, limit)

    fy = taps(filter_y)
    vsum = sum(tap(fy, k) * im[..., k:k + H, :] for k in range(7))
    vsum = vsum + (im[..., 3:3 + H, :] << FILTER_BITS) - \
        (1 << (bd + round1 - 1))
    return torch.clamp(_rpot(vsum, round1), 0, (1 << bd) - 1)
