"""Batched AV1 forward/inverse 2D transforms (normative, integer-exact).

Counterpart of ``svtav1_tpu/ops/transforms.py`` for what the intra paths
use: square transforms at n = 8, 16, 32 and 64 with DCT, ADST (n <= 16)
and identity 1D kinds (no flips, no rectangles).  Each 1D butterfly stage of
``spec.txfm.compiled_stages`` is a gather + int32 multiply-add
over the last axis, batched over the leading axes.  As in the JAX package,
int32 products do not overflow for 8/10-bit coefficient ranges (clamped
stage ranges <= 18 bits times cospi <= 13 bits).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import upload
from ..spec import txfm as T


def round2(x, bit: int):
    """AV1 Round2: (x + (1 << (bit-1))) >> bit (arithmetic)."""
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


def _clamp(x, bit: int):
    return x.clamp(-(1 << (bit - 1)), (1 << (bit - 1)) - 1)


def _round_shift_signed(x, shift: int):
    """shift > 0: Round2; shift < 0: multiply by 2^-shift."""
    if shift == 0:
        return x
    if shift > 0:
        return round2(x, shift)
    return x << (-shift)


@lru_cache(maxsize=None)
def _stages_t(kind: str, n: int, direction: str, cos_bit: int,
              device: str):
    """compiled_stages as tensors on `device` (one upload per network)."""
    out = []
    for ia, wa, ib, wb, mode in T.compiled_stages(kind, n, direction,
                                                  cos_bit):
        out.append(tuple(upload(a, device)
                         for a in (ia.astype("int64"), wa, ib.astype("int64"),
                                   wb, mode.astype("int32"))))
    return tuple(out)


def _apply_network(x, kind: str, n: int, direction: str, cos_bit: int,
                   clamp_bit: int):
    half = 1 << (cos_bit - 1)
    for ia, wa, ib, wb, mode in _stages_t(kind, n, direction, cos_bit,
                                          str(x.device)):
        lin = wa * x[..., ia] + wb * x[..., ib]
        out = torch.where(mode == T.MODE_BTF, (lin + half) >> cos_bit, lin)
        if clamp_bit:
            out = torch.where(mode == T.MODE_ADD_CLAMP,
                              _clamp(lin, clamp_bit), out)
        x = out
    return x


def _identity(x, n: int):
    """Identity transform (same formula both directions,
    EbInvTransforms.c:2331-2360, EbTransforms.c:2205-2237)."""
    if n == 8:
        return x * 2
    if n == 16:
        return round2(x * (2 * T.NEW_SQRT2), T.NEW_SQRT2_BITS)
    if n == 32:
        return x * 4
    return round2(x * (4 * T.NEW_SQRT2), T.NEW_SQRT2_BITS)


_KIND = {T.DCT_1D: "dct", T.ADST_1D: "adst", T.IDTX_1D: "idtx"}


def _kinds(tx_size: int, tx_type: int):
    w, h = T.TX_W[tx_size], T.TX_H[tx_size]
    row, col = T.HTX_TAB[tx_type], T.VTX_TAB[tx_type]
    if w != h or w not in (8, 16, 32, 64) or row not in _KIND \
            or col not in _KIND or (w > 16 and T.ADST_1D in (row, col)):
        raise NotImplementedError(
            f"tx_size {tx_size} / tx_type {tx_type}: the port covers square "
            "8..64 DCT, 8/16 ADST and identity (svtav1_tpu.ops.transforms "
            "has the rest)")
    return w, _KIND[row], _KIND[col]


def _apply_1d(x, kind: str, n: int, direction: str, cos_bit: int,
              clamp_bit: int):
    if kind == "idtx":
        return _identity(x, n)
    return _apply_network(x, kind, n, direction, cos_bit, clamp_bit)


def inv_ranges(bd: int) -> dict:
    """The inverse transform's clamps at bd, as bit widths: its input (the
    dequantizer's range), the row network's stages, the row output and the
    column network's stages (row and column differ above 8 bits); and
    res_max, the residual's limit before reconstruction.  inv_txfm2d and
    add_residual_clip use them, and so does the CUDA wavefront kernel
    (cuda/wavefront_kernel.tx_params)."""
    return dict(inp=bd + 8, row=T.opt_range(bd, False), mid=max(bd + 6, 16),
                col=T.opt_range(bd, True),
                res_max=(1 << (7 + bd)) - 1 + (914 << (bd - 7)))


def inv_txfm2d(coeffs, tx_size: int, tx_type: int, bd: int = 8):
    """Inverse 2D transform of dequantized coeffs [..., n, n] -> residual."""
    n, row_kind, col_kind = _kinds(tx_size, tx_type)
    shift = T.INV_SHIFT[(n, n)]
    r = inv_ranges(bd)
    x = _clamp(coeffs.to(torch.int32), r["inp"])
    x = _apply_1d(x, row_kind, n, "inv", T.INV_COS_BIT, r["row"])
    x = _round_shift_signed(x, -shift[0])
    x = _clamp(x.transpose(-1, -2), r["mid"])
    x = _apply_1d(x, col_kind, n, "inv", T.INV_COS_BIT, r["col"])
    x = _round_shift_signed(x, -shift[1])
    return x.transpose(-1, -2)


def add_residual_clip(pred, residual, bd: int = 8):
    """recon = clip(pred + wraplow(residual))."""
    int_max = inv_ranges(bd)["res_max"]
    res = residual.clamp(-int_max - 1, int_max)
    return (pred.to(torch.int32) + res).clamp(0, (1 << bd) - 1)


def fwd_txfm2d(residual, tx_size: int, tx_type: int, bd: int = 8):
    """Forward 2D transform of residual [..., n, n] -> coeffs [..., n, n]."""
    n, row_kind, col_kind = _kinds(tx_size, tx_type)
    shift = T.FWD_SHIFT[(n, n)]
    wi = n.bit_length() - 3
    cos_bit_col = T.FWD_COS_BIT_COL[wi][wi]
    cos_bit_row = T.FWD_COS_BIT_ROW[wi][wi]
    x = residual.to(torch.int32).transpose(-1, -2)       # columns first
    x = _round_shift_signed(x, -shift[0])
    x = _apply_1d(x, col_kind, n, "fwd", cos_bit_col, 0)
    x = _round_shift_signed(x, -shift[1]).transpose(-1, -2)
    x = _apply_1d(x, row_kind, n, "fwd", cos_bit_row, 0)
    return _round_shift_signed(x, -shift[2])
