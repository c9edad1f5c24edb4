"""Quantization / dequantization in PyTorch.

Counterpart of ``svtav1_tpu/ops/quant.py``: the encoder's deadzone
quantizer (rounding 48/128 of the step), its one-step coefficient
optimization (``quantize_dq_opt``), and the normative dequantizer (spec
§7.12.3: level * dqv masked to 24 bits, >> tx scale shift, re-signed,
clamped to ±2^(bd+7)).  dc/ac are the dequant steps (Python ints, or 0-d
int32 tensors on the coefficients' device); the dc step applies at
position (0, 0) only.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import upload
from ..spec import tables as tbl


@lru_cache(maxsize=None)
def _dqv_t(dc: int, ac: int, h: int, w: int, device: str):
    m = np.full((h, w), ac, np.int32)
    m[0, 0] = dc
    return upload(m, device)


@lru_cache(maxsize=None)
def _dc_pos(h: int, w: int, device: str):
    m = np.zeros((h, w), bool)
    m[0, 0] = True
    return upload(m, device)


def _dqv(dc, ac, h: int, w: int, device):
    """Per-position dequant step [h, w] on `device`: one upload per
    (steps, shape, device) for int steps; for 0-d int32 tensors on
    `device` (a captured graph's inputs) a select, so that the steps may
    change between replays."""
    if isinstance(dc, torch.Tensor) and dc.device == torch.device(device):
        return torch.where(_dc_pos(h, w, str(device)), dc, ac)
    return _dqv_t(int(dc), int(ac), h, w, str(device))


def quantize_dq(coeffs, tx_size: int, dc, ac, bd: int = 8):
    """Deadzone quantization of coeffs [..., h, w] -> levels."""
    shift = tbl.tx_scale_shift(tx_size)
    dqv = _dqv(dc, ac, coeffs.shape[-2], coeffs.shape[-1], coeffs.device)
    scaled = coeffs.abs().to(torch.int32) << shift
    rounding = (dqv * 48) >> 7
    level = torch.div(scaled + rounding, dqv, rounding_mode="floor")
    level = level.clamp(0, (1 << 15) - 1)
    return torch.sign(coeffs).to(torch.int32) * level


def dequantize_dq(levels, tx_size: int, dc, ac, bd: int = 8):
    """Normative dequantization of levels [..., h, w] -> coefficients."""
    shift = tbl.tx_scale_shift(tx_size)
    dqv = _dqv(dc, ac, levels.shape[-2], levels.shape[-1], levels.device)
    v = ((levels.abs().to(torch.int32) * dqv) & 0xFFFFFF) >> shift
    v = torch.sign(levels).to(torch.int32) * v
    lim = 1 << (bd + 7)
    return v.clamp(-lim, lim - 1)


# ---- coefficient optimization (encoder-side, non-normative) ----------- #

@lru_cache(maxsize=None)
def tx_gain(tx_size: int, bd: int = 8) -> float:
    """Pixel SSE per unit coefficient SSE of a tx size (the integer
    transforms are not orthonormal): the float32 energy of the inverse DCT
    of one 1024 coefficient at (h/4, w/4), over 1024^2, on the CPU."""
    from ..spec.txfm import DCT_DCT
    from .transforms import inv_txfm2d
    h, w = tbl.TX_H[tx_size], tbl.TX_W[tx_size]
    c = torch.zeros((1, h, w), dtype=torch.int32)
    c[0, h // 4, w // 4] = 1024
    r = inv_txfm2d(c, tx_size, DCT_DCT, bd).to(torch.float32)
    return float((r ** 2).sum() / (1024.0 * 1024.0))


def quantize_dq_opt(coeffs, tx_size: int, dc, ac, lam, bd: int = 8):
    """Deadzone quantization + one-step coefficient optimization: each
    level steps down by 1 (to zero included) when the pixel-domain
    distortion it adds is cheaper than lam times the estimated rate it
    saves.  lam: float32 0-d tensor (the RD lambda)."""
    shift = tbl.tx_scale_shift(tx_size)
    g = tx_gain(tx_size, bd)           # pixel SSE per unit coeff SSE
    dqv = _dqv(dc, ac, coeffs.shape[-2], coeffs.shape[-1], coeffs.device)
    scaled = coeffs.abs().to(torch.int32) << shift
    rounding = (dqv * 48) >> 7
    l0 = torch.div(scaled + rounding, dqv,
                   rounding_mode="floor").clamp(max=(1 << 15) - 1)
    # scaled-domain reconstruction errors at l0 and l0-1
    e0 = (scaled - l0 * dqv).to(torch.float32)
    e1 = e0 + dqv.to(torch.float32)
    # pixel-domain distortion increase of stepping the level down
    dd = (e1 * e1 - e0 * e0) * (g / float(4 ** shift))
    l0f = l0.clamp(min=1).to(torch.float32)
    # marginal rate of the current level (calibrated _resid_bits shape): a
    # vanishing coefficient also saves its nnz term
    dr = torch.where(l0 == 1, 2.43 + 1.83,
                     1.83 * (torch.log2(1.0 + l0f) - torch.log2(l0f)))
    down = (l0 > 0) & (dd < lam * dr)
    lev = l0 - down.to(torch.int32)
    return torch.sign(coeffs).to(torch.int32) * lev
