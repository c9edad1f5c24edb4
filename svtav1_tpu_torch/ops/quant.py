"""Quantization / dequantization in PyTorch.

Counterpart of ``svtav1_tpu/ops/quant.py``: the encoder's deadzone
quantizer (rounding 48/128 of the step) and the normative dequantizer
(spec §7.12.3: level * dqv masked to 24 bits, >> tx scale shift, re-signed,
clamped to ±2^(bd+7)).  dc/ac are the dequant steps; the dc step applies
at position (0, 0) only.
"""

from __future__ import annotations

import torch

from ..spec import tables as tbl


def _dqv(dc, ac, h: int, w: int, device):
    m = torch.full((h, w), int(ac), dtype=torch.int32, device=device)
    m[0, 0] = int(dc)
    return m


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
