"""Batched AV1 intra predictors (normative, spec §7.11.2) in PyTorch.

Counterpart of ``svtav1_tpu/ops/intra.py``: each predictor maps a batch of
edge vectors (above[..., w], left[..., h], above-left corner[...]) to
predictions [..., h, w] with integer tensor ops (int32 in, int32 out).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import upload

# AV1 intra mode enum (spec §6.10.19)
(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
 D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
 PAETH_PRED) = range(13)

# sm_weight_arrays (spec Sm_Weights_Tx_*), indexed by block dimension:
# the weights of an n-sample edge are SM_WEIGHTS[n:2n].
SM_WEIGHTS = np.array([
    0, 0, 255, 128,
    # bs = 4
    255, 149, 85, 64,
    # bs = 8
    255, 197, 146, 105, 73, 50, 37, 32,
    # bs = 16
    255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17, 16,
    # bs = 32
    255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92, 83,
    74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8,
    # bs = 64
    255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163,
    156, 150, 144, 138, 133, 127, 121, 116, 111, 106, 101, 96, 91, 86, 82,
    77, 73, 69, 65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32, 29, 27, 25, 22,
    20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4,
], dtype=np.int32)

SM_WEIGHT_LOG2_SCALE = 8


@lru_cache(maxsize=None)
def _weights_t(n: int, device: str) -> torch.Tensor:
    return upload(SM_WEIGHTS[n:2 * n], device)


def _weights(n: int, like: torch.Tensor) -> torch.Tensor:
    """The n smooth weights on like's device (one upload per device)."""
    return _weights_t(n, str(like.device))


def dc_pred(above, left, have_above: bool = True, have_left: bool = True,
            bd: int = 8):
    """above: [..., w] int32, left: [..., h] int32 -> [..., h, w]."""
    h, w = left.shape[-1], above.shape[-1]
    shape = above.shape[:-1] + (h, w)
    if have_above and have_left:
        s = above.sum(-1) + left.sum(-1)
        dc = torch.div(s + ((w + h) >> 1), w + h, rounding_mode="floor")
    elif have_above:
        dc = torch.div(above.sum(-1) + (w >> 1), w, rounding_mode="floor")
    elif have_left:
        dc = torch.div(left.sum(-1) + (h >> 1), h, rounding_mode="floor")
    else:
        dc = torch.full(above.shape[:-1], 1 << (bd - 1), dtype=torch.int32,
                        device=above.device)
    return dc.to(torch.int32)[..., None, None].expand(shape)


def v_pred(above, left):
    h = left.shape[-1]
    return above[..., None, :].expand(above.shape[:-1] +
                                      (h, above.shape[-1]))


def h_pred(above, left):
    w = above.shape[-1]
    return left[..., :, None].expand(left.shape[:-1] + (left.shape[-1], w))


def paeth_pred(above, left, top_left):
    """top_left: [...] one sample per batch element."""
    t = above[..., None, :]                         # [..., 1, w]
    l = left[..., :, None]                          # [..., h, 1]
    tl = top_left[..., None, None]
    base = t + l - tl
    p_t = (base - t).abs()
    p_l = (base - l).abs()
    p_tl = (base - tl).abs()
    shape = base.shape
    return torch.where((p_l <= p_t) & (p_l <= p_tl), l.expand(shape),
                       torch.where(p_t <= p_tl, t.expand(shape),
                                   tl.expand(shape)))


def _smooth_div(v, log2_scale: int):
    return (v + (1 << (log2_scale - 1))) >> log2_scale


def smooth_pred(above, left):
    h, w = left.shape[-1], above.shape[-1]
    below = left[..., -1:]
    right = above[..., -1:]
    wh = _weights(h, above)
    ww = _weights(w, above)
    scale = 1 << SM_WEIGHT_LOG2_SCALE
    p = (wh[:, None] * above[..., None, :] +
         (scale - wh)[:, None] * below[..., None] +
         ww[None, :] * left[..., :, None] +
         (scale - ww)[None, :] * right[..., None])
    return _smooth_div(p, SM_WEIGHT_LOG2_SCALE + 1)


def smooth_v_pred(above, left):
    h = left.shape[-1]
    below = left[..., -1:]
    wh = _weights(h, above)
    scale = 1 << SM_WEIGHT_LOG2_SCALE
    p = (wh[:, None] * above[..., None, :] +
         (scale - wh)[:, None] * below[..., None])
    return _smooth_div(p, SM_WEIGHT_LOG2_SCALE)


def smooth_h_pred(above, left):
    w = above.shape[-1]
    right = above[..., -1:]
    ww = _weights(w, above)
    scale = 1 << SM_WEIGHT_LOG2_SCALE
    p = (ww[None, :] * left[..., :, None] +
         (scale - ww)[None, :] * right[..., None])
    return _smooth_div(p, SM_WEIGHT_LOG2_SCALE)


def predict(mode: int, above, left, top_left, have_above=True,
            have_left=True, bd: int = 8):
    """Dispatch one smooth/DC-family mode over a batch of edges."""
    if mode == DC_PRED:
        return dc_pred(above, left, have_above, have_left, bd)
    if mode == V_PRED:
        return v_pred(above, left)
    if mode == H_PRED:
        return h_pred(above, left)
    if mode == SMOOTH_PRED:
        return smooth_pred(above, left)
    if mode == SMOOTH_V_PRED:
        return smooth_v_pred(above, left)
    if mode == SMOOTH_H_PRED:
        return smooth_h_pred(above, left)
    if mode == PAETH_PRED:
        return paeth_pred(above, left, top_left)
    raise NotImplementedError(f"mode {mode}")
