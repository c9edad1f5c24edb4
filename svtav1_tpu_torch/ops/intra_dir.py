"""Batched directional intra prediction (spec §7.11.2.4) in PyTorch.

Counterpart of ``svtav1_tpu/ops/intra_dir.py``.  With the intra edge filter
off, every zone is a 2-tap interpolation over the extended edges with
static per-(angle, size) index and shift maps (numpy, below); the CUDA
wavefront kernel reads the same maps.

Edge conventions per block (int32):
  above_ext [b, 2n]: above row + top-right extension (real or replicated)
  left_ext  [b, 2n]: left col + bottom-left extension
  corner    [b]    : above-left sample
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import upload

# mode -> base angle (spec §7.11.2.1)
MODE_ANGLE = {1: 90, 2: 180, 3: 45, 4: 135, 5: 113, 6: 157, 7: 203, 8: 67}

# Dr_Intra_Derivative (normative)
_DR = np.zeros(90, np.int32)
for _a, _v in [(3, 1023), (6, 547), (9, 372), (14, 273), (17, 215), (20, 178),
               (23, 151), (26, 132), (29, 116), (32, 102), (36, 90), (39, 80),
               (42, 71), (45, 64), (48, 57), (51, 51), (54, 45), (58, 40),
               (61, 35), (64, 31), (67, 27), (70, 23), (73, 19), (76, 15),
               (81, 11), (84, 7), (87, 3)]:
    _DR[_a] = _v


def get_dx(angle: int) -> int:
    if 0 < angle < 90:
        return int(_DR[angle])
    if 90 < angle < 180:
        return int(_DR[180 - angle])
    return 1


def get_dy(angle: int) -> int:
    if 90 < angle < 180:
        return int(_DR[angle - 90])
    if 180 < angle < 270:
        return int(_DR[270 - angle])
    return 1


@lru_cache(maxsize=None)
def _z1_maps(n: int, angle: int):
    dx = get_dx(angle)
    max_base = 2 * n - 1
    r = np.arange(n)
    x = dx * (r + 1)
    base = (x >> 6)[:, None] + np.arange(n)[None, :]
    shift = ((x >> 1) & 0x1F)[:, None] + np.zeros((1, n), np.int32)
    over = base >= max_base
    i0 = np.minimum(base, max_base)
    i1 = np.minimum(base + 1, max_base)
    return i0, i1, shift, over


@lru_cache(maxsize=None)
def _z3_maps(n: int, angle: int):
    dy = get_dy(angle)
    max_base = 2 * n - 1
    c = np.arange(n)
    y = dy * (c + 1)
    base = (y >> 6)[None, :] + np.arange(n)[:, None]
    shift = ((y >> 1) & 0x1F)[None, :] + np.zeros((n, 1), np.int32)
    over = base >= max_base
    i0 = np.minimum(base, max_base)
    i1 = np.minimum(base + 1, max_base)
    return i0, i1, shift, over


@lru_cache(maxsize=None)
def _z2_maps(n: int, angle: int):
    dx, dy = get_dx(angle), get_dy(angle)
    r = np.arange(n)[:, None]
    c = np.arange(n)[None, :]
    x = -dx * (r + 1)
    base1 = (x >> 6) + c                       # >= -1 means "use above"
    shift1 = ((x & 0x3F) >> 1) + 0 * c
    y = (r << 6) - dy * (c + 1)
    base2 = y >> 6
    shift2 = ((y & 0x3F) >> 1) + 0 * r
    use_above = base1 >= -1
    # +1 offsets index into [corner | edge_0..edge_{n-1}] arrays
    a0 = np.clip(base1 + 1, 0, n)
    a1 = np.clip(base1 + 2, 0, n)
    l0 = np.clip(base2 + 1, 0, n)
    l1 = np.clip(base2 + 2, 0, n)
    return use_above, a0, a1, np.broadcast_to(shift1, (n, n)).copy(), \
        l0, l1, np.broadcast_to(shift2, (n, n)).copy()


@lru_cache(maxsize=None)
def _maps_t(n: int, angle: int, device: str):
    """The zone's maps of (n, angle) as tensors on `device` (one upload per
    device): (i0, i1, shift) triples flattened, and the [n, n] mask."""
    if angle < 90 or angle > 180:
        i0, i1, shift, over = (_z1_maps if angle < 90 else _z3_maps)(n, angle)
        tabs = [(i0, i1, shift)]
        mask = over
    else:
        ua, a0, a1, s1, l0, l1, s2 = _z2_maps(n, angle)
        tabs = [(a0, a1, s1), (l0, l1, s2)]
        mask = ua
    flat = [tuple(upload(np.asarray(a, np.int64 if k < 2 else np.int32)
                         .reshape(-1), device) for k, a in enumerate(t))
            for t in tabs]
    return flat, upload(np.asarray(mask, bool), device)


def _interp(edge, i0, i1, shift, n: int):
    val = (edge[..., i0] * (32 - shift) + edge[..., i1] * shift + 16) >> 5
    return val.reshape(edge.shape[:-1] + (n, n))


def dr_pred(mode: int, delta: int, above_ext, left_ext, corner, n: int,
            bd: int = 8):
    """Directional prediction for one (mode, delta); batched [..., n, n]."""
    angle = MODE_ANGLE[mode] + 3 * delta
    lo, hi = 0, (1 << bd) - 1
    if angle == 90:
        return above_ext[..., None, :n].expand(above_ext.shape[:-1] + (n, n))
    if angle == 180:
        return left_ext[..., :n, None].expand(left_ext.shape[:-1] + (n, n))
    tabs, mask = _maps_t(n, angle, str(above_ext.device))
    if 90 < angle < 180:
        above_c = torch.cat([corner[..., None], above_ext[..., :n]], dim=-1)
        left_c = torch.cat([corner[..., None], left_ext[..., :n]], dim=-1)
        va = _interp(above_c, *tabs[0], n)
        vl = _interp(left_c, *tabs[1], n)
        return torch.where(mask, va, vl).clamp(lo, hi)
    edge = above_ext if angle < 90 else left_ext
    val = _interp(edge, *tabs[0], n)
    fill = edge[..., 2 * n - 1][..., None, None]
    return torch.where(mask, fill, val).clamp(lo, hi)
