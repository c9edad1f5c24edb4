"""CDEF (Constrained Directional Enhancement Filter), spec §7.15.

Counterpart of ``svtav1_tpu/ops/cdef.py``; reference behaviour
EbCdef.c (svt_aom_cdef_find_dir_c :151, svt_cdef_filter_block_c :253).

- Direction search: the 8 directional partial sums of an 8x8 block are one
  float32 product against 0/1 indicator matrices (exact: |partial| <= 1024),
  and the costs keep the reference's int32 wraparound (the JAX package's
  int32 arithmetic) by reducing exact int64 sums modulo 2**32.
- Filter: each pixel gathers its 12 taps (4 primary, 8 secondary per
  direction) from the padded plane at its own block's direction, so a
  plane costs one gather instead of one pass per direction.  The taps and
  the clip bounds depend only on the direction map; ``cdef_taps`` computes
  them once and ``filter_taps`` applies any strengths to them (the search
  reuses one ``cdef_taps`` for all 32 candidates).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import upload

CDEF_VERY_LARGE = 0x7F7F

# (dy, dx) tap offsets per direction (Cdef_Directions, spec §7.15.3)
DIRECTIONS = [
    [(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)],
    [(0, 1), (1, 2)], [(1, 1), (2, 2)], [(1, 0), (2, 1)],
    [(1, 0), (2, 0)], [(1, 0), (2, -1)],
]

PRI_TAPS = [[4, 2], [3, 3]]
SEC_TAPS = [[2, 1], [2, 1]]

_DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)


def _partial_mats_np():
    """[64, 8 * 15] indicator matrix: partial[d, k] = x_flat @ M[:, d*15+k]."""
    M = np.zeros((8, 64, 15), np.float32)
    for i in range(8):
        for j in range(8):
            f = i * 8 + j
            M[0, f, i + j] = 1
            M[1, f, i + j // 2] = 1
            M[2, f, i] = 1
            M[3, f, 3 + i - j // 2] = 1
            M[4, f, 7 + i - j] = 1
            M[5, f, 3 - i // 2 + j] = 1
            M[6, f, j] = 1
            M[7, f, i // 2 + j] = 1
    return np.ascontiguousarray(M.transpose(1, 0, 2).reshape(64, 120))


@lru_cache(maxsize=None)
def _partial_mats(device) -> torch.Tensor:
    return upload(_partial_mats_np(), device)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


@lru_cache(maxsize=None)
def _div_weights(device):
    """(div[1:8], div[2:8:2]) as int64 tensors on `device`."""
    return upload(_DIV_TABLE[1:8], device), upload(_DIV_TABLE[2:8:2], device)


def find_dir(blocks: torch.Tensor, coeff_shift: int = 0):
    """blocks [B, 8, 8] integer -> (dir [B], var [B]) int32, per spec."""
    x = (blocks.to(torch.int32) >> coeff_shift) - 128
    flat = x.reshape(x.shape[:-2] + (64,)).to(torch.float32)
    partial = (flat @ _partial_mats(blocks.device)).to(torch.int64)
    p2 = partial.reshape(-1, 8, 15) ** 2                 # exact
    div = _DIV_TABLE.tolist()
    w7, w3 = _div_weights(blocks.device)
    cost = [(p2[:, d, :7] * w7).sum(-1) + (p2[:, d, 8:15] * w7.flip(0)).sum(-1)
            + p2[:, d, 7] * div[8] for d in (0, 4)]
    c2 = p2[:, 2, :8].sum(-1) * div[8]
    c6 = p2[:, 6, :8].sum(-1) * div[8]
    odd = [p2[:, d, 3:8].sum(-1) * div[8] +
           ((p2[:, d, 0:3] + p2[:, d, 8:11].flip(-1)) * w3).sum(-1)
           for d in (1, 3, 5, 7)]
    # int32 wraparound of the reference C (and of the JAX package)
    costs = _wrap32(torch.stack([cost[0], odd[0], c2, odd[1], cost[1],
                                 odd[2], c6, odd[3]], -1))      # [B, 8]
    best_dir = torch.argmax(costs, -1)                 # first maximum
    best_cost = costs.gather(-1, best_dir[:, None])[:, 0]
    ortho = costs.gather(-1, ((best_dir + 4) & 7)[:, None])[:, 0]
    var = _wrap32(best_cost - ortho) >> 10
    return best_dir.to(torch.int32), var.to(torch.int32)


def find_dir_plane(plane: torch.Tensor, coeff_shift: int = 0):
    """Per-8x8 direction/variance over a [..., H, W] plane ->
    (dir [..., H//8, W//8], var [..., H//8, W//8])."""
    H, W = plane.shape[-2], plane.shape[-1]
    lead = tuple(plane.shape[:-2])
    bh, bw = H // 8, W // 8
    blocks = plane.reshape(lead + (bh, 8, bw, 8))
    blocks = blocks.transpose(-3, -2).reshape(-1, 8, 8)
    d, v = find_dir(blocks, coeff_shift)
    return d.reshape(lead + (bh, bw)), v.reshape(lead + (bh, bw))


def pad_plane(plane: torch.Tensor) -> torch.Tensor:
    """2-pixel CDEF_VERY_LARGE border around the frame, int32."""
    return torch.nn.functional.pad(plane.to(torch.int32), (2, 2, 2, 2),
                                   value=CDEF_VERY_LARGE)


def _msb(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for v >= 1 (get_msb), elementwise int32."""
    v = v.to(torch.int32)
    r = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        hit = (v >> s) > 0
        r = r + hit.to(torch.int32) * s
        v = torch.where(hit, v >> s, v)
    return r


def adjust_strength_map(strength: torch.Tensor, var: torch.Tensor):
    """Per-block variance-adjusted luma primary strength
    (EbCdef.c:130 adjust_strength)."""
    v6 = var >> 6
    i = torch.where(v6 > 0, torch.clamp(_msb(torch.clamp(v6, min=1)),
                                        max=12), 0)
    return torch.where(var != 0, (strength * (4 + i) + 8) >> 4, 0)


def _constrain_map(diff, strength, damping: int):
    """constrain() with per-pixel strengths (broadcast against diff)."""
    shift = torch.clamp(damping - _msb(torch.clamp(strength, min=1)), min=0)
    ad = diff.abs()
    c = torch.minimum(ad, torch.clamp(strength - (ad >> shift), min=0))
    return torch.sign(diff) * torch.where(strength > 0, c, 0)


@lru_cache(maxsize=None)
def _tap_offsets(Wp: int, device) -> torch.Tensor:
    """[8, 12] flat offsets in a padded plane of width Wp, per direction:
    primary k=0 (+, -), k=1 (+, -), then secondary k=0 for d+2 (+, -),
    d-2 (+, -), then the same for k=1."""
    off = np.zeros((8, 12), np.int64)
    for d in range(8):
        slots = []
        for k in range(2):
            for sgn in (1, -1):
                dy, dx = DIRECTIONS[d][k]
                slots.append(sgn * (dy * Wp + dx))
        for k in range(2):
            for dd in ((d + 2) & 7, (d - 2) & 7):
                for sgn in (1, -1):
                    dy, dx = DIRECTIONS[dd][k]
                    slots.append(sgn * (dy * Wp + dx))
        off[d] = slots
    return upload(off, device)


@lru_cache(maxsize=None)
def _tap_weights(device):
    """Per-slot tap weights in ``_tap_offsets``' order: the primary taps
    of an even strength (PRI_TAPS[0]; an odd one takes PRI_TAPS[1], 3 and
    3) and the secondary taps."""
    (p0, p1), (s0, s1) = PRI_TAPS[0], SEC_TAPS[0]
    return (upload(np.array([p0, p0, p1, p1], np.int32), device),
            upload(np.array([s0] * 4 + [s1] * 4, np.int32), device))


def _rep(m: torch.Tensor, block: int) -> torch.Tensor:
    return m.repeat_interleave(block, -2).repeat_interleave(block, -1)


def cdef_taps(padded: torch.Tensor, dmap: torch.Tensor, block: int):
    """The strength-independent part of the filter: (x, taps, lo, hi) with
    x [..., H, W] the interior, taps [..., H, W, 12] the pixels at each
    pixel's 12 tap positions for its block's direction (order of
    ``_tap_offsets``), and lo/hi the clip bounds (min / max of x and the
    taps, CDEF_VERY_LARGE taps left out of the max)."""
    H = padded.shape[-2] - 4
    Wp = padded.shape[-1]
    W = Wp - 4
    lead = tuple(padded.shape[:-2])
    x = padded[..., 2:2 + H, 2:2 + W]
    base = (torch.arange(H, device=padded.device)[:, None] + 2) * Wp + \
        torch.arange(W, device=padded.device)[None, :] + 2
    dpix = _rep(dmap.to(torch.int64), block)                  # [..., H, W]
    idx = base[..., None] + _tap_offsets(Wp, padded.device)[dpix]
    taps = torch.gather(padded.reshape(lead + (-1,)), -1,
                        idx.reshape(lead + (-1,))).reshape(lead + (H, W, 12))
    big = taps == CDEF_VERY_LARGE
    hi = torch.maximum(x, torch.where(big, x[..., None], taps).amax(-1))
    lo = torch.minimum(x, taps.amin(-1))
    return x, taps, lo, hi


def filter_taps(taps, pri_map, sec_map, pri_damping: int, sec_damping: int,
                block: int, coeff_shift: int = 0):
    """The filter output from ``cdef_taps`` and per-block final strengths
    pri_map / sec_map [..., H//block, W//block]."""
    x, t, lo, hi = taps
    pri = _rep(pri_map.to(torch.int32), block)[..., None]     # [..., H, W, 1]
    sec = _rep(sec_map.to(torch.int32), block)[..., None]
    diff = t - x[..., None]
    odd = ((pri >> coeff_shift) & 1) == 1
    wp, ws = _tap_weights(x.device)
    wp = torch.where(odd, PRI_TAPS[1][0], wp)
    s = (wp * _constrain_map(diff[..., :4], pri, pri_damping)).sum(
        -1, dtype=torch.int32) + \
        (ws * _constrain_map(diff[..., 4:], sec, sec_damping)).sum(
            -1, dtype=torch.int32)
    y = x + ((8 + s - (s < 0).to(torch.int32)) >> 4)
    return torch.minimum(torch.maximum(y, lo), hi)


def cdef_filter_plane_map(padded, dmap, pri_map, sec_map, pri_damping: int,
                          sec_damping: int, block: int,
                          coeff_shift: int = 0):
    """Filter all `block`x`block` blocks with per-block strength maps.

    padded: [..., H+4, W+4] int32 (CDEF_VERY_LARGE outside the frame);
    dmap/pri_map/sec_map: [..., H//block, W//block] - direction and the
    final primary/secondary strengths (after the variance adjustment and
    << coeff_shift).  block = 8 (luma) or 4 (4:2:0 chroma).  Returns
    [..., H, W] int32."""
    return filter_taps(cdef_taps(padded, dmap, block), pri_map, sec_map,
                       pri_damping, sec_damping, block, coeff_shift)


def cdef_filter_plane(padded, dirs, pri_strength: int, sec_strength: int,
                      pri_damping: int, sec_damping: int,
                      coeff_shift: int = 0):
    """Filter all 8x8 blocks of a plane with one strength pair (the
    golden-vector form): padded [..., H+4, W+4], dirs [..., H//8, W//8]."""
    full = lambda v: torch.full(dirs.shape, v, dtype=torch.int32,
                                device=dirs.device)
    return cdef_filter_plane_map(padded, dirs, full(pri_strength),
                                 full(sec_strength), pri_damping,
                                 sec_damping, 8, coeff_shift)


def cdef_apply_frame(y, u, v, skip8, idx8, y_pri, y_sec, uv_pri, uv_sec,
                     damping: int, bd: int = 8):
    """Normative frame CDEF (EbDecCdef.c:120-230 / EbCdef.c:339-432): filter
    every non-skip 8x8 luma block and its 4x4 chroma blocks from the
    pre-CDEF (post-deblock) planes.

    y [H, W], u/v [H/2, W/2]; skip8 [H/8, W/8] bool (True = coded skip);
    idx8 [H/8, W/8] int64, the per-8x8 cdef_idx; y_pri/y_sec/uv_pri/uv_sec
    [n_strengths] int32 (sec already 3 -> 4 decoded); damping =
    cdef_damping.  Returns the filtered (y, u, v) int32."""
    cs = bd - 8
    y, u, v = (p.to(torch.int32) for p in (y, u, v))
    dirs, var = find_dir_plane(y, cs)
    yp = y_pri[idx8] << cs
    ys = y_sec[idx8] << cs
    y_f = cdef_filter_plane_map(pad_plane(y), torch.where(yp > 0, dirs, 0),
                                adjust_strength_map(yp, var), ys,
                                damping + cs, damping + cs, 8, cs)
    up = uv_pri[idx8] << cs
    us = uv_sec[idx8] << cs
    dir_c = torch.where(up > 0, dirs, 0)
    uv_f = [cdef_filter_plane_map(pad_plane(p), dir_c, up, us,
                                  damping + cs - 1, damping + cs - 1, 4, cs)
            for p in (u, v)]
    return (torch.where(_rep(skip8, 8), y, y_f),
            torch.where(_rep(skip8, 4), u, uv_f[0]),
            torch.where(_rep(skip8, 4), v, uv_f[1]))


def cdef_apply_params(rec, skip8, params, bd: int = 8):
    """Apply a chosen CDEF parameter set.  rec = (y, u, v) tensors; skip8
    [H/8, W/8] bool numpy array; params as cdef_search_frame
    returns them: {damping, bits, y_strengths, uv_strengths, idx_map}.
    Returns the filtered (y, u, v) int32 tensors."""
    dev = rec[0].device
    idx8 = upload(np.repeat(np.repeat(params["idx_map"].astype(np.int64), 8,
                                      0), 8, 1), dev)
    tab = lambda pairs, i: upload(np.array([p[i] for p in pairs], np.int32),
                                  dev)
    return cdef_apply_frame(rec[0], rec[1], rec[2], upload(skip8, dev), idx8,
                            tab(params["y_strengths"], 0),
                            tab(params["y_strengths"], 1),
                            tab(params["uv_strengths"], 0),
                            tab(params["uv_strengths"], 1),
                            int(params["damping"]), bd)
