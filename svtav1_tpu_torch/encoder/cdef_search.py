"""CDEF strength search (encoder side).

Counterpart of ``svtav1_tpu/encoder/cdef_search.py``; reference
svt_av1_cdef_search / finish_cdef_search (EbEncCdef.c) with damping
3 + base_q_idx // 64 (EbCdefProcess.c:147) and the greedy dual luma/chroma
strength-set selection of svt_search_one_dual.

The per-unit SSE of every candidate strength pair runs on the planes'
device, one candidate at a time (the direction taps are gathered once and
reused by all 32); the set selection is the JAX package's host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import upload
from ..ops.cdef import (adjust_strength_map, cdef_taps, filter_taps,
                        find_dir_plane, pad_plane)

# candidate pri x sec strength pairs (sec value 3 is not signalable)
PRI_CAND = (0, 1, 2, 3, 4, 6, 8, 12)
SEC_CAND = (0, 1, 2, 4)
CAND_PAIRS = tuple((p, s) for p in PRI_CAND for s in SEC_CAND)


def _unit_sse(diff2, nonskip8, block: int):
    """diff2 [H, W] squared errors -> per-64x64-unit int64 sums over
    non-skip blocks.  nonskip8 [H//block, W//block] bool."""
    H, W = diff2.shape[-2], diff2.shape[-1]
    bh, bw = H // block, W // block
    per_blk = diff2.reshape(bh, block, bw, block).sum((1, 3),
                                                      dtype=torch.int64)
    per_blk = torch.where(nonskip8, per_blk, 0)
    # one 64x64 luma unit = 8x8 blocks of 8 (luma) or of 4 (4:2:0 chroma)
    u = 8
    return per_blk.reshape(bh // u, u, bw // u, u).sum((1, 3))


def cdef_candidate_sse(src, rec, skip8, cands, damping: int, bd: int = 8):
    """Per-unit SSE of every candidate strength pair.

    src/rec: (y, u, v) tensors on one device; skip8 [H/8, W/8] bool tensor;
    cands: (pri, sec) pairs.  Returns (mse_y [N, uh, uw], mse_uv
    [N, uh, uw]) int64 tensors on that device."""
    cs = bd - 8
    rec = [p.to(torch.int32) for p in rec]
    src = [p.to(torch.int32) for p in src]
    dirs, var = find_dir_plane(rec[0], cs)
    zero = torch.zeros_like(dirs)
    pads = [pad_plane(p) for p in rec]
    nonskip = ~skip8
    # the taps for the two direction maps a candidate can use: the
    # searched directions (pri > 0) and direction 0 (pri == 0)
    taps = {(p, on): cdef_taps(pads[p], dirs if on else zero, 8 if p == 0
                               else 4)
            for p in range(3) for on in (False, True)}
    mse_y, mse_uv = [], []
    for pri, sec in cands:
        py, ss = pri << cs, sec << cs
        pmap = torch.full_like(dirs, py)
        smap = torch.full_like(dirs, ss)
        yf = filter_taps(taps[0, py > 0], adjust_strength_map(pmap, var),
                         smap, damping + cs, damping + cs, 8, cs)
        mse_y.append(_unit_sse((yf - src[0]) ** 2, nonskip, 8))
        sse = 0
        for p in (1, 2):
            f = filter_taps(taps[p, py > 0], pmap, smap, damping + cs - 1,
                            damping + cs - 1, 4, cs)
            sse = sse + _unit_sse((f - src[p]) ** 2, nonskip, 4)
        mse_uv.append(sse)
    return torch.stack(mse_y), torch.stack(mse_uv)


def _greedy_dual(my, muv, n: int):
    """svt_search_one_dual analogue: pick n (luma, chroma) candidate-index
    pairs greedily (+ one refinement sweep) minimizing total per-unit-min
    SSE.  my/muv: [U, N] float64.  Returns (pairs list, per-unit best)."""
    U, N = my.shape
    comb = my[:, :, None] + muv[:, None, :]              # [U, Ny, Nuv]
    cur = np.full(U, np.inf)
    pairs = []
    for _ in range(n):
        tot = np.minimum(cur[:, None, None], comb).sum(0)
        iy, iuv = np.unravel_index(np.argmin(tot), tot.shape)
        pairs.append((int(iy), int(iuv)))
        cur = np.minimum(cur, comb[:, iy, iuv])
    # refinement: re-choose each member holding the others fixed
    for _ in range(2):
        changed = False
        for j in range(len(pairs)):
            others = [p for k, p in enumerate(pairs) if k != j]
            if others:
                base = np.min(np.stack([comb[:, a, b] for a, b in others],
                                       1), 1)
            else:
                base = np.full(U, np.inf)
            tot = np.minimum(base[:, None, None], comb).sum(0)
            iy, iuv = np.unravel_index(np.argmin(tot), tot.shape)
            if (iy, iuv) != pairs[j] and tot[iy, iuv] < \
                    np.minimum(base, comb[:, pairs[j][0],
                                          pairs[j][1]]).sum():
                pairs[j] = (int(iy), int(iuv))
                changed = True
        if not changed:
            break
    stack = np.stack([comb[:, a, b] for a, b in pairs], 1)   # [U, n]
    return pairs, stack


def cdef_search_frame(src, rec, skip8, qindex: int, lam: float,
                      bd: int = 8):
    """Full CDEF RDO for one frame.

    src/rec: (y, u, v) tensors on one device (rec = post-deblock); skip8
    [H/8, W/8] bool numpy array.  Returns the params dict {damping, bits,
    y_strengths, uv_strengths, idx_map [sb_rows, sb_cols]}: strengths are
    (pri, sec) tuples, sec in {0, 1, 2, 4}."""
    damping = 3 + (qindex >> 6)
    mse_y, mse_uv = cdef_candidate_sse(src, rec, upload(skip8, rec[0].device),
                                       CAND_PAIRS, damping, bd)
    mse_y = mse_y.cpu().numpy()                 # the search's one read
    mse_uv = mse_uv.cpu().numpy()
    my = mse_y.astype(np.float64).reshape(len(CAND_PAIRS), -1).T
    muv = mse_uv.astype(np.float64).reshape(len(CAND_PAIRS), -1).T
    uh, uw = mse_y.shape[1:]
    n_coded = int((~skip8).reshape(uh, 8, uw, 8)
                  .any((1, 3)).sum())

    best = None
    for bits in range(4):
        n = 1 << bits
        pairs, stack = _greedy_dual(my, muv, n)
        tot = stack.min(1).sum()
        rate = n * 12 + n_coded * bits
        cost = tot + lam * rate
        if best is None or cost < best[0]:
            idx = stack.argmin(1).reshape(uh, uw)
            best = (cost, bits, pairs, idx)
    _, bits, pairs, idx_map = best

    y_str = [CAND_PAIRS[a] for a, _ in pairs]
    uv_str = [CAND_PAIRS[b] for _, b in pairs]
    return {"damping": damping, "bits": bits,
            "y_strengths": y_str, "uv_strengths": uv_str,
            "idx_map": idx_map.astype(np.int32)}


def build_skip8(part, y_lev, u_lev, v_lev, y_slev, u_slev, v_slev,
                part_sb=None, y_lev_sb=None, u_lev_sb=None, v_lev_sb=None):
    """Per-8x8 coded-skip map [4*bh, 4*bw] bool from a frame's partition
    and level arrays (numpy) - the tile coder's skip semantics (skip = all
    three planes' levels zero).  part_sb plus the *_lev_sb arrays add the
    64x64 NONE depth."""
    bh, bw = part.shape
    skip32 = ~(y_lev.reshape(bh, bw, -1).any(-1) |
               u_lev.reshape(bh, bw, -1).any(-1) |
               v_lev.reshape(bh, bw, -1).any(-1))
    skip16 = ~(y_slev.reshape(bh, bw, 4, -1).any(-1) |
               u_slev.reshape(bh, bw, 4, -1).any(-1) |
               v_slev.reshape(bh, bw, 4, -1).any(-1))
    s32 = np.repeat(np.repeat(skip32, 4, 0), 4, 1)
    z = skip16.reshape(bh, bw, 2, 2)                  # [.., sr, sc]
    s16 = np.repeat(np.repeat(
        z.transpose(0, 2, 1, 3).reshape(bh * 2, bw * 2), 2, 0), 2, 1)
    pm = np.repeat(np.repeat(part.astype(bool), 4, 0), 4, 1)
    out = np.where(pm, s16, s32)
    if part_sb is not None:
        sh, sw = part_sb.shape
        skip64 = ~(y_lev_sb.reshape(sh, sw, -1).any(-1) |
                   u_lev_sb.reshape(sh, sw, -1).any(-1) |
                   v_lev_sb.reshape(sh, sw, -1).any(-1))
        s64 = np.repeat(np.repeat(skip64, 8, 0), 8, 1)
        psb = np.repeat(np.repeat(part_sb.astype(bool), 8, 0), 8, 1)
        out = np.where(psb, out, s64)
    return out


def cdef_frame_config_fields(params):
    """FrameConfig kwargs from a search result."""
    return dict(cdef_damping=params["damping"], cdef_bits=params["bits"],
                cdef_y_strengths=tuple(params["y_strengths"]),
                cdef_uv_strengths=tuple(params["uv_strengths"]))
