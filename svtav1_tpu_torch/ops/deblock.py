"""AV1 deblocking (loop) filter, spec §7.14, in PyTorch.

Counterpart of ``svtav1_tpu/ops/deblock.py``: the flat path's uniform
transform grid (``deblock_plane_uniform``), the partition path's
partition-aware edge set (``deblock_plane_part``) and its frame-level
level search (``dlf_sse_part``).  One vertical-edge pass over the whole
plane, then one horizontal-edge pass (spec order); every edge of a pass is
filtered at once: gather the 14-pixel neighbourhoods, evaluate the masks
and every filter variant branchlessly, scatter back the taps the filter
writes.  In the JAX package this is XLA code outside any Pallas kernel, so
plain tensor code is its counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import upload


def thresholds(lvl: int, sharpness: int = 0):
    """(mblim, lim, hev_thr) per spec §7.14.4."""
    inside = lvl >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        inside = min(inside, 9 - sharpness)
    inside = max(1, inside)
    return 2 * (lvl + 2) + inside, inside, lvl >> 4


def _thresholds_t(lvl, sharpness: int = 0):
    """thresholds() for a level given as a Python int or a 0-d tensor."""
    return thresholds(int(lvl), sharpness)


def _filter_core(px, filter_length: int, mblim: int, lim: int, thr: int,
                 bd: int = 8):
    """px [..., 14] int32 = p6..p0,q0..q6 across the edge -> filtered.

    Only the taps the chosen filter writes are modified.  For bd > 8 the
    limits, the signed-clamp range and the flatness threshold scale by
    1 << (bd-8) (spec §7.14.6)."""
    sh = bd - 8
    off = 128 << sh
    mblim, lim, thr = mblim << sh, lim << sh, thr << sh
    flat_thr = 1 << sh
    sc = lambda x: x.clamp(-off, off - 1)
    p = {i: px[..., 6 - i] for i in range(7)}
    q = {i: px[..., 7 + i] for i in range(7)}
    ab = lambda a, b: (a - b).abs()
    where = torch.where

    if filter_length == 4:
        mask = ((ab(p[1], p[0]) <= lim) & (ab(q[1], q[0]) <= lim) &
                (ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 <= mblim))
    elif filter_length == 6:
        mask = ((ab(p[2], p[1]) <= lim) & (ab(p[1], p[0]) <= lim) &
                (ab(q[1], q[0]) <= lim) & (ab(q[2], q[1]) <= lim) &
                (ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 <= mblim))
    else:
        mask = ((ab(p[3], p[2]) <= lim) & (ab(p[2], p[1]) <= lim) &
                (ab(p[1], p[0]) <= lim) & (ab(q[1], q[0]) <= lim) &
                (ab(q[2], q[1]) <= lim) & (ab(q[3], q[2]) <= lim) &
                (ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 <= mblim))

    # filter4 (branchless)
    zero = torch.zeros_like(p[0])
    hev = (ab(p[1], p[0]) > thr) | (ab(q[1], q[0]) > thr)
    ps1, ps0 = p[1] - off, p[0] - off
    qs0, qs1 = q[0] - off, q[1] - off
    f = where(hev, sc(ps1 - qs1), zero)
    f = where(mask, sc(f + 3 * (qs0 - ps0)), zero)
    f1 = sc(f + 4) >> 3
    f2 = sc(f + 3) >> 3
    n_q0 = sc(qs0 - f1) + off
    n_p0 = sc(ps0 + f2) + off
    f3 = where(hev, zero, (f1 + 1) >> 1)
    n_q1 = sc(qs1 - f3) + off
    n_p1 = sc(ps1 + f3) + off

    out = px.clone()
    if filter_length == 4:
        for idx, val in ((5, n_p1), (6, n_p0), (7, n_q0), (8, n_q1)):
            out[..., idx] = val
        return out

    r2 = lambda v: (v + 4) >> 3
    if filter_length == 6:
        flat = ((ab(p[1], p[0]) <= flat_thr) & (ab(q[1], q[0]) <= flat_thr) &
                (ab(p[2], p[0]) <= flat_thr) & (ab(q[2], q[0]) <= flat_thr))
        sm = flat & mask
        s_p1 = r2(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0])
        s_p0 = r2(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1])
        s_q0 = r2(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2])
        s_q1 = r2(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3)
        for idx, s, n in ((5, s_p1, n_p1), (6, s_p0, n_p0), (7, s_q0, n_q0),
                          (8, s_q1, n_q1)):
            out[..., idx] = where(sm, s, n)
        return out

    flat = ((ab(p[1], p[0]) <= flat_thr) & (ab(q[1], q[0]) <= flat_thr) &
            (ab(p[2], p[0]) <= flat_thr) & (ab(q[2], q[0]) <= flat_thr) &
            (ab(p[3], p[0]) <= flat_thr) & (ab(q[3], q[0]) <= flat_thr))
    sm = flat & mask
    e_p2 = r2(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0])
    e_p1 = r2(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1])
    e_p0 = r2(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2])
    e_q0 = r2(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3])
    e_q1 = r2(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2)
    e_q2 = r2(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3)
    f8 = {2: where(sm, e_p2, p[2]), 1: where(sm, e_p1, n_p1),
          0: where(sm, e_p0, n_p0)}
    g8 = {0: where(sm, e_q0, n_q0), 1: where(sm, e_q1, n_q1),
          2: where(sm, e_q2, q[2])}
    if filter_length == 8:
        for idx, val in ((4, f8[2]), (5, f8[1]), (6, f8[0]), (7, g8[0]),
                         (8, g8[1]), (9, g8[2])):
            out[..., idx] = val
        return out

    # filter_length == 14
    flat2 = ((ab(p[6], p[0]) <= flat_thr) & (ab(p[5], p[0]) <= flat_thr) &
             (ab(p[4], p[0]) <= flat_thr) & (ab(q[4], q[0]) <= flat_thr) &
             (ab(q[5], q[0]) <= flat_thr) & (ab(q[6], q[0]) <= flat_thr))
    wide = flat2 & sm
    r4 = lambda v: (v + 8) >> 4
    w_p5 = r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] + q[0])
    w_p4 = r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0] +
              q[0] + q[1])
    w_p3 = r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0] +
              q[0] + q[1] + q[2])
    w_p2 = r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0] +
              q[0] + q[1] + q[2] + q[3])
    w_p1 = r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2 +
              q[0] + q[1] + q[2] + q[3] + q[4])
    w_p0 = r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 +
              q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5])
    w_q0 = r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 +
              q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6])
    w_q1 = r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 +
              q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2)
    w_q2 = r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 +
              q[3] * 2 + q[4] + q[5] + q[6] * 3)
    w_q3 = r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 +
              q[4] * 2 + q[5] + q[6] * 4)
    w_q4 = r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 +
              q[5] * 2 + q[6] * 5)
    w_q5 = r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 +
              q[6] * 7)
    for idx, wv, keep in ((1, w_p5, p[5]), (2, w_p4, p[4]), (3, w_p3, p[3]),
                          (4, w_p2, f8[2]), (5, w_p1, f8[1]),
                          (6, w_p0, f8[0]), (7, w_q0, g8[0]),
                          (8, w_q1, g8[1]), (9, w_q2, g8[2]),
                          (10, w_q3, q[3]), (11, w_q4, q[4]),
                          (12, w_q5, q[5])):
        out[..., idx] = where(wide, wv, keep)
    return out


# tap window each filter length writes within the 14-wide strip (writing
# the whole strip back would clobber neighbours when edges are closer
# than 14 pixels)
_WRITE_WIN = {4: (5, 9), 6: (5, 9), 8: (4, 10), 14: (1, 13)}


def _filter_pass(x, spacing: int, end: int, filter_length: int, level: int,
                 sharpness: int, bd: int):
    """Filter the vertical edges at columns spacing, 2*spacing, ... < end
    of x [..., h, w]."""
    if level <= 0 or end <= spacing:
        return x
    mblim, lim, thr = _thresholds_t(level, sharpness)
    # edge columns made on x's device: no host-to-device copy (which would
    # synchronise the stream)
    dev = x.device
    cols = (torch.arange(spacing, end, spacing, device=dev)[:, None] +
            torch.arange(-7, 7, device=dev)[None, :])       # [E, 14]
    filt = _filter_core(x[..., cols], filter_length, mblim, lim, thr, bd)
    lo, hi = _WRITE_WIN[filter_length]
    x = x.clone()
    x[..., cols[:, lo:hi]] = filt[..., lo:hi]
    return x


def deblock_plane_uniform(plane, spacing: int, filter_length: int,
                          level_v, level_h, sharpness: int = 0,
                          bd: int = 8, valid_h: int = None):
    """Deblock planes [..., h, w] on a uniform transform grid `spacing`:
    vertical-edge pass, then horizontal-edge pass.  A level of 0 turns a
    pass off.  valid_h: true (unpadded) frame height; horizontal edges at
    rows >= valid_h lie outside the frame and are not filtered."""
    h, w = plane.shape[-2], plane.shape[-1]
    vh = h if valid_h is None else valid_h
    x = plane.to(torch.int32)
    x = _filter_pass(x, spacing, w, filter_length, int(level_v), sharpness,
                     bd)
    x = _filter_pass(x.transpose(-1, -2), spacing, min(h, vh), filter_length,
                     int(level_h), sharpness, bd)
    return x.transpose(-1, -2).contiguous()


def _filter_edges(x, pos: np.ndarray, act, filter_length: int, level: int,
                  sharpness: int, bd: int):
    """Filter the vertical edges at columns `pos` of x [..., h, w] where
    act [..., h, len(pos)] is set (all edges read x before any write)."""
    if level <= 0 or len(pos) == 0:
        return x
    mblim, lim, thr = thresholds(level, sharpness)
    cols = upload(pos[:, None] + np.arange(-7, 7)[None, :], x.device)
    px = x[..., cols]                                  # [..., h, E, 14]
    filt = _filter_core(px, filter_length, mblim, lim, thr, bd)
    px = torch.where(act[..., None], filt, px)
    lo, hi = _WRITE_WIN[filter_length]
    x = x.clone()
    x[..., cols[:, lo:hi]] = px[..., lo:hi]
    return x


def _part_act(part, part_sb, n: int, pos: np.ndarray, spacing: int):
    """Which edges at positions `pos` (along the last axis of part's
    [..., rows, cols] maps) filter, for each of the n pixel lines: edges
    on the spacing grid always, half-spacing edges inside blocks marked
    split; with part_sb, only the 2*spacing grid filters inside an SB that
    is one block.  -> [..., n, len(pos)] bool."""
    dev = part.device
    sp2 = 2 * spacing
    lines = np.arange(n)
    on_grid = upload((pos % spacing) == 0, dev)
    act = (part[..., upload(lines // spacing, dev), :][
        ..., :, upload(pos // spacing, dev)] == 1) | on_grid
    if part_sb is not None:
        on_sb = upload((pos % sp2) == 0, dev)
        sb_split = part_sb[..., upload(lines // sp2, dev), :][
            ..., :, upload(pos // sp2, dev)] == 1
        act = on_sb | (act & sb_split)
    return act


def deblock_plane_part(plane, part, spacing: int, filter_length: int,
                       level_v: int, level_h: int, sharpness: int = 0,
                       bd: int = 8, part_sb=None, valid_h: int = None):
    """Partition-aware deblock of planes [..., h, w]: edges on the
    `spacing` grid always filter; half-spacing edges filter only inside
    blocks marked split in part [..., h/spacing, w/spacing].  part_sb
    [..., h/(2 spacing), w/(2 spacing)] (0 = whole-SB block, 1 = split):
    inside a whole-SB block only the 2*spacing grid filters.  The filter
    taps do not depend on the partition (16/32 luma tx both take the
    14-tap path, 8/16 chroma the 6-tap path).  valid_h: true (unpadded)
    frame height; horizontal edges at rows >= valid_h are not filtered."""
    h, w = plane.shape[-2], plane.shape[-1]
    vh = h if valid_h is None else valid_h
    hs = spacing // 2
    x = plane.to(torch.int32)
    xs = np.arange(hs, w, hs)
    act = _part_act(part, part_sb, h, xs, spacing)
    x = _filter_edges(x, xs, act, filter_length, int(level_v), sharpness, bd)
    ys = np.arange(hs, h, hs)
    ys = ys[ys < vh]
    tr = lambda a: None if a is None else a.transpose(-1, -2)
    act = _part_act(tr(part), tr(part_sb), w, ys, spacing)
    x = _filter_edges(x.transpose(-1, -2), ys, act, filter_length,
                      int(level_h), sharpness, bd)
    return x.transpose(-1, -2).contiguous()


def dlf_sse_part(plane, src, part, levels, spacing: int, filter_length: int,
                 sharpness: int = 0, bd: int = 8, part_sb=None,
                 valid_h: int = None):
    """Frame-level DLF level search: deblock `plane` at each level of
    `levels` (Python ints, both edge directions) and return the exact
    int64 SSE against `src` over the valid rows, per level [nlev], on the
    plane's device."""
    vh = plane.shape[-2] if valid_h is None else valid_h
    src = src.to(torch.int32)[..., :vh, :]
    sses = []
    for lvl in levels:
        out = deblock_plane_part(plane, part, spacing, filter_length, lvl,
                                 lvl, sharpness, bd, part_sb, valid_h)
        d = (out[..., :vh, :] - src).to(torch.int64)
        sses.append((d * d).sum())
    return torch.stack(sses)
