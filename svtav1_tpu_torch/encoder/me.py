"""Batched hierarchical motion estimation, plain PyTorch on the planes'
device.

Counterpart of ``svtav1_tpu/encoder/me.py`` (the HME/ME pyramid of
EbMotionEstimation.c: hme_level_0/1/2 coarse search, integer refinement,
then subpel): every block of the plane is searched at once.
  1. HME L2: exhaustive +-16 at 1/4 resolution (+-64 full-pel) with a
     centre-bias penalty on |mv|;
  2. with ``long_range`` (a pyramid reference more than 4 frames away),
     HME L3: exhaustive +-12 at 1/8 resolution (+-96 full-pel), its winner
     refined +-2 at 1/4 resolution, taking L2's place where its penalised
     1/4-resolution SAD is lower;
  3. L1: +-2 refinement at 1/2 resolution, then +-2 at full resolution;
     the full-pel mv is clamped so the normative UMV clamp never alters it;
  4. a half- then quarter-pel diamond on normative (REGULAR) predictions.

Out-of-plane reads replicate edge pixels.  The JAX package pads the planes
by edge replication (wider with ``long_range``, to cover L3's reach) and
clamps its gather indices to the padded plane; that reads the same pixels
as clamping the indices to the plane itself, whatever the padding's width,
which is what the gathers here do.  SADs are exact integer sums, so their
order does not matter; argmin keeps the first minimum, as XLA's does.
"""

from __future__ import annotations

import torch

from ..ops.mc import interp_block_dyn, kernel_table
from ..ops.metrics import downsample2x

BLK = 32
L2_RANGE = 16        # +-16 at 1/4 res -> +-64 full-pel
L3_RANGE = 12        # +-12 at 1/8 res -> +-96 full-pel (long-range refs)
ME_PEN = 3           # centre-bias penalty per unit of |mv| at 1/4 res


def _gather_regions(plane, y0, x0, size: int):
    """plane [B, H, W]; y0/x0 [B, N] region starts (may lie outside the
    plane) -> [B, N, size, size], rows and columns clamped to the plane."""
    B, H, W = plane.shape
    ar = torch.arange(size, device=plane.device)
    rows = (y0[..., None] + ar).clamp(0, H - 1)
    cols = (x0[..., None] + ar).clamp(0, W - 1)
    bi = torch.arange(B, device=plane.device)[:, None, None, None]
    return plane[bi, rows[:, :, :, None], cols[:, :, None, :]]


def _blocks(plane, bs: int):
    """[B, H, W] -> [B, N, bs, bs] raster blocks."""
    B, H, W = plane.shape
    bh, bw = H // bs, W // bs
    x = plane.reshape(B, bh, bs, bw, bs).permute(0, 1, 3, 2, 4)
    return x.reshape(B, bh * bw, bs, bs)


def _sad_field(src_b, regions, bs: int, rng: int):
    """SAD at every integer offset: src [B, N, bs, bs] against regions
    [B, N, bs+2r, bs+2r] -> [B, N, 2r+1, 2r+1] int64 (one offset row at a
    time, to bound the temporary)."""
    n = 2 * rng + 1
    rows = []
    for dy in range(n):
        win = regions[:, :, dy:dy + bs].unfold(3, bs, 1)   # [B,N,bs,n,bs]
        d = (win - src_b[:, :, :, None, :]).abs_()
        rows.append(d.sum((2, 4)))
    return torch.stack(rows, 2)


def _argmin_offset(sads, r: int):
    idx = torch.argmin(sads, dim=-1)
    n = 2 * r + 1
    return idx // n - r, idx % n - r


def motion_estimate(src, ref, bs: int = BLK, long_range: bool = False):
    """src/ref [B, H, W] luma tensors (any integer dtype) -> (mv8 [B, bh, bw,
    2] int32 quarter-pel mvs in 1/8-pel units, full-pel SAD [B, bh, bw]
    int32 of the chosen position)."""
    B, H, W = src.shape
    bh, bw = H // bs, W // bs
    N = bh * bw
    dev = src.device
    src = src.to(torch.int32)
    ref = ref.to(torch.int32)
    r_idx = (torch.arange(N, device=dev) // bw * bs)[None].expand(B, N)
    c_idx = (torch.arange(N, device=dev) % bw * bs)[None].expand(B, N)

    # HME L2: exhaustive at 1/4 resolution, centre-biased
    src2 = downsample2x(downsample2x(src))
    ref2 = downsample2x(downsample2x(ref))
    bs2 = bs // 4
    s2 = _blocks(src2, bs2)
    reg2 = _gather_regions(ref2, r_idx // 4 - L2_RANGE, c_idx // 4 - L2_RANGE,
                           bs2 + 2 * L2_RANGE)
    sad2 = _sad_field(s2, reg2, bs2, L2_RANGE)
    off2 = torch.arange(-L2_RANGE, L2_RANGE + 1, device=dev).abs()
    sad2 = sad2 + ME_PEN * (off2[:, None] + off2[None, :])
    n2 = 2 * L2_RANGE + 1
    idx = torch.argmin(sad2.reshape(B, N, -1), dim=-1)
    mv2y = idx // n2 - L2_RANGE
    mv2x = idx % n2 - L2_RANGE
    if long_range:
        # HME L3: exhaustive at 1/8 res, refined +-2 at 1/4, competing
        # with L2's winner by penalised 1/4-res SAD
        best2 = sad2.reshape(B, N, -1).min(-1).values
        bs3 = bs // 8
        reg3 = _gather_regions(downsample2x(ref2), r_idx // 8 - L3_RANGE,
                               c_idx // 8 - L3_RANGE, bs3 + 2 * L3_RANGE)
        sad3 = _sad_field(_blocks(downsample2x(src2), bs3), reg3, bs3,
                          L3_RANGE)
        # 1/8-res offsets are twice the 1/4-res scale, SADs a quarter area
        off3 = torch.arange(-L3_RANGE, L3_RANGE + 1, device=dev).abs()
        sad3 = sad3 + (ME_PEN * 2 // 4 + 1) * (off3[:, None] + off3[None, :])
        n3 = 2 * L3_RANGE + 1
        idx3 = torch.argmin(sad3.reshape(B, N, -1), dim=-1)
        mv3y = idx3 // n3 - L3_RANGE
        mv3x = idx3 % n3 - L3_RANGE
        reg2b = _gather_regions(ref2, r_idx // 4 + 2 * mv3y - 2,
                                c_idx // 4 + 2 * mv3x - 2, bs2 + 4)
        sref2 = _sad_field(s2, reg2b, bs2, 2).reshape(B, N, -1)
        dy2, dx2 = _argmin_offset(sref2, 2)
        cand_y, cand_x = 2 * mv3y + dy2, 2 * mv3x + dx2
        cand_sad = sref2.min(-1).values + ME_PEN * (cand_y.abs() +
                                                    cand_x.abs())
        take = cand_sad < best2
        mv2y = torch.where(take, cand_y, mv2y)
        mv2x = torch.where(take, cand_x, mv2x)

    # L1: +-2 refinement at 1/2 resolution
    bs1 = bs // 2
    reg1 = _gather_regions(downsample2x(ref), r_idx // 2 + 2 * mv2y - 2,
                           c_idx // 2 + 2 * mv2x - 2, bs1 + 4)
    dy, dx = _argmin_offset(_sad_field(_blocks(downsample2x(src), bs1), reg1,
                                       bs1, 2).reshape(B, N, -1), 2)
    mv1y = 2 * mv2y + dy
    mv1x = 2 * mv2x + dx

    # full-pel: +-2 refinement at full resolution
    s0 = _blocks(src, bs)
    reg0 = _gather_regions(ref, r_idx + 2 * mv1y - 2, c_idx + 2 * mv1x - 2,
                           bs + 4)
    sref = _sad_field(s0, reg0, bs, 2).reshape(B, N, -1)
    dy, dx = _argmin_offset(sref, 2)
    mvy = 2 * mv1y + dy
    mvx = 2 * mv1x + dx
    best_sad = sref.min(-1).values

    # clamp the full-pel mv so the normative UMV clamp can never alter it
    mvy = torch.minimum(torch.maximum(mvy, -(r_idx + 32)),
                        (H - bs - r_idx) + 32)
    mvx = torch.minimum(torch.maximum(mvx, -(c_idx + 32)),
                        (W - bs - c_idx) + 32)

    # subpel: half then quarter diamond on normative predictions
    kern = kernel_table(0, src)

    def subpel_cost(mv8y, mv8x):
        q4r, q4c = 2 * mv8y, 2 * mv8x
        win = _gather_regions(ref, r_idx + (q4r >> 4) - 3,
                              c_idx + (q4c >> 4) - 3, bs + 7)
        pred = interp_block_dyn(win, kern[q4c & 15], kern[q4r & 15])
        return (pred - s0).abs_().sum((-1, -2))

    mv8y, mv8x = 8 * mvy, 8 * mvx
    for step in (4, 2):                        # half-pel, then quarter-pel
        best_c = subpel_cost(mv8y, mv8x)
        best_dy = torch.zeros_like(mv8y)
        best_dx = torch.zeros_like(mv8x)
        for oy in (-step, 0, step):
            for ox in (-step, 0, step):
                if oy == 0 and ox == 0:
                    continue
                c = subpel_cost(mv8y + oy, mv8x + ox)
                take = c < best_c
                best_c = torch.where(take, c, best_c)
                best_dy = torch.where(take, oy, best_dy)
                best_dx = torch.where(take, ox, best_dx)
        mv8y = mv8y + best_dy
        mv8x = mv8x + best_dx

    mv8 = torch.stack([mv8y, mv8x], -1).to(torch.int32)
    return mv8.reshape(B, bh, bw, 2), best_sad.to(torch.int32).reshape(
        B, bh, bw)
