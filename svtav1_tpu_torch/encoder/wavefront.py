"""Whole-plane mode decision + reconstruction over the quad wavefront.

Counterpart of ``svtav1_tpu/encoder/wavefront.py``: the flat intra
wavefront, and its mixed form with precomputed inter candidates (the flat
P frame's lanes).  The schedule is a 2:1 anti-diagonal wavefront over
quads (2x2 blocks: a 64x64 SB of 32x32 luma blocks, a 32x32 chroma region
of 16x16 blocks), the four blocks of a quad in z-order, so the boundary
state always holds every neighbour the AV1 coding order makes available,
including the above-right and below-left edges of the directional modes.

Every candidate runs the normative integer chain (predict, forward
transform, quantize, dequantize, inverse transform, reconstruct), so the
chosen levels and recon are bit-final.  Selection is the first minimum of
``sse + lambda * (mode_rate + resid_bits)`` over the candidate order.  In
the mixed form the inter lanes follow the intra candidates: each brings a
bit-final prediction and a rate of its own a block, runs the chain with
DCT_DCT, and a candidate whose mask is false costs 3e38.

``encode_plane_wavefront`` and ``encode_plane_wavefront_mixed`` run the
plain PyTorch body below for a tensor on the CPU and the hand-written CUDA
kernel (``cuda/wavefront_kernel.py``) for a tensor on a CUDA device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import intra
from ..ops.intra_dir import dr_pred
from ..ops.quant import dequantize_dq, quantize_dq
from ..ops.transforms import add_residual_clip, fwd_txfm2d, inv_txfm2d
from ..spec import tables as tbl
from ..spec.cdf import CdfContext
from ..spec.txfm import DCT_DCT, uv_intra_tx_type


def expand_candidates(modes, angle_deltas=(0,)):
    """[(mode, delta)]; delta != 0 only for directional modes."""
    out = []
    for m in modes:
        if 1 <= m <= 8:
            out.extend((m, d) for d in angle_deltas)
        else:
            out.append((m, 0))
    return tuple(out)


DEFAULT_MODES = (intra.DC_PRED, intra.V_PRED, intra.H_PRED,
                 intra.D45_PRED, intra.D135_PRED, intra.D113_PRED,
                 intra.D157_PRED, intra.D203_PRED, intra.D67_PRED,
                 intra.SMOOTH_PRED, intra.SMOOTH_V_PRED, intra.SMOOTH_H_PRED,
                 intra.PAETH_PRED)
DIRECTIONAL = set(range(1, 9))


def _quad_tables(bh: int, bw: int):
    """Static schedule tables [nsteps, 4, D]: block coords + availability
    for the quad z-order wavefront (decoder z-order has_tr/has_bl rules).
    The valid lanes of each sub-step are a prefix of the D lanes."""
    assert bh % 2 == 0 and bw % 2 == 0, "plane must be a whole number of SBs"
    QH, QW = bh // 2, bw // 2
    nsteps = 2 * (QH - 1) + (QW - 1) + 1
    D = 0
    steps = []
    for d in range(nsteps):
        Rs = [R for R in range(QH) if 0 <= d - 2 * R < QW]
        steps.append(Rs)
        D = max(D, len(Rs))
    rs = np.zeros((nsteps, 4, D), np.int32)
    cs = np.zeros((nsteps, 4, D), np.int32)
    valid = np.zeros((nsteps, 4, D), bool)
    has_tr = np.zeros((nsteps, 4, D), bool)
    has_bl = np.zeros((nsteps, 4, D), bool)
    for d, Rs in enumerate(steps):
        for z, (qr, qc) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            for i, R in enumerate(Rs):
                C = d - 2 * R
                r, c = 2 * R + qr, 2 * C + qc
                rs[d, z, i] = r
                cs[d, z, i] = c
                valid[d, z, i] = True
                if qr == 0:
                    has_tr[d, z, i] = (r > 0) and (c + 1 < bw)
                else:
                    has_tr[d, z, i] = (qc == 0) and (c + 1 < bw)
                has_bl[d, z, i] = (qr == 0 and qc == 0 and c > 0 and
                                   r + 1 < bh)
    return rs, cs, valid, has_tr, has_bl


def _lambda(qindex: int) -> float:
    """RD lambda (bits <-> SSE), scaled by SVT_TPU_LAMBDA_SCALE read at
    call time, as the JAX package does."""
    _, ac = tbl.qindex_to_dq(qindex, 8)
    scale = float(os.environ.get("SVT_TPU_LAMBDA_SCALE", "1.0"))
    return scale * 0.00875 * float(ac) * float(ac) / 16.0


def _cdf_bits(table, sym: int) -> float:
    """-log2 P(sym) from a default [icdf..., counter] table slice."""
    hi = 32768 if sym == 0 else int(table[sym - 1])
    lo = int(table[sym])
    p = max(hi - lo, 1) / 32768.0
    return -np.log2(p)


def intra_mode_rate_table(cands, qindex: int, kf=True,
                          cdf: CdfContext = None) -> np.ndarray:
    """Per-candidate mode-signaling bits from the default CDFs (`cdf`, or
    a new CdfContext); kf="uv" takes the uv_mode CDF of the paired chroma
    wavefront."""
    cdf = cdf or CdfContext(qindex)
    out = np.zeros(len(cands), np.float32)
    for i, (mode, delta) in enumerate(cands):
        if kf == "uv":
            bits = _cdf_bits(cdf.uv_mode_cdf[1][0], mode)
        elif kf:
            bits = _cdf_bits(cdf.kf_y_cdf[0][0], mode)
        else:
            bits = _cdf_bits(cdf.y_mode_cdf[3], mode)
        if 1 <= mode <= 8:
            bits += _cdf_bits(cdf.angle_delta_cdf[mode - 1], delta + 3)
        out[i] = bits
    return out


def _resid_bits(lev, bs: int):
    """Residual-bit estimate calibrated against the real tile coder."""
    nnz = (lev != 0).sum((-1, -2)).to(torch.float32)
    lbits = torch.log2(1.0 + lev.abs().to(torch.float32)).sum((-1, -2))
    if bs >= 32:
        est = 25.7 + 2.43 * nnz + 1.83 * lbits
    else:
        est = 16.2 + 2.47 * nnz + 1.58 * lbits
    return torch.where(nnz > 0, est, torch.ones_like(est))


def rd_params(qindex: int, bd: int, cands, kf=True):
    """RD inputs of a wavefront call, on the CPU: (dc step int32, ac step
    int32, lambda float32, mode-rate table float32 [C])."""
    dc, ac = tbl.qindex_to_dq(qindex, bd)
    return (torch.tensor(int(dc), dtype=torch.int32),
            torch.tensor(int(ac), dtype=torch.int32),
            torch.tensor(_lambda(qindex), dtype=torch.float32),
            torch.from_numpy(intra_mode_rate_table(cands, qindex, kf=kf)))


def rd_from_numpy(dc, ac, lam, mode_rate):
    """The JAX package's rd_params output, as numpy arrays, as the port's
    rd tuple."""
    return (torch.tensor(int(np.asarray(dc)), dtype=torch.int32),
            torch.tensor(int(np.asarray(ac)), dtype=torch.int32),
            torch.from_numpy(np.array(lam, np.float32).reshape(())),
            torch.from_numpy(np.asarray(mode_rate, np.float32).copy()))


def encode_plane_wavefront(src, bs: int, tx_size: int, qindex: int,
                           modes: tuple = DEFAULT_MODES, bd: int = 8,
                           angle_deltas: tuple = (0,), valid_h: int = None,
                           paired: bool = False, kf=True,
                           uv_tx: bool = False):
    """src [B, h, w] pixel tensor (h, w multiples of 2*bs) ->
    (mode_idx [B, bh, bw] int32, levels [B, bh, bw, bs, bs] int32,
    recon [B, h, w] int32); mode_idx indexes expand_candidates(modes,
    angle_deltas).

    valid_h: true (unpadded) frame height; left and below-left edge rows
    clamp at valid_h-1 (§7.11.2 bottom-edge rule).
    paired=True: src stacks two planes [U..., V...] on the batch axis and
    each (u, v) pair picks the same candidate (one uv_mode for both).
    uv_tx=True: each candidate uses its uv_mode-implied tx type."""
    cands = expand_candidates(modes, angle_deltas)
    rd = rd_params(qindex, bd, cands, kf=kf)
    if src.device.type == "cpu":
        return _wavefront_body(src, rd, bs, tx_size, modes, bd, angle_deltas,
                               valid_h, paired, uv_tx)
    from ..cuda.wavefront_kernel import wavefront_cuda
    return wavefront_cuda(src, rd, bs, tx_size, modes, bd, angle_deltas,
                          valid_h, paired, uv_tx)


def encode_plane_wavefront_mixed(src, bs: int, tx_size: int, qindex: int,
                                 extra_preds, extra_rate, extra_ok, intra_ok,
                                 n_extra: int, modes: tuple = DEFAULT_MODES,
                                 bd: int = 8, angle_deltas: tuple = (0,),
                                 valid_h: int = None):
    """Mode decision with n_extra precomputed inter candidates after the
    intra ones (expand_candidates(modes, angle_deltas): the flat P frame),
    rates from the inter frame's y_mode CDF.  src [B, h, w] uint8; extra_preds [B, nE, bh, bw, bs, bs] int32
    (or uint8) bit-final predictions; extra_rate [B, nE, bh, bw] float32
    bits; extra_ok [B, nE, bh, bw] and intra_ok [B, bh, bw] bool.  Frames
    are independent (U and V may ride one call).  Returns (cand_idx,
    levels, recon) as encode_plane_wavefront; cand_idx >= n_intra selects
    inter lane cand_idx - n_intra."""
    if extra_preds.shape[1] != n_extra:
        raise ValueError(f"extra_preds holds {extra_preds.shape[1]} lanes, "
                         f"not n_extra={n_extra}")
    cands = expand_candidates(modes, angle_deltas)
    rd = rd_params(qindex, bd, cands, kf=False)
    extra = (extra_preds, extra_rate, extra_ok, intra_ok)
    if src.device.type == "cpu":
        return _wavefront_body(src, rd, bs, tx_size, modes, bd, angle_deltas,
                               valid_h=valid_h, extra=extra)
    from ..cuda.wavefront_kernel import wavefront_cuda
    return wavefront_cuda(src, rd, bs, tx_size, modes, bd, angle_deltas,
                          valid_h=valid_h, extra=extra)


def _tx_types(cands, tx_size: int, uv_tx: bool):
    if uv_tx:
        return [uv_intra_tx_type(m, tx_size) for m, _ in cands]
    return [DCT_DCT] * len(cands)


def _edges(rowbuf, colbuf, rs, cs, has_tr, has_bl, bs: int, vh: int,
           base: int):
    """§7.11.2 edges of the blocks (rs[i], cs[i]) of every frame from the
    boundary buffers rowbuf [B, bh, w] and colbuf [B, h, bw]; left rows
    clamp at vh - 1.  Returns above [B, D, bs], left [B, D, bs], corner
    [B, D], above_ext [B, D, 2bs], left_ext [B, D, 2bs]."""
    h, w = colbuf.shape[1], rowbuf.shape[2]
    ar = torch.arange(bs, device=rowbuf.device)
    y, x = rs * bs, cs * bs
    ha = (rs > 0)[None, :, None]                           # [1, D, 1]
    hl = (cs > 0)[None, :, None]
    rm1 = (rs - 1).clamp(min=0)
    cm1 = (cs - 1).clamp(min=0)
    above_real = rowbuf[:, rm1[:, None], x[:, None] + ar[None, :]]
    lrows = (y[:, None] + ar[None, :]).clamp(max=vh - 1)
    left_real = colbuf[:, lrows, cm1[:, None]]
    corner_real = rowbuf[:, rm1, (x - 1).clamp(min=0)]
    above = torch.where(ha, above_real,
                        torch.where(hl, left_real[..., 0:1], base - 1))
    left = torch.where(hl, left_real,
                       torch.where(ha, above_real[..., 0:1], base + 1))
    ha1, hl1 = ha[..., 0], hl[..., 0]
    corner = torch.where(
        ha1 & hl1, corner_real,
        torch.where(ha1, above_real[..., 0],
                    torch.where(hl1, left_real[..., 0], base)))
    tr_real = rowbuf[:, rm1[:, None],
                     (x + bs).clamp(max=w - bs)[:, None] + ar[None, :]]
    brows = ((y + bs).clamp(max=h - bs)[:, None] +
             ar[None, :]).clamp(max=vh - 1)
    bl_real = colbuf[:, brows, cm1[:, None]]
    above_ext = torch.cat(
        [above, torch.where(has_tr[None, :, None], tr_real,
                            above[..., -1:])], dim=-1)
    left_ext = torch.cat(
        [left, torch.where(has_bl[None, :, None], bl_real,
                           left[..., -1:])], dim=-1)
    return above, left, corner, above_ext, left_ext


def _wavefront_body(src, rd, bs: int, tx_size: int, modes=DEFAULT_MODES,
                    bd: int = 8, angle_deltas=(0,), valid_h: int = None,
                    paired: bool = False, uv_tx: bool = False, extra=None):
    """Plain PyTorch wavefront on src's device; same contract as
    encode_plane_wavefront with rd = rd_params(...).  extra: the mixed
    form's (extra_preds, extra_rate, extra_ok, intra_ok), or None."""
    dqdc, dqac, lam, mode_rate = rd
    dev = src.device
    B, h, w = src.shape
    vh = h if valid_h is None else valid_h
    bh, bw = h // bs, w // bs
    rs_t, cs_t, valid_t, has_tr_t, has_bl_t = _quad_tables(bh, bw)
    base = 1 << (bd - 1)
    cands = expand_candidates(modes, angle_deltas)
    types = _tx_types(cands, tx_size, uv_tx)
    rate_c = mode_rate.to(dev)[:, None]                    # [NI, 1]
    lam = float(lam)
    if extra is not None:
        x_pred, x_rate, x_ok, i_ok = extra
        types = types + [DCT_DCT] * x_pred.shape[1]
        x_pred = x_pred.to(torch.int32)
    C = len(types)

    src_b = src.to(torch.int32).reshape(B, bh, bs, bw, bs).permute(
        0, 1, 3, 2, 4)
    ar = torch.arange(bs, device=dev)
    # coding-order boundary state: bottom row of every completed block
    # (rowbuf [B, bh, w]) and its right column (colbuf [B, h, bw])
    rowbuf = torch.zeros((B, bh, w), dtype=torch.int32, device=dev)
    colbuf = torch.zeros((B, h, bw), dtype=torch.int32, device=dev)
    mode_idx = torch.zeros((B, bh, bw), dtype=torch.int32, device=dev)
    levels = torch.zeros((B, bh, bw, bs, bs), dtype=torch.int32, device=dev)
    recon_b = torch.zeros((B, bh, bw, bs, bs), dtype=torch.int32,
                          device=dev)

    # sub-steps in z-order inside each wavefront step; the valid lanes
    # of a sub-step are a prefix, so only those are evaluated
    fold = lambda a: a.reshape((-1,) + a.shape[2:])
    n_valid = fold(valid_t).sum(1)
    rs_f, cs_f, htr_f, hbl_f = (
        torch.as_tensor(fold(a), device=dev)
        for a in (rs_t.astype(np.int64), cs_t.astype(np.int64), has_tr_t,
                  has_bl_t))
    for k in range(len(n_valid)):
        D = int(n_valid[k])
        rs, cs = rs_f[k, :D], cs_f[k, :D]
        has_tr, has_bl = htr_f[k, :D], hbl_f[k, :D]
        y, x = rs * bs, cs * bs
        ha1, hl1 = rs > 0, cs > 0
        above, left, corner, above_ext, left_ext = _edges(
            rowbuf, colbuf, rs, cs, has_tr, has_bl, bs, vh, base)
        blocks = src_b[:, rs, cs]                          # [B, D, bs, bs]

        # flatten batch x lane for the candidate stack
        fb = lambda a: a.reshape((B * D,) + a.shape[2:])
        f_src, f_above, f_left, f_corner = map(
            fb, (blocks, above, left, corner))
        f_above_ext, f_left_ext = fb(above_ext), fb(left_ext)
        f_ha = ha1.expand(B, D).reshape(-1)[:, None, None]
        f_hl = hl1.expand(B, D).reshape(-1)[:, None, None]

        preds = []
        for mode, delta in cands:
            if mode == intra.DC_PRED:
                p = [intra.dc_pred(f_above, f_left, a, l, bd)
                     for a, l in ((True, True), (True, False),
                                  (False, True), (False, False))]
                pred = torch.where(f_ha & f_hl, p[0],
                                   torch.where(f_ha, p[1],
                                               torch.where(f_hl, p[2],
                                                           p[3])))
            elif mode in DIRECTIONAL and (delta != 0 or mode not in
                                          (intra.V_PRED, intra.H_PRED)):
                pred = dr_pred(mode, delta, f_above_ext, f_left_ext,
                               f_corner, bs, bd)
            else:
                pred = intra.predict(mode, f_above, f_left, f_corner)
            preds.append(pred)
        if extra is not None:
            # inter lanes after the intra candidates: [nE, BD, ...]
            preds += list(x_pred[:, :, rs, cs].transpose(0, 1).reshape(
                -1, B * D, bs, bs))
        pred_s = torch.stack(preds)                        # [C, BD, bs, bs]
        resid = f_src[None] - pred_s

        lev = torch.empty_like(resid)
        inv = torch.empty_like(resid)
        for tt in sorted(set(types)):
            idx = [i for i, ty in enumerate(types) if ty == tt]
            lv = quantize_dq(fwd_txfm2d(resid[idx], tx_size, tt, bd),
                             tx_size, dqdc, dqac, bd)
            lev[idx] = lv
            inv[idx] = inv_txfm2d(dequantize_dq(lv, tx_size, dqdc, dqac, bd),
                                  tx_size, tt, bd)
        recb = add_residual_clip(pred_s, inv, bd)
        sse = ((f_src[None] - recb) ** 2).sum((-1, -2)).to(torch.float32)
        rate = rate_c.expand(-1, B * D)
        if extra is not None:
            lane = lambda a: a[:, :, rs, cs].transpose(0, 1).reshape(-1, B * D)
            rate = torch.cat([rate, lane(x_rate)])
            ok = torch.cat([i_ok[:, rs, cs].reshape(1, B * D).expand(
                len(cands), -1), lane(x_ok)])
        cost = sse + lam * (rate + _resid_bits(lev, bs))   # [C, BD]
        if extra is not None:
            cost = torch.where(ok, cost, torch.full_like(cost, 3e38))
        if paired:
            # (u, v) halves of the batch pick one candidate: pair sums
            cp = cost.reshape(C, 2, (B // 2) * D).sum(1)
            best = torch.argmin(cp, 0).repeat(2)
        else:
            best = torch.argmin(cost, 0)                   # first minimum
        lanes = torch.arange(B * D, device=dev)
        best_lev = lev[best, lanes].reshape(B, D, bs, bs)
        best_rec = recb[best, lanes].reshape(B, D, bs, bs)

        mode_idx[:, rs, cs] = best.to(torch.int32).reshape(B, D)
        levels[:, rs, cs] = best_lev
        recon_b[:, rs, cs] = best_rec
        rowbuf[:, rs[:, None], x[:, None] + ar[None, :]] = best_rec[:, :, -1]
        colbuf[:, y[:, None] + ar[None, :], cs[:, None]] = \
            best_rec[:, :, :, -1]

    recon = recon_b.permute(0, 1, 3, 2, 4).reshape(B, h, w)
    return mode_idx, levels, recon
