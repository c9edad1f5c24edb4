"""Plain PyTorch reference of the flat all-intra device stage.

What ``IntraEncoder.device_encode`` computes on the flat path (presets
11-13), from the source planes alone: the quad wavefront mode decision
over 32x32 luma blocks (TX_32X32, DCT) and paired 16x16 U+V blocks (the
uv_mode's implied tx type), every candidate through the normative integer
chain (predict, forward transform, quantize, dequantize, inverse
transform, reconstruct), then uniform deblocking.  It is a frozen copy of
the port's plain body (``encoder/wavefront.py``, ``ops/{intra,intra_dir,
transforms,quant,deblock}.py``), cut to what this path runs, so that a
change to the program cannot move it.

One deliberate difference from the port's plain body: each block's
residual-bit estimate sums log2(1 + |level|) along each row first and then
over the rows as a butterfly (``_row_butterfly``), the association the
CUDA kernel uses.  The RD cost is float32 and its first minimum picks the
mode, so an association that rounds differently can flip a near tie;
with this one a correct kernel agrees bit for bit.

``cost_dtype`` exists for the benchmark's control: the same decision with
the RD cost computed in bfloat16, the precision below the float32 that the
configuration states.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import tables

BLK, CBLK = 32, 16
N_MODES = 13                         # DC .. PAETH, spec order
DIRECTIONAL = range(1, 9)
MODE_ANGLE = {1: 90, 2: 180, 3: 45, 4: 135, 5: 113, 6: 157, 7: 203, 8: 67}
# chroma intra tx type implied by the uv mode (DCT_DCT 0, ADST_DCT 1,
# DCT_ADST 2, ADST_ADST 3); (row kind, column kind) of each type
UV_TX_TYPE = (0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3)
TX_KINDS = {0: ("dct", "dct"), 1: ("dct", "adst"), 2: ("adst", "dct"),
            3: ("adst", "adst")}
SM_WEIGHTS = {
    16: [255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17,
         16],
    32: [255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92,
         83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8],
}
DR_DERIV = {3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151,
            26: 132, 29: 116, 32: 102, 36: 90, 39: 80, 42: 71, 45: 64,
            48: 57, 51: 51, 54: 45, 58: 40, 61: 35, 64: 31, 67: 27, 70: 23,
            73: 19, 76: 15, 81: 11, 84: 7, 87: 3}


# ---------------------------------------------------------------- RD inputs

def lf_levels(qindex: int) -> tuple:
    """(luma, chroma) deblocking levels derived from qindex."""
    l = max(0, min(63, qindex * qindex // 1100 + qindex // 12 - 2))
    return l, max(0, l * 3 // 4)


def rd_lambda(qindex: int) -> float:
    _, ac = tables.qindex_to_dq(qindex, 8)
    return float(np.float32(0.00875 * float(ac) * float(ac) / 16.0))


def _cdf_bits(row, sym: int) -> float:
    hi = 32768 if sym == 0 else int(row[sym - 1])
    return -np.log2(max(hi - int(row[sym]), 1) / 32768.0)


def mode_rates(chroma: bool) -> np.ndarray:
    """Bits of each candidate's mode symbol in the default CDFs."""
    t = tables.spec()
    row = t["uv_mode_cdf"][1][0] if chroma else t["kf_y_cdf"][0][0]
    out = np.zeros(N_MODES, np.float32)
    for m in range(N_MODES):
        bits = _cdf_bits(row, m)
        if m in DIRECTIONAL:
            bits += _cdf_bits(t["angle_delta_cdf"][m - 1], 3)
        out[m] = bits
    return out


# ---------------------------------------------------------------- predictors

def _weights(n, dev):
    return torch.tensor(SM_WEIGHTS[n], dtype=torch.int32, device=dev)


def dc_pred(above, left, ha: bool, hl: bool, bd: int):
    h, w = left.shape[-1], above.shape[-1]
    if ha and hl:
        dc = torch.div(above.sum(-1) + left.sum(-1) + ((w + h) >> 1), w + h,
                       rounding_mode="floor")
    elif ha:
        dc = torch.div(above.sum(-1) + (w >> 1), w, rounding_mode="floor")
    elif hl:
        dc = torch.div(left.sum(-1) + (h >> 1), h, rounding_mode="floor")
    else:
        dc = torch.full(above.shape[:-1], 1 << (bd - 1), dtype=torch.int32,
                        device=above.device)
    return dc.to(torch.int32)[..., None, None].expand(
        above.shape[:-1] + (h, w))


def smooth_pred(mode: int, above, left):
    n = above.shape[-1]
    wt = _weights(n, above.device)
    below, right = left[..., -1:], above[..., -1:]
    vert = (wt[:, None] * above[..., None, :] +
            (256 - wt)[:, None] * below[..., None])
    horz = (wt[None, :] * left[..., :, None] +
            (256 - wt)[None, :] * right[..., None])
    if mode == 9:
        return (vert + horz + 256) >> 9
    return ((vert if mode == 10 else horz) + 128) >> 8


def paeth_pred(above, left, corner):
    t, l, tl = above[..., None, :], left[..., :, None], corner[..., None, None]
    base = t + l - tl
    pt, pl, ptl = (base - t).abs(), (base - l).abs(), (base - tl).abs()
    shape = base.shape
    return torch.where((pl <= pt) & (pl <= ptl), l.expand(shape),
                       torch.where(pt <= ptl, t.expand(shape),
                                   tl.expand(shape)))


def _dx(angle):
    return DR_DERIV[angle] if angle < 90 else DR_DERIV[180 - angle] \
        if angle < 180 else 1


def _dy(angle):
    return DR_DERIV[angle - 90] if 90 < angle < 180 else \
        DR_DERIV[270 - angle] if 180 < angle < 270 else 1


@lru_cache(maxsize=None)
def _dr_maps(n: int, angle: int, device: str):
    """Gather maps of a directional angle (spec §7.11.2.4, edge filter and
    upsampling off): zone 1 (< 90) and 3 (> 180) interpolate one extended
    edge, zone 2 the corner-prefixed above or left edge."""
    up = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt).reshape(
        -1), device=device)
    if angle < 90 or angle > 180:
        d = _dx(angle) if angle < 90 else _dy(angle)
        k = np.arange(n)
        pos = d * (k + 1)
        if angle < 90:          # row r shifts by (r+1)*dx
            base = (pos >> 6)[:, None] + k[None, :]
            shift = ((pos >> 1) & 0x1F)[:, None] + 0 * k[None, :]
        else:                   # column c shifts by (c+1)*dy
            base = (pos >> 6)[None, :] + k[:, None]
            shift = ((pos >> 1) & 0x1F)[None, :] + 0 * k[:, None]
        mb = 2 * n - 1
        return ([(up(np.minimum(base, mb), np.int64),
                  up(np.minimum(base + 1, mb), np.int64),
                  up(shift, np.int32))],
                torch.as_tensor(base >= mb, device=device))
    dx, dy = _dx(angle), _dy(angle)
    r, c = np.arange(n)[:, None], np.arange(n)[None, :]
    x = -dx * (r + 1)
    base1 = (x >> 6) + c
    shift1 = ((x & 0x3F) >> 1) + 0 * c
    y = (r << 6) - dy * (c + 1)
    base2 = y >> 6
    shift2 = ((y & 0x3F) >> 1) + 0 * r
    tabs = [(up(np.clip(base1 + 1, 0, n), np.int64),
             up(np.clip(base1 + 2, 0, n), np.int64), up(shift1, np.int32)),
            (up(np.clip(base2 + 1, 0, n), np.int64),
             up(np.clip(base2 + 2, 0, n), np.int64), up(shift2, np.int32))]
    return tabs, torch.as_tensor(base1 >= -1, device=device)


def _interp(edge, i0, i1, shift, n):
    v = (edge[..., i0] * (32 - shift) + edge[..., i1] * shift + 16) >> 5
    return v.reshape(edge.shape[:-1] + (n, n))


def dr_pred(mode: int, above_ext, left_ext, corner, n: int, bd: int):
    angle = MODE_ANGLE[mode]
    tabs, mask = _dr_maps(n, angle, str(above_ext.device))
    if 90 < angle < 180:
        va = _interp(torch.cat([corner[..., None], above_ext[..., :n]], -1),
                     *tabs[0], n)
        vl = _interp(torch.cat([corner[..., None], left_ext[..., :n]], -1),
                     *tabs[1], n)
        return torch.where(mask, va, vl).clamp(0, (1 << bd) - 1)
    edge = above_ext if angle < 90 else left_ext
    val = _interp(edge, *tabs[0], n)
    fill = edge[..., 2 * n - 1][..., None, None]
    return torch.where(mask, fill, val).clamp(0, (1 << bd) - 1)


def predict(mode, above, left, corner, above_ext, left_ext, ha, hl, n, bd):
    """[C-th mode] prediction of a stack of blocks; ha / hl [N, 1, 1]."""
    if mode == 0:
        p = [dc_pred(above, left, a, l, bd)
             for a, l in ((True, True), (True, False), (False, True),
                          (False, False))]
        return torch.where(ha & hl, p[0], torch.where(
            ha, p[1], torch.where(hl, p[2], p[3])))
    if mode == 1:
        return above[..., None, :].expand(above.shape[:-1] + (n, n))
    if mode == 2:
        return left[..., :, None].expand(left.shape[:-1] + (n, n))
    if mode in DIRECTIONAL:
        return dr_pred(mode, above_ext, left_ext, corner, n, bd)
    if mode == 12:
        return paeth_pred(above, left, corner)
    return smooth_pred(mode, above, left)


# ---------------------------------------------------------------- transforms

FWD_SHIFT = {16: (2, -2, 0), 32: (2, -4, 0)}
FWD_COS_BIT = {16: (13, 12), 32: (12, 12)}     # (column, row)
INV_SHIFT = (-2, -4)
INV_COS_BIT = 12


@lru_cache(maxsize=None)
def _network(kind: str, n: int, direction: str, cos_bit: int, device: str):
    """Each butterfly stage as (ia, wa, ib, wb, mode) tensors: out[r] =
    wa[r] * x[ia[r]] + wb[r] * x[ib[r]], rounded by cos_bit (mode 1),
    clamped (mode 0, inverse only) or as is (mode 2)."""
    cospi = tables.spec()["cospi"][cos_bit - 10].astype(np.int64)
    out = []
    for stage in tables.stages()[f"svt_av1_{direction[0]}{kind}{n}_new"]:
        ia, wa, ib, wb, mode = (np.zeros(n, np.int64) for _ in range(5))
        for r, op in enumerate(stage):
            tag = op[0]
            if tag == "btf":
                (sa, ka), i0, (sb, kb), i1 = op[1:5]
                ia[r], ib[r] = i0, i1
                wa[r] = int(cospi[ka]) * (-1 if sa == "-c" else 1)
                wb[r] = int(cospi[kb]) * (-1 if sb == "-c" else 1)
                mode[r] = 1
            elif tag in ("add", "addnc"):
                _, s0, i0, s1, i1 = op
                ia[r], wa[r], ib[r], wb[r] = i0, s0, i1, s1
                mode[r] = 0 if tag == "add" else 2
            elif tag in ("pass", "neg"):
                ia[r], wa[r] = op[1], 1 if tag == "pass" else -1
                mode[r] = 2
            else:
                raise ValueError(tag)
        dev = torch.device(device)
        out.append((torch.as_tensor(ia, device=dev),
                    torch.as_tensor(wa, dtype=torch.int32, device=dev),
                    torch.as_tensor(ib, device=dev),
                    torch.as_tensor(wb, dtype=torch.int32, device=dev),
                    torch.as_tensor(mode, dtype=torch.int32, device=dev)))
    return out


def _clamp(x, bits):
    return x.clamp(-(1 << (bits - 1)), (1 << (bits - 1)) - 1)


def _rshift(x, s):
    """s > 0: Round2 by s; s < 0: multiply by 2^-s."""
    if s > 0:
        return (x + (1 << (s - 1))) >> s
    return x << (-s) if s < 0 else x


def _apply(x, kind, n, direction, cos_bit, clamp_bits):
    half = 1 << (cos_bit - 1)
    for ia, wa, ib, wb, mode in _network(kind, n, direction, cos_bit,
                                         str(x.device)):
        lin = wa * x[..., ia] + wb * x[..., ib]
        out = torch.where(mode == 1, (lin + half) >> cos_bit, lin)
        if clamp_bits:
            out = torch.where(mode == 0, _clamp(lin, clamp_bits), out)
        x = out
    return x


def inv_ranges(bd: int) -> dict:
    return dict(inp=bd + 8, row=16 if bd == 8 else 18, mid=max(bd + 6, 16),
                col=16, res_max=(1 << (7 + bd)) - 1 + (914 << (bd - 7)))


def fwd_txfm(res, n: int, tx_type: int):
    row, col = TX_KINDS[tx_type]
    s = FWD_SHIFT[n]
    cb_col, cb_row = FWD_COS_BIT[n]
    x = _rshift(res.to(torch.int32).transpose(-1, -2), -s[0])
    x = _apply(x, col, n, "fwd", cb_col, 0)
    x = _rshift(x, -s[1]).transpose(-1, -2)
    return _rshift(_apply(x, row, n, "fwd", cb_row, 0), -s[2])


def inv_txfm(coeffs, n: int, tx_type: int, bd: int):
    row, col = TX_KINDS[tx_type]
    r = inv_ranges(bd)
    x = _clamp(coeffs.to(torch.int32), r["inp"])
    x = _rshift(_apply(x, row, n, "inv", INV_COS_BIT, r["row"]),
                -INV_SHIFT[0])
    x = _clamp(x.transpose(-1, -2), r["mid"])
    x = _rshift(_apply(x, col, n, "inv", INV_COS_BIT, r["col"]),
                -INV_SHIFT[1])
    return x.transpose(-1, -2)


def _dqv(dc, ac, n, dev):
    m = torch.full((n, n), ac, dtype=torch.int32, device=dev)
    m[0, 0] = dc
    return m


def quantize(coeffs, n: int, dc: int, ac: int):
    """The encoder's deadzone quantizer (rounding 48/128 of the step)."""
    shift = int(n * n > 256)
    dqv = _dqv(dc, ac, n, coeffs.device)
    lev = torch.div((coeffs.abs() << shift) + ((dqv * 48) >> 7), dqv,
                    rounding_mode="floor").clamp(0, (1 << 15) - 1)
    return torch.sign(coeffs).to(torch.int32) * lev


def dequantize(levels, n: int, dc: int, ac: int, bd: int):
    """Normative dequantization (spec §7.12.3)."""
    shift = int(n * n > 256)
    dqv = _dqv(dc, ac, n, levels.device)
    v = ((levels.abs() * dqv) & 0xFFFFFF) >> shift
    lim = 1 << (bd + 7)
    return (torch.sign(levels).to(torch.int32) * v).clamp(-lim, lim - 1)


# ---------------------------------------------------------------- wavefront

def _quad_schedule(bh: int, bw: int):
    """The sub-steps of the 2:1 quad wavefront, each a list of (r, c,
    has_top_right, has_bottom_left) in z-order within the quad."""
    QH, QW = bh // 2, bw // 2
    steps = []
    for d in range(2 * (QH - 1) + QW):
        Rs = [R for R in range(QH) if 0 <= d - 2 * R < QW]
        for qr, qc in ((0, 0), (0, 1), (1, 0), (1, 1)):
            sub = []
            for R in Rs:
                r, c = 2 * R + qr, 2 * (d - 2 * R) + qc
                tr = (r > 0 and c + 1 < bw) if qr == 0 else \
                    (qc == 0 and c + 1 < bw)
                bl = qr == 0 and qc == 0 and c > 0 and r + 1 < bh
                sub.append((r, c, tr, bl))
            steps.append(sub)
    return steps


def _row_butterfly(lb):
    """Sum of lb [..., n, n] over its last two axes: along each row in
    order, then over the rows by halves (n/2, n/4, ... apart)."""
    s = torch.zeros(lb.shape[:-1], dtype=torch.float32, device=lb.device)
    for i in range(lb.shape[-1]):
        s = s + lb[..., i]
    o = s.shape[-1] // 2
    while o:
        s = s[..., :o] + s[..., o:2 * o]
        o //= 2
    return s[..., 0]


def resid_bits(lev, n: int):
    nnz = (lev != 0).sum((-1, -2)).to(torch.float32)
    lbits = _row_butterfly(torch.log2(1.0 + lev.abs().to(torch.float32)))
    if n >= 32:
        est = 25.7 + 2.43 * nnz + 1.83 * lbits
    else:
        est = 16.2 + 2.47 * nnz + 1.58 * lbits
    return torch.where(nnz > 0, est, torch.ones_like(est))


def wavefront(src, n: int, qindex: int, bd: int, valid_h: int,
              chroma: bool, cost_dtype=torch.float32):
    """src [B, h, w] pixels -> (mode [B, bh, bw], levels [B, bh, bw, n, n],
    recon [B, h, w]), int32.  chroma: src stacks [U..., V...] and each
    (u, v) pair takes one mode (costs summed), each mode with its implied
    tx type; luma codes DCT_DCT."""
    dev = src.device
    B, h, w = src.shape
    bh, bw = h // n, w // n
    base = 1 << (bd - 1)
    dc, ac = tables.qindex_to_dq(qindex, bd)
    lam = torch.tensor(rd_lambda(qindex), dtype=torch.float32, device=dev)
    rate = torch.as_tensor(mode_rates(chroma), device=dev)[:, None]
    types = UV_TX_TYPE if chroma else (0,) * N_MODES
    src_b = src.to(torch.int32).reshape(B, bh, n, bw, n).permute(0, 1, 3, 2,
                                                                 4)
    ar = torch.arange(n, device=dev)
    rowbuf = torch.zeros((B, bh, w), dtype=torch.int32, device=dev)
    colbuf = torch.zeros((B, h, bw), dtype=torch.int32, device=dev)
    mode_map = torch.zeros((B, bh, bw), dtype=torch.int32, device=dev)
    levels = torch.zeros((B, bh, bw, n, n), dtype=torch.int32, device=dev)
    recon = torch.zeros((B, bh, bw, n, n), dtype=torch.int32, device=dev)
    for sub in _quad_schedule(bh, bw):
        if not sub:
            continue
        D = len(sub)
        rs, cs, has_tr, has_bl = (torch.tensor(v, device=dev)
                                  for v in zip(*sub))
        y, x = rs * n, cs * n
        ha, hl = (rs > 0)[None, :, None], (cs > 0)[None, :, None]
        rm1, cm1 = (rs - 1).clamp(min=0), (cs - 1).clamp(min=0)
        # §7.11.2 edges: missing ones take the other edge's first sample or
        # base -/+ 1; left rows clamp at the frame's last valid row
        above_r = rowbuf[:, rm1[:, None], x[:, None] + ar[None, :]]
        left_r = colbuf[:, (y[:, None] + ar[None, :]).clamp(max=valid_h - 1),
                        cm1[:, None]]
        corner_r = rowbuf[:, rm1, (x - 1).clamp(min=0)]
        above = torch.where(ha, above_r, torch.where(hl, left_r[..., :1],
                                                     base - 1))
        left = torch.where(hl, left_r, torch.where(ha, above_r[..., :1],
                                                   base + 1))
        ha1, hl1 = ha[..., 0], hl[..., 0]
        corner = torch.where(ha1 & hl1, corner_r, torch.where(
            ha1, above_r[..., 0], torch.where(hl1, left_r[..., 0], base)))
        tr_r = rowbuf[:, rm1[:, None],
                      (x + n).clamp(max=w - n)[:, None] + ar[None, :]]
        bl_r = colbuf[:, ((y + n).clamp(max=h - n)[:, None] +
                          ar[None, :]).clamp(max=valid_h - 1), cm1[:, None]]
        above_ext = torch.cat([above, torch.where(
            has_tr[None, :, None], tr_r, above[..., -1:])], -1)
        left_ext = torch.cat([left, torch.where(
            has_bl[None, :, None], bl_r, left[..., -1:])], -1)

        fb = lambda a: a.reshape((B * D,) + a.shape[2:])
        f_src = fb(src_b[:, rs, cs])
        f_ha = ha1.expand(B, D).reshape(-1)[:, None, None]
        f_hl = hl1.expand(B, D).reshape(-1)[:, None, None]
        pred = torch.stack([predict(m, fb(above), fb(left), fb(corner),
                                    fb(above_ext), fb(left_ext), f_ha, f_hl,
                                    n, bd) for m in range(N_MODES)])
        resid = f_src[None] - pred
        lev = torch.empty_like(resid)
        inv = torch.empty_like(resid)
        for tt in sorted(set(types)):
            idx = [i for i, t in enumerate(types) if t == tt]
            lv = quantize(fwd_txfm(resid[idx], n, tt), n, dc, ac)
            lev[idx] = lv
            inv[idx] = inv_txfm(dequantize(lv, n, dc, ac, bd), n, tt, bd)
        rmax = inv_ranges(bd)["res_max"]
        rec = (pred + inv.clamp(-rmax - 1, rmax)).clamp(0, (1 << bd) - 1)
        sse = ((f_src[None] - rec) ** 2).sum((-1, -2))
        if cost_dtype == torch.float32:
            cost = sse.to(torch.float32) + lam * (rate + resid_bits(lev, n))
        else:
            cd = cost_dtype
            cost = sse.to(cd) + lam.to(cd) * (rate.to(cd) +
                                              resid_bits(lev, n).to(cd))
        if chroma:
            best = torch.argmin(cost.reshape(N_MODES, 2, -1).sum(1),
                                0).repeat(2)
        else:
            best = torch.argmin(cost, 0)          # first minimum
        lanes = torch.arange(B * D, device=dev)
        best_rec = rec[best, lanes].reshape(B, D, n, n)
        mode_map[:, rs, cs] = best.to(torch.int32).reshape(B, D)
        levels[:, rs, cs] = lev[best, lanes].reshape(B, D, n, n)
        recon[:, rs, cs] = best_rec
        rowbuf[:, rs[:, None], x[:, None] + ar[None, :]] = best_rec[:, :, -1]
        colbuf[:, y[:, None] + ar[None, :], cs[:, None]] = \
            best_rec[:, :, :, -1]
    return mode_map, levels, recon.permute(0, 1, 3, 2, 4).reshape(B, h, w)


# ---------------------------------------------------------------- deblock

def _thresholds(lvl: int):
    inside = max(1, lvl)
    return 2 * (lvl + 2) + inside, inside, lvl >> 4


def _filter_core(px, length: int, lvl: int, bd: int):
    """px [..., 14] = p6..p0, q0..q6 across each edge -> filtered taps
    (spec §7.14.6, sharpness 0)."""
    mblim, lim, thr = _thresholds(lvl)
    sh = bd - 8
    off = 128 << sh
    mblim, lim, thr, fthr = mblim << sh, lim << sh, thr << sh, 1 << sh
    sc = lambda v: v.clamp(-off, off - 1)
    p = [px[..., 6 - i] for i in range(7)]
    q = [px[..., 7 + i] for i in range(7)]
    ab = lambda a, b: (a - b).abs()
    where = torch.where
    edge = ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 <= mblim
    k = {4: 1, 6: 2, 14: 3}[length]
    mask = edge
    for i in range(k):
        mask = mask & (ab(p[i + 1], p[i]) <= lim) & (ab(q[i + 1], q[i]) <= lim)
    zero = torch.zeros_like(p[0])
    hev = (ab(p[1], p[0]) > thr) | (ab(q[1], q[0]) > thr)
    ps1, ps0, qs0, qs1 = p[1] - off, p[0] - off, q[0] - off, q[1] - off
    f = where(hev, sc(ps1 - qs1), zero)
    f = where(mask, sc(f + 3 * (qs0 - ps0)), zero)
    f1, f2 = sc(f + 4) >> 3, sc(f + 3) >> 3
    n_q0, n_p0 = sc(qs0 - f1) + off, sc(ps0 + f2) + off
    f3 = where(hev, zero, (f1 + 1) >> 1)
    n_q1, n_p1 = sc(qs1 - f3) + off, sc(ps1 + f3) + off
    out = px.clone()
    if length == 4:
        for i, v in ((5, n_p1), (6, n_p0), (7, n_q0), (8, n_q1)):
            out[..., i] = v
        return out
    r2 = lambda v: (v + 4) >> 3
    if length == 6:
        flat = ((ab(p[1], p[0]) <= fthr) & (ab(q[1], q[0]) <= fthr) &
                (ab(p[2], p[0]) <= fthr) & (ab(q[2], q[0]) <= fthr))
        sm = flat & mask
        s = (r2(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0]),
             r2(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1]),
             r2(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2]),
             r2(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3))
        for i, sv, nv in zip((5, 6, 7, 8), s, (n_p1, n_p0, n_q0, n_q1)):
            out[..., i] = where(sm, sv, nv)
        return out
    flat = mask
    for i in (1, 2, 3):
        flat = flat & (ab(p[i], p[0]) <= fthr) & (ab(q[i], q[0]) <= fthr)
    sm = flat
    f8 = (where(sm, r2(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0]), p[2]),
          where(sm, r2(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1]),
                n_p1),
          where(sm, r2(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2]),
                n_p0),
          where(sm, r2(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3]),
                n_q0),
          where(sm, r2(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2),
                n_q1),
          where(sm, r2(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3), q[2]))
    wide = sm
    for i in (4, 5, 6):
        wide = wide & (ab(p[i], p[0]) <= fthr) & (ab(q[i], q[0]) <= fthr)
    r4 = lambda v: (v + 8) >> 4
    wv = (
        r4(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] + q[0]),
        r4(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0] +
           q[0] + q[1]),
        r4(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0] +
           q[0] + q[1] + q[2]),
        r4(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0] +
           q[0] + q[1] + q[2] + q[3]),
        r4(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2 +
           q[0] + q[1] + q[2] + q[3] + q[4]),
        r4(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 +
           q[0] * 2 + q[1] + q[2] + q[3] + q[4] + q[5]),
        r4(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 +
           q[1] * 2 + q[2] + q[3] + q[4] + q[5] + q[6]),
        r4(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 +
           q[2] * 2 + q[3] + q[4] + q[5] + q[6] * 2),
        r4(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 +
           q[3] * 2 + q[4] + q[5] + q[6] * 3),
        r4(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 +
           q[4] * 2 + q[5] + q[6] * 4),
        r4(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 +
           q[5] * 2 + q[6] * 5),
        r4(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 +
           q[6] * 7))
    keep = (p[5], p[4], p[3]) + f8 + (q[3], q[4], q[5])
    for i, (v, kv) in enumerate(zip(wv, keep)):
        out[..., i + 1] = where(wide, v, kv)
    return out


_WRITE = {4: (5, 9), 6: (5, 9), 14: (1, 13)}


def _pass(x, spacing: int, end: int, length: int, lvl: int, bd: int):
    if lvl <= 0 or end <= spacing:
        return x
    cols = (torch.arange(spacing, end, spacing, device=x.device)[:, None] +
            torch.arange(-7, 7, device=x.device)[None, :])
    filt = _filter_core(x[..., cols], length, lvl, bd)
    lo, hi = _WRITE[length]
    x = x.clone()
    x[..., cols[:, lo:hi]] = filt[..., lo:hi]
    return x


def deblock(plane, spacing: int, length: int, lvl: int, bd: int,
            valid_h: int):
    """Uniform-grid deblocking: vertical edges, then horizontal edges
    above the frame's last valid row."""
    h, w = plane.shape[-2:]
    x = _pass(plane.to(torch.int32), spacing, w, length, lvl, bd)
    x = _pass(x.transpose(-1, -2), spacing, min(h, valid_h), length, lvl, bd)
    return x.transpose(-1, -2).contiguous()


def device_stage(frames, qindex: int, bd: int, height: int, device,
                 cost_dtype=torch.float32) -> dict:
    """The device stage of (y, u, v) numpy frames: mode maps, levels and
    deblocked recons of luma [B, ...] and of U then V [2B, ...]."""
    ph = -(-height // 64) * 64
    pad = lambda a, rows: np.pad(a, [(0, 0), (0, rows - a.shape[1]), (0, 0)],
                                 mode="edge")
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(
        np.int32)).to(device)
    yb = to(pad(np.stack([f[0] for f in frames]), ph))
    uvb = to(pad(np.concatenate([np.stack([f[1] for f in frames]),
                                 np.stack([f[2] for f in frames])]), ph // 2))
    y_mi, y_lev, y_rec = wavefront(yb, BLK, qindex, bd, height, False,
                                   cost_dtype)
    uv_mi, uv_lev, uv_rec = wavefront(uvb, CBLK, qindex, bd, height // 2,
                                      True, cost_dtype)
    l, lc = lf_levels(qindex)
    y_rec = deblock(y_rec, BLK, 14, l, bd, height)
    uv_rec = deblock(uv_rec, CBLK, 6, lc, bd, height // 2)
    return {"y_mi": y_mi, "uv_mi": uv_mi, "y_lev": y_lev, "uv_lev": uv_lev,
            "y_rec": y_rec, "uv_rec": uv_rec}
