"""Plain PyTorch and Python reference of the flat all-intra encode of a
frame whose height leaves m = 12 valid mi rows in its bottom SB row
(height % 64 == 48, the CTC's 2160-row class): the edge strip.

There the spec lets no 32x32 block of the bottom 32-row be coded whole
(§5.11.4: hasRows is false at +8 mi); it is coded SPLIT (split_or_horz)
into 16x16 NONE blocks (TX_16X16 luma, DCT_DCT, whose tx type symbol is
coded; 8x8 chroma, TX_8X8, the uv mode's implied type), the two top ones
of each in the frame.  The top-left 32x32 block of each SB of that row
reads its below-left edge from the strip of the SB to its left, so the
bottom SB row is coded as one chain in coding order: per SB the top-left
and top-right 32x32 (chroma 16x16) blocks, then the four in-frame strip
blocks left to right, with the flat path's 13 candidates, RD cost and
first-minimum rule.  Every SB row above it is the flat reference's
(``encoder.wavefront``, which codes the whole plane; the chain overwrites
its bottom SB row).  The deblock adds the strip's vertical transform
edges (16 px luma, 8 px chroma) with the grid's filter lengths; the tile
adds the strip's partition and block syntax.

It reuses the flat reference (``encoder``, ``coder``) by import and adds
the 8-point transforms and the tables the strip needs, frozen in
``data/edge_tables.json``; it imports nothing of the program.  The
device stage's outputs are the flat reference's keys with the bottom SB
row as the chain leaves it (zero modes and levels for the split 32x32
blocks, zero recon below the frame), plus the strip's modes and levels:
``y_emi`` [B, n], ``y_elev`` [B, n, 16, 16], ``uv_emi`` [2B, n] and
``uv_elev`` [2B, n, 8, 8] (U then V), n = 2 * width / 32, strip block
2 * (32-block column) + j.
"""

from __future__ import annotations

import json
from functools import lru_cache

import numpy as np
import torch

from . import coder as C
from . import encoder as E
from . import tables

SM8 = [255, 197, 146, 105, 73, 50, 37, 32]
FWD_SHIFT8 = (2, -1, 0)
FWD_COS_BIT8 = (13, 13)             # (column, row)
INV_SHIFT8 = (-1, -4)


@lru_cache(maxsize=None)
def edge_tables() -> dict:
    return json.loads((tables.DATA / "edge_tables.json").read_text())


# ---------------------------------------------------------------- 8x8

@lru_cache(maxsize=None)
def _network8(kind: str, direction: str, cos_bit: int, device: str):
    """E._network of the 8-point transforms (their stages frozen here)."""
    cospi = tables.spec()["cospi"][cos_bit - 10].astype(np.int64)
    out = []
    for stage in edge_tables()["stages"][f"svt_av1_{direction[0]}{kind}8_new"]:
        ia, wa, ib, wb, mode = (np.zeros(8, np.int64) for _ in range(5))
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


def _apply8(x, kind, direction, cos_bit, clamp_bits):
    half = 1 << (cos_bit - 1)
    for ia, wa, ib, wb, mode in _network8(kind, direction, cos_bit,
                                          str(x.device)):
        lin = wa * x[..., ia] + wb * x[..., ib]
        out = torch.where(mode == 1, (lin + half) >> cos_bit, lin)
        if clamp_bits:
            out = torch.where(mode == 0, E._clamp(lin, clamp_bits), out)
        x = out
    return x


def fwd_txfm(res, n: int, tx_type: int):
    if n != 8:
        return E.fwd_txfm(res, n, tx_type)
    row, col = E.TX_KINDS[tx_type]
    s = FWD_SHIFT8
    x = E._rshift(res.to(torch.int32).transpose(-1, -2), -s[0])
    x = _apply8(x, col, "fwd", FWD_COS_BIT8[0], 0)
    x = E._rshift(x, -s[1]).transpose(-1, -2)
    return E._rshift(_apply8(x, row, "fwd", FWD_COS_BIT8[1], 0), -s[2])


def inv_txfm(coeffs, n: int, tx_type: int, bd: int):
    if n != 8:
        return E.inv_txfm(coeffs, n, tx_type, bd)
    row, col = E.TX_KINDS[tx_type]
    r = E.inv_ranges(bd)
    x = E._clamp(coeffs.to(torch.int32), r["inp"])
    x = E._rshift(_apply8(x, row, "inv", E.INV_COS_BIT, r["row"]),
                  -INV_SHIFT8[0])
    x = E._clamp(x.transpose(-1, -2), r["mid"])
    x = E._rshift(_apply8(x, col, "inv", E.INV_COS_BIT, r["col"]),
                  -INV_SHIFT8[1])
    return x.transpose(-1, -2)


def predict(mode, above, left, corner, above_ext, left_ext, ha, hl, n, bd):
    """E.predict, with the 8x8 smooth weights."""
    if n == 8 and mode in (9, 10, 11):
        w = torch.tensor(SM8, dtype=torch.int32, device=above.device)
        top, lft = above[..., None, :], left[..., :, None]
        below, right = left[..., -1][..., None, None], \
            above[..., -1][..., None, None]
        wr, wc = w[:, None], w[None, :]
        v = (wr * top + (256 - wr) * below + 128) >> 8
        h = (wc * lft + (256 - wc) * right + 128) >> 8
        if mode == 9:
            return (wr * top + (256 - wr) * below + wc * lft +
                    (256 - wc) * right + 256) >> 9
        return v if mode == 10 else h
    return E.predict(mode, above, left, corner, above_ext, left_ext, ha, hl,
                     n, bd)


# ---------------------------------------------------------------- chain

def chain_blocks(w: int, big: int) -> list:
    """The bottom SB row in coding order: (dy, x, n, has_tr, has_bl, out)
    with out the block column of a top big block or -1 - k for strip
    block k (the above-right of every strip block but each SB's last is
    in the 32-row above it; no strip block's below-left is coded)."""
    s = big // 2
    out = []
    for k in range(w // (2 * big)):
        x = 2 * big * k
        out += [(0, x, big, True, x > 0, 2 * k),
                (0, x + big, big, x + 2 * big < w, False, 2 * k + 1)]
        out += [(big, x + j * s, s, j < 3, False, -1 - (4 * k + j))
                for j in range(4)]
    return out


def _edges(rec, y, x, n, has_tr, has_bl, vh, base):
    """§7.11.2 edges of block (y, x) of size n of every plane of rec
    [B, h, w] (left rows clamped at vh - 1)."""
    B, h, w = rec.shape
    ar = torch.arange(n, device=rec.device)
    ha, hl = y > 0, x > 0
    above_r = rec[:, max(y - 1, 0), x:x + n]
    left_r = rec[:, (y + ar).clamp(max=vh - 1), max(x - 1, 0)]
    full = lambda v: torch.full((B, n), v, dtype=rec.dtype, device=rec.device)
    above = above_r if ha else (left_r[:, :1].expand(B, n) if hl
                                else full(base - 1))
    left = left_r if hl else (above_r[:, :1].expand(B, n) if ha
                              else full(base + 1))
    corner = (rec[:, y - 1, x - 1] if ha and hl else above_r[:, 0] if ha
              else left_r[:, 0] if hl else full(base)[:, 0])
    tr = rec[:, y - 1, min(x + n, w - n):min(x + n, w - n) + n] \
        if has_tr and ha else above[:, -1:].expand(B, n)
    bl = rec[:, (min(y + n, h - n) + ar).clamp(max=vh - 1), x - 1] \
        if has_bl and hl else left[:, -1:].expand(B, n)
    return (above, left, corner, torch.cat([above, tr], -1),
            torch.cat([left, bl], -1), ha, hl)


def _decide(src, edges, n, chroma, qindex, bd, cost_dtype):
    """The first-minimum candidate of N blocks src [N, n, n] from their
    edges: (best [N], levels [N, n, n], recon [N, n, n])."""
    above, left, corner, above_ext, left_ext, ha, hl = edges
    N = src.shape[0]
    dev = src.device
    dc, ac = tables.qindex_to_dq(qindex, bd)
    lam = torch.tensor(E.rd_lambda(qindex), dtype=torch.float32, device=dev)
    rate = torch.as_tensor(E.mode_rates(chroma), device=dev)[:, None]
    types = E.UV_TX_TYPE if chroma else (0,) * E.N_MODES
    f_ha = torch.full((N, 1, 1), ha, device=dev)
    f_hl = torch.full((N, 1, 1), hl, device=dev)
    pred = torch.stack([predict(m, above, left, corner, above_ext, left_ext,
                                f_ha, f_hl, n, bd)
                        for m in range(E.N_MODES)])
    resid = src[None] - pred
    lev = torch.empty_like(resid)
    inv = torch.empty_like(resid)
    for tt in sorted(set(types)):
        idx = [i for i, t in enumerate(types) if t == tt]
        lv = E.quantize(fwd_txfm(resid[idx], n, tt), n, dc, ac)
        lev[idx] = lv
        inv[idx] = inv_txfm(E.dequantize(lv, n, dc, ac, bd), n, tt, bd)
    rmax = E.inv_ranges(bd)["res_max"]
    rec = (pred + inv.clamp(-rmax - 1, rmax)).clamp(0, (1 << bd) - 1)
    sse = ((src[None] - rec) ** 2).sum((-1, -2))
    if cost_dtype == torch.float32:
        cost = sse.to(torch.float32) + lam * (rate + E.resid_bits(lev, n))
    else:
        cd = cost_dtype
        cost = sse.to(cd) + lam.to(cd) * (rate.to(cd) +
                                          E.resid_bits(lev, n).to(cd))
    if chroma:
        best = torch.argmin(cost.reshape(E.N_MODES, 2, -1).sum(1),
                            0).repeat(2)
    else:
        best = torch.argmin(cost, 0)
    lanes = torch.arange(N, device=dev)
    return best, lev[best, lanes], rec[best, lanes]


def chain(src, mode_map, levels, recon, big, qindex, bd, valid_h, chroma,
          cost_dtype=torch.float32):
    """Code the bottom SB row of src [B, h, w] into the flat reference's
    outputs (written in place); returns the strip's (modes [B, n],
    levels [B, n, big/2, big/2])."""
    B, h, w = src.shape
    s, y0, bh = big // 2, h - 2 * big, h // big
    base = 1 << (bd - 1)
    srci = src.to(torch.int32)
    n_strip = 2 * (w // big)
    e_mi = torch.zeros((B, n_strip), dtype=torch.int32, device=src.device)
    e_lev = torch.zeros((B, n_strip, s, s), dtype=torch.int32,
                        device=src.device)
    mode_map[:, bh - 1] = 0
    levels[:, bh - 1] = 0
    recon[:, y0:] = 0
    for dy, x, n, tr, bl, out in chain_blocks(w, big):
        y = y0 + dy
        best, lev, rec = _decide(srci[:, y:y + n, x:x + n],
                                 _edges(recon, y, x, n, tr, bl, valid_h,
                                        base), n, chroma, qindex, bd,
                                 cost_dtype)
        recon[:, y:y + n, x:x + n] = rec
        if out >= 0:
            mode_map[:, bh - 2, out] = best.to(torch.int32)
            levels[:, bh - 2, out] = lev
        else:
            e_mi[:, -1 - out] = best.to(torch.int32)
            e_lev[:, -1 - out] = lev
    recon[:, valid_h:] = 0
    return e_mi, e_lev


def _pass_at(x, start: int, spacing: int, end: int, length: int, lvl: int,
             bd: int):
    """E._pass over the vertical edges start, start + spacing, ..."""
    if lvl <= 0 or end <= start:
        return x
    cols = (torch.arange(start, end, spacing, device=x.device)[:, None] +
            torch.arange(-7, 7, device=x.device)[None, :])
    filt = E._filter_core(x[..., cols], length, lvl, bd)
    lo, hi = E._WRITE[length]
    x = x.clone()
    x[..., cols[:, lo:hi]] = filt[..., lo:hi]
    return x


def deblock(plane, spacing: int, length: int, lvl: int, bd: int,
            valid_h: int):
    """E.deblock plus the strip's vertical edges halfway between the
    grid's, in its rows [h - spacing, valid_h), in the vertical pass."""
    h, w = plane.shape[-2:]
    x = E._pass(plane.to(torch.int32), spacing, w, length, lvl, bd)
    if lvl > 0:
        x = x.clone()
        x[..., h - spacing:valid_h, :] = _pass_at(
            x[..., h - spacing:valid_h, :], spacing // 2, spacing, w, length,
            lvl, bd)
    x = E._pass(x.transpose(-1, -2), spacing, min(h, valid_h), length, lvl,
                bd)
    return x.transpose(-1, -2).contiguous()


def device_stage(frames, qindex: int, bd: int, height: int, device,
                 cost_dtype=torch.float32) -> dict:
    """E.device_stage of an m = 12 height, with the strip's outputs."""
    if height % 64 != 48:
        raise ValueError(f"height {height}: the edge strip needs "
                         "height % 64 == 48")
    # no product here is a matmul or a convolution; TF32 is off all the
    # same, so that no float32 product could be rounded below float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = -(-height // 64) * 64
    pad = lambda a, rows: np.pad(a, [(0, 0), (0, rows - a.shape[1]), (0, 0)],
                                 mode="edge")
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(
        np.int32)).to(device)
    yb = to(pad(np.stack([f[0] for f in frames]), ph))
    uvb = to(pad(np.concatenate([np.stack([f[1] for f in frames]),
                                 np.stack([f[2] for f in frames])]), ph // 2))
    y_mi, y_lev, y_rec = E.wavefront(yb, E.BLK, qindex, bd, height, False,
                                     cost_dtype)
    uv_mi, uv_lev, uv_rec = E.wavefront(uvb, E.CBLK, qindex, bd, height // 2,
                                        True, cost_dtype)
    y_emi, y_elev = chain(yb, y_mi, y_lev, y_rec, E.BLK, qindex, bd, height,
                          False, cost_dtype)
    uv_emi, uv_elev = chain(uvb, uv_mi, uv_lev, uv_rec, E.CBLK, qindex, bd,
                            height // 2, True, cost_dtype)
    l, lc = E.lf_levels(qindex)
    y_rec = deblock(y_rec, E.BLK, 14, l, bd, height)
    uv_rec = deblock(uv_rec, E.CBLK, 6, lc, bd, height // 2)
    return {"y_mi": y_mi, "uv_mi": uv_mi, "y_lev": y_lev, "uv_lev": uv_lev,
            "y_rec": y_rec, "uv_rec": uv_rec, "y_emi": y_emi,
            "y_elev": y_elev, "uv_emi": uv_emi, "uv_elev": uv_elev}


# ---------------------------------------------------------------- tile

class TileCoder(C.TileCoder):
    """C.TileCoder with the strip: 8x8 transforms and the TX_16X16 luma
    tx type symbol."""

    def __init__(self, qindex: int, adapt: bool):
        super().__init__(qindex, adapt)
        t = edge_tables()
        self.eob16[8] = [list(r) for r in np.asarray(
            t["eob_flag_cdf64"][tables.q_ctx(qindex)]).reshape(2, 2, 8)
            .tolist()]
        self.tx16 = [list(r) for r in t["intra_tx16_cdf"]]
        self.tx16_n = t["intra_tx16_nsyms"]
        self.tx16_dct = t["intra_tx16_dct_symbol"]

    def coeffs(self, lev_scan, base_scan, br_scan, n: int, ptype: int,
               tctx: int, dctx: int, tx_row=None) -> int:
        """C.TileCoder.coeffs at n = 32, 16 or 8, with the tx type symbol
        in tx_row (the luma TX_16X16 set's CDF of the block's mode) after
        all_zero."""
        ec = self.ec
        txs = {32: 3, 16: 2, 8: 1}[n]
        nz = np.flatnonzero(lev_scan)
        eob = int(nz[-1]) + 1 if len(nz) else 0
        ec.symbol(int(eob == 0), self.txb_skip[txs][tctx], 2)
        if eob == 0:
            return 0
        if tx_row is not None:
            ec.symbol(self.tx16_dct, tx_row, self.tx16_n)
        pt = 0
        while pt < 11 and eob >= C.EOB_GROUP_START[pt + 1]:
            pt += 1
        extra = eob - C.EOB_GROUP_START[pt]
        ec.symbol(pt - 1, self.eob16[n][ptype][0],
                  {32: 11, 16: 9, 8: 7}[n])
        bits = C.EOB_OFFSET_BITS[pt]
        if bits:
            ec.symbol((extra >> (bits - 1)) & 1,
                      self.eob_extra[txs][ptype][pt], 2)
            for i in range(1, bits):
                ec.bool((extra >> (bits - 1 - i)) & 1)
        vals = lev_scan[:eob].tolist()
        bctx = base_scan[:eob].tolist()
        rctx = br_scan[:eob].tolist()
        base, base_eob = self.base[txs][ptype], self.base_eob[txs][ptype]
        br = self.br[min(txs, 3)][ptype]
        npix = n * n
        for ci in range(eob - 1, -1, -1):
            level = abs(vals[ci])
            if ci == eob - 1:
                ctx = 0 if ci == 0 else 1 if ci <= npix // 8 else \
                    2 if ci <= npix // 4 else 3
                ec.symbol(min(level, 3) - 1, base_eob[ctx], 3)
            else:
                ec.symbol(min(level, 3), base[bctx[ci]], 4)
            if level > 2:
                row = br[rctx[ci]]
                rem = level - 3
                for _ in range(4):
                    k = min(rem, 3)
                    ec.symbol(k, row, 4)
                    if k < 3:
                        break
                    rem -= 3
        cul = 0
        for ci in range(eob):
            v = vals[ci]
            if not v:
                continue
            level = abs(v)
            cul += level
            if ci == 0:
                ec.symbol(int(v < 0), self.dc_sign[ptype][dctx], 2)
            else:
                ec.bool(int(v < 0))
            if level > 14:
                x = level - 14
                length = x.bit_length()
                for _ in range(length - 1):
                    ec.bool(0)
                for i in range(length - 1, -1, -1):
                    ec.bool((x >> i) & 1)
        cul = min(cul, 63)
        dc = vals[0]
        return cul | (1 << 6) if dc < 0 else cul + (2 << 6) if dc > 0 \
            else cul

    def _block(self, st, mi_r, mi_c, bs, ym, um, planes, tx_row):
        """One intra block of bs luma at (mi_r, mi_c) after its partition
        symbol; planes: per plane (levels, base ctx, br ctx) in scan
        order."""
        ec = self.ec
        mi_rows = st["mi_rows"]
        skip = int(not any(np.any(p[0]) for p in planes))
        sg, mg = st["skip"], st["mode"]
        a_skip = sg[mi_r - 1, mi_c] if mi_r else 0
        l_skip = sg[mi_r, mi_c - 1] if mi_c else 0
        ec.symbol(skip, self.skip[a_skip + l_skip], 2)
        a_mode = mg[mi_r - 1, mi_c] if mi_r else 0
        l_mode = mg[mi_r, mi_c - 1] if mi_c else 0
        ec.symbol(ym, self.kf_y[C.INTRA_MODE_CONTEXT[a_mode]][
            C.INTRA_MODE_CONTEXT[l_mode]], 13)
        if 1 <= ym <= 8:
            ec.symbol(3, self.angle[ym - 1], 7)
        ec.symbol(um, self.uv_mode[1][ym], 14)
        if 1 <= um <= 8:
            ec.symbol(3, self.angle[um - 1], 7)
        for p in range(3):
            lev_s, base_s, br_s = planes[p]
            sh = 0 if p == 0 else 1
            n = bs >> sh
            units = n // 4
            units_v = min(units, max(0, (((mi_rows * 4) >> sh) -
                                         ((mi_r * 4) >> sh)) // 4))
            au0 = ((mi_c * 4) >> sh) // 4
            lu0 = (((mi_r * 4) >> sh) // 4) % (16 >> sh)
            acul, aav = st["above_cul"][p], st["above_av"][p]
            lcul, lav = st["left_cul"][p], st["left_av"][p]
            if skip:
                for k in range(units):
                    acul[au0 + k] = 0
                    aav[au0 + k] = 1
                    lcul[lu0 + k] = 0
                    lav[lu0 + k] = 1
                continue
            if p == 0:
                tctx = 0
            else:
                a_nz = any(aav[au0 + k] and acul[au0 + k] & 0x3F
                           for k in range(units))
                l_nz = any(lav[lu0 + k] and lcul[lu0 + k] & 0x3F
                           for k in range(units_v))
                tctx = 7 + int(a_nz) + int(l_nz)
            signs = 0
            for k in range(units):
                if aav[au0 + k]:
                    s = acul[au0 + k] >> 6
                    signs += 1 if s == 2 else -1 if s == 1 else 0
            for k in range(units_v):
                if lav[lu0 + k]:
                    s = lcul[lu0 + k] >> 6
                    signs += 1 if s == 2 else -1 if s == 1 else 0
            dctx = 2 if signs > 0 else 1 if signs < 0 else 0
            cul = self.coeffs(lev_s, base_s, br_s, n, min(p, 1), tctx, dctx,
                              tx_row if p == 0 else None)
            for k in range(units):
                acul[au0 + k] = cul
                aav[au0 + k] = 1
                lcul[lu0 + k] = cul if k < units_v else 0
                lav[lu0 + k] = 1
        rows = min(bs // 4, mi_rows - mi_r)
        sg[mi_r:mi_r + rows, mi_c:mi_c + bs // 4] = skip
        mg[mi_r:mi_r + rows, mi_c:mi_c + bs // 4] = ym

    def encode_edge(self, y_modes, uv_modes, y_lev, u_lev, v_lev, width: int,
                    height: int, true_h: int, strip) -> bytes:
        """C.TileCoder.encode with the strip: strip = (y modes [n], uv
        modes [n], luma levels [n, 16, 16], U and V levels [n, 8, 8])."""
        mi_cols, mi_rows = width // 4, true_h // 4

        def scanned(lev):
            n = lev.shape[-1]
            zz = tables.zigzag(n)
            base, br = C._contexts(lev)
            flat = lambda a: a.reshape(a.shape[:-2] + (n * n,))[..., zz]
            return flat(lev), flat(base), flat(br)

        top = [scanned(np.asarray(a)) for a in (y_lev, u_lev, v_lev)]
        e_ym, e_um = np.asarray(strip[0]), np.asarray(strip[1])
        low = [scanned(np.asarray(a)) for a in strip[2:]]
        y_modes, uv_modes = np.asarray(y_modes), np.asarray(uv_modes)
        aw = (width // 4, width // 8, width // 8)
        st = {"mi_rows": mi_rows,
              "skip": np.zeros((mi_rows, mi_cols), np.int32),
              "mode": np.zeros((mi_rows, mi_cols), np.int32),
              "above_cul": [[0] * w for w in aw],
              "above_av": [[0] * w for w in aw]}
        above_part = [0] * mi_cols
        ec = self.ec

        def part_cdf(left_part, mi_r, mi_c, bsl):
            ctx = ((left_part[mi_r % 16] >> bsl) & 1) * 2 + \
                ((above_part[mi_c] >> bsl) & 1) + 4 * bsl
            return self.partition[ctx]

        for sb_r in range(height // 64):
            left_part = [0] * 16
            st["left_cul"] = [[0] * 16 for _ in range(3)]
            st["left_av"] = [[0] * 16 for _ in range(3)]
            for sb_c in range(width // 64):
                mi_c0 = sb_c * 16
                cdf = part_cdf(left_part, sb_r * 16, mi_c0, 3)
                if sb_r * 16 + 8 < mi_rows:
                    ec.symbol(3, cdf, 10)
                else:
                    self._split_at_bottom(cdf)
                for qr, qc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    br_, bc = sb_r * 2 + qr, sb_c * 2 + qc
                    mi_r, mi_c = br_ * 8, bc * 8
                    if mi_r >= mi_rows:
                        continue
                    if mi_r + 4 >= mi_rows:
                        # the strip: split_or_horz SPLIT at 32, then the
                        # two in-frame 16x16 NONE blocks
                        self._split_at_bottom(part_cdf(left_part, mi_r,
                                                       mi_c, 2))
                        for j in range(2):
                            k, c = 2 * bc + j, mi_c + 4 * j
                            ec.symbol(0, part_cdf(left_part, mi_r, c, 1), 10)
                            ym = int(e_ym[k])
                            self._block(st, mi_r, c, 16, ym, int(e_um[k]),
                                        [tuple(a[k] for a in p) for p in low],
                                        self.tx16[ym])
                            above_part[c:c + 4] = [28] * 4
                            left_part[mi_r % 16:mi_r % 16 + 4] = [28] * 4
                        continue
                    ec.symbol(0, part_cdf(left_part, mi_r, mi_c, 2), 10)
                    self._block(st, mi_r, mi_c, 32, int(y_modes[br_, bc]),
                                int(uv_modes[br_, bc]),
                                [tuple(a[br_, bc] for a in p) for p in top],
                                None)
                    above_part[mi_c:mi_c + 8] = [24] * 8
                    left_part[qr * 8:qr * 8 + 8] = [24] * 8
        return ec.done()


def host_stage(y_modes, uv_modes, y_lev, u_lev, v_lev, strip, width: int,
               height: int, qindex: int, lf: tuple, cdf_update: bool) -> bytes:
    """C.host_stage of an m = 12 frame with its strip (encode_edge's)."""
    tile = TileCoder(qindex, cdf_update).encode_edge(
        y_modes, uv_modes, y_lev, u_lev, v_lev, width, y_lev.shape[0] * 32,
        height, strip)
    return C.key_frame_payload(tile, width, height, qindex, lf, cdf_update)
