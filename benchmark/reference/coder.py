"""Plain Python reference of the flat all-intra host stage.

What ``IntraEncoder.host_finish`` writes on the flat path for a frame that
is not the stream's first: a temporal delimiter and one OBU_FRAME (the key
frame's uncompressed header, then one tile of 64x64 superblocks split into
32x32 blocks, each with its skip flag, luma mode, uv mode and the
coefficients of its 32x32 luma and two 16x16 chroma transforms), coded by
the AV1 range coder with per-symbol CDF adaptation (spec §8.2, §8.4).  It
follows the syntax of the port's C tile coder (``native/tile_coder.c``)
and the header writer (``encoder/headers.py``) symbol for symbol, written
anew in Python over frozen default CDFs, so that no change to the program
moves it.

The context of every base and range symbol depends only on the block's
final levels, so both are worked out for all blocks of a plane at once
with numpy (``_contexts``); the range coder itself runs symbol by symbol.
"""

from __future__ import annotations

import numpy as np

from . import tables

EOB_GROUP_START = (0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513)
EOB_OFFSET_BITS = (0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)


class RangeEncoder:
    """Daala/AV1 multi-symbol range encoder; a CDF is a list of n inverse
    cumulative probabilities (the last 0) and an adaptation counter."""

    def __init__(self, adapt: bool):
        self.low, self.rng, self.cnt = 0, 0x8000, -9
        self.out = []
        self.adapt = adapt

    def _norm(self, low: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.out.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.out.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & 0xFFFFFFFF
        self.rng = (rng << d) & 0xFFFF
        self.cnt = s

    def symbol(self, s: int, cdf: list, n: int, adapt: bool = True) -> None:
        r = self.rng
        fh = cdf[s]
        if s > 0:
            u = ((r >> 8) * (cdf[s - 1] >> 6) >> 1) + 4 * (n - s)
            v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - 1 - s)
            self._norm(self.low + r - u, u - v)
        else:
            self._norm(self.low, r - (((r >> 8) * (fh >> 6) >> 1) +
                                      4 * (n - 1)))
        if adapt and self.adapt:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + (
                0 if n < 2 else 1 if n < 4 else 2)
            for i in range(n - 1):
                c = cdf[i]
                cdf[i] = c + ((32768 - c) >> rate) if i < s else \
                    c - (c >> rate)
            if count < 32:
                cdf[n] = count + 1

    def bool(self, val: int) -> None:
        """An equiprobable bit."""
        r = self.rng
        v = ((r >> 8) * (0x4000 >> 6) >> 1) + 4
        if val:
            self._norm(self.low + r - v, v)
        else:
            self._norm(self.low, r - v)

    def done(self) -> bytes:
        c, s = self.cnt, self.cnt + 10
        m = 0x3FFF
        e = ((self.low + m) & ~m) | (m + 1)
        buf = list(self.out)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while s > 0:
                buf.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
        out = bytearray(len(buf))
        carry = 0
        for i in range(len(buf) - 1, -1, -1):
            carry += buf[i]
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)


def _contexts(lev: np.ndarray) -> tuple:
    """Base and range contexts of every position of blocks lev [..., n, n]
    (spec get_coeff_base_ctx / get_br_ctx for the 2D class, square)."""
    n = lev.shape[-1]
    a = np.abs(lev).astype(np.int32)
    p = np.zeros(a.shape[:-2] + (n + 2, n + 2), np.int32)
    p[..., :n, :n] = a
    c3 = np.minimum(p, 3)
    at = lambda q, r, c: q[..., r:r + n, c:c + n]
    mag = at(c3, 0, 1) + at(c3, 1, 0) + at(c3, 1, 1) + at(c3, 0, 2) + \
        at(c3, 2, 0)
    r, c = np.arange(n)[:, None], np.arange(n)[None, :]
    off = np.where(r + c < 2, 1, np.where(r + c < 4, 6, 21))
    base = np.minimum((mag + 1) >> 1, 4) + off
    base[..., 0, 0] = 0
    c127 = np.minimum(p, 127)
    mb = np.minimum((at(c127, 0, 1) + at(c127, 1, 0) + at(c127, 1, 1) + 1)
                    >> 1, 6)
    br = mb + np.where((r == 0) & (c == 0), 0,
                       np.where((r < 2) & (c < 2), 7, 14))
    return base, br


class TileCoder:
    """The flat all-intra tile of one frame (one tile, 32x32 blocks)."""

    def __init__(self, qindex: int, adapt: bool):
        t = tables.spec()
        qc = tables.q_ctx(qindex)
        coef = lambda k: t[k][qc].astype(np.int64).tolist()
        self.txb_skip = coef("txb_skip_cdf")
        self.eob16 = {16: coef("eob_flag_cdf256"), 32: coef("eob_flag_cdf1024")}
        self.eob_extra = coef("eob_extra_cdf")
        self.base_eob = coef("coeff_base_eob_cdf")
        self.base = coef("coeff_base_cdf")
        self.br = coef("coeff_br_cdf")
        self.dc_sign = coef("dc_sign_cdf")
        mode = lambda k: t[k].astype(np.int64).tolist()
        self.partition = mode("partition_cdf")
        self.skip = mode("skip_cdfs")
        self.kf_y = mode("kf_y_cdf")
        self.uv_mode = mode("uv_mode_cdf")
        self.angle = mode("angle_delta_cdf")
        self.ec = RangeEncoder(adapt)

    def coeffs(self, lev_scan, base_scan, br_scan, n: int, ptype: int,
               tctx: int, dctx: int) -> int:
        """One transform block, its levels, contexts in scan order: writes
        the block and returns its cul_level (sum, dc sign in bits 6+)."""
        ec = self.ec
        txs = 3 if n == 32 else 2
        nz = np.flatnonzero(lev_scan)
        eob = int(nz[-1]) + 1 if len(nz) else 0
        ec.symbol(int(eob == 0), self.txb_skip[txs][tctx], 2)
        if eob == 0:
            return 0
        pt = 0
        while pt < 11 and eob >= EOB_GROUP_START[pt + 1]:
            pt += 1
        extra = eob - EOB_GROUP_START[pt]
        ec.symbol(pt - 1, self.eob16[n][ptype][0], 11 if n == 32 else 9)
        bits = EOB_OFFSET_BITS[pt]
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

    def _split_at_bottom(self, cdf: list) -> None:
        """The SB's partition where it crosses the frame bottom: one bool,
        SPLIT, with P(split) gathered from the partition CDF, not adapted
        (spec §5.11.4 split_or_horz)."""
        psum = 0
        for s in (2, 3, 4, 6, 7, 9):
            psum += cdf[s - 1] - (cdf[s] if s < 9 else 0)
        self.ec.symbol(1, [psum, 0, 0], 2, adapt=False)

    def encode(self, y_modes, uv_modes, y_lev, u_lev, v_lev, width: int,
               height: int, true_h: int) -> bytes:
        """y_modes, uv_modes [bh, bw]; y_lev [bh, bw, 32, 32]; u_lev, v_lev
        [bh, bw, 16, 16]: the tile's bytes."""
        mi_cols, mi_rows = width // 4, true_h // 4
        planes = []
        for lev in (y_lev, u_lev, v_lev):
            n = lev.shape[-1]
            zz = tables.zigzag(n)
            flat = lambda a: a.reshape(a.shape[:2] + (n * n,))[..., zz]
            base, br = _contexts(lev)
            planes.append((flat(lev), flat(base), flat(br), n))
        coded = [np.asarray(lev != 0).reshape(lev.shape[:2] + (-1,)).any(-1)
                 for lev in (y_lev, u_lev, v_lev)]
        skip_blk = ~(coded[0] | coded[1] | coded[2])
        y_modes, uv_modes = np.asarray(y_modes), np.asarray(uv_modes)
        above_part = [0] * mi_cols
        skip_grid = np.zeros((mi_rows, mi_cols), np.int32)
        mode_grid = np.zeros((mi_rows, mi_cols), np.int32)
        aw = (width // 4, width // 8, width // 8)
        above_cul = [[0] * w for w in aw]
        above_av = [[0] * w for w in aw]
        ec = self.ec
        for sb_r in range(height // 64):
            left_part = [0] * 16
            left_cul = [[0] * 16 for _ in range(3)]
            left_av = [[0] * 16 for _ in range(3)]
            for sb_c in range(width // 64):
                mi_c0 = sb_c * 16
                ctx = ((left_part[0] >> 3) & 1) * 2 + \
                    ((above_part[mi_c0] >> 3) & 1) + 12
                if sb_r * 16 + 8 < mi_rows:
                    ec.symbol(3, self.partition[ctx], 10)
                else:
                    self._split_at_bottom(self.partition[ctx])
                for qr, qc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    br_, bc = sb_r * 2 + qr, sb_c * 2 + qc
                    mi_r, mi_c = br_ * 8, bc * 8
                    if mi_r >= mi_rows:
                        continue
                    ctx = ((left_part[qr * 8] >> 2) & 1) * 2 + \
                        ((above_part[mi_c] >> 2) & 1) + 8
                    ec.symbol(0, self.partition[ctx], 10)
                    skip = int(skip_blk[br_, bc])
                    a_skip = skip_grid[mi_r - 1, mi_c] if mi_r else 0
                    l_skip = skip_grid[mi_r, mi_c - 1] if mi_c else 0
                    ec.symbol(skip, self.skip[a_skip + l_skip], 2)
                    ym = int(y_modes[br_, bc])
                    a_mode = mode_grid[mi_r - 1, mi_c] if mi_r else 0
                    l_mode = mode_grid[mi_r, mi_c - 1] if mi_c else 0
                    ec.symbol(ym, self.kf_y[INTRA_MODE_CONTEXT[a_mode]][
                        INTRA_MODE_CONTEXT[l_mode]], 13)
                    if 1 <= ym <= 8:
                        ec.symbol(3, self.angle[ym - 1], 7)
                    um = int(uv_modes[br_, bc])
                    ec.symbol(um, self.uv_mode[1][ym], 14)
                    if 1 <= um <= 8:
                        ec.symbol(3, self.angle[um - 1], 7)
                    for p in range(3):
                        lev_s, base_s, br_s, n = planes[p]
                        sh = 0 if p == 0 else 1
                        units = (32 >> sh) // 4
                        units_v = min(units, max(
                            0, (((mi_rows * 4) >> sh) - ((mi_r * 4) >> sh))
                            // 4))
                        au0 = ((bc * 32) >> sh) // 4
                        lu0 = (((br_ * 32) >> sh) // 4) % (16 >> sh)
                        if skip:
                            for k in range(units):
                                above_cul[p][au0 + k] = 0
                                above_av[p][au0 + k] = 1
                                left_cul[p][lu0 + k] = 0
                                left_av[p][lu0 + k] = 1
                            continue
                        if p == 0:
                            tctx = 0
                        else:
                            a_nz = any(above_av[p][au0 + k] and
                                       above_cul[p][au0 + k] & 0x3F
                                       for k in range(units))
                            l_nz = any(left_av[p][lu0 + k] and
                                       left_cul[p][lu0 + k] & 0x3F
                                       for k in range(units_v))
                            tctx = 7 + int(a_nz) + int(l_nz)
                        signs = 0
                        for k in range(units):
                            if above_av[p][au0 + k]:
                                s = above_cul[p][au0 + k] >> 6
                                signs += 1 if s == 2 else -1 if s == 1 else 0
                        for k in range(units_v):
                            if left_av[p][lu0 + k]:
                                s = left_cul[p][lu0 + k] >> 6
                                signs += 1 if s == 2 else -1 if s == 1 else 0
                        dctx = 2 if signs > 0 else 1 if signs < 0 else 0
                        cul = self.coeffs(lev_s[br_, bc], base_s[br_, bc],
                                          br_s[br_, bc], n, min(p, 1), tctx,
                                          dctx)
                        for k in range(units):
                            above_cul[p][au0 + k] = cul
                            above_av[p][au0 + k] = 1
                            left_cul[p][lu0 + k] = cul if k < units_v else 0
                            left_av[p][lu0 + k] = 1
                    rows8 = min(8, mi_rows - mi_r)
                    skip_grid[mi_r:mi_r + rows8, mi_c:mi_c + 8] = skip
                    mode_grid[mi_r:mi_r + rows8, mi_c:mi_c + 8] = ym
                    above_part[mi_c:mi_c + 8] = [24] * 8
                    left_part[qr * 8:qr * 8 + 8] = [24] * 8
        return ec.done()


# ---------------------------------------------------------------- OBUs

class BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, value: int, n: int) -> None:
        self.bits.extend((value >> i) & 1 for i in range(n - 1, -1, -1))

    def data(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, b[i:i + 8])), 2)
                     for i in range(0, len(b), 8))


def _leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        byte, v = v & 0x7F, v >> 7
        out.append(byte | (0x80 if v else 0))
        if not v:
            return bytes(out)


def obu(obu_type: int, payload: bytes) -> bytes:
    return bytes([(obu_type << 3) | 2]) + _leb128(len(payload)) + payload


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def frame_header(width: int, height: int, qindex: int, lf: tuple,
                 cdf_update: bool) -> bytes:
    """The uncompressed header of a shown key frame with one tile, no
    segmentation, delta q or in-loop filter beyond deblocking (spec
    §5.9.2), byte aligned."""
    w = BitWriter()
    w.f(0, 1)                       # show_existing_frame
    w.f(0, 2)                       # KEY_FRAME
    w.f(1, 1)                       # show_frame
    w.f(0 if cdf_update else 1, 1)  # disable_cdf_update
    w.f(0, 1)                       # frame_size_override_flag
    w.f(0, 1)                       # render_and_frame_size_different
    if cdf_update:
        w.f(1, 1)                   # disable_frame_end_update_cdf
    sb_cols, sb_rows = -(-width // 64), -(-height // 64)
    min_cols = _tile_log2(64, sb_cols)
    if max(min_cols, _tile_log2(2304, sb_rows * sb_cols)) > 0:
        raise NotImplementedError("frame size forces several tiles")
    w.f(1, 1)                       # uniform_tile_spacing_flag
    if _tile_log2(1, min(sb_cols, 64)) > 0:
        w.f(0, 1)                   # increment_tile_cols_log2
    if _tile_log2(1, min(sb_rows, 64)) > 0:
        w.f(0, 1)                   # increment_tile_rows_log2
    w.f(qindex, 8)
    w.f(0, 3)                       # delta_q y dc, u dc, u ac
    w.f(0, 1)                       # using_qmatrix
    w.f(0, 1)                       # segmentation_enabled
    if qindex:
        w.f(0, 1)                   # delta_q_present
    w.f(lf[0], 6)
    w.f(lf[0], 6)
    if lf[0]:
        w.f(lf[1], 6)
        w.f(lf[1], 6)
    w.f(0, 3)                       # sharpness
    w.f(0, 1)                       # loop_filter_delta_enabled
    w.f(0, 1)                       # tx_mode_select: TX_MODE_LARGEST
    w.f(1, 1)                       # reduced_tx_set
    return w.data()


def key_frame_payload(tile: bytes, width: int, height: int, qindex: int,
                      lf: tuple, cdf_update: bool) -> bytes:
    """Temporal delimiter + OBU_FRAME of a key frame after the first."""
    return obu(2, b"") + obu(6, frame_header(width, height, qindex, lf,
                                             cdf_update) + tile)


def host_stage(y_modes, uv_modes, y_lev, u_lev, v_lev, width: int,
               height: int, qindex: int, lf: tuple, cdf_update: bool) -> bytes:
    """The payload of one frame from its device stage: mode maps [bh, bw],
    levels [bh, bw, 32, 32] and [bh, bw, 16, 16] (numpy)."""
    tile = TileCoder(qindex, cdf_update).encode(
        y_modes, uv_modes, y_lev, u_lev, v_lev, width, y_lev.shape[0] * 32,
        height)
    return key_frame_payload(tile, width, height, qindex, lf, cdf_update)
