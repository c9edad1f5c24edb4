"""Tile entropy coder of the partition path: key, single-reference and
compound inter frames, 64x64 NONE or SPLIT into 32x32 blocks, each NONE or
SPLIT into 16x16 leaves (chroma 32/16/8).

Counterpart of ``svtav1_tpu/encoder/tile_codec.py`` (with
``tile_inter.choose_inter_mode``), cut to no 16x8 bottom strip
(``geometry.check_dims`` and the bottom force masks exclude it on this
path).  One coder codes one tile column (the whole frame with one tile):
its maps are the tile's, its contexts and MV stacks stop at the tile's
edges, and ``mi_col_off`` / ``frame_mi_cols`` place it in the frame for
the frame-relative parts (the MV stack clamp, the CCSO units).  In inter frames (kf=False) each block codes is_inter; an
inter block codes the LAST reference, its mode against the block's MV
stack (NEARESTMV / NEARMV / GLOBALMV when its mv equals that predictor,
NEWMV otherwise, with the DRL index and the mv residual) and its
residuals with the inter tx set (DCT only); an intra block codes its y
mode from the inter frame's y_mode CDF.  A compound frame (comp=True,
REFERENCE_MODE_SELECT) codes comp_mode on every inter block; its
compound blocks (lanes 3 and 4) code the LAST+ALTREF pair and
NEAREST_NEARESTMV, GLOBAL_GLOBALMV or NEW_NEWMV against the pair's stack,
with four mv components.  It codes the
in-loop filters' block-level syntax: the CDEF index, the CCSO unit flags
and the loop-restoration units.  The reference analogue is
svt_aom_write_sb's recursive partition walk (EbEntropyCoding.c:5440).
Pure Python over numpy: it runs on the host.
"""

from __future__ import annotations

import numpy as np

from ..ec import inter_modes as IM
from ..ec import lr_syntax as LRS
from ..ec import modes as M
from ..ec.coeffs import write_coeffs_txb
from ..ec.mvpred import MiGrid, find_mv_stack
from ..ec.range_coder import RangeEncoder
from ..spec import mv as MV
from ..spec.cdf import CdfContext
from ..spec.txfm import DCT_DCT, TX_8X8, TX_16X16, TX_32X32, TX_64X64
from .wavefront2 import TX_SEARCH_TYPES

SB = 64

# size_group_lookup per luma block size (intra y-mode CDF of inter frames)
SIZE_GROUP = {64: 3, 32: 3, 16: 2}


def choose_inter_mode(mv, res, gm=(0, 0)):
    """The inter mode that codes mv against the block's stack res (the
    inverse of the decoder's assign_mv): NEARESTMV / NEARMV when it equals
    that predictor, GLOBALMV when it equals the frame's translation gm,
    else NEWMV against the precision-lowered stack[0] (res.nearest_mv).
    Returns (mode, the NEWMV predictor or None)."""
    if tuple(mv) == res.nearest_mv:
        return MV.NEARESTMV, None
    if tuple(mv) == res.near_mv:
        return MV.NEARMV, None
    if tuple(mv) == tuple(gm):
        return MV.GLOBALMV, None
    return MV.NEWMV, res.nearest_mv


class TileCoder:
    """One tile of a frame (the whole frame with one tile column)."""

    def __init__(self, width, height, qindex, cdf_update, true_h=None,
                 cdef_bits: int = 0, cdef_idx=None, kf: bool = True,
                 cdf_init=None, gm_mv=(0, 0), comp: bool = False,
                 mi_col_off: int = 0, frame_mi_cols: int = None):
        """width/height are the padded (SB-aligned) plane dims the block
        maps were produced at; true_h (<= height, multiple of 8) is the
        signalled frame height: blocks whose top-left falls outside it are
        not coded and blocks crossing it use the spec's inferred edge
        partitions (split_or_horz).  cdef_idx [sb_rows, sb_cols] (None:
        the frame has no CDEF syntax) is coded as a cdef_bits literal at
        the first non-skip block of each 64x64 (EbEntropyCoding.c:3968
        write_cdef).  kf=False codes an inter frame: cdf_init (a CDF
        snapshot, the primary reference frame's) seeds its CDFs, and gm_mv
        is the frame's translation global mv of LAST (1/8 pel, identity
        (0, 0)), which GLOBALMV blocks take.  comp=True codes a compound
        frame: lanes 3 and 4 are LAST+ALTREF blocks and the mv maps carry
        four components (the ALTREF mv last).  A tile column: width is
        the tile's, mi_col_off its first 4x4 column in the frame and
        frame_mi_cols the frame's 4x4 columns; cdef_idx and the LR units
        are the tile's slices, the CCSO info the frame's."""
        self.w, self.h = width, height
        self.mi_col_off = mi_col_off
        self.frame_mi_cols = frame_mi_cols or width // 4
        self.kf = kf
        self.true_h = true_h if true_h is not None else height
        self.mi_cols, self.mi_rows = width // 4, self.true_h // 4
        self.enc = RangeEncoder()
        self.cdf = (cdf_init.clone() if cdf_init is not None
                    else CdfContext(qindex, update=cdf_update))
        self.gm_mv = tuple(gm_mv)
        self.comp = comp
        # the mode info the inter branch's mv stack and contexts read
        self.grid = None if kf else MiGrid(self.mi_rows, self.mi_cols)
        # inter modes coded, by mode (NEARESTMV..NEWMV, and the compound
        # modes of a compound frame); intra blocks of an inter frame
        self.mode_counts = dict.fromkeys(
            (MV.NEARESTMV, MV.NEARMV, MV.GLOBALMV, MV.NEWMV) +
            ((MV.NEAREST_NEARESTMV, MV.GLOBAL_GLOBALMV, MV.NEW_NEWMV)
             if comp else ()), 0)
        self.n_intra = 0
        self.above_part = np.zeros(self.mi_cols, np.uint8)
        self.skip_grid = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.mode_grid = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.above_cul = {0: np.zeros(width // 4, np.uint8),
                          1: np.zeros(width // 8, np.uint8),
                          2: np.zeros(width // 8, np.uint8)}
        self.above_av = {p: np.zeros_like(self.above_cul[p], bool)
                         for p in range(3)}
        self.cdef_idx = cdef_idx
        self.cdef_bits = cdef_bits
        self._cdef_pending = False
        # CCSO (fork graft): the search's info dict, whose per-plane
        # [uh, uw] flag grids (256x256 luma units) are coded as one CDF2
        # symbol per enabled plane at the first block of each aligned unit
        # (EbEntropyCoding.c:4008 write_ccso); None -> no CCSO syntax
        self.ccso_info = None
        # loop restoration: per-plane frame types and units dicts of
        # [sb_rows, sb_cols(, k)] arrays, coded at SB start
        # (EbEntropyCoding.c:4150)
        self.lr_types = (0, 0, 0)
        self.lr_units = None
        self._lr_ref = None

    def set_lr(self, lr_types, lr_units):
        self.lr_types = tuple(lr_types)
        self.lr_units = lr_units
        self._lr_ref = [LRS.default_ref_state() for _ in range(3)]

    def _write_lr_sb(self, sb_r, sb_c):
        if self.lr_units is None:
            return
        for p in range(3):
            if self.lr_types[p] == LRS.RESTORE_NONE:
                continue
            u = self.lr_units[p]
            unit = {"eps": u["eps"][sb_r, sb_c],
                    "xqd": u["xqd"][sb_r, sb_c],
                    "taps_v": list(u["taps_v"][sb_r, sb_c]),
                    "taps_h": list(u["taps_h"][sb_r, sb_c])}
            LRS.write_lr_unit(self.enc, self.cdf, self.lr_types[p],
                              int(u["type"][sb_r, sb_c]), unit,
                              self._lr_ref[p], p > 0)

    def encode(self, part, mi_top, lev_top_y, lev_top_u, lev_top_v,
               mi_sub, lev_sub_y, lev_sub_u, lev_sub_v, cands_top,
               cands_sub, stx_sub, part_sb, mi_sb, lev_sb_y, lev_sb_u,
               lev_sb_v, uv_top, uv_sub, uv_sb, mv_top=None, mv_sub=None,
               mv_sb=None):
        """part [bh, bw] 0/1; *_top at 32-block granularity; *_sub indexed
        [bh, bw, 4 (z), ...]; stx_sub [bh, bw, 4] indexes TX_SEARCH_TYPES.
        part_sb [sbh, sbw] (0 = 64x64 NONE, 1 = split): a NONE SB codes one
        64x64 block whose luma TXB is TX_64X64 with the 32x32 coded area
        lev_sb_y, chroma TX_32X32 (lev_sb_u/v).  uv_top [bh, bw] / uv_sub
        [bh, bw, 4] / uv_sb [sbh, sbw]: the chroma modes.  Inter frames:
        a mode index past the candidate list marks an inter block, whose mv
        (1/8 pel) mv_top [bh, bw, 2] / mv_sub [bh, bw, 4, 2] / mv_sb [sbh,
        sbw, 2] holds.  Returns (tile bytes, the adapted CdfContext)."""
        self._uv_top, self._uv_sub = uv_top, uv_sub
        enc, cdf = self.enc, self.cdf
        sb_cols = self.w // SB
        sb_rows = (self.mi_rows + 15) // 16
        for sb_r in range(sb_rows):
            self.left_part = np.zeros(SB // 4, np.uint8)
            self.left_cul = {0: np.zeros(SB // 4, np.uint8),
                             1: np.zeros(SB // 8, np.uint8),
                             2: np.zeros(SB // 8, np.uint8)}
            self.left_av = {p: np.zeros_like(self.left_cul[p], bool)
                            for p in range(3)}
            for sb_c in range(sb_cols):
                self._cdef_pending = self.cdef_idx is not None
                self._write_lr_sb(sb_r, sb_c)
                ctx = M.partition_plane_ctx(int(self.above_part[sb_c * 16]),
                                            int(self.left_part[0]), SB)
                sb_has_rows = sb_r * 16 + 8 < self.mi_rows
                if not part_sb[sb_r, sb_c] and sb_has_rows:
                    M.write_partition(enc, cdf, ctx, M.PARTITION_NONE, SB)
                    self._code_block(sb_r * 16, sb_c * 16, 64,
                                     int(mi_sb[sb_r, sb_c]), cands_top,
                                     lev_sb_y[sb_r, sb_c],
                                     lev_sb_u[sb_r, sb_c],
                                     lev_sb_v[sb_r, sb_c], TX_64X64,
                                     TX_32X32, uv_mode=int(uv_sb[sb_r, sb_c]),
                                     mv=_at(mv_sb, sb_r, sb_c))
                    a, l = M.partition_ctx_value(64, 64)
                    self.above_part[sb_c * 16:sb_c * 16 + 16] = a
                    self.left_part[:] = l
                    continue
                if sb_has_rows:
                    M.write_partition(enc, cdf, ctx, M.PARTITION_SPLIT, SB)
                else:
                    M.write_partition_edge(enc, cdf, ctx, True, SB,
                                           False, True)
                for qr, qc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    br, bc = sb_r * 2 + qr, sb_c * 2 + qc
                    if br * 8 >= self.mi_rows:
                        continue       # 32-quad entirely below the frame
                    self._code_32(br, bc, qr, part, mi_top, lev_top_y,
                                  lev_top_u, lev_top_v, mi_sub, lev_sub_y,
                                  lev_sub_u, lev_sub_v, cands_top, cands_sub,
                                  stx_sub, mv_top, mv_sub)
        return enc.done(), cdf

    # ---------------------------------------------------------------- #

    def _code_32(self, br, bc, qr, part, mi_top, ly, lu, lv, mi_sub, sly,
                 slu, slv, cands_top, cands_sub, stx_sub, mv_top=None,
                 mv_sub=None):
        enc, cdf = self.enc, self.cdf
        mi_r, mi_c = br * 8, bc * 8
        ctx = M.partition_plane_ctx(int(self.above_part[mi_c]),
                                    int(self.left_part[qr * 8]), 32)
        has_rows32 = mi_r + 4 < self.mi_rows
        if not part[br, bc] and has_rows32:
            M.write_partition(enc, cdf, ctx, M.PARTITION_NONE, 32)
            self._code_block(mi_r, mi_c, 32, int(mi_top[br, bc]), cands_top,
                             ly[br, bc], lu[br, bc], lv[br, bc], TX_32X32,
                             TX_16X16, uv_mode=int(self._uv_top[br, bc]),
                             mv=_at(mv_top, br, bc))
            a, l = M.partition_ctx_value(32, 32)
            self.above_part[mi_c:mi_c + 8] = a
            self.left_part[qr * 8:qr * 8 + 8] = l
            return
        if has_rows32:
            M.write_partition(enc, cdf, ctx, M.PARTITION_SPLIT, 32)
        else:
            M.write_partition_edge(enc, cdf, ctx, True, 32, False, True)
        for z, (sr, sc) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            smr, smc = mi_r + sr * 4, mi_c + sc * 4
            if smr >= self.mi_rows:
                continue               # 16-leaf below the frame
            if smr + 2 >= self.mi_rows:
                raise ValueError("a 16x16 leaf crossing the frame bottom "
                                 "needs a 16x8 strip block (not ported)")
            lctx = M.partition_plane_ctx(
                int(self.above_part[smc]),
                int(self.left_part[qr * 8 + sr * 4]), 16)
            M.write_partition(enc, cdf, lctx, M.PARTITION_NONE, 16)
            stx = TX_SEARCH_TYPES[int(stx_sub[br, bc, z])]
            self._code_block(smr, smc, 16, int(mi_sub[br, bc, z]), cands_sub,
                             sly[br, bc, z], slu[br, bc, z], slv[br, bc, z],
                             TX_16X16, TX_8X8, y_tx_type=stx,
                             uv_mode=int(self._uv_sub[br, bc, z]),
                             mv=_at(mv_sub, br, bc, z))
            a, l = M.partition_ctx_value(16, 16)
            self.above_part[smc:smc + 4] = a
            self.left_part[qr * 8 + sr * 4:qr * 8 + sr * 4 + 4] = l

    # ---------------------------------------------------------------- #

    def _code_block(self, mi_r, mi_c, bs, idx, cands, y_lev, u_lev, v_lev,
                    tx_y, tx_uv, y_tx_type=DCT_DCT, uv_mode: int = 0,
                    mv=None):
        enc, cdf = self.enc, self.cdf
        bw4 = bs // 4
        have_above, have_left = mi_r > 0, mi_c > 0
        is_inter = idx >= len(cands)
        skip = int(not (y_lev.any() or u_lev.any() or v_lev.any()))

        a_skip = int(self.skip_grid[mi_r - 1, mi_c]) if have_above else 0
        l_skip = int(self.skip_grid[mi_r, mi_c - 1]) if have_left else 0
        M.write_skip(enc, cdf, a_skip + l_skip, skip)

        if self._cdef_pending and not skip:
            v = int(self.cdef_idx[mi_r // 16, mi_c // 16])
            for i in range(self.cdef_bits - 1, -1, -1):
                enc.encode_bool((v >> i) & 1, 0x4000)
            self._cdef_pending = False

        # CCSO unit flags: at the first block of each 256x256-luma-aligned
        # unit, one CDF2 symbol per enabled plane, regardless of skip
        fc = mi_c + self.mi_col_off
        if self.ccso_info is not None and mi_r % 64 == 0 and fc % 64 == 0:
            ur, uc = mi_r // 64, fc // 64
            for p in range(3):
                pi = self.ccso_info["planes"][p]
                if pi is not None:
                    t = cdf.ccso_cdf[p]
                    f = int(pi["flags"][ur, uc])
                    enc.encode_symbol(f, t)
                    cdf.update(t, f)

        if not self.kf:
            grid = self.grid
            IM.write_is_inter(enc, cdf, IM.intra_inter_ctx(
                grid.is_inter(mi_r - 1, mi_c) if have_above else None,
                grid.is_inter(mi_r, mi_c - 1) if have_left else None),
                is_inter)
        if is_inter:
            self._code_inter(mi_r, mi_c, bw4, mv, idx - len(cands))
            mode, y_tx_type = 0, DCT_DCT
        else:
            mode, delta = cands[idx]
            if self.kf:
                a_mode = (int(self.mode_grid[mi_r - 1, mi_c]) if have_above
                          else 0)
                l_mode = (int(self.mode_grid[mi_r, mi_c - 1]) if have_left
                          else 0)
                M.write_kf_y_mode(enc, cdf, a_mode, l_mode, mode)
            else:
                IM.write_y_mode_inter(enc, cdf, mode, SIZE_GROUP[bs])
            if M.is_directional(mode):
                M.write_angle_delta(enc, cdf, mode, delta)
            # CfL is allowed for blocks <= 32x32 only (spec 5.11.5
            # intra_frame_mode_info); 64x64 blocks use the 13-symbol CDF
            M.write_uv_mode(enc, cdf, bs <= 32, mode, uv_mode)
            if M.is_directional(uv_mode):
                M.write_angle_delta(enc, cdf, uv_mode, 0)
            self.mode_grid[mi_r:mi_r + bw4, mi_c:mi_c + bw4] = mode
            if not self.kf:
                self.grid.set_block(mi_r, mi_c, bw4, bw4, MV.INTRA_FRAME,
                                    mode)
                self.n_intra += 1

        self._code_residuals(mi_r, mi_c, bs, skip, mode, y_lev, u_lev,
                             v_lev, tx_y, tx_uv, y_tx_type, is_inter)
        self.skip_grid[mi_r:mi_r + bw4, mi_c:mi_c + bw4] = skip

    def _code_inter(self, mi_r, mi_c, bw4, mv, lane):
        """The block's reference (LAST, or in a compound frame the comp
        mode and, on lanes 3-4, the LAST+ALTREF pair), its mode, DRL index
        and mv(s)."""
        enc, cdf, grid = self.enc, self.cdf, self.grid
        have_above, have_left = mi_r > 0, mi_c > 0

        def nb_ref(r, c, avail):
            if not avail or grid.ref0[r, c] < 1:
                return None
            r0, r1 = int(grid.ref0[r, c]), int(grid.ref1[r, c])
            return (r0, r1) if r1 >= 1 else r0

        counts = IM.neighbor_ref_counts(nb_ref(mi_r - 1, mi_c, have_above),
                                        nb_ref(mi_r, mi_c - 1, have_left))
        if self.comp:
            nb_info = lambda r, c, avail: (
                (grid.ref0[r, c] >= 1, int(grid.ref0[r, c]),
                 int(grid.ref1[r, c])) if avail else None)
            a_i = nb_info(mi_r - 1, mi_c, have_above)
            l_i = nb_info(mi_r, mi_c - 1, have_left)
            IM.write_comp_mode(enc, cdf, IM.ref_mode_ctx(a_i, l_i),
                               lane >= 3)
            if lane >= 3:
                self._code_compound(mi_r, mi_c, bw4, mv, a_i, l_i, counts)
                return
        IM.write_ref_frame_last(enc, cdf, counts)
        mvv = (int(mv[0]), int(mv[1]))
        res = find_mv_stack(grid, mi_r, mi_c, bw4, bw4,
                            mi_col_off=self.mi_col_off,
                            frame_mi_cols=self.frame_mi_cols,
                            gm_mv=self.gm_mv)
        mode, ref_mv = choose_inter_mode(mvv, res, gm=self.gm_mv)
        IM.write_inter_mode(enc, cdf, mode, res.mode_context)
        if mode in (MV.NEWMV, MV.NEARMV):
            IM.write_drl_idx(enc, cdf, mode, res.stack, res.num_found)
        if mode == MV.NEWMV:
            IM.write_mv(enc, cdf, mvv, ref_mv)
        grid.set_block(mi_r, mi_c, bw4, bw4, MV.LAST_FRAME, mode, *mvv)
        self.mode_counts[mode] += 1

    def _code_compound(self, mi_r, mi_c, bw4, mv, a_i, l_i, counts):
        """A LAST+ALTREF block: the pair, then NEAREST_NEARESTMV when its
        four mv components equal the pair stack's precision-lowered first
        entry, GLOBAL_GLOBALMV when they are all zero (compound frames fit
        no global motion), else NEW_NEWMV with the DRL index and both mv
        residuals against that entry."""
        enc, cdf, grid = self.enc, self.cdf, self.grid
        IM.write_comp_refs_last_altref(enc, cdf, a_i, l_i, counts)
        mvp = tuple(int(v) for v in mv[:4])
        res = find_mv_stack(grid, mi_r, mi_c, bw4, bw4,
                            ref_frame=(MV.LAST_FRAME, MV.ALTREF_FRAME),
                            mi_col_off=self.mi_col_off,
                            frame_mi_cols=self.frame_mi_cols)
        s0 = res.ref_list[0]
        p0 = (MV.lower_mv_precision(s0[0], s0[1]) +
              MV.lower_mv_precision(s0[2], s0[3]))
        if mvp == p0:
            mode = MV.NEAREST_NEARESTMV
        elif mvp == (0, 0, 0, 0):
            mode = MV.GLOBAL_GLOBALMV
        else:
            mode = MV.NEW_NEWMV
        IM.write_inter_compound_mode(enc, cdf, mode, res.mode_context)
        if mode == MV.NEW_NEWMV:
            IM.write_drl_idx(enc, cdf, mode, res.stack, res.num_found)
            IM.write_mv(enc, cdf, mvp[:2], p0[:2])
            IM.write_mv(enc, cdf, mvp[2:], p0[2:])
        grid.set_block(mi_r, mi_c, bw4, bw4, MV.LAST_FRAME, mode, mvp[0],
                       mvp[1], ref1=MV.ALTREF_FRAME, mv1r=mvp[2],
                       mv1c=mvp[3])
        self.mode_counts[mode] += 1

    def _code_residuals(self, mi_r, mi_c, bs, skip, y_mode, y_lev, u_lev,
                        v_lev, tx_y, tx_uv, y_tx_type=DCT_DCT,
                        is_inter: bool = False):
        enc, cdf = self.enc, self.cdf
        sb_mi_r = mi_r % 16
        for plane, lev, txs in ((0, y_lev, tx_y), (1, u_lev, tx_uv),
                                (2, v_lev, tx_uv)):
            shift = 0 if plane == 0 else 1
            units = (bs >> shift) // 4
            # txbs overhanging the frame bottom: contexts are read over the
            # in-frame units only, and the beyond-edge left entries reset
            # to 0 after coding (EbDecParseBlock.c:2117-2133, :1644-1654)
            row_px = (mi_r * 4) >> shift
            valid_px = (self.mi_rows * 4) >> shift
            units_v = min(units, max(0, (valid_px - row_px) // 4))
            au0 = ((mi_c * 4) >> shift) // 4
            lu0 = ((sb_mi_r * 4) >> shift) // 4
            if skip:
                self.above_cul[plane][au0:au0 + units] = 0
                self.above_av[plane][au0:au0 + units] = True
                self.left_cul[plane][lu0:lu0 + units] = 0
                self.left_av[plane][lu0:lu0 + units] = True
                continue
            a_cul = self.above_cul[plane][au0:au0 + units]
            a_av = self.above_av[plane][au0:au0 + units]
            l_cul = self.left_cul[plane][lu0:lu0 + units_v]
            l_av = self.left_av[plane][lu0:lu0 + units_v]
            if plane == 0:
                tctx = 0
            else:
                tctx = 7 + int(((a_cul & 0x3F)[a_av] != 0).any()) + \
                    int(((l_cul & 0x3F)[l_av] != 0).any())
            signs = 0
            for culs, avs in ((a_cul, a_av), (l_cul, l_av)):
                for cl, av in zip(culs, avs):
                    if av:
                        s = int(cl) >> 6
                        signs += 1 if s == 2 else (-1 if s == 1 else 0)
            dctx = 2 if signs > 0 else (1 if signs < 0 else 0)
            cul = write_coeffs_txb(enc, cdf, lev, txs,
                                   y_tx_type if plane == 0 else DCT_DCT,
                                   min(plane, 1), tctx, dctx,
                                   is_inter=is_inter, intra_mode=y_mode)
            self.above_cul[plane][au0:au0 + units] = cul
            self.above_av[plane][au0:au0 + units] = True
            self.left_cul[plane][lu0:lu0 + units_v] = cul
            self.left_cul[plane][lu0 + units_v:lu0 + units] = 0
            self.left_av[plane][lu0:lu0 + units] = True


def _at(mv, *idx):
    """mv[idx], or None when the frame has no mvs (key frames)."""
    return None if mv is None else mv[idx]
