"""The port's AV1 decoder: OBU parse, tile parse on the host,
reconstruction and in-loop filters on a device.

Counterpart of ``svtav1_tpu/decoder/decoder.py``.  It decodes the streams
that decoder decodes (key and inter frames, single reference and compound
LAST+ALTREF, 64/32/16 partitions with TX_LARGEST, angle deltas, uniform
tile columns, 8- and 10-bit 4:2:0, deblocking, CDEF, the fork's CCSO, loop
restoration, show_existing overlays and no-show frames, film grain on the
output, metadata OBUs) to the same frames, and raises ``DecodeError`` for
the same corrupt or unsupported streams with the same messages.  One
difference, on purpose: a V_PRED or H_PRED block with a non-zero angle
delta is predicted at 90 or 180 degrees plus 3 x delta, as the spec and
both encoders do (the JAX decoder predicts it as plain V or H).

The reference reconstructs one block at a time, interleaved with the
parse.  Here a frame goes through five stages:

1. ``_parse_tiles``: the tiles are parsed on the host (the parse reads no
   pixels) into per-block records: residual levels by (plane, tx size, tx
   type), inter blocks by (plane, size, compound), intra blocks in decode
   order with the flat indices of their edge pixels.  Every index that
   reaches a device tensor is built here from the frame geometry and
   checked, so a corrupt stream raises ``DecodeError`` before any device
   work (an out-of-range index on a CUDA tensor would be a device-side
   assert that poisons the context).
2. ``_residuals``: every non-zero level of the frame goes up in one copy,
   and each group is dequantized and inverse-transformed in one batch,
   then scattered into a frame-sized residual plane.
3. ``_predict_inter``: one motion-compensated batch per group from the
   DPB's padded planes; prediction plus residual, clipped, is scattered
   into the recon planes.
4. ``_predict_intra``: the intra blocks, serially in decode order, on the
   device: edges gathered by index from the recon plane (whose flat
   buffer carries the three constant edge values after its pixels),
   predicted, residual added, written back.  An intra block reads only
   pixels of blocks decoded before it, so running it after every inter
   block gives the interleaved order's result.
5. ``_filter_frame``: partition deblock, crop to the signalled size,
   CDEF, CCSO from the pre-CDEF luma, loop restoration.

A shown frame costs one device-to-host copy.  The DPB holds the filtered
planes edge-padded for motion compensation, on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, upload
from ..ec import inter_modes as IM
from ..ec import lr_syntax as LRS
from ..ec.coeffs import read_coeffs_txb
from ..ec.modes import (INTRA_MODE_CONTEXT, PARTITION_NONE, PARTITION_SPLIT,
                        read_partition_edge)
from ..ec.mvpred import MiGrid, find_mv_stack
from ..ec.range_coder import RangeDecoder
from ..ec.subexp import read_signed_subexp_bits
from ..encoder.headers import _tile_log2
from ..ops import intra
from ..ops.ccso import CCSO_OFFSETS, ccso_apply_frame
from ..ops.cdef import cdef_apply_params
from ..ops.deblock import deblock_plane_part
from ..ops.film_grain import apply_film_grain
from ..ops.intra_dir import dr_pred
from ..ops.lr_frame import lr_apply_frame
from ..ops.mc import (MV_PRED_PAD, pad_plane, predict_inter_blocks,
                      predict_inter_blocks_compound)
from ..ops.quant import dequantize_dq
from ..ops.transforms import inv_txfm2d
from ..spec import mv as MV
from ..spec import tables as tbl
from ..spec.cdf import CdfContext
from ..spec.mv import lower_mv_precision as _lp
from ..spec.txfm import (DCT_DCT, TX_8X8, TX_16X16, TX_32X32, TX_64X64,
                         uv_intra_tx_type)
from ..utils.bitio import BitReader
from ..utils.metadata import parse_metadata_payload
from ..utils.obu import (OBU_FRAME, OBU_FRAME_HEADER, OBU_METADATA,
                         OBU_SEQUENCE_HEADER, OBU_TILE_GROUP, parse_obus)


class DecodeError(Exception):
    """Raised for corrupt or unsupported streams."""


def _need(cond, msg):
    """Unsupported-or-corrupt syntax guard (explicit so `python -O` cannot
    strip it; reference analogue: EbErrorType returns, EbDecParseObu.c)."""
    if not cond:
        raise DecodeError(msg)


@dataclass
class SeqInfo:
    width: int = 0
    height: int = 0
    bit_depth: int = 8
    use_128x128_sb: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_order_hint: bool = False
    order_hint_bits: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    monochrome: bool = False
    film_grain_params_present: bool = False
    enable_ccso: bool = False     # fork graft (nonstandard, opt-in parse)


@dataclass
class FrameInfo:
    frame_type: int = 0
    show_frame: bool = True
    base_q_idx: int = 100
    disable_cdf_update: bool = True
    tx_mode_select: bool = False
    reduced_tx_set: bool = False
    filter_level: tuple = (0, 0)
    filter_level_u: int = 0
    filter_level_v: int = 0
    lf_sharpness: int = 0
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: tuple = (0,) * 7
    allow_high_precision_mv: bool = False
    interpolation_filter: int = 0
    primary_ref_frame: int = 7
    disable_frame_end_update_cdf: bool = True
    tile_cols_log2: int = 0
    context_update_tile_id: int = 0
    showable: bool = True
    show_existing_idx: int = -1       # >= 0: show_existing_frame header
    film_grain: dict = None
    reference_select: bool = False
    lr_frame_types: tuple = (0, 0, 0)   # 0 NONE 1 WIENER 2 SGR 3 SWITCH
    ccso: dict = None                   # fork graft; parsed encode_ccso
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_strengths: tuple = ((0, 0),)     # (pri, sec) decoded (3→4)
    cdef_uv_strengths: tuple = ((0, 0),)
    gm_mv: dict = None                      # {ref: (row, col)} 1/8-pel


class _TileState:
    """Per-tile neighbour context state (grids and coefficient contexts)."""

    def __init__(self, mi_rows, mi_cols, w, h, x_off):
        self.mi_cols_t = mi_cols
        self.x_off = x_off
        self.grid = MiGrid(mi_rows, mi_cols)
        self.above_part = np.zeros(mi_cols, np.uint8)
        self.skip_grid = np.zeros((mi_rows, mi_cols), np.uint8)
        self.mode_grid = np.zeros((mi_rows, mi_cols), np.uint8)
        self.above_cul = {0: np.zeros(w // 4, np.uint8),
                          1: np.zeros(w // 8, np.uint8),
                          2: np.zeros(w // 8, np.uint8)}
        self.above_av = {p: np.zeros_like(self.above_cul[p], bool)
                         for p in range(3)}

    def reset_sb_row(self):
        self.left_part = np.zeros(16, np.uint8)
        self.left_cul = {0: np.zeros(16, np.uint8),
                         1: np.zeros(8, np.uint8),
                         2: np.zeros(8, np.uint8)}
        self.left_av = {p: np.zeros_like(self.left_cul[p], bool)
                        for p in range(3)}


class _Pack:
    """Host arrays of one frame gathered into one upload: add() returns
    the offset of an array in the pack, tensor() uploads the pack once."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.parts = []
        self.n = 0

    def add(self, a) -> int:
        a = np.asarray(a, self.dtype).reshape(-1)
        off = self.n
        self.parts.append(a)
        self.n += a.size
        return off

    def tensor(self, device):
        flat = (np.concatenate(self.parts) if self.parts
                else np.zeros(0, self.dtype))
        return upload(flat, device)


def _directional(mode: int, delta: int) -> bool:
    """Predicted by dr_pred at MODE_ANGLE[mode] + 3 * delta (spec
    §7.11.2.4): the directional modes, V_PRED and H_PRED only with a
    non-zero angle delta (with delta 0 they are the plain copies)."""
    return 1 <= mode <= 8 and (delta != 0 or mode not in (intra.V_PRED,
                                                          intra.H_PRED))


class Decoder:
    """One stream's decoder: decode_frame_obus(tu) per temporal unit, in
    decode order.  Reconstruction and filters run on `device` ("cuda" by
    default; a card that is asked for and absent raises)."""

    def __init__(self, ccso: bool = False, device="cuda") -> None:
        # ccso=True: expect the fork's nonstandard grafted syntax (seq-level
        # enable_ccso bit + frame encode_ccso + per-unit tile flags).  Like
        # the reference fork, CCSO streams are not standard AV1: the syntax
        # is not self-describing, so the caller must opt in.
        self.expect_ccso = ccso
        self.device = resolve_device(device)
        self.seq: SeqInfo | None = None
        self.frame_header: FrameInfo | None = None   # the last frame's
        self.metadata = []           # parsed (type, value) metadata OBUs
        self.dpb = [None] * 8        # (y, u, v) edge-padded int32 tensors
        self.dpb_gm = [None] * 8     # saved per-frame gm_mv dicts
        self.dpb_cdf = [None] * 8    # frame-end CDF state per slot
        self.dpb_fg = [None] * 8     # film grain params per slot

    # ---------------- headers ---------------- #

    def _parse_sequence_header(self, payload: bytes) -> SeqInfo:
        r = BitReader(payload)
        s = SeqInfo()
        profile = r.f(3)
        _need(profile == 0, "profile 0 only")
        r.bit()                       # still_picture
        reduced = r.bit()
        _need(not reduced, "reduced_still_picture_header")
        if r.bit():                   # timing_info_present
            raise NotImplementedError("timing info")
        r.bit()                       # initial_display_delay_present
        n_ops = r.f(5) + 1
        for _ in range(n_ops):
            r.f(12)
            lvl = r.f(5)
            if lvl > 7:
                r.bit()
        wbits = r.f(4) + 1
        hbits = r.f(4) + 1
        s.width = r.f(wbits) + 1
        s.height = r.f(hbits) + 1
        if r.bit():                   # frame_id_numbers_present
            raise NotImplementedError
        s.use_128x128_sb = bool(r.bit())
        s.enable_filter_intra = bool(r.bit())
        s.enable_intra_edge_filter = bool(r.bit())
        r.bit()                       # enable_interintra_compound
        r.bit()                       # enable_masked_compound
        r.bit()                       # enable_warped_motion
        r.bit()                       # enable_dual_filter
        s.enable_order_hint = bool(r.bit())
        if s.enable_order_hint:
            r.bit()
            r.bit()
        if r.bit():                   # seq_choose_screen_content_tools
            force_sct = 2
        else:
            force_sct = r.bit()
        if force_sct > 0:
            raise NotImplementedError("screen content tools")
        if s.enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
        s.enable_superres = bool(r.bit())
        s.enable_cdef = bool(r.bit())
        s.enable_restoration = bool(r.bit())
        if self.expect_ccso:
            # fork graft: unconditional extra seq bit
            # (EbEntropyCoding.c:2872); not present in standard AV1
            s.enable_ccso = bool(r.bit())
        # color config
        high_bd = r.bit()
        s.bit_depth = 10 if high_bd else 8
        s.monochrome = bool(r.bit())
        if r.bit():                   # color_description_present
            r.f(8)
            r.f(8)
            r.f(8)
        r.bit()                       # color_range
        if not s.monochrome:
            r.f(2)                    # chroma_sample_position
            r.bit()                   # separate_uv_delta_q
        s.film_grain_params_present = bool(r.bit())
        return s

    def _parse_frame_header(self, r: BitReader, seq: SeqInfo) -> FrameInfo:
        fr = FrameInfo()
        if r.bit():                   # show_existing_frame
            fr.show_existing_idx = r.f(3)
            return fr
        fr.frame_type = r.f(2)
        _need(fr.frame_type in (0, 1), "intra-only / switch frames")
        is_inter = fr.frame_type == 1
        fr.show_frame = bool(r.bit())
        if not fr.show_frame:
            fr.showable = bool(r.bit())
        if is_inter:
            _need(r.bit() == 0, "error_resilient_mode")
        fr.disable_cdf_update = bool(r.bit())
        _need(r.bit() == 0, "frame_size_override")
        if seq.enable_order_hint:
            r.f(seq.order_hint_bits)
        if is_inter:
            fr.primary_ref_frame = r.f(3)
            fr.refresh_frame_flags = r.f(8)
            fr.ref_frame_idx = tuple(r.f(3) for _ in range(7))
        if seq.enable_superres:
            _need(r.bit() == 0, "superres")
        _need(r.bit() == 0, "render size")
        if is_inter:
            fr.allow_high_precision_mv = bool(r.bit())
            _need(not fr.allow_high_precision_mv, "high-precision mv")
            _need(r.bit() == 0, "switchable interp filter")
            fr.interpolation_filter = r.f(2)
            _need(r.bit() == 0, "motion mode switchable")
        if not fr.disable_cdf_update:
            fr.disable_frame_end_update_cdf = bool(r.bit())
        # tile info (single-tile subset)
        _need(r.bit() == 1, "uniform tile spacing only")
        sb = 128 if seq.use_128x128_sb else 64
        sb_cols = (seq.width + sb - 1) // sb
        sb_rows = (seq.height + sb - 1) // sb
        sb_shift = 7 if sb == 128 else 6
        max_tile_width_sb = 4096 >> sb_shift
        min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
        max_log2_cols = _tile_log2(1, min(sb_cols, 64))
        max_log2_rows = _tile_log2(1, min(sb_rows, 64))
        tile_cols_log2 = min_log2_cols
        while tile_cols_log2 < max_log2_cols and r.bit():
            tile_cols_log2 += 1
        max_tile_area_sb = (4096 * 2304) >> (2 * sb_shift)
        min_log2_tiles = max(min_log2_cols,
                             _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
        min_log2_rows = max(min_log2_tiles - tile_cols_log2, 0)
        tile_rows_log2 = min_log2_rows
        while tile_rows_log2 < max_log2_rows and r.bit():
            tile_rows_log2 += 1
        if tile_cols_log2 or tile_rows_log2:
            fr.context_update_tile_id = r.f(tile_cols_log2 + tile_rows_log2)
            _need(r.f(2) == 3, "tile_size_bytes == 4 expected")
        _need(tile_rows_log2 == 0, "tile rows")
        fr.tile_cols_log2 = tile_cols_log2
        _need(sb_cols % (1 << tile_cols_log2) == 0,
              "non-uniform tile columns")
        # quantization
        fr.base_q_idx = r.f(8)
        _need(r.bit() == 0, "delta_q_y_dc")
        if not seq.monochrome:
            _need(r.bit() == 0, "delta_q_u_dc")
            _need(r.bit() == 0, "delta_q_u_ac")
        _need(r.bit() == 0, "qmatrix")
        _need(r.bit() == 0, "segmentation")
        if fr.base_q_idx > 0:
            _need(r.bit() == 0, "delta_q_present")
        l0 = r.f(6)
        l1 = r.f(6)
        fr.filter_level = (l0, l1)
        if not seq.monochrome and (l0 or l1):
            fr.filter_level_u = r.f(6)
            fr.filter_level_v = r.f(6)
        fr.lf_sharpness = r.f(3)
        _need(r.bit() == 0, "loop_filter_delta")
        if seq.enable_cdef:
            # cdef_params (spec §5.9.19); sec value 3 decodes to 4
            fr.cdef_damping = r.f(2) + 3
            fr.cdef_bits = r.f(2)
            ys, uvs = [], []
            for _ in range(1 << fr.cdef_bits):
                yp = r.f(4)
                ysec = r.f(2)
                up = r.f(4)
                usec = r.f(2)
                ys.append((yp, ysec + (ysec == 3)))
                uvs.append((up, usec + (usec == 3)))
            fr.cdef_y_strengths = tuple(ys)
            fr.cdef_uv_strengths = tuple(uvs)
        if seq.enable_restoration:
            # lr_params (spec §5.9.20); Remap_Lr_Type coded order
            remap = {0: 0, 1: 3, 2: 1, 3: 2}
            types = [remap[r.f(2)] for _ in range(3)]
            uses_lr = any(types)
            uses_chroma_lr = bool(types[1] or types[2])
            if uses_lr:
                _need(r.bit() == 0, "64px LR units only")
                if uses_chroma_lr:
                    _need(r.bit() == 1, "32px chroma LR units only")
            fr.lr_frame_types = tuple(types)
        if seq.enable_ccso:
            fr.ccso = self._parse_ccso(r)
        fr.tx_mode_select = bool(r.bit())
        _need(not fr.tx_mode_select, "TX_MODE_LARGEST subset")
        if is_inter:
            fr.reference_select = bool(r.bit())
        fr.reduced_tx_set = bool(r.bit())
        if is_inter:
            fr.gm_mv = self._parse_global_motion(r, fr)
        fr.film_grain = self._parse_film_grain(r, seq, fr)
        return fr

    def _parse_global_motion(self, r: BitReader, fr) -> dict:
        """global_motion_params, TRANSLATION only (spec 5.9.24/25;
        EbDecParseObu.c:1217 read_global_motion_params).  Returns
        {ref: (mv_row, mv_col)} in 1/8-pel; PrevGmParams come from the
        primary-ref frame's saved params (identity when
        PRIMARY_REF_NONE)."""
        prev = {}
        if fr.primary_ref_frame != 7:
            slot = fr.ref_frame_idx[fr.primary_ref_frame]
            prev = self.dpb_gm[slot] or {}
        gm = {}
        for ref in range(1, 8):
            if not r.bit():          # is_global
                continue
            _need(not r.bit(), "rot-zoom global motion")
            _need(bool(r.bit()), "affine global motion")
            pmv = tuple(prev.get(ref, (0, 0)))
            row = read_signed_subexp_bits(r, -256, 257, pmv[0] >> 1) << 1
            col = read_signed_subexp_bits(r, -256, 257, pmv[1] >> 1) << 1
            if (row, col) != (0, 0):
                gm[ref] = (row, col)
        return gm

    @staticmethod
    def _parse_ccso(r: BitReader) -> dict:
        """encode_ccso read path (fork graft, EbEntropyCoding.c:2361 with
        CONFIG_D143_CCSO_FM_FLAG=1 + CONFIG_CCSO_SIGFIX=1)."""
        if not r.bit():                  # ccso_frame_flag
            return None
        planes = []
        for _ in range(3):
            if not r.bit():              # ccso_enable[plane]
                planes.append(None)
                continue
            bo_only = r.bit()
            if bo_only:
                mbl = r.f(3)
                quant_idx, support, edge_clf = 0, 0, 0
            else:
                quant_idx = r.f(2)
                support = r.f(3)
                edge_clf = r.bit()
                mbl = r.f(2)
            intervals = 1 if bo_only else (3 if edge_clf == 0 else 2)
            lut = np.zeros(128, np.int32)
            for d0 in range(intervals):
                for d1 in range(intervals):
                    for band in range(1 << mbl):
                        oi = 0
                        while oi < 7 and r.bit():
                            oi += 1
                        lut[(band << 4) + (d0 << 2) + d1] = \
                            CCSO_OFFSETS[oi]
            planes.append(dict(quant_idx=quant_idx, support=support,
                               edge_clf=edge_clf, max_band_log2=mbl,
                               bo_only=bo_only, lut=lut))
        return {"planes": planes}

    @staticmethod
    def _parse_film_grain(r: BitReader, seq: SeqInfo, fr) -> dict:
        """film_grain_params (spec §5.9.30; EbDecParseObu read path)."""
        if not getattr(seq, "film_grain_params_present", False):
            return None
        if not (fr.show_frame or fr.showable):
            return None
        if not r.bit():               # apply_grain
            return None
        fg = {"grain_seed": r.f(16)}
        if fr.frame_type == 1:
            if not r.bit():           # update_grain == 0
                fg["load_ref_idx"] = r.f(3)
                return fg
        n_y = r.f(4)
        _need(n_y <= 14, "num_y_points > 14")
        fg["num_y_points"] = n_y
        fg["scaling_points_y"] = [(r.f(8), r.f(8)) for _ in range(n_y)]
        csfl = bool(r.bit()) if not seq.monochrome else False
        fg["chroma_scaling_from_luma"] = int(csfl)
        chroma_pts = not (seq.monochrome or csfl or n_y == 0)
        if chroma_pts:
            ncb = r.f(4)
            _need(ncb <= 10, "num_cb_points > 10")
            fg["num_cb_points"] = ncb
            fg["scaling_points_cb"] = [(r.f(8), r.f(8))
                                       for _ in range(ncb)]
            ncr = r.f(4)
            _need(ncr <= 10, "num_cr_points > 10")
            fg["num_cr_points"] = ncr
            fg["scaling_points_cr"] = [(r.f(8), r.f(8))
                                       for _ in range(ncr)]
        else:
            fg["num_cb_points"] = fg["num_cr_points"] = 0
            fg["scaling_points_cb"] = fg["scaling_points_cr"] = []
        fg["scaling_shift"] = r.f(2) + 8
        lag = r.f(2)
        fg["ar_coeff_lag"] = lag
        num_pos = 2 * lag * (lag + 1)
        fg["ar_coeffs_y"] = [0] * 24
        fg["ar_coeffs_cb"] = [0] * 25
        fg["ar_coeffs_cr"] = [0] * 25
        if n_y:
            for i in range(num_pos):
                fg["ar_coeffs_y"][i] = r.f(8) - 128
            num_pos_c = num_pos + 1
        else:
            num_pos_c = num_pos
        if fg["num_cb_points"] or csfl:
            for i in range(num_pos_c):
                fg["ar_coeffs_cb"][i] = r.f(8) - 128
        if fg["num_cr_points"] or csfl:
            for i in range(num_pos_c):
                fg["ar_coeffs_cr"][i] = r.f(8) - 128
        fg["ar_coeff_shift"] = r.f(2) + 6
        fg["grain_scale_shift"] = r.f(2)
        if fg["num_cb_points"]:
            fg["cb_mult"] = r.f(8)
            fg["cb_luma_mult"] = r.f(8)
            fg["cb_offset"] = r.f(9)
        else:
            fg["cb_mult"] = fg["cb_luma_mult"] = fg["cb_offset"] = 0
        if fg["num_cr_points"]:
            fg["cr_mult"] = r.f(8)
            fg["cr_luma_mult"] = r.f(8)
            fg["cr_offset"] = r.f(9)
        else:
            fg["cr_mult"] = fg["cr_luma_mult"] = fg["cr_offset"] = 0
        fg["overlap_flag"] = r.bit()
        fg["clip_to_restricted_range"] = r.bit()
        fg["random_seed"] = fg["grain_seed"]
        fg["bit_depth"] = seq.bit_depth
        return fg

    # ---------------- tile parse ---------------- #

    @staticmethod
    def _part_ctx(above: int, left: int, bsl: int) -> int:
        return ((int(left) >> bsl) & 1) * 2 + ((int(above) >> bsl) & 1) + \
            bsl * 4

    def _parse_tiles(self, data: bytes, seq: SeqInfo, fr: FrameInfo):
        """Parse every tile of the frame into the block records of
        _begin_frame (uniform tile columns; 64 -> 32 forced split, 32
        NONE/SPLIT(16), or 64 NONE)."""
        w, h = seq.width, seq.height
        is_inter_frame = fr.frame_type == 1
        if is_inter_frame:
            ref = self.dpb[fr.ref_frame_idx[0]]
            _need(ref is not None, "missing reference frame")
            self._refp = ref
            self._refp2 = None
            if fr.reference_select:
                ref2 = self.dpb[fr.ref_frame_idx[6]]   # ALTREF slot
                _need(ref2 is not None, "missing ALTREF reference")
                self._refp2 = ref2
        self._begin_frame(seq)
        n_tiles = 1 << fr.tile_cols_log2
        if n_tiles == 1:
            chunks = [data]
        else:
            chunks = []
            off = 0
            for _ in range(n_tiles - 1):
                _need(off + 4 <= len(data), "truncated tile sizes")
                sz = int.from_bytes(data[off:off + 4], "little") + 1
                chunks.append(data[off + 4:off + 4 + sz])
                off += 4 + sz
            chunks.append(data[off:])
        tw = w // n_tiles
        for t, chunk in enumerate(chunks):
            end_cdf = self._decode_one_tile(chunk, seq, fr, is_inter_frame,
                                            t * tw, tw)
            if t == fr.context_update_tile_id:
                self._end_cdf = end_cdf

    def _begin_frame(self, seq: SeqInfo):
        """Per-frame maps and block records.  Recon buffers and maps are
        SB-padded: bottom-row blocks may legally overhang the true frame
        bottom (spec §5.11.4 hasRows); the output is cropped to the
        signalled size after the loop filters."""
        w, h = seq.width, seq.height
        ph = -(-h // 64) * 64
        self._ph = ph
        self._part_map = np.zeros((ph // 32, w // 32), np.int32)
        self._part_sb_map = np.ones((ph // 64, w // 64), np.int32)
        self._cdef_idx = np.zeros((ph // 64, w // 64), np.int32)
        self._cdef_read = np.zeros((ph // 64, w // 64), bool)
        # CCSO per-plane 256x256-luma-unit on/off flags (fork graft)
        self._ccso_flags = np.zeros((3, -(-h // 256), -(-w // 256)),
                                    np.int32)
        self._skip8 = np.ones((ph // 8, w // 8), bool)
        sbh, sbw = ph // 64, w // 64
        self._lr_units = [
            {"type": np.zeros((sbh, sbw), np.int32),
             "eps": np.zeros((sbh, sbw), np.int32),
             "xqd": np.zeros((sbh, sbw, 2), np.int32),
             "taps_v": np.zeros((sbh, sbw, 3), np.int32),
             "taps_h": np.zeros((sbh, sbw, 3), np.int32)}
            for _ in range(3)]
        # block records: residual levels by (plane, tx size, tx type) ->
        # [(y0, x0, levels)]; inter blocks by (plane, size, compound) ->
        # [(y0, x0, mv row, mv col[, mv1 row, mv1 col])]; intra blocks in
        # decode order (plane, y0, x0, size, mode, angle delta, have
        # above, have left, offset of the edge indices in _idx)
        self._resid = {}
        self._inter = {}
        self._intra = []
        self._idx = _Pack(np.int64)
        # plane geometry: (rows, cols) of the SB-padded recon planes
        self._dims = [(ph, w), (ph // 2, w // 2), (ph // 2, w // 2)]

    def _decode_one_tile(self, data: bytes, seq: SeqInfo, fr: FrameInfo,
                         is_inter_frame: bool, x_off: int, tw: int):
        w, h = seq.width, seq.height
        mi_rows = h // 4
        dec = RangeDecoder(data)
        if fr.primary_ref_frame != 7 and is_inter_frame:
            prev = self.dpb_cdf[fr.ref_frame_idx[fr.primary_ref_frame]]
            _need(prev is not None, "primary ref has no saved CDF state")
            cdf = prev.clone()
        else:
            cdf = CdfContext(fr.base_q_idx,
                             update=not fr.disable_cdf_update)
        st = _TileState(h // 4, tw // 4, tw, h, x_off)
        lr_ref = [LRS.default_ref_state() for _ in range(3)]

        for sb_r in range(self._ph // 64):
            st.reset_sb_row()
            for sb_c in range(tw // 64):
                if any(t for t in fr.lr_frame_types):
                    sbc_f = sb_c + x_off // 64
                    for p in range(3):
                        ut, eps, xqd, tv, th = LRS.read_lr_unit(
                            dec, cdf, fr.lr_frame_types[p], lr_ref[p],
                            p > 0)
                        u = self._lr_units[p]
                        u["type"][sb_r, sbc_f] = ut
                        u["eps"][sb_r, sbc_f] = eps
                        u["xqd"][sb_r, sbc_f] = xqd
                        u["taps_v"][sb_r, sbc_f] = tv
                        u["taps_h"][sb_r, sbc_f] = th
                mi_c0 = sb_c * 16
                ctx = self._part_ctx(st.above_part[mi_c0], st.left_part[0],
                                     3)
                if sb_r * 16 + 8 < mi_rows:
                    t = cdf.partition_cdf[ctx]
                    p64 = dec.decode_symbol(t, 10)
                    cdf.update(t, p64)
                else:
                    # SB crosses the frame bottom: split_or_horz bool
                    p64 = read_partition_edge(dec, cdf, ctx, 64,
                                              False, True)
                if p64 == PARTITION_NONE:
                    self._part_sb_map[sb_r, sb_c + x_off // 64] = 0
                    self._decode_block(dec, cdf, st, sb_r * 16, sb_c * 16,
                                       64, sb_r * 2, sb_c * 2, seq, fr,
                                       is_inter_frame)
                    st.above_part[mi_c0:mi_c0 + 16] = 16
                    st.left_part[:] = 16
                    continue
                _need(p64 == PARTITION_SPLIT, "unsupported 64x64 partition")
                for qr, qc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    br, bc = sb_r * 2 + qr, sb_c * 2 + qc
                    mi_r, mi_c = br * 8, bc * 8
                    if mi_r >= mi_rows:
                        continue         # quad below the frame bottom
                    ctx = self._part_ctx(st.above_part[mi_c],
                                         st.left_part[qr * 8], 2)
                    if mi_r + 4 < mi_rows:
                        t = cdf.partition_cdf[ctx]
                        p32 = dec.decode_symbol(t, 10)
                        cdf.update(t, p32)
                    else:
                        p32 = read_partition_edge(dec, cdf, ctx, 32,
                                                  False, True)
                    if p32 == PARTITION_NONE:
                        self._decode_block(dec, cdf, st, mi_r, mi_c, 32,
                                           br, bc, seq, fr, is_inter_frame)
                        st.above_part[mi_c:mi_c + 8] = 24
                        st.left_part[qr * 8:qr * 8 + 8] = 24
                    elif p32 == PARTITION_SPLIT:
                        self._part_map[br, bc + x_off // 32] = 1
                        for sr, sc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                            smr = mi_r + sr * 4
                            smc = mi_c + sc * 4
                            if smr >= mi_rows:
                                continue  # 16-leaf below the frame bottom
                            lctx = self._part_ctx(
                                st.above_part[smc],
                                st.left_part[qr * 8 + sr * 4], 1)
                            if smr + 2 < mi_rows:
                                t = cdf.partition_cdf[lctx]
                                p16 = dec.decode_symbol(t, 10)
                                cdf.update(t, p16)
                            else:
                                p16 = read_partition_edge(dec, cdf, lctx,
                                                          16, False, True)
                            _need(p16 == PARTITION_NONE,
                                  "8x8/16x8 partitions unsupported")
                            self._decode_block(dec, cdf, st, smr, smc, 16,
                                               br, bc, seq, fr,
                                               is_inter_frame)
                            st.above_part[smc:smc + 4] = 28
                            lo = qr * 8 + sr * 4
                            st.left_part[lo:lo + 4] = 28
                    else:
                        raise DecodeError("unsupported partition type")
        self._skip8[:h // 8, x_off // 8:(x_off + tw) // 8] = \
            st.skip_grid[::2, ::2].astype(bool)
        return cdf

    def _decode_block(self, dec, cdf, st, mi_r, mi_c, bs, br, bc, seq, fr,
                      is_inter_frame):
        grid = st.grid
        bw4 = bs // 4
        have_above, have_left = mi_r > 0, mi_c > 0
        a_skip = int(st.skip_grid[mi_r - 1, mi_c]) if have_above else 0
        l_skip = int(st.skip_grid[mi_r, mi_c - 1]) if have_left else 0
        t = cdf.skip_cdfs[a_skip + l_skip]
        skip = dec.decode_symbol(t)
        cdf.update(t, skip)

        if seq.enable_cdef and not skip:
            # cdef_idx: literal at the first non-skip block per 64x64
            # (spec read_cdef; EbDecParseBlock.c read path)
            sbr = mi_r // 16
            sbc = (mi_c + st.x_off // 4) // 16
            if not self._cdef_read[sbr, sbc]:
                val = 0
                for _ in range(fr.cdef_bits):
                    val = (val << 1) | dec.decode_bool(0x4000)
                self._cdef_idx[sbr, sbc] = val
                self._cdef_read[sbr, sbc] = True

        # CCSO unit flags (fork graft, EbEntropyCoding.c:4008 write_ccso
        # read path): first block of each 256x256-luma unit, skip or not
        mi_c_f = mi_c + st.x_off // 4
        if fr.ccso is not None and mi_r % 64 == 0 and mi_c_f % 64 == 0:
            ur, uc = mi_r // 64, mi_c_f // 64
            for p in range(3):
                if fr.ccso["planes"][p] is not None:
                    t = cdf.ccso_cdf[p]
                    f = dec.decode_symbol(t)
                    cdf.update(t, f)
                    self._ccso_flags[p, ur, uc] = f

        y_mode = 0
        angle_delta = 0
        uv_mode = 0
        uv_angle_delta = 0
        mv = (0, 0)
        is_inter = False
        if is_inter_frame:
            above_inter = grid.is_inter(mi_r - 1, mi_c) if have_above \
                else None
            left_inter = grid.is_inter(mi_r, mi_c - 1) if have_left else None
            is_inter = IM.read_is_inter(
                dec, cdf, IM.intra_inter_ctx(above_inter, left_inter))
        mv1 = None
        if is_inter:
            def nb_ref(r, c, avail):
                if not avail:
                    return None
                r0 = int(grid.ref0[r, c])
                if r0 < 1:
                    return None
                r1 = int(grid.ref1[r, c])
                return (r0, r1) if r1 >= 1 else r0

            a_ref = nb_ref(mi_r - 1, mi_c, have_above)
            l_ref = nb_ref(mi_r, mi_c - 1, have_left)
            counts = IM.neighbor_ref_counts(a_ref, l_ref)
            is_comp = False
            if fr.reference_select:
                def nb_info(r, c, avail):
                    if not avail:
                        return None
                    return (grid.ref0[r, c] >= 1, int(grid.ref0[r, c]),
                            int(grid.ref1[r, c]))
                a_i = nb_info(mi_r - 1, mi_c, have_above)
                l_i = nb_info(mi_r, mi_c - 1, have_left)
                is_comp = IM.read_comp_mode(dec, cdf,
                                            IM.ref_mode_ctx(a_i, l_i))
            if is_comp:
                refs = IM.read_comp_refs(dec, cdf, a_i, l_i, counts)
                res = find_mv_stack(
                    grid, mi_r, mi_c, bw4, bw4, ref_frame=refs,
                    mi_col_off=st.x_off // 4, frame_mi_cols=seq.width // 4)
                cmode = IM.read_inter_compound_mode(dec, cdf,
                                                    res.mode_context)
                ref_mv_idx = 0
                if cmode == MV.NEW_NEWMV or MV.has_nearmv(cmode):
                    ref_mv_idx = IM.read_drl_idx(dec, cdf, cmode,
                                                 res.stack,
                                                 res.num_found)
                s0 = res.ref_list[0]
                if cmode == MV.NEAREST_NEARESTMV:
                    mv = _lp(s0[0], s0[1])
                    mv1 = _lp(s0[2], s0[3])
                elif cmode == MV.NEAR_NEARMV:
                    sn = (res.stack[1 + ref_mv_idx]
                          if len(res.stack) > 1 + ref_mv_idx
                          else (0, 0, 0, 0, 0))
                    mv = _lp(sn[0], sn[1])
                    mv1 = _lp(sn[2], sn[3])
                elif cmode == MV.GLOBAL_GLOBALMV:
                    mv, mv1 = (0, 0), (0, 0)
                elif cmode == MV.NEW_NEWMV:
                    sr = (res.stack[ref_mv_idx]
                          if len(res.stack) > ref_mv_idx
                          else (0, 0, 0, 0, 0))
                    mv = IM.read_mv(dec, cdf, _lp(sr[0], sr[1]))
                    mv1 = IM.read_mv(dec, cdf, _lp(sr[2], sr[3]))
                else:
                    raise DecodeError(
                        "mixed NEW/NEAREST compound modes unsupported")
                grid.set_block(mi_r, mi_c, bw4, bw4, refs[0], cmode,
                               mv[0], mv[1], ref1=refs[1], mv1r=mv1[0],
                               mv1c=mv1[1])
            else:
                IM.read_ref_frame_single(dec, cdf, counts)
                gmv = tuple((fr.gm_mv or {}).get(MV.LAST_FRAME, (0, 0)))
                res = find_mv_stack(
                    grid, mi_r, mi_c, bw4, bw4, mi_col_off=st.x_off // 4,
                    frame_mi_cols=seq.width // 4, gm_mv=gmv)
                mode = IM.read_inter_mode(dec, cdf, res.mode_context)
                ref_mv_idx = 0
                if mode in (MV.NEWMV, MV.NEARMV):
                    ref_mv_idx = IM.read_drl_idx(dec, cdf, mode,
                                                 res.stack,
                                                 res.num_found)
                if mode == MV.NEARESTMV:
                    mv = res.nearest_mv
                elif mode == MV.NEARMV:
                    mv = (_lp(*res.stack[1 + ref_mv_idx][:2])
                          if ref_mv_idx > 0 else res.near_mv)
                elif mode == MV.GLOBALMV:
                    mv = gmv
                else:
                    ref_mv = (_lp(*res.stack[ref_mv_idx][:2])
                              if res.num_found > 1 else res.nearest_mv)
                    mv = IM.read_mv(dec, cdf, ref_mv)
                grid.set_block(mi_r, mi_c, bw4, bw4, MV.LAST_FRAME, mode,
                               mv[0], mv[1])
        else:
            if is_inter_frame:
                sg = 3 if bs >= 32 else 2
                y_mode = dec.decode_symbol(cdf.y_mode_cdf[sg], 13)
                cdf.update(cdf.y_mode_cdf[sg], y_mode)
            else:
                a_mode = int(st.mode_grid[mi_r - 1, mi_c]) if have_above \
                    else 0
                l_mode = int(st.mode_grid[mi_r, mi_c - 1]) if have_left \
                    else 0
                t = cdf.kf_y_cdf[INTRA_MODE_CONTEXT[a_mode]][
                    INTRA_MODE_CONTEXT[l_mode]]
                y_mode = dec.decode_symbol(t)
                cdf.update(t, y_mode)
            if 1 <= y_mode <= 8:
                t = cdf.angle_delta_cdf[y_mode - 1]
                angle_delta = dec.decode_symbol(t) - 3
                cdf.update(t, angle_delta + 3)
            # CfL allowed only for blocks <= 32x32 (spec 5.11.5): the
            # 64x64 path reads the 13-symbol UV-mode CDF
            cfl = bs <= 32
            nsyms = 14 if cfl else 13
            t = cdf.uv_mode_cdf[int(cfl)][y_mode]
            uv_mode = dec.decode_symbol(t, nsyms)
            cdf.update(t, uv_mode, nsyms)
            _need(uv_mode < 13, "CfL not emitted by this encoder")
            if 1 <= uv_mode <= 8:
                t = cdf.angle_delta_cdf[uv_mode - 1]
                uv_angle_delta = dec.decode_symbol(t) - 3
                cdf.update(t, uv_angle_delta + 3)
            grid.set_block(mi_r, mi_c, bw4, bw4, MV.INTRA_FRAME, y_mode)
            st.mode_grid[mi_r:mi_r + bw4, mi_c:mi_c + bw4] = y_mode

        if bs == 64:
            tx_y, tx_uv = TX_64X64, TX_32X32
        else:
            tx_y = TX_32X32 if bs == 32 else TX_16X16
            tx_uv = TX_16X16 if bs == 32 else TX_8X8
        sb_mi_r = mi_r % 16
        for plane, pbs, txs in ((0, bs, tx_y), (1, bs // 2, tx_uv),
                                (2, bs // 2, tx_uv)):
            shift = 0 if plane == 0 else 1
            y0 = (mi_r * 4) >> shift
            x0 = ((mi_c * 4) + st.x_off) >> shift
            units = (bs >> shift) // 4
            # frame-bottom overhang: contexts read over in-frame units
            # only; beyond-edge left entries reset to 0 after the txb
            # (EbDecParseBlock.c:2117-2133, update_coeff_ctx :1644-1654)
            valid_px = (st.grid.mi_rows * 4) >> shift
            units_v = min(units, max(0, (valid_px - y0) // 4))
            au0 = ((mi_c * 4) >> shift) // 4
            lu0 = ((sb_mi_r * 4) >> shift) // 4
            lev = None
            if not skip:
                if plane == 0:
                    tctx = 0
                else:
                    a_nz = (st.above_cul[plane][au0:au0 + units] &
                            0x3F)[st.above_av[plane][au0:au0 + units]]
                    l_nz = (st.left_cul[plane][lu0:lu0 + units_v] &
                            0x3F)[st.left_av[plane][lu0:lu0 + units_v]]
                    tctx = 7 + int((a_nz != 0).any()) + \
                        int((l_nz != 0).any())
                signs = 0
                for culs, avs in ((st.above_cul[plane][au0:au0 + units],
                                   st.above_av[plane][au0:au0 + units]),
                                  (st.left_cul[plane][lu0:lu0 + units_v],
                                   st.left_av[plane][lu0:lu0 + units_v])):
                    for cl, av in zip(culs, avs):
                        if av:
                            sg = int(cl) >> 6
                            signs += 1 if sg == 2 else (-1 if sg == 1
                                                        else 0)
                dctx = 2 if signs > 0 else (1 if signs < 0 else 0)
                # TX_64X64 codes only its low 32x32 band (adjusted tx
                # size, spec §5.11.39); the rest of the block is zero
                rd_n = 32 if pbs == 64 else pbs
                lev, tx_type = read_coeffs_txb(
                    dec, cdf, rd_n, rd_n, txs, DCT_DCT,
                    min(plane, 1), tctx, dctx,
                    is_inter=is_inter, intra_mode=y_mode)
                if plane > 0 and not is_inter:
                    # chroma-intra tx type is implied by uv_mode (spec
                    # compute_tx_type; EbCommonUtils.h:67), clamped to
                    # DCT past 16x16
                    tx_type = uv_intra_tx_type(uv_mode, txs)
                if rd_n != pbs:
                    full = np.zeros((pbs, pbs), lev.dtype)
                    full[:rd_n, :rd_n] = lev
                    lev = full
                cul = min(63, int(np.abs(lev).sum()))
                dcv = int(lev[0, 0])
                if dcv < 0:
                    cul |= 1 << 6
                elif dcv > 0:
                    cul += 2 << 6
            else:
                cul = 0
            st.above_cul[plane][au0:au0 + units] = cul
            st.above_av[plane][au0:au0 + units] = True
            st.left_cul[plane][lu0:lu0 + units_v] = cul
            st.left_cul[plane][lu0 + units_v:lu0 + units] = 0
            st.left_av[plane][lu0:lu0 + units] = True

            if lev is not None and lev.any():
                self._resid.setdefault((plane, txs, tx_type), []).append(
                    (y0, x0, lev))
            if is_inter:
                self._inter.setdefault((plane, pbs, mv1 is not None),
                                       []).append(
                    (y0, x0) + tuple(mv) + tuple(mv1 or ()))
            else:
                mode = y_mode if plane == 0 else uv_mode
                adelta = angle_delta if plane == 0 else uv_angle_delta
                idx = self._edge_index(
                    plane, y0, x0, pbs, mode, adelta, br, bc, bs,
                    have_above, have_left, st.mi_cols_t * 4 // 32,
                    seq.height >> shift)
                self._intra.append(
                    (plane, y0, x0, pbs, mode, adelta, have_above,
                     have_left, self._idx.add(idx)))

        st.skip_grid[mi_r:mi_r + bw4, mi_c:mi_c + bw4] = skip

    def _edge_index(self, plane, y0, x0, bs, mode, delta, br, bc, luma_bs,
                    ha, hl, tile_bw, vh):
        """Flat indices into the plane's recon buffer of an intra block's
        edges, [above (bs), above-right (bs), left (bs), below-left (bs),
        corner]: the reference's _predict edge rules (left rows clamped at
        the true plane height vh; unavailable edges replicate a
        neighbour or take one of the three constants stored after the
        pixels: base - 1, base + 1, base)."""
        h, w = self._dims[plane]
        n = h * w
        cols = np.arange(x0, x0 + bs)
        if ha:
            above = (y0 - 1) * w + cols
        elif hl:
            above = np.full(bs, y0 * w + x0 - 1)
        else:
            above = np.full(bs, n)
        if hl:
            left = np.minimum(np.arange(y0, y0 + bs), vh - 1) * w + x0 - 1
        elif ha:
            left = np.full(bs, (y0 - 1) * w + x0)
        else:
            left = np.full(bs, n + 1)
        if ha and hl:
            corner = (y0 - 1) * w + x0 - 1
        elif ha:
            corner = (y0 - 1) * w + x0
        elif hl:
            corner = y0 * w + x0 - 1
        else:
            corner = n + 2
        has_tr = has_bl = False
        if _directional(mode, delta):
            # extended-edge availability: z-order rule for full 32x32
            # blocks; 16x16 leaves only carry Z2-safe modes, for which the
            # extension is never read (replication is then normative)
            if luma_bs == 64 and bs == 64:
                # full-SB block: above-right SB is decoded (raster SB
                # order), below-left never is; br/bc and tile_bw are in
                # 32-block units, compared at SB granularity
                has_tr = br > 0 and bc // 2 + 1 < tile_bw // 2
            elif luma_bs == 32 and bs >= 16:
                qr, qc = br % 2, bc % 2
                if qr == 0:
                    has_tr = br > 0 and bc + 1 < tile_bw
                else:
                    has_tr = qc == 0 and bc + 1 < tile_bw
                has_bl = (qr == 0 and qc == 0 and bc > 0 and
                          br + 1 < h // bs)
        if has_tr and ha:
            tr = (y0 - 1) * w + cols + bs
        else:
            tr = np.full(bs, above[-1])
        if has_bl and hl:
            tr_rows = np.minimum(np.arange(y0 + bs, y0 + 2 * bs), vh - 1)
            bl = tr_rows * w + x0 - 1
        else:
            bl = np.full(bs, left[-1])
        idx = np.concatenate([above, tr, left, bl, [corner]])
        _need(idx.min() >= 0 and idx.max() < n + 3,
              "intra edge outside the plane")
        return idx

    # ---------------- reconstruction ---------------- #

    def _reconstruct(self, seq: SeqInfo, fr: FrameInfo):
        """Stages 2-4 on the device; returns the SB-padded recon planes.
        The frame's integers go up in two copies: the levels (int32) and
        every index, position and mv (int64)."""
        dev = self.device
        levels = _Pack(np.int32)
        resid = [(key, len(ents), ents[0][2].shape[0],
                  self._idx.add([e[:2] for e in ents]),
                  levels.add(np.stack([e[2] for e in ents])))
                 for key, ents in self._resid.items()]
        inter = [(key, len(ents), self._idx.add(ents))
                 for key, ents in self._inter.items()]
        self._idx_t = self._idx.tensor(dev)
        self._lev_t = levels.tensor(dev)
        self._bufs, self._rec, self._res = [], [], []
        base = 1 << (seq.bit_depth - 1)
        for h, w in self._dims:
            buf = torch.zeros(h * w + 3, dtype=torch.int32, device=dev)
            buf[h * w].fill_(base - 1)
            buf[h * w + 1].fill_(base + 1)
            buf[h * w + 2].fill_(base)
            self._bufs.append(buf)
            self._rec.append(buf[:h * w].view(h, w))
            self._res.append(torch.zeros((h, w), dtype=torch.int32,
                                         device=dev))
        self._residuals(seq, fr, resid)
        self._predict_inter(seq, fr, inter)
        self._predict_intra(seq, fr)
        return tuple(self._rec)

    def _block_index(self, pos, bs):
        """(rows [n, bs, 1], cols [n, 1, bs]) of the n blocks at pos [n,
        2] (y0, x0)."""
        ar = torch.arange(bs, device=self.device)
        return pos[:, 0, None, None] + ar[None, :, None], \
            pos[:, 1, None, None] + ar[None, None, :]

    def _residuals(self, seq: SeqInfo, fr: FrameInfo, groups):
        """Stage 2: each (plane, tx size, tx type) group dequantized and
        inverse-transformed in one batch into the residual planes."""
        bd = seq.bit_depth
        dc, ac = tbl.qindex_to_dq(fr.base_q_idx, bd)
        for (plane, txs, tx_type), n, bs, pos_off, lev_off in groups:
            lev = self._lev_t[lev_off:lev_off + n * bs * bs].view(n, bs, bs)
            pos = self._idx_t[pos_off:pos_off + 2 * n].view(n, 2)
            res = inv_txfm2d(dequantize_dq(lev, txs, dc, ac, bd), txs,
                             tx_type, bd)
            rows, cols = self._block_index(pos, bs)
            self._res[plane][rows, cols] = res

    def _predict_inter(self, seq: SeqInfo, fr: FrameInfo, groups):
        """Stage 3: one motion-compensated batch per (plane, size,
        compound) group, plus residual, clipped, into the recon planes."""
        bd = seq.bit_depth
        for (plane, bs, comp), n, off in groups:
            k = 6 if comp else 4
            a = self._idx_t[off:off + k * n].view(n, k)
            ss = min(plane, 1)
            args = (a[None, :, 0], a[None, :, 1], a[None, :, 2:4])
            if comp:
                pred = predict_inter_blocks_compound(
                    self._refp[plane][None], self._refp2[plane][None],
                    *args, a[None, :, 4:6], seq.height, seq.width, bs, ss,
                    bd, fr.interpolation_filter)[0]
            else:
                pred = predict_inter_blocks(
                    self._refp[plane][None], *args, seq.height, seq.width,
                    bs, ss, bd, fr.interpolation_filter)[0]
            rows, cols = self._block_index(a, bs)
            self._rec[plane][rows, cols] = (
                pred + self._res[plane][rows, cols]).clamp_(0, (1 << bd) - 1)

    def _predict_intra(self, seq: SeqInfo, fr: FrameInfo):
        """Stage 4: the intra blocks in decode order, on the device; no
        value is read back to the host."""
        bd = seq.bit_depth
        hi = (1 << bd) - 1
        for plane, y0, x0, bs, mode, adelta, ha, hl, off in self._intra:
            e = self._bufs[plane][self._idx_t[off:off + 4 * bs + 1]]
            above, left = e[None, :bs], e[None, 2 * bs:3 * bs]
            corner = e[4 * bs:]
            if mode == intra.DC_PRED:
                pred = intra.dc_pred(above, left, ha, hl, bd)[0]
            elif _directional(mode, adelta):
                pred = dr_pred(mode, adelta, e[None, :2 * bs],
                               e[None, 2 * bs:4 * bs], corner, bs, bd)[0]
            else:
                pred = intra.predict(mode, above, left, corner)[0]
            blk = self._rec[plane][y0:y0 + bs, x0:x0 + bs]
            blk.copy_((pred + self._res[plane][y0:y0 + bs, x0:x0 + bs])
                      .clamp_(0, hi))

    # ---------------- frame stages ---------------- #

    def _filter_frame(self, planes, seq: SeqInfo, fr: FrameInfo):
        """Stage 5: partition deblock on the SB-padded planes, crop to the
        signalled size, CDEF, CCSO from the pre-CDEF luma, LR."""
        y, u, v = planes
        bd = seq.bit_depth
        th = seq.height
        vh = None if y.shape[0] == th else th
        vhc = None if vh is None else vh // 2
        if fr.filter_level[0] or fr.filter_level[1]:
            pm = upload(self._part_map, self.device)
            psb = upload(self._part_sb_map, self.device)
            y = deblock_plane_part(y, pm, 32, 14, fr.filter_level[0],
                                   fr.filter_level[1], fr.lf_sharpness,
                                   bd=bd, part_sb=psb, valid_h=vh)
            u = deblock_plane_part(u, pm, 16, 6, fr.filter_level_u,
                                   fr.filter_level_u, fr.lf_sharpness,
                                   bd=bd, part_sb=psb, valid_h=vhc)
            v = deblock_plane_part(v, pm, 16, 6, fr.filter_level_v,
                                   fr.filter_level_v, fr.lf_sharpness,
                                   bd=bd, part_sb=psb, valid_h=vhc)
        # crop the SB-padded recon to the signalled frame size; every
        # later stage (CDEF/LR/refs/output) sees the true dims
        y, u, v = y[:th], u[:th // 2], v[:th // 2]
        db_planes = (y, u, v)
        if seq.enable_cdef and any(
                p or s for p, s in (fr.cdef_y_strengths +
                                    fr.cdef_uv_strengths)):
            params = {"damping": fr.cdef_damping,
                      "bits": fr.cdef_bits,
                      "y_strengths": fr.cdef_y_strengths,
                      "uv_strengths": fr.cdef_uv_strengths,
                      "idx_map": self._cdef_idx}
            y, u, v = cdef_apply_params((y, u, v), self._skip8, params, bd)
        if fr.ccso is not None:
            # fork graft: correct post-CDEF planes from the pre-CDEF luma
            # (EbCcso.c:626 ccso_frame dataflow)
            info = {"planes": [
                (dict(pi, flags=self._ccso_flags[p])
                 if pi is not None else None)
                for p, pi in enumerate(fr.ccso["planes"])]}
            y, u, v = ccso_apply_frame((y, u, v), db_planes[0], info, bd)
        if any(fr.lr_frame_types):
            infos = [self._lr_units[p] if fr.lr_frame_types[p]
                     else None for p in range(3)]
            y, u, v = lr_apply_frame((y, u, v), db_planes, infos, bd)
        return tuple(p.to(torch.int32) for p in (y, u, v))

    # ---------------- public ---------------- #

    def decode_frame_obus(self, data: bytes):
        """Decode one temporal unit; returns (y, u, v) numpy planes (uint8,
        or uint16 at 10-bit) or None.

        Raises DecodeError on corrupt/unsupported input."""
        try:
            return self._decode_frame_obus(data)
        except DecodeError:
            raise
        except (AssertionError, IndexError, ValueError,
                NotImplementedError) as e:
            raise DecodeError(f"corrupt or unsupported stream: {e}") from e

    def reference(self, slot: int):
        """The DPB entry of `slot` as (y, u, v) numpy int32 planes of the
        signalled size (None when the slot is empty)."""
        ent = self.dpb[slot]
        if ent is None:
            return None
        return tuple(p.cpu().numpy() for p in self._crop(ent))

    @staticmethod
    def _crop(padded):
        P = MV_PRED_PAD
        return tuple(p[P:p.shape[0] - P, P:p.shape[1] - P] for p in padded)

    def _resolve_film_grain(self, fg):
        """Resolve update_grain=0 (load_grain_params): copy the stored
        slot params, keeping this frame's grain_seed (spec §6.8.20
        tempGrainSeed rule)."""
        if fg is None or "load_ref_idx" not in fg:
            return fg
        base = self.dpb_fg[fg["load_ref_idx"]]
        _need(base is not None, "film grain load from empty slot")
        out = dict(base)
        out["grain_seed"] = out["random_seed"] = fg["grain_seed"]
        return out

    def _output_frame(self, planes, fg):
        """Display path: one device-to-host copy of the planes; film grain
        synthesis applies to the output only, references stay grain-free
        (§7.18)."""
        bd = self.seq.bit_depth
        dt = np.uint8 if bd == 8 else np.uint16
        flat = torch.cat([p.reshape(-1) for p in planes]).to(
            torch.uint8 if bd == 8 else torch.int16).cpu().numpy()
        out, off = [], 0
        for p in planes:
            n = p.numel()
            out.append(flat[off:off + n].reshape(p.shape).astype(dt))
            off += n
        if fg is None:
            return tuple(out)
        out = apply_film_grain(fg, tuple(p.astype(np.uint8) for p in out))
        return tuple(p.astype(dt) for p in out)

    def _decode_frame_obus(self, data: bytes):
        frame = None
        for obu_type, _, _, payload in parse_obus(data):
            if obu_type == OBU_SEQUENCE_HEADER:
                self.seq = self._parse_sequence_header(payload)
            elif obu_type == OBU_METADATA:        # §5.8
                try:
                    self.metadata.append(parse_metadata_payload(payload))
                except Exception:
                    pass               # unknown metadata is skippable
            elif obu_type == OBU_FRAME:
                _need(self.seq is not None, "frame before sequence header")
                r = BitReader(payload)
                fr = self._parse_frame_header(r, self.seq)
                r.byte_align()
                if fr.tile_cols_log2 > 0:
                    # tile_group_obu: tile_start_and_end flag, then align
                    _need(r.bit() == 0, "tile_start_and_end_present")
                    r.byte_align()
                tile_data = payload[r.bits_read // 8:]
                self._end_cdf = None
                self.frame_header = fr
                self._parse_tiles(tile_data, self.seq, fr)
                y, u, v = self._filter_frame(
                    self._reconstruct(self.seq, fr), self.seq, fr)
                fg = self._resolve_film_grain(fr.film_grain)
                if fr.show_frame:
                    frame = self._output_frame((y, u, v), fg)
                refresh = (0xFF if fr.frame_type == 0
                           else fr.refresh_frame_flags)
                ref_entry = tuple(pad_plane(p) for p in (y, u, v))
                end_cdf = None
                if (not fr.disable_cdf_update and
                        not fr.disable_frame_end_update_cdf and
                        self._end_cdf is not None):
                    end_cdf = self._end_cdf.snapshot()
                for slot in range(8):
                    if refresh & (1 << slot):
                        self.dpb[slot] = ref_entry
                        self.dpb_cdf[slot] = end_cdf
                        self.dpb_fg[slot] = fg
                        self.dpb_gm[slot] = dict(fr.gm_mv or {})
            elif obu_type == OBU_FRAME_HEADER:
                _need(self.seq is not None, "header before sequence header")
                fr = self._parse_frame_header(BitReader(payload), self.seq)
                _need(fr.show_existing_idx >= 0,
                      "separate non-show_existing frame header OBUs")
                ent = self.dpb[fr.show_existing_idx]
                _need(ent is not None, "show_existing of empty slot")
                frame = self._output_frame(
                    self._crop(ent), self.dpb_fg[fr.show_existing_idx])
            elif obu_type == OBU_TILE_GROUP:
                raise NotImplementedError("separate tile group OBUs")
        return frame
