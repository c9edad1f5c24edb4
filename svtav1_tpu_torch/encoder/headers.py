"""AV1 sequence / frame header writers (spec §5.5, §5.9).

Copy of ``svtav1_tpu/encoder/headers.py``.  Reference behavior:
write_sequence_header / write_uncompressed_header_obu in the reference's
Source/Lib/Encoder/Codec/EbEntropyCoding.c:2791,3309.  We emit
*standard* AV1 (the fork's grafted CCSO sequence bit is only written in its
nonstandard `ccso` mode — see spec/ccso notes); conformance bar is decode by
dav1d/libaom, the same oracle the reference e2e suite uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.bitio import BitWriter
from ..utils.obu import (OBU_FRAME, OBU_FRAME_HEADER, OBU_SEQUENCE_HEADER,
                         OBU_TEMPORAL_DELIMITER, wrap_obu)

# the fork's CCSO offset alphabet (ccso_offset[8], the JAX package's
# ops/ccso.py), kept here so the header writer needs no CCSO module
CCSO_OFFSETS = (0, 1, -1, 3, -3, 7, -7, -10)


# AV1 Annex A.3: (seq_level_idx, MaxPicSize, MaxHSize, MaxVSize) of the
# first level of each size class from 4.0 up; every level of a class
# (4.0-4.1, 5.0-5.3, 6.0-6.3) has the same three limits
_LEVEL_SIZES = ((8, 2228224, 4096, 2304), (12, 8912896, 8192, 4352),
                (16, 35651584, 16384, 8704))
_LEVEL_MAX = 31                     # no level's limits


def level_idx(width: int, height: int) -> int:
    """seq_level_idx of the smallest level from 4.0 up whose MaxPicSize,
    MaxHSize and MaxVSize hold a width x height frame: 8 (4.0) up to
    2,228,224 samples, 12 (5.0) for 3840x2160; 31 past every level."""
    for idx, pic, hs, vs in _LEVEL_SIZES:
        if width * height <= pic and width <= hs and height <= vs:
            return idx
    return _LEVEL_MAX


@dataclass
class SequenceConfig:
    width: int
    height: int
    bit_depth: int = 8
    seq_level_idx: int = None       # None: level_idx(width, height)
    seq_profile: int = 0
    use_128x128_sb: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_order_hint: bool = False
    order_hint_bits: int = 7
    enable_cdef: bool = False
    enable_restoration: bool = False
    enable_superres: bool = False
    monochrome: bool = False
    film_grain_params_present: bool = False
    ccso_fork_mode: bool = False    # fork-compat nonstandard bit (§2.6 SURVEY)

    def __post_init__(self):
        if self.seq_level_idx is None:
            self.seq_level_idx = level_idx(self.width, self.height)

    @property
    def frame_width_bits(self) -> int:
        return max((self.width - 1).bit_length(), 1)

    @property
    def frame_height_bits(self) -> int:
        return max((self.height - 1).bit_length(), 1)

    @property
    def sb_size(self) -> int:
        return 128 if self.use_128x128_sb else 64


@dataclass
class FrameConfig:
    frame_type: int = 0             # 0 KEY_FRAME, 1 INTER_FRAME
    show_frame: bool = True
    base_q_idx: int = 100
    disable_cdf_update: bool = True
    tx_mode_select: bool = False    # False → TX_MODE_LARGEST
    disable_frame_end_update_cdf: bool = True
    reduced_tx_set: bool = True
    allow_screen_content_tools: bool = False
    filter_level: tuple = (0, 0)    # (y_vert, y_horz)
    filter_level_u: int = 0
    filter_level_v: int = 0
    lf_sharpness: int = 0
    tile_cols_log2: int = 0         # uniform tile columns (2^k)
    context_update_tile_id: int = 0
    # CDEF (written only when seq.enable_cdef)
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_strengths: tuple = ((0, 0),)     # (pri, sec) per preset
    cdef_uv_strengths: tuple = ((0, 0),)
    # inter-frame fields (low-delay P defaults: all refs → DPB slot 0,
    # refresh slot 0, CDFs reset per frame via PRIMARY_REF_NONE)
    # loop restoration per-plane frame types (0 NONE, 1 WIENER,
    # 2 SGRPROJ, 3 SWITCHABLE); written only when seq.enable_restoration
    lr_frame_types: tuple = (0, 0, 0)
    error_resilient: bool = False
    primary_ref_frame: int = 7      # PRIMARY_REF_NONE
    refresh_frame_flags: int = 0x01
    ref_frame_idx: tuple = (0, 0, 0, 0, 0, 0, 0)
    allow_high_precision_mv: bool = False
    interpolation_filter: int = 0   # EIGHTTAP_REGULAR (frame-level)
    # film grain (written when seq.film_grain_params_present and the
    # frame is shown/showable): None → apply_grain=0; a params dict
    # (ops/film_grain naming + "grain_seed") → full update; a dict with
    # "load_ref_idx" → update_grain=0 load-from-reference
    film_grain: dict = None
    reference_select: bool = False  # REFERENCE_MODE_SELECT (compound)
    # global motion (TRANSLATION only): {ref(1..7): (mv_row, mv_col)} in
    # 1/8-pel (even — quarter-pel precision with !allow_high_precision);
    # gm_prev = the primary-ref frame's saved gm_mv dict (PrevGmParams
    # chain for the subexp reference, spec 5.9.25)
    gm_mv: dict = None
    gm_prev: dict = None
    # CCSO (fork graft; written only when seq.ccso_fork_mode): None →
    # ccso_frame_flag 0, else the ccso_search info dict ({'planes': [...]})
    ccso: dict = None


def write_sequence_header_obu(cfg: SequenceConfig) -> bytes:
    w = BitWriter()
    w.f(cfg.seq_profile, 3)
    w.bit(0)                        # still_picture
    w.bit(0)                        # reduced_still_picture_header
    w.bit(0)                        # timing_info_present_flag
    w.bit(0)                        # initial_display_delay_present_flag
    w.f(0, 5)                       # operating_points_cnt_minus_1
    w.f(0, 12)                      # operating_point_idc[0]
    w.f(cfg.seq_level_idx, 5)
    if cfg.seq_level_idx > 7:
        w.bit(0)                    # seq_tier[0]

    w.f(cfg.frame_width_bits - 1, 4)
    w.f(cfg.frame_height_bits - 1, 4)
    w.f(cfg.width - 1, cfg.frame_width_bits)
    w.f(cfg.height - 1, cfg.frame_height_bits)

    w.bit(0)                        # frame_id_numbers_present_flag
    w.bit(1 if cfg.use_128x128_sb else 0)
    w.bit(1 if cfg.enable_filter_intra else 0)
    w.bit(1 if cfg.enable_intra_edge_filter else 0)
    w.bit(0)                        # enable_interintra_compound
    w.bit(0)                        # enable_masked_compound
    w.bit(0)                        # enable_warped_motion
    w.bit(0)                        # enable_dual_filter
    w.bit(1 if cfg.enable_order_hint else 0)
    if cfg.enable_order_hint:
        w.bit(0)                    # enable_jnt_comp
        w.bit(0)                    # enable_ref_frame_mvs
    w.bit(0)                        # seq_choose_screen_content_tools
    w.bit(0)                        # seq_force_screen_content_tools = 0
    if cfg.enable_order_hint:
        w.f(cfg.order_hint_bits - 1, 3)
    w.bit(1 if cfg.enable_superres else 0)
    w.bit(1 if cfg.enable_cdef else 0)
    w.bit(1 if cfg.enable_restoration else 0)
    if cfg.ccso_fork_mode:
        w.bit(1)                    # fork's grafted enable_ccso (nonstandard)

    # color_config
    w.bit(1 if cfg.bit_depth == 10 else 0)   # high_bitdepth
    w.bit(1 if cfg.monochrome else 0)
    w.bit(0)                        # color_description_present_flag
    if cfg.monochrome:
        w.bit(0)                    # color_range
    else:
        w.bit(0)                    # color_range
        # profile 0: 4:2:0 implied; chroma_sample_position
        w.f(0, 2)                   # CSP_UNKNOWN
        w.bit(0)                    # separate_uv_delta_q

    w.bit(1 if cfg.film_grain_params_present else 0)

    # trailing bits
    w.bit(1)
    w.byte_align()
    return wrap_obu(OBU_SEQUENCE_HEADER, w.data())


def write_frame_header(seq: SequenceConfig, fr: FrameConfig,
                       for_obu_frame: bool = True) -> BitWriter:
    """Uncompressed frame header bits (spec §5.9.2) for shown KEY intra
    frames and single-reference low-delay INTER frames.  Field order
    matches the reference writer (EbEntropyCoding.c:3309
    write_uncompressed_header_obu)."""
    w = BitWriter()
    is_inter = fr.frame_type == 1
    w.bit(0)                        # show_existing_frame
    w.f(fr.frame_type, 2)
    w.bit(1 if fr.show_frame else 0)
    if not fr.show_frame:
        w.bit(1)                    # showable_frame (show_existing later)
    if fr.frame_type not in (0, 1):
        raise NotImplementedError("intra-only / switch frames")
    if is_inter:
        w.bit(1 if fr.error_resilient else 0)
    w.bit(1 if fr.disable_cdf_update else 0)
    # allow_screen_content_tools: seq_force==0 → inferred 0
    # force_integer_mv: inferred 0 (seq_force_integer_mv == SELECT but
    # allow_screen_content_tools == 0)
    w.bit(0)                        # frame_size_override_flag
    if seq.enable_order_hint:
        w.f(0, seq.order_hint_bits)  # order_hint
    if is_inter and not fr.error_resilient:
        w.f(fr.primary_ref_frame, 3)
    if is_inter:
        w.f(fr.refresh_frame_flags, 8)
        # ref_order_hint: only if error_resilient && enable_order_hint
        for i in range(7):
            w.f(fr.ref_frame_idx[i], 3)
    # refresh_frame_flags: KEY+show → inferred 0xFF

    # frame_size: override 0 → max size; superres disabled at seq → skip
    if seq.enable_superres:
        w.bit(0)                    # use_superres
    w.bit(0)                        # render_and_frame_size_different

    if is_inter:
        w.bit(1 if fr.allow_high_precision_mv else 0)
        w.bit(0)                    # is_filter_switchable
        w.f(fr.interpolation_filter, 2)
        w.bit(0)                    # is_motion_mode_switchable
        # use_ref_frame_mvs: needs enable_order_hint → skip
    # allow_intrabc: only if allow_screen_content_tools (key/intra frames)
    if not fr.disable_cdf_update:
        w.bit(1 if fr.disable_frame_end_update_cdf else 0)
    # tile_info
    sb = seq.sb_size
    sb_cols = (seq.width + sb - 1) // sb
    sb_rows = (seq.height + sb - 1) // sb
    _write_tile_info(w, sb_cols, sb_rows, sb, fr.tile_cols_log2,
                     fr.context_update_tile_id)

    # quantization_params
    w.f(fr.base_q_idx, 8)
    w.bit(0)                        # delta_q_y_dc present
    if not seq.monochrome:
        # separate_uv_delta_q=0 → no diff_uv_delta
        w.bit(0)                    # delta_q_u_dc
        w.bit(0)                    # delta_q_u_ac
    w.bit(0)                        # using_qmatrix

    # segmentation_params
    w.bit(0)                        # segmentation_enabled

    # delta_q_params
    if fr.base_q_idx > 0:
        w.bit(0)                    # delta_q_present
    # delta_lf only if delta_q_present

    # loop_filter_params (CodedLossless false, allow_intrabc false)
    w.f(fr.filter_level[0], 6)
    w.f(fr.filter_level[1], 6)
    if not seq.monochrome and (fr.filter_level[0] or fr.filter_level[1]):
        w.f(fr.filter_level_u, 6)
        w.f(fr.filter_level_v, 6)
    w.f(fr.lf_sharpness, 3)
    w.bit(0)                        # loop_filter_delta_enabled

    # cdef_params (spec §5.9.19; sec strength 4 codes as 3)
    if seq.enable_cdef:
        w.f(fr.cdef_damping - 3, 2)
        w.f(fr.cdef_bits, 2)
        for i in range(1 << fr.cdef_bits):
            yp, ys = fr.cdef_y_strengths[i]
            up, us = fr.cdef_uv_strengths[i]
            w.f(yp, 4)
            w.f(min(ys, 3), 2)
            w.f(up, 4)
            w.f(min(us, 3), 2)
    # lr_params (spec §5.9.20): per-plane frame restoration type +
    # unit sizes.  Unit size fixed at 64 luma / 32 chroma (lr_unit_shift
    # = 0, lr_uv_shift = 1) — one unit per superblock.
    if seq.enable_restoration:
        uses_lr = False
        uses_chroma_lr = False
        for p, t in enumerate(fr.lr_frame_types):
            # Remap_Lr_Type coded order: NONE, SWITCHABLE, WIENER, SGRPROJ
            w.f({0: 0, 1: 2, 2: 3, 3: 1}[t], 2)
            if t != 0:
                uses_lr = True
                if p > 0:
                    uses_chroma_lr = True
        if uses_lr:
            w.bit(0)                # lr_unit_shift = 0 → 64px luma units
            if uses_chroma_lr:
                w.bit(1)            # lr_uv_shift → 32px chroma units

    # CCSO params (fork graft; EbEntropyCoding.c:2361 encode_ccso with
    # CONFIG_D143_CCSO_FM_FLAG=1 + CONFIG_CCSO_SIGFIX=1, EbDefinitions.h:
    # 1413-1414) — only in nonstandard fork-syntax streams
    if seq.ccso_fork_mode:
        _write_ccso(w, fr)

    # read_tx_mode
    w.bit(1 if fr.tx_mode_select else 0)
    if is_inter:
        w.bit(1 if fr.reference_select else 0)
    # skip_mode: not allowed (no reference_select / order hints) → skip
    # allow_warped_motion: seq enable_warped_motion=0 → inferred 0
    w.bit(1 if fr.reduced_tx_set else 0)
    if is_inter:
        _write_global_motion(w, fr)
    _write_film_grain_params(w, seq, fr)
    return w


def _write_global_motion(w: BitWriter, fr: FrameConfig) -> None:
    """global_motion_params (spec 5.9.24/25), TRANSLATION type only.
    Reference read path: EbDecParseObu.c:1184-1258 read_global_param
    (abs_bits = GM_ABS_TRANS_ONLY_BITS-1 = 8, prec_bits = 2 with
    !allow_high_precision_mv; coded value = gm_params >> 14 = mv >> 1
    since gm_params = mv << (WARPEDMODEL_PREC_BITS - 3))."""
    from ..ec.subexp import write_signed_subexp_bits
    gm = fr.gm_mv or {}
    prev = fr.gm_prev or {}
    for ref in range(1, 8):
        mv = tuple(gm.get(ref, (0, 0)))
        if mv == (0, 0):
            w.bit(0)                # is_global = 0 (IDENTITY)
            continue
        w.bit(1)                    # is_global
        w.bit(0)                    # is_rot_zoom
        w.bit(1)                    # is_translation
        pmv = tuple(prev.get(ref, (0, 0)))
        for i in (0, 1):            # params[0]=row, params[1]=col
            write_signed_subexp_bits(w, -256, 257, pmv[i] >> 1,
                                     mv[i] >> 1)


def _write_ccso(w: BitWriter, fr: FrameConfig) -> None:
    """encode_ccso (EbEntropyCoding.c:2361): frame flag, per-plane config,
    then truncated-unary offset-idx per LUT entry over the signaled
    (edge-interval² × band) grid; offset alphabet ccso_offset[8]."""
    info = fr.ccso
    w.bit(1 if info else 0)
    if not info:
        return
    for p in range(3):
        pi = info["planes"][p]
        w.bit(1 if pi else 0)
        if not pi:
            continue
        bo_only = int(pi.get("bo_only", 0))
        mbl = int(pi["max_band_log2"])
        edge_clf = int(pi["edge_clf"])
        w.bit(bo_only)
        if bo_only:
            w.f(mbl, 3)
        else:
            w.f(int(pi["quant_idx"]), 2)
            w.f(int(pi["support"]), 3)
            w.bit(edge_clf)
            w.f(mbl, 2)
        intervals = 1 if bo_only else (3 if edge_clf == 0 else 2)
        lut = pi["lut"]
        for d0 in range(intervals):
            for d1 in range(intervals):
                for band in range(1 << mbl):
                    oi = CCSO_OFFSETS.index(
                        int(lut[(band << 4) + (d0 << 2) + d1]))
                    for k in range(7):      # truncated unary, 7 max bits
                        w.bit(1 if oi != k else 0)
                        if oi == k:
                            break


def _write_film_grain_params(w: BitWriter, seq: SequenceConfig,
                             fr: FrameConfig) -> None:
    """film_grain_params (spec §5.9.30; reference writer
    EbEntropyCoding.c:3125 write_film_grain_params).  Our no-show frames
    are always showable, so presence reduces to the sequence flag."""
    if not seq.film_grain_params_present:
        return
    fg = fr.film_grain
    w.bit(1 if fg else 0)           # apply_grain
    if not fg:
        return
    w.f(fg["grain_seed"], 16)
    if fr.frame_type == 1:
        update = "load_ref_idx" not in fg
        w.bit(1 if update else 0)
        if not update:
            w.f(fg["load_ref_idx"], 3)
            return
    w.f(fg["num_y_points"], 4)
    for x, v in fg["scaling_points_y"]:
        w.f(x, 8)
        w.f(v, 8)
    if not seq.monochrome:
        w.bit(1 if fg["chroma_scaling_from_luma"] else 0)
    chroma_pts = not (seq.monochrome or fg["chroma_scaling_from_luma"] or
                      fg["num_y_points"] == 0)   # 4:2:0 rule
    if chroma_pts:
        w.f(fg["num_cb_points"], 4)
        for x, v in fg["scaling_points_cb"]:
            w.f(x, 8)
            w.f(v, 8)
        w.f(fg["num_cr_points"], 4)
        for x, v in fg["scaling_points_cr"]:
            w.f(x, 8)
            w.f(v, 8)
    w.f(fg["scaling_shift"] - 8, 2)
    lag = fg["ar_coeff_lag"]
    w.f(lag, 2)
    num_pos = 2 * lag * (lag + 1)
    if fg["num_y_points"]:
        for i in range(num_pos):
            w.f(int(fg["ar_coeffs_y"][i]) + 128, 8)
        num_pos_c = num_pos + 1
    else:
        num_pos_c = num_pos
    ncb = fg["num_cb_points"] if chroma_pts else 0
    ncr = fg["num_cr_points"] if chroma_pts else 0
    if ncb or fg["chroma_scaling_from_luma"]:
        for i in range(num_pos_c):
            w.f(int(fg["ar_coeffs_cb"][i]) + 128, 8)
    if ncr or fg["chroma_scaling_from_luma"]:
        for i in range(num_pos_c):
            w.f(int(fg["ar_coeffs_cr"][i]) + 128, 8)
    w.f(fg["ar_coeff_shift"] - 6, 2)
    w.f(fg["grain_scale_shift"], 2)
    if ncb:
        w.f(fg["cb_mult"], 8)
        w.f(fg["cb_luma_mult"], 8)
        w.f(fg["cb_offset"], 9)
    if ncr:
        w.f(fg["cr_mult"], 8)
        w.f(fg["cr_luma_mult"], 8)
        w.f(fg["cr_offset"], 9)
    w.bit(1 if fg["overlap_flag"] else 0)
    w.bit(1 if fg["clip_to_restricted_range"] else 0)


def _write_tile_info(w: BitWriter, sb_cols: int, sb_rows: int, sb: int,
                     tile_cols_log2: int = 0, ctx_update_tile: int = 0):
    """Uniform tile-column tile info (spec §5.9.15)."""
    sb_shift = 7 if sb == 128 else 6
    sb_size_log2 = sb_shift
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))

    tile_cols_log2 = max(tile_cols_log2, min_log2_tile_cols)
    if tile_cols_log2 > max_log2_tile_cols:
        raise ValueError("tile_cols_log2 beyond the level limit")
    min_log2_tile_rows = max(min_log2_tiles - tile_cols_log2, 0)
    if min_log2_tile_rows > 0:
        raise NotImplementedError("frame area forces tile rows")
    w.bit(1)                        # uniform_tile_spacing_flag
    for _ in range(tile_cols_log2 - min_log2_tile_cols):
        w.bit(1)
    if tile_cols_log2 < max_log2_tile_cols:
        w.bit(0)
    tile_rows_log2 = 0
    for _ in range(tile_rows_log2 - min_log2_tile_rows):
        w.bit(1)
    if tile_rows_log2 < max_log2_tile_rows:
        w.bit(0)
    if tile_cols_log2 > 0 or tile_rows_log2 > 0:
        w.f(ctx_update_tile, tile_cols_log2 + tile_rows_log2)
        w.f(3, 2)                   # tile_size_bytes_minus_1 (4-byte sizes)
    return (1 << tile_cols_log2), (1 << tile_rows_log2)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def assemble_frame(seq: SequenceConfig, fr: FrameConfig,
                   tile_payload, first: bool = False,
                   metadata: bytes = b"") -> bytes:
    """TD + (sequence header if first) + metadata OBUs + OBU_FRAME(frame
    hdr + tile group).

    tile_payload: bytes (single tile) or a list of per-tile byte strings
    (uniform tile columns; fr.tile_cols_log2 must match).
    metadata: pre-wrapped OBU_METADATA bytes (utils/metadata.py),
    placed after the sequence header per the spec's ordering note
    (reference: EbPacketizationProcess.c writes metadata before the
    frame OBU)."""
    out = wrap_obu(OBU_TEMPORAL_DELIMITER, b"")
    if first:
        out += write_sequence_header_obu(seq)
    out += metadata
    hdr = write_frame_header(seq, fr)
    hdr.byte_align()
    if isinstance(tile_payload, (list, tuple)):
        tiles = list(tile_payload)
    else:
        tiles = [tile_payload]
    if len(tiles) > 1:
        # tile_start_and_end_present_flag = 0 (one group, all tiles),
        # then tile_size_minus_1 (le32) before every tile but the last
        hdr.bit(0)
        hdr.byte_align()
        body = b""
        for t in tiles[:-1]:
            body += (len(t) - 1).to_bytes(4, "little") + t
        body += tiles[-1]
        payload = hdr.data() + body
    else:
        payload = hdr.data() + tiles[0]
    out += wrap_obu(OBU_FRAME, payload)
    return out


def assemble_key_frame(seq: SequenceConfig, fr: FrameConfig,
                       tile_payload: bytes, first: bool = True,
                       metadata: bytes = b"") -> bytes:
    return assemble_frame(seq, fr, tile_payload, first, metadata)


def assemble_show_existing(slot: int) -> bytes:
    """TD + OBU_FRAME_HEADER displaying DPB slot `slot`
    (show_existing_frame=1, spec §5.9.2; reference packetization emits
    these for overlay/alt-ref display, EbPacketizationProcess.c)."""
    w = BitWriter()
    w.bit(1)                        # show_existing_frame
    w.f(slot, 3)                    # frame_to_show_map_idx
    w.bit(1)                        # trailing_bits: standalone
    w.byte_align()                  # OBU_FRAME_HEADER ends 1 + zeros
    return (wrap_obu(OBU_TEMPORAL_DELIMITER, b"") +
            wrap_obu(OBU_FRAME_HEADER, w.data()))
