"""Motion vector math of the encoder and the decoder (AV1 spec §6.10.23,
§7.10.2).

Copy of ``svtav1_tpu/spec/mv.py``.  Behavior reference:
EbDecParseInterBlock.c (decoder side, i.e. spec-conformant) and
EbCabacContextModel.h:527-541 for the coding layout.

MVs are (row, col) pairs in 1/8-luma-pel units throughout.
"""

from __future__ import annotations

# prediction modes (AV1 PredictionMode enum order)
NEARESTMV = 13
NEARMV = 14
GLOBALMV = 15
NEWMV = 16

MV_JOINTS = 4          # ZERO, HNZVZ, HZVNZ, HNZVNZ
MV_CLASSES = 11
CLASS0_SIZE = 2
MV_OFFSET_BITS = 10
MV_FP_SIZE = 4

MV_BORDER = 16 * 8     # 16 pels in 1/8 units
REF_CAT_LEVEL = 640
MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
MVREF_ROW_COLS = 3

# mode_context packing (EbDefinitions.h:1292-1297)
GLOBALMV_OFFSET = 3
REFMV_OFFSET = 4
NEWMV_CTX_MASK = (1 << GLOBALMV_OFFSET) - 1
GLOBALMV_CTX_MASK = (1 << (REFMV_OFFSET - GLOBALMV_OFFSET)) - 1
REFMV_CTX_MASK = (1 << (8 - REFMV_OFFSET)) - 1

# reference frames
NONE_FRAME = -1
INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7


# compound inter modes (PredictionMode enum order)
NEAREST_NEARESTMV = 17
NEAR_NEARMV = 18
NEAREST_NEWMV = 19
NEW_NEARESTMV = 20
NEAR_NEWMV = 21
NEW_NEARMV = 22
GLOBAL_GLOBALMV = 23
NEW_NEWMV = 24


def has_newmv(mode: int) -> bool:
    return mode in (NEWMV, NEW_NEWMV, NEAR_NEWMV, NEW_NEARMV,
                    NEAREST_NEWMV, NEW_NEARESTMV)


def has_nearmv(mode: int) -> bool:
    return mode in (NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV)


def compound_mode_ctx(mode_context: int) -> int:
    """svt_aom_mode_context_analyzer (EbInterPrediction.c:2439)."""
    cmap = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))
    newmv_ctx = mode_context & NEWMV_CTX_MASK
    refmv_ctx = (mode_context >> REFMV_OFFSET) & REFMV_CTX_MASK
    return cmap[refmv_ctx >> 1][min(newmv_ctx, 4)]


def is_inter_mode(mode: int) -> bool:
    return mode >= NEARESTMV


def get_mv_class(z: int):
    """(class, offset) for magnitude-1 value z (svt_av1_get_mv_class)."""
    c = 10 if z >= CLASS0_SIZE * 4096 else max((z >> 3).bit_length() - 1, 0)
    base = 0 if c == 0 else CLASS0_SIZE << (c + 2)
    return c, z - base


def mv_joint(row: int, col: int) -> int:
    return (1 if col else 0) | ((1 if row else 0) << 1)


def lower_mv_precision(row: int, col: int, allow_hp: bool = False,
                       force_int: bool = False):
    """Spec lower_mv_precision: quarter-pel rounding toward zero when high
    precision is off."""
    if force_int:
        row = (row // 8) * 8 if row >= 0 else -((-row // 8) * 8)
        col = (col // 8) * 8 if col >= 0 else -((-col // 8) * 8)
        return row, col
    if not allow_hp:
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return row, col


def clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def clamp_mv_ref(row: int, col: int, bw4: int, bh4: int, mi_row: int,
                 mi_col: int, mi_rows: int, mi_cols: int):
    """Stack-entry clamp (clamp_mv_ref): block edges ± (size·8 + MV_BORDER).
    bw4/bh4 in mi (4-pel) units."""
    bw_px, bh_px = bw4 * 4, bh4 * 4
    mb_to_left = -(mi_col * 32)
    mb_to_right = (mi_cols - bw4 - mi_col) * 32
    mb_to_top = -(mi_row * 32)
    mb_to_bottom = (mi_rows - bh4 - mi_row) * 32
    col = clamp(col, mb_to_left - bw_px * 8 - MV_BORDER,
                mb_to_right + bw_px * 8 + MV_BORDER)
    row = clamp(row, mb_to_top - bh_px * 8 - MV_BORDER,
                mb_to_bottom + bh_px * 8 + MV_BORDER)
    return row, col


def clamp_mv_to_umv_border(row: int, col: int, bw_px: int, bh_px: int,
                           mi_row: int, mi_col: int, bw4: int, bh4: int,
                           mi_rows: int, mi_cols: int, ss_x: int, ss_y: int):
    """Prediction-time clamp (dec_clamp_mv_to_umv_border_sb) — returns the
    plane-scaled mv in 1/16-plane-pel units."""
    spel_left = (4 + bw_px) << 4
    spel_right = spel_left - 16
    spel_top = (4 + bh_px) << 4
    spel_bottom = spel_top - 16
    r = row * (1 << (1 - ss_y))
    c = col * (1 << (1 - ss_x))
    mb_to_left = -(mi_col * 32)
    mb_to_right = (mi_cols - bw4 - mi_col) * 32
    mb_to_top = -(mi_row * 32)
    mb_to_bottom = (mi_rows - bh4 - mi_row) * 32
    c = clamp(c, mb_to_left * (1 << (1 - ss_x)) - spel_left,
              mb_to_right * (1 << (1 - ss_x)) + spel_right)
    r = clamp(r, mb_to_top * (1 << (1 - ss_y)) - spel_top,
              mb_to_bottom * (1 << (1 - ss_y)) + spel_bottom)
    return r, c
