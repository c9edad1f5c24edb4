"""Inter-frame mode-info symbol writers (spec §5.11.15-5.11.32).

Copy of the single-reference writers of ``svtav1_tpu/ec/inter_modes.py``:
is_inter, the LAST reference, the inter modes (NEWMV / NEARESTMV / NEARMV /
GLOBALMV), the DRL index, motion-vector residuals and the intra y mode of
inter frames, with their contexts (reference EbDecParseInterBlock.c:27-347
neighbour ref counts and single-ref contexts, :1167 drl ctx, :1217-1257
read_mv; EbDecParseHelper.c:129 intra/inter ctx).  The compound writers and
every reader are not ported.
"""

from __future__ import annotations

import numpy as np

from ..spec import mv as M

# size_group_lookup[BLOCK_32X32] (intra y-mode cdf bucket in inter frames)
SIZE_GROUP_32 = 3


# ------------------------------------------------------------------ #
# contexts

def intra_inter_ctx(above_inter, left_inter):
    """above_inter/left_inter: None if unavailable, else bool is_inter."""
    if above_inter is not None and left_inter is not None:
        ai, li = int(not above_inter), int(not left_inter)
        return 3 if (ai and li) else (ai or li)
    if above_inter is not None or left_inter is not None:
        nb = above_inter if above_inter is not None else left_inter
        return 2 * int(not nb)
    return 0


def neighbor_ref_counts(above_ref, left_ref):
    """Reference-frame histogram over the two direct neighbours; each is
    None (unavailable or intra) or an int reference."""
    counts = np.zeros(8, np.int32)
    for r in (above_ref, left_ref):
        if r is not None and r >= 1:
            counts[r] += 1
    return counts


def _ctx3(a: int, b: int) -> int:
    return 1 if a == b else (0 if a < b else 2)


def single_ref_p1_ctx(counts):
    fwd = counts[1] + counts[2] + counts[3] + counts[4]
    bwd = counts[5] + counts[6] + counts[7]
    return _ctx3(fwd, bwd)


def single_ref_p3_ctx(counts):        # get_pred_context_comp_ref_p
    return _ctx3(counts[1] + counts[2], counts[3] + counts[4])


def single_ref_p4_ctx(counts):
    return _ctx3(counts[1], counts[2])


def drl_ctx(stack, idx: int) -> int:
    w0 = stack[idx][-1]
    w1 = stack[idx + 1][-1]
    if w0 >= M.REF_CAT_LEVEL and w1 < M.REF_CAT_LEVEL:
        return 1
    if w0 < M.REF_CAT_LEVEL and w1 < M.REF_CAT_LEVEL:
        return 2
    return 0


# ------------------------------------------------------------------ #
# writers

def _sym(enc, cdf, table, val, nsyms=None):
    enc.encode_symbol(val, table, nsyms or (len(table) - 1))
    cdf.update(table, val)


def write_is_inter(enc, cdf, ctx: int, is_inter: bool):
    _sym(enc, cdf, cdf.intra_inter_cdf[ctx], int(is_inter))


def write_ref_frame_last(enc, cdf, counts):
    """Signal ref_frame = LAST (single reference)."""
    _sym(enc, cdf, cdf.single_ref_cdf[single_ref_p1_ctx(counts)][0], 0)
    _sym(enc, cdf, cdf.single_ref_cdf[single_ref_p3_ctx(counts)][2], 0)
    _sym(enc, cdf, cdf.single_ref_cdf[single_ref_p4_ctx(counts)][3], 0)


def write_inter_mode(enc, cdf, mode: int, mode_context: int):
    newmv_ctx = mode_context & M.NEWMV_CTX_MASK
    _sym(enc, cdf, cdf.newmv_cdf[newmv_ctx], int(mode != M.NEWMV))
    if mode == M.NEWMV:
        return
    zeromv_ctx = (mode_context >> M.GLOBALMV_OFFSET) & M.GLOBALMV_CTX_MASK
    _sym(enc, cdf, cdf.zeromv_cdf[zeromv_ctx], int(mode != M.GLOBALMV))
    if mode == M.GLOBALMV:
        return
    refmv_ctx = (mode_context >> M.REFMV_OFFSET) & M.REFMV_CTX_MASK
    _sym(enc, cdf, cdf.refmv_cdf[refmv_ctx], int(mode == M.NEARMV))


def write_drl_idx(enc, cdf, mode: int, stack, num_found: int):
    """ref_mv_idx is always 0 for NEWMV and 1 (stack[1]) for NEARMV
    (read_drl_idx, EbDecParseInterBlock.c:1179)."""
    if mode == M.NEWMV:
        for idx in range(2):
            if num_found > idx + 1:
                _sym(enc, cdf, cdf.drl_cdf[drl_ctx(stack, idx)], 0)
                return
    if M.has_nearmv(mode):
        for idx in range(1, 3):
            if num_found > idx + 1:
                _sym(enc, cdf, cdf.drl_cdf[drl_ctx(stack, idx)], 0)
                return


def write_mv_component(enc, cdf, comp: int, diff: int, usehp: bool = False):
    """comp 0 = row, 1 = col; diff in 1/8 pel (even without hp)."""
    sign = int(diff < 0)
    mag = -diff if sign else diff
    mv_class, offset = M.get_mv_class(mag - 1)
    d = offset >> 3
    fr = (offset >> 1) & 3
    hp = offset & 1
    _sym(enc, cdf, cdf.nmv_sign_cdf[comp], sign)
    _sym(enc, cdf, cdf.nmv_classes_cdf[comp], mv_class)
    if mv_class == 0:
        _sym(enc, cdf, cdf.nmv_class0_cdf[comp], d)
    else:
        for i in range(mv_class):
            _sym(enc, cdf, cdf.nmv_bits_cdf[comp][i], (d >> i) & 1)
    fp_cdf = (cdf.nmv_class0_fp_cdf[comp][d] if mv_class == 0
              else cdf.nmv_fp_cdf[comp])
    _sym(enc, cdf, fp_cdf, fr)
    if usehp:
        hp_cdf = (cdf.nmv_class0_hp_cdf[comp] if mv_class == 0
                  else cdf.nmv_hp_cdf[comp])
        _sym(enc, cdf, hp_cdf, hp)
    elif hp != 1:
        raise ValueError("quarter-pel mv diffs must be even in 1/8 units")


def write_mv(enc, cdf, mv, ref_mv, usehp: bool = False):
    dr = mv[0] - ref_mv[0]
    dc = mv[1] - ref_mv[1]
    joint = M.mv_joint(dr, dc)
    _sym(enc, cdf, cdf.nmv_joints_cdf, joint)
    if joint & 2:
        write_mv_component(enc, cdf, 0, dr, usehp)
    if joint & 1:
        write_mv_component(enc, cdf, 1, dc, usehp)


def write_y_mode_inter(enc, cdf, mode: int, size_group: int = SIZE_GROUP_32):
    """Intra luma mode inside an inter frame (y_mode_cdf[size group], not
    kf_y_cdf)."""
    _sym(enc, cdf, cdf.y_mode_cdf[size_group], mode, 13)
