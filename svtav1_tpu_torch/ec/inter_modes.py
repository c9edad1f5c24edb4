"""Inter-frame mode-info symbol coding (spec §5.11.15-5.11.32).

Copy of ``svtav1_tpu/ec/inter_modes.py``: write/read pairs for is_inter,
the single LAST reference, the inter modes (NEWMV / NEARESTMV / NEARMV /
GLOBALMV), the DRL index, motion-vector residuals and the intra y mode of
inter frames, with their contexts; and the compound syntax of
REFERENCE_MODE_SELECT frames (the reference mode, the LAST+ALTREF pair,
the compound modes), written and read.  Context derivations mirror the
reference's spec-conformant decoder (EbDecParseInterBlock.c:27-347
neighbour ref counts and single-ref contexts, :57 reference-mode context,
:1167 drl ctx, :1217-1257 read_mv; EbDecParseHelper.c:129 intra/inter ctx,
:213 compound reference type context).
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
    """ref frame histogram over the two direct neighbors; each entry is
    None (unavailable-or-intra), an int ref, or a (ref0, ref1) pair for
    compound neighbors (both refs counted, count_refs in spec)."""
    counts = np.zeros(8, np.int32)
    for r in (above_ref, left_ref):
        if r is None:
            continue
        for ri in (r if isinstance(r, tuple) else (r,)):
            if ri >= 1:
                counts[ri] += 1
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
# encoder side

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


IS_BACKWARD = lambda r: r is not None and r >= M.BWDREF_FRAME


def ref_mode_ctx(above, left):
    """get_reference_mode_context (EbDecParseInterBlock.c:57).
    above/left: None (unavailable) or (is_inter, ref0, ref1) with
    ref1 = 0 for single-ref / intra neighbors."""
    def second(nb):
        return nb is not None and nb[2] >= 1

    if above is not None and left is not None:
        if not second(above) and not second(left):
            return int(IS_BACKWARD(above[1]) and above[0]) ^ \
                int(IS_BACKWARD(left[1]) and left[0])
        if not second(above):
            return 2 + int((above[0] and IS_BACKWARD(above[1])) or
                           not above[0])
        if not second(left):
            return 2 + int((left[0] and IS_BACKWARD(left[1])) or
                           not left[0])
        return 4
    nb = above if above is not None else left
    if nb is not None:
        if not second(nb):
            return int(nb[0] and IS_BACKWARD(nb[1]))
        return 3
    return 1


def comp_ref_type_ctx(above, left):
    """svt_aom_get_comp_reference_type_context
    (EbDecParseHelper.c:213).  Neighbor tuples as in ref_mode_ctx; all
    our compound pairs are bidirectional (no unidir emission)."""
    def second(nb):
        return nb[2] >= 1

    def uni(nb):
        # has_uni_comp_refs: both refs on the same side
        return second(nb) and not (IS_BACKWARD(nb[2]) ^
                                   IS_BACKWARD(nb[1]))

    if above is not None and left is not None:
        a_intra = not above[0]
        l_intra = not left[0]
        if a_intra and l_intra:
            return 2
        if a_intra or l_intra:
            nb = left if a_intra else above
            if not second(nb):
                return 2
            return 1 + 2 * int(uni(nb))
        a_sg = not second(above)
        l_sg = not second(left)
        frfa, frfl = above[1], left[1]
        if a_sg and l_sg:
            return 1 + 2 * int(not (IS_BACKWARD(frfa) ^
                                    IS_BACKWARD(frfl)))
        if l_sg or a_sg:
            uni_rfc = uni(left) if a_sg else uni(above)
            if not uni_rfc:
                return 1
            return 3 + int(not (IS_BACKWARD(frfa) ^ IS_BACKWARD(frfl)))
        a_u, l_u = uni(above), uni(left)
        if not a_u and not l_u:
            return 0
        if not a_u or not l_u:
            return 2
        return 3 + int(not ((frfa == M.BWDREF_FRAME) ^
                            (frfl == M.BWDREF_FRAME)))
    if above is not None or left is not None:
        nb = above if above is not None else left
        if not nb[0]:
            return 2
        if not second(nb):
            return 2
        return 4 * int(uni(nb))
    return 2


def comp_bwdref_p_ctx(counts):
    return _ctx3(counts[5] + counts[6], counts[7])


def write_comp_mode(enc, cdf, ctx: int, is_comp: bool):
    """comp_mode symbol (REFERENCE_MODE_SELECT frames)."""
    _sym(enc, cdf, cdf.comp_inter_cdf[ctx], int(is_comp))


def write_comp_refs_last_altref(enc, cdf, above, left, counts):
    """Signal the BIDIR pair (LAST, ALTREF) (read_ref_frames compound
    branch, EbDecParseInterBlock.c:245)."""
    _sym(enc, cdf, cdf.comp_ref_type_cdf[comp_ref_type_ctx(above, left)],
         1)                                   # BIDIR_COMP_REFERENCE
    _sym(enc, cdf, cdf.comp_ref_cdf[single_ref_p3_ctx(counts)][0], 0)
    _sym(enc, cdf, cdf.comp_ref_cdf[single_ref_p4_ctx(counts)][1], 0)
    _sym(enc, cdf, cdf.comp_bwdref_cdf[comp_bwdref_p_ctx(counts)][0], 1)


def write_inter_compound_mode(enc, cdf, mode: int, mode_context: int):
    ctx = M.compound_mode_ctx(mode_context)
    _sym(enc, cdf, cdf.inter_compound_mode_cdf[ctx],
         mode - M.NEAREST_NEARESTMV, 8)


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
    """ref_mv_idx is always 0 for NEW(_NEW)MV / effective NEAR =
    stack[1] (read_drl_idx, EbDecParseInterBlock.c:1179)."""
    if mode in (M.NEWMV, M.NEW_NEWMV):
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
    """comp 0 = row, 1 = col; diff in 1/8 pel (must be even without hp)."""
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


# ------------------------------------------------------------------ #
# decoder side

def _rd(dec, cdf, table, nsyms=None):
    v = dec.decode_symbol(table, nsyms or (len(table) - 1))
    cdf.update(table, v)
    return v


def read_is_inter(dec, cdf, ctx: int) -> bool:
    return bool(_rd(dec, cdf, cdf.intra_inter_cdf[ctx]))


def read_ref_frame_single(dec, cdf, counts) -> int:
    bit0 = _rd(dec, cdf, cdf.single_ref_cdf[single_ref_p1_ctx(counts)][0])
    if bit0:
        raise NotImplementedError("backward reference frames")
    bit2 = _rd(dec, cdf, cdf.single_ref_cdf[single_ref_p3_ctx(counts)][2])
    if bit2:
        raise NotImplementedError("LAST3/GOLDEN references")
    bit3 = _rd(dec, cdf, cdf.single_ref_cdf[single_ref_p4_ctx(counts)][3])
    if bit3:
        raise NotImplementedError("LAST2 reference")
    return M.LAST_FRAME


def read_comp_mode(dec, cdf, ctx: int) -> bool:
    return bool(_rd(dec, cdf, cdf.comp_inter_cdf[ctx]))


def read_comp_refs(dec, cdf, above, left, counts):
    """Compound ref pair (BIDIR subset: fwd in {LAST}, bwd in
    {ALTREF}); raises on pairs outside the emitted subset."""
    t = _rd(dec, cdf,
            cdf.comp_ref_type_cdf[comp_ref_type_ctx(above, left)])
    if t == 0:
        raise NotImplementedError("unidirectional compound")
    bit = _rd(dec, cdf, cdf.comp_ref_cdf[single_ref_p3_ctx(counts)][0])
    if bit:
        raise NotImplementedError("LAST3/GOLDEN compound fwd ref")
    bit1 = _rd(dec, cdf, cdf.comp_ref_cdf[single_ref_p4_ctx(counts)][1])
    if bit1:
        raise NotImplementedError("LAST2 compound fwd ref")
    bwd = _rd(dec, cdf, cdf.comp_bwdref_cdf[comp_bwdref_p_ctx(counts)][0])
    if not bwd:
        raise NotImplementedError("BWDREF/ALTREF2 compound bwd ref")
    return (M.LAST_FRAME, M.ALTREF_FRAME)


def read_inter_compound_mode(dec, cdf, mode_context: int) -> int:
    ctx = M.compound_mode_ctx(mode_context)
    v = _rd(dec, cdf, cdf.inter_compound_mode_cdf[ctx], 8)
    return M.NEAREST_NEARESTMV + v


def read_inter_mode(dec, cdf, mode_context: int) -> int:
    if not _rd(dec, cdf, cdf.newmv_cdf[mode_context & M.NEWMV_CTX_MASK]):
        return M.NEWMV
    zeromv_ctx = (mode_context >> M.GLOBALMV_OFFSET) & M.GLOBALMV_CTX_MASK
    if not _rd(dec, cdf, cdf.zeromv_cdf[zeromv_ctx]):
        return M.GLOBALMV
    refmv_ctx = (mode_context >> M.REFMV_OFFSET) & M.REFMV_CTX_MASK
    return (M.NEARMV if _rd(dec, cdf, cdf.refmv_cdf[refmv_ctx])
            else M.NEARESTMV)


def read_drl_idx(dec, cdf, mode: int, stack, num_found: int) -> int:
    ref_mv_idx = 0
    if mode in (M.NEWMV, M.NEW_NEWMV):
        for idx in range(2):
            if num_found > idx + 1:
                drl = _rd(dec, cdf, cdf.drl_cdf[drl_ctx(stack, idx)])
                ref_mv_idx = idx
                if not drl:
                    return ref_mv_idx
                ref_mv_idx = idx + 1
    if M.has_nearmv(mode):
        for idx in range(1, 3):
            if num_found > idx + 1:
                drl = _rd(dec, cdf, cdf.drl_cdf[drl_ctx(stack, idx)])
                ref_mv_idx = idx + drl - 1
                if not drl:
                    return ref_mv_idx
    return ref_mv_idx


def read_mv_component(dec, cdf, comp: int, usehp: bool = False) -> int:
    sign = _rd(dec, cdf, cdf.nmv_sign_cdf[comp])
    mv_class = _rd(dec, cdf, cdf.nmv_classes_cdf[comp], M.MV_CLASSES)
    if mv_class == 0:
        d = _rd(dec, cdf, cdf.nmv_class0_cdf[comp])
        mag = 0
    else:
        d = 0
        for i in range(mv_class):
            d |= _rd(dec, cdf, cdf.nmv_bits_cdf[comp][i]) << i
        mag = M.CLASS0_SIZE << (mv_class + 2)
    fp_cdf = (cdf.nmv_class0_fp_cdf[comp][d] if mv_class == 0
              else cdf.nmv_fp_cdf[comp])
    fr = _rd(dec, cdf, fp_cdf, M.MV_FP_SIZE)
    if usehp:
        hp_cdf = (cdf.nmv_class0_hp_cdf[comp] if mv_class == 0
                  else cdf.nmv_hp_cdf[comp])
        hp = _rd(dec, cdf, hp_cdf)
    else:
        hp = 1
    mag += ((d << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def read_mv(dec, cdf, ref_mv, usehp: bool = False):
    joint = _rd(dec, cdf, cdf.nmv_joints_cdf, M.MV_JOINTS)
    dr = read_mv_component(dec, cdf, 0, usehp) if joint & 2 else 0
    dc = read_mv_component(dec, cdf, 1, usehp) if joint & 1 else 0
    return (ref_mv[0] + dr, ref_mv[1] + dc)


def read_y_mode_inter(dec, cdf) -> int:
    return _rd(dec, cdf, cdf.y_mode_cdf[SIZE_GROUP_32], 13)
