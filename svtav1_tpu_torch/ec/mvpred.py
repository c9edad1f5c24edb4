"""Reference-MV stack construction (AV1 spec §7.10.2 find_mv_stack).

Copy of ``svtav1_tpu/ec/mvpred.py``: single-reference and compound
(LAST + ALTREF pair) stacks, over a whole frame or a tile column.  The
encoder's entropy pass and the decoder run the same process: the stack
and its mode_context select the inter-mode CDFs and the MV predictors
(reference EbDecParseInterBlock.c:749-1120 dec_setup_ref_mv_list).
Temporal MVP (use_ref_frame_mvs) is not used by the emitted streams
(enable_order_hint = 0) and is omitted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..spec import mv as M


@dataclass
class MiGrid:
    """Per-4x4-mi-unit mode info for one frame (the decoder's mi grid).

    Every unit covered by a block holds that block's info."""
    mi_rows: int
    mi_cols: int
    ref0: np.ndarray = None      # int8: 0=intra, ≥1 = ref frame
    ref1: np.ndarray = None      # int8: 0=NONE, ≥1 = second (compound)
    mode: np.ndarray = None      # uint8 PredictionMode
    mv_row: np.ndarray = None    # int16 (1/8 pel)
    mv_col: np.ndarray = None
    mv1_row: np.ndarray = None   # second-ref mv (compound blocks)
    mv1_col: np.ndarray = None
    bw4: np.ndarray = None       # uint8: owning block width in mi units
    bh4: np.ndarray = None

    def __post_init__(self):
        sh = (self.mi_rows, self.mi_cols)
        self.ref0 = np.zeros(sh, np.int8)
        self.ref1 = np.zeros(sh, np.int8)
        self.mode = np.zeros(sh, np.uint8)
        self.mv_row = np.zeros(sh, np.int16)
        self.mv_col = np.zeros(sh, np.int16)
        self.mv1_row = np.zeros(sh, np.int16)
        self.mv1_col = np.zeros(sh, np.int16)
        self.bw4 = np.ones(sh, np.uint8)
        self.bh4 = np.ones(sh, np.uint8)

    def set_block(self, mi_row, mi_col, bw4, bh4, ref0, mode, mvr=0, mvc=0,
                  ref1=0, mv1r=0, mv1c=0):
        s = (slice(mi_row, mi_row + bh4), slice(mi_col, mi_col + bw4))
        self.ref0[s] = ref0
        self.ref1[s] = ref1
        self.mode[s] = mode
        self.mv_row[s] = mvr
        self.mv_col[s] = mvc
        self.mv1_row[s] = mv1r
        self.mv1_col[s] = mv1c
        self.bw4[s] = bw4
        self.bh4[s] = bh4

    def is_inter(self, r, c) -> bool:
        return self.ref0[r, c] >= 1


@dataclass
class MvStackResult:
    stack: list                  # [(row, col, weight)]
    num_found: int
    mode_context: int
    nearest_mv: tuple            # lower-precisioned ref list [0]
    near_mv: tuple               # lower-precisioned ref list [1]
    ref_list: list               # raw stack[0..1] padded with global mv


def _has_top_right(mi_row, mi_col, bw4, bh4, sb_mi=16):
    """has_top_right (EbDecParseInterBlock.c:546), square blocks, 64px SB."""
    bs = max(bw4, bh4)
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    if bs > 16:
        return 0
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    while bs < sb_mi:
        if mask_col & bs:
            if (mask_col & (2 * bs)) and (mask_row & (2 * bs)):
                has_tr = 0
                break
        else:
            break
        bs <<= 1
    # rectangular-block adjustments (is_sec_rect) don't apply to squares
    return int(has_tr)


class _Ctx:
    """Mutable scratch for one find_mv_stack call."""
    __slots__ = ("stack", "found_above", "found_left", "newmv_count",
                 "processed_rows", "processed_cols")

    def __init__(self):
        self.stack = []          # [row, col, weight] lists
        self.found_above = 0
        self.found_left = 0
        self.newmv_count = 0
        self.processed_rows = 0
        self.processed_cols = 0


def _add_candidate(ctx: _Ctx, grid: MiGrid, r, c, ref_frame, weight,
                   above: bool):
    """add_ref_mv_candidate (EbDecParseInterBlock.c:353).  ref_frame is
    an int (single) or a (ref0, ref1) pair (compound)."""
    if grid.ref0[r, c] < 1:
        return                   # intra block
    if isinstance(ref_frame, tuple):
        # compound: candidate must use the exact same pair
        if (int(grid.ref0[r, c]) == ref_frame[0] and
                int(grid.ref1[r, c]) == ref_frame[1]):
            mv = (int(grid.mv_row[r, c]), int(grid.mv_col[r, c]),
                  int(grid.mv1_row[r, c]), int(grid.mv1_col[r, c]))
            for e in ctx.stack:
                if tuple(e[:4]) == mv:
                    e[4] += weight
                    break
            else:
                if len(ctx.stack) < M.MAX_REF_MV_STACK_SIZE:
                    ctx.stack.append(list(mv) + [weight])
            if M.has_newmv(int(grid.mode[r, c])):
                ctx.newmv_count += 1
            if above:
                ctx.found_above += 1
            else:
                ctx.found_left += 1
        return
    # single reference: both of the candidate's refs are checked
    for ri in range(2):
        cref = int(grid.ref0[r, c]) if ri == 0 else int(grid.ref1[r, c])
        if cref != ref_frame:
            continue
        if ri == 0:
            mvr, mvc = int(grid.mv_row[r, c]), int(grid.mv_col[r, c])
        else:
            mvr, mvc = int(grid.mv1_row[r, c]), int(grid.mv1_col[r, c])
        for e in ctx.stack:
            if e[0] == mvr and e[1] == mvc:
                e[2] += weight
                break
        else:
            if len(ctx.stack) < M.MAX_REF_MV_STACK_SIZE:
                ctx.stack.append([mvr, mvc, weight])
        if M.has_newmv(int(grid.mode[r, c])):
            ctx.newmv_count += 1
        if above:
            ctx.found_above += 1
        else:
            ctx.found_left += 1


def _scan_row(ctx, grid, mi_row, mi_col, bw4, ref_frame, delta_row,
              max_row_offset, tile):
    end4 = min(bw4, grid.mi_cols - mi_col, 16)
    delta_col = 0
    if abs(delta_row) > 1:
        delta_col = 1
        if (mi_col & 1) and bw4 < 2:
            delta_col -= 1
    use_step_16 = bw4 >= 16
    i = 0
    while i < end4:
        r, c = mi_row + delta_row, mi_col + delta_col + i
        if not (tile[0] <= r < tile[1] and tile[2] <= c < tile[3]):
            break
        cw4, ch4 = int(grid.bw4[r, c]), int(grid.bh4[r, c])
        ln = min(bw4, cw4)
        if use_step_16:
            ln = max(4, ln)
        elif abs(delta_row) > 1:
            ln = max(2, ln)
        weight = 2
        if bw4 >= 2 and bw4 <= cw4:
            inc = min(-max_row_offset + delta_row + 1, ch4)
            weight = max(weight, inc)
            ctx.processed_rows = inc - delta_row - 1
        _add_candidate(ctx, grid, r, c, ref_frame, ln * weight, above=True)
        i += ln


def _scan_col(ctx, grid, mi_row, mi_col, bh4, ref_frame, delta_col,
              max_col_offset, tile):
    end4 = min(bh4, grid.mi_rows - mi_row, 16)
    delta_row = 0
    if abs(delta_col) > 1:
        delta_row = 1
        if (mi_row & 1) and bh4 < 2:
            delta_row -= 1
    use_step_16 = bh4 >= 16
    i = 0
    while i < end4:
        r, c = mi_row + delta_row + i, mi_col + delta_col
        if not (tile[0] <= r < tile[1] and tile[2] <= c < tile[3]):
            break
        cw4, ch4 = int(grid.bw4[r, c]), int(grid.bh4[r, c])
        ln = min(bh4, ch4)
        if abs(delta_col) > 1:
            ln = max(2, ln)
        if use_step_16:
            ln = max(4, ln)
        weight = 2
        if bh4 >= 2 and bh4 <= ch4:
            inc = min(-max_col_offset + delta_col + 1, cw4)
            weight = max(weight, inc)
            ctx.processed_cols = inc - delta_col - 1
        _add_candidate(ctx, grid, r, c, ref_frame, ln * weight, above=False)
        i += ln


def _scan_blk(ctx, grid, mi_row, mi_col, ref_frame, delta_row, delta_col,
              tile):
    r, c = mi_row + delta_row, mi_col + delta_col
    if tile[0] <= r < tile[1] and tile[2] <= c < tile[3]:
        _add_candidate(ctx, grid, r, c, ref_frame, 4, above=True)


def _stable_sort_desc(seg):
    """The spec's bubble passes == stable sort by descending weight.
    Weight is the last element (index 2 single-ref, 4 compound)."""
    seg.sort(key=lambda e: -e[-1])


def find_mv_stack(grid: MiGrid, mi_row: int, mi_col: int, bw4: int, bh4: int,
                  ref_frame=M.LAST_FRAME,
                  allow_hp: bool = False, force_int: bool = False,
                  mi_col_off: int = 0,
                  frame_mi_cols: int = None,
                  gm_mv=(0, 0)) -> MvStackResult:
    """find_mv_stack, single or compound.  ref_frame: int (single) or
    (fwd, bwd) pair (compound — stack entries become
    (r0, c0, r1, c1, weight), ref_list entries 4-tuples).
    The grid is one tile's: scans and availability are tile-relative.
    For a tile column, mi_col_off/frame_mi_cols supply the frame-global
    placement, since the stack clamp (clamp_mv_ref) is frame-relative."""
    comp = isinstance(ref_frame, tuple)
    tile = (0, grid.mi_rows, 0, grid.mi_cols)
    if frame_mi_cols is None:
        frame_mi_cols = grid.mi_cols
    ctx = _Ctx()
    up_avail = mi_row > tile[0]
    left_avail = mi_col > tile[2]
    row_adj = int(bh4 < 2 and (mi_row & 1))
    col_adj = int(bw4 < 2 and (mi_col & 1))
    max_row_offset = 0
    max_col_offset = 0
    if up_avail:
        max_row_offset = -(M.MVREF_ROW_COLS << 1) + row_adj
        if bh4 < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = M.clamp(max_row_offset, tile[0] - mi_row,
                                 tile[1] - mi_row - 1)
    if left_avail:
        max_col_offset = -(M.MVREF_ROW_COLS << 1) + col_adj
        if bw4 < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = M.clamp(max_col_offset, tile[2] - mi_col,
                                 tile[3] - mi_col - 1)

    if abs(max_row_offset) >= 1:
        _scan_row(ctx, grid, mi_row, mi_col, bw4, ref_frame, -1,
                  max_row_offset, tile)
    if abs(max_col_offset) >= 1:
        _scan_col(ctx, grid, mi_row, mi_col, bh4, ref_frame, -1,
                  max_col_offset, tile)
    if _has_top_right(mi_row, mi_col, bw4, bh4):
        _scan_blk(ctx, grid, mi_row, mi_col, ref_frame, -1, bw4, tile)

    nearest_match = int(ctx.found_above > 0) + int(ctx.found_left > 0)
    num_nearest = len(ctx.stack)
    num_new = ctx.newmv_count
    for e in ctx.stack:
        e[-1] += M.REF_CAT_LEVEL

    mode_context = 0
    # no temporal MVP (use_ref_frame_mvs=0): globalmv context bits stay 0

    # second outer area: top-left point, then rows/cols -3, -5
    _scan_blk(ctx, grid, mi_row, mi_col, ref_frame, -1, -1, tile)
    for idx in range(2, M.MVREF_ROW_COLS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if (abs(row_offset) <= abs(max_row_offset) and
                abs(row_offset) > ctx.processed_rows):
            _scan_row(ctx, grid, mi_row, mi_col, bw4, ref_frame, row_offset,
                      max_row_offset, tile)
        if (abs(col_offset) <= abs(max_col_offset) and
                abs(col_offset) > ctx.processed_cols):
            _scan_col(ctx, grid, mi_row, mi_col, bh4, ref_frame, col_offset,
                      max_col_offset, tile)

    # two-segment stable sort by weight
    nearest_seg = ctx.stack[:num_nearest]
    rest_seg = ctx.stack[num_nearest:]
    _stable_sort_desc(nearest_seg)
    _stable_sort_desc(rest_seg)
    ctx.stack = nearest_seg + rest_seg

    # extra search: re-scan row/col -1 for any-inter candidates
    if len(ctx.stack) < M.MAX_MV_REF_CANDIDATES:
        mi_w = min(16, bw4, grid.mi_cols - mi_col)
        mi_h = min(16, bh4, grid.mi_rows - mi_row)
        mi_size = min(mi_w, mi_h)
        ref_id = [[], []]        # compound: per-pair-ref matching mvs
        ref_diff = [[], []]      # compound: other inter mvs (bias 0)
        for pss in range(2):
            idx = 0
            while (idx < mi_size and
                   (comp or len(ctx.stack) < M.MAX_MV_REF_CANDIDATES)):
                if pss == 0:
                    r, c = mi_row - 1, mi_col + idx
                else:
                    r, c = mi_row + idx, mi_col - 1
                if not (tile[0] <= r < tile[1] and tile[2] <= c < tile[3]):
                    break
                if comp:
                    # add_extra_mv_candidate
                    # (EbDecParseInterBlock.c:689)
                    for ri in range(2):
                        cref = (int(grid.ref0[r, c]) if ri == 0
                                else int(grid.ref1[r, c]))
                        if cref < 1:
                            continue
                        mv = ((int(grid.mv_row[r, c]),
                               int(grid.mv_col[r, c])) if ri == 0 else
                              (int(grid.mv1_row[r, c]),
                               int(grid.mv1_col[r, c])))
                        for ci in range(2):
                            if cref == ref_frame[ci] and \
                                    len(ref_id[ci]) < 2:
                                ref_id[ci].append(mv)
                            elif len(ref_diff[ci]) < 2:
                                ref_diff[ci].append(mv)
                elif grid.ref0[r, c] >= 1:
                    # process_single_ref_mv_candidate: any inter
                    # neighbor's mvs, both refs (sign bias all 0)
                    for ri in range(2):
                        cref = (int(grid.ref0[r, c]) if ri == 0
                                else int(grid.ref1[r, c]))
                        if cref < 1:
                            continue
                        if len(ctx.stack) >= M.MAX_MV_REF_CANDIDATES:
                            break
                        mvr = (int(grid.mv_row[r, c]) if ri == 0
                               else int(grid.mv1_row[r, c]))
                        mvc = (int(grid.mv_col[r, c]) if ri == 0
                               else int(grid.mv1_col[r, c]))
                        if not any(e[0] == mvr and e[1] == mvc
                                   for e in ctx.stack):
                            ctx.stack.append([mvr, mvc, 2])
                idx += int(grid.bh4[r, c]) if pss else int(grid.bw4[r, c])
        if comp and len(ctx.stack) < M.MAX_MV_REF_CANDIDATES:
            # comp_list assembly + pair append
            # (EbDecParseInterBlock.c:1020-1055)
            comp_list = [[None, None], [None, None]]   # [entry][ref]
            for ci in range(2):
                ent = (ref_id[ci] + ref_diff[ci])[:2]
                while len(ent) < 2:
                    ent.append((0, 0))
                comp_list[0][ci] = ent[0]
                comp_list[1][ci] = ent[1]
            if len(ctx.stack) == 1:
                if (comp_list[0][0] == tuple(ctx.stack[0][0:2]) and
                        comp_list[0][1] == tuple(ctx.stack[0][2:4])):
                    pick = comp_list[1]
                else:
                    pick = comp_list[0]
                ctx.stack.append(list(pick[0]) + list(pick[1]) + [2])
            else:
                for ent in comp_list:
                    ctx.stack.append(list(ent[0]) + list(ent[1]) + [2])

    # clamp (frame-relative coordinates)
    for e in ctx.stack:
        e[0], e[1] = M.clamp_mv_ref(e[0], e[1], bw4, bh4, mi_row,
                                    mi_col + mi_col_off, grid.mi_rows,
                                    frame_mi_cols)
        if comp:
            e[2], e[3] = M.clamp_mv_ref(e[2], e[3], bw4, bh4, mi_row,
                                        mi_col + mi_col_off,
                                        grid.mi_rows, frame_mi_cols)

    # mode context from the three counters
    ref_match_count = int(ctx.found_above > 0) + int(ctx.found_left > 0)
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_context |= 1
        if ref_match_count == 1:
            mode_context |= 1 << M.REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 2 << M.REFMV_OFFSET
    elif nearest_match == 1:
        mode_context |= 2 if num_new > 0 else 3
        if ref_match_count == 1:
            mode_context |= 3 << M.REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 4 << M.REFMV_OFFSET
    else:
        mode_context |= 4 if num_new >= 1 else 5
        mode_context |= 5 << M.REFMV_OFFSET

    # mv_ref_list: stack[0..1] padded with the global mv (spec 7.10.2.6;
    # gm_mv = setup_global_mv's TRANSLATION vector, identity → 0; the
    # single-ref translation-GM path threads the frame's gm here)
    ref_list = []
    width = 4 if comp else 2
    pad = (0,) * width if comp else tuple(gm_mv)
    for i in range(M.MAX_MV_REF_CANDIDATES):
        if i < len(ctx.stack):
            ref_list.append(tuple(ctx.stack[i][:width]))
        else:
            ref_list.append(pad)
    nearest = M.lower_mv_precision(*ref_list[0][:2], allow_hp, force_int)
    near = M.lower_mv_precision(*ref_list[1][:2], allow_hp, force_int)
    return MvStackResult([tuple(e) for e in ctx.stack], len(ctx.stack),
                         mode_context, nearest, near, ref_list)
