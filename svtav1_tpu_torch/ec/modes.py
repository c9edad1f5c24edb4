"""Mode-info symbol writers for intra (key) frames, spec §5.11.17-5.11.26.

Copy of ``svtav1_tpu/ec/modes.py`` (reference: EbEntropyCoding.c
write_intra_*, libaom partition_plane_context): the partition,
edge-partition, skip, kf y mode, uv mode and angle delta writers, and the
edge-partition reader.
"""

from __future__ import annotations

import numpy as np

# partition types
(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
 PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
 PARTITION_HORZ_4, PARTITION_VERT_4) = range(10)

# intra mode → kf context bucket (libaom intra_mode_context)
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

# partition_context_lookup: above = 32 - w/4, left = 32 - h/4 (in mi units
# the value is a bitmask; see libaom av1_partition_context_lookup)


def partition_ctx_value(w: int, h: int):
    return 32 - (w // 4), 32 - (h // 4)


def partition_plane_ctx(above_ctx: int, left_ctx: int, bsize_w: int) -> int:
    """bsl-indexed partition context (libaom partition_plane_context)."""
    bsl = {8: 0, 16: 1, 32: 2, 64: 3, 128: 4}[bsize_w]
    above = (above_ctx >> bsl) & 1
    left = (left_ctx >> bsl) & 1
    return (left * 2 + above) + bsl * 4


def n_partition_symbols(bsize_w: int) -> int:
    if bsize_w == 8:
        return 4
    if bsize_w == 128:
        return 8
    return 10


def write_partition(enc, cdf, ctx: int, partition: int, bsize_w: int):
    t = cdf.partition_cdf[ctx]
    enc.encode_symbol(partition, t, n_partition_symbols(bsize_w))
    cdf.update(t, partition)


def write_skip(enc, cdf, skip_ctx: int, skip: int):
    t = cdf.skip_cdfs[skip_ctx]
    enc.encode_symbol(skip, t)
    cdf.update(t, skip)


def write_kf_y_mode(enc, cdf, above_mode: int, left_mode: int, mode: int):
    t = cdf.kf_y_cdf[INTRA_MODE_CONTEXT[above_mode]][
        INTRA_MODE_CONTEXT[left_mode]]
    enc.encode_symbol(mode, t)
    cdf.update(t, mode)


def write_angle_delta(enc, cdf, mode: int, delta: int):
    """delta in [-3, 3]; cdf indexed by mode - V_PRED."""
    t = cdf.angle_delta_cdf[mode - 1]
    enc.encode_symbol(delta + 3, t)
    cdf.update(t, delta + 3)


def write_uv_mode(enc, cdf, cfl_allowed: bool, y_mode: int, uv_mode: int):
    t = cdf.uv_mode_cdf[int(cfl_allowed)][y_mode]
    nsyms = 14 if cfl_allowed else 13
    enc.encode_symbol(uv_mode, t, nsyms)
    cdf.update(t, uv_mode, nsyms)


def is_directional(mode: int) -> bool:
    return 1 <= mode <= 8


def _cdf_elem_prob(t, e: int, nsyms: int) -> int:
    hi = 32768 if e == 0 else int(t[e - 1])
    lo = int(t[e]) if e < nsyms - 1 else 0
    return hi - lo


def write_partition_edge(enc, cdf, ctx: int, split: bool, bsize_w: int,
                         has_rows: bool, has_cols: bool):
    """Partition signaling for blocks crossing the frame edge (spec
    5.11.4 / reference EbDecParseBlock.c parse_partition_type): when one
    dimension is present a SPLIT-vs-(HORZ|VERT) bool is coded with a
    probability gathered from the partition CDF (partition_gather_*_alike,
    EbCabacContextModel.h:721-747, no adaptation); when neither is
    present the partition is an implied SPLIT (no bits)."""
    if not has_rows and not has_cols:
        if not split:
            raise ValueError("a block crossing both edges is an implied "
                             "SPLIT")
        return
    t = cdf.partition_cdf[ctx]
    n = n_partition_symbols(bsize_w)
    if has_cols:                       # crosses the bottom: SPLIT or HORZ
        elems = [PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
                 PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_VERT_4]
    else:                              # crosses the right: SPLIT or VERT
        elems = [PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A,
                 PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_HORZ_4]
    psum = sum(_cdf_elem_prob(t, e, n) for e in elems if e < n)
    # scratch 2-symbol icdf: sym 1 = SPLIT with prob psum/32768
    icdf = np.array([psum, 0, 0], np.int32)
    enc.encode_symbol(1 if split else 0, icdf, 2)


def read_partition_edge(dec, cdf, ctx: int, bsize_w: int,
                        has_rows: bool, has_cols: bool) -> int:
    """Decoder mirror of write_partition_edge: returns the partition
    (PARTITION_SPLIT / PARTITION_HORZ / PARTITION_VERT).  No CDF
    adaptation — the scratch bool is derived per read
    (EbDecParseBlock.c:1940-1954)."""
    if not has_rows and not has_cols:
        return PARTITION_SPLIT
    t = cdf.partition_cdf[ctx]
    n = n_partition_symbols(bsize_w)
    if has_cols:
        elems = [PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
                 PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_VERT_4]
        other = PARTITION_HORZ
    else:
        elems = [PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A,
                 PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_HORZ_4]
        other = PARTITION_VERT
    psum = sum(_cdf_elem_prob(t, e, n) for e in elems if e < n)
    icdf = np.array([psum, 0, 0], np.int32)
    return PARTITION_SPLIT if dec.decode_symbol(icdf, 2) else other
