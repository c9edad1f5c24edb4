"""Frame geometry: SB padding and bottom-edge partition legality.

Copy of ``svtav1_tpu/encoder/geometry.py``.  AV1 signals the true frame
size while coding a whole number of superblocks; the source is padded to
SB multiples and blocks in the bottom SB row may overhang the frame edge
where the spec's partition rules still let their partition symbol be coded
(spec §5.11.4 hasRows).  With m = valid mi rows in the bottom SB row:

  m=16 : full SB row, no constraint.
  m=14 : force the bottom 32-row to PARTITION_NONE (overhangs 8 px).
  m=12 : force the bottom 32-row to SPLIT (its +12mi 16-children start
         outside the frame and are not coded).
  m=8  : force SB SPLIT; the +8mi quads are not coded.
  m=6  : force SB SPLIT and the +0mi quad to NONE.
  m=4  : force SB SPLIT and the +0mi quad to SPLIT.
  m in {2, 10} (height % 64 in {8, 40}) needs 16x8 edge blocks: not
  implemented.  The flat path (32x32 NONE blocks) codes m in
  {6, 8, 12, 14, 16}.  At m=12 its bottom 32-row is coded as SPLIT
  (split_or_horz) into 16x16 NONE blocks (TX_16X16 luma, TX_8X8 chroma),
  the edge strip; the +12mi children start outside the frame and are not
  coded.  m=4 would need the same rule one level up (its +0mi quad split
  into 16x16 blocks) and is not implemented on the flat path.
"""

from __future__ import annotations

import numpy as np

SB = 64

# m values codable without 16x8 strip blocks, per path
PART_OK_M = (4, 6, 8, 12, 14, 16)
FLAT_OK_M = (6, 8, 12, 14, 16)  # flat path: 32x32 NONE blocks, and the
                                # 16x16 edge strip at m=12
EDGE_M = 12                     # the flat path's m with an edge strip


def pad64(v: int) -> int:
    return -(-v // SB) * SB


def height_m(height: int) -> int:
    """Valid mi rows in the bottom SB row (16 when SB-aligned)."""
    mi_rows = height // 4
    sb_rows = pad64(height) // SB
    return mi_rows - (sb_rows - 1) * 16


def check_dims(width: int, height: int, part_search: bool = True,
               inloop_extras: bool = False) -> None:
    """Raise ValueError unless (width, height) is encodable."""
    if width % SB:
        raise ValueError("width must be a multiple of 64 (width padding "
                         "not yet implemented)")
    if height % 8:
        raise ValueError("height must be a multiple of 8 (4:2:0 chroma "
                         "mi alignment)")
    m = height_m(height)
    ok = PART_OK_M if part_search else FLAT_OK_M
    if m not in ok:
        hint = "" if part_search else \
            " on the flat path - use part_search=True"
        raise ValueError(
            f"height % 64 == {height % SB} requires 16x8 edge blocks "
            f"(not yet implemented{hint})")
    if inloop_extras and height % SB:
        raise ValueError("CDEF/LR/CCSO at non-SB-aligned heights not yet "
                         "implemented")


def pad_plane_bottom(arr: np.ndarray, ph: int) -> np.ndarray:
    """Edge-replicate [..., h, w] rows up to ph (the reference's
    pad_picture_to_multiple_of_sb_dimensions bottom padding)."""
    h = arr.shape[-2]
    if h == ph:
        return arr
    pad = [(0, 0)] * (arr.ndim - 2) + [(0, ph - h), (0, 0)]
    return np.pad(arr, pad, mode="edge")


def bottom_force_masks(bh: int, bw: int, sh: int, sw: int, mi_rows: int):
    """Partition force masks for the true-height bottom SB row.

    Returns (force_part [bh, bw], force_sb [sh, sw]) int32 with -1 free /
    0 NONE / 1 SPLIT, for encode_plane_wavefront_part."""
    fp = np.full((bh, bw), -1, np.int32)
    fsb = np.full((sh, sw), -1, np.int32)
    m = mi_rows - (sh - 1) * 16
    if m == 16:
        return fp, fsb
    if m == 14:
        fp[bh - 1] = 0
    elif m == 12:
        fp[bh - 1] = 1
    elif m == 8:
        fsb[sh - 1] = 1
    elif m == 6:
        fsb[sh - 1] = 1
        fp[bh - 2] = 0
    elif m == 4:
        fsb[sh - 1] = 1
        fp[bh - 2] = 1
    else:
        raise ValueError(f"unsupported bottom mi rows m={m}")
    return fp, fsb
