"""Frame geometry: SB padding and the flat path's bottom-edge rule.

Copy of ``svtav1_tpu/encoder/geometry.py``, cut to the flat path.  AV1
signals the true frame size while coding a whole number of superblocks;
the source is padded to SB multiples and blocks in the bottom SB row may
overhang the frame edge where the spec's partition rules still let their
partition symbol be coded (spec §5.11.4 hasRows).  With m = valid mi rows
in the bottom SB row, the flat path (32x32 NONE blocks only) codes m in
{6, 8, 14, 16}; heights with height % 64 in {8, 40} (m in {2, 10}) need
16x8 edge blocks, and m in {4, 12} need the partition path.
"""

from __future__ import annotations

import numpy as np

SB = 64

# m values codable without 16x8 strip blocks, per path
PART_OK_M = (4, 6, 8, 12, 14, 16)
FLAT_OK_M = (6, 8, 14, 16)      # flat path: 32x32 NONE blocks only


def pad64(v: int) -> int:
    return -(-v // SB) * SB


def height_m(height: int) -> int:
    """Valid mi rows in the bottom SB row (16 when SB-aligned)."""
    mi_rows = height // 4
    sb_rows = pad64(height) // SB
    return mi_rows - (sb_rows - 1) * 16


def check_dims(width: int, height: int, part_search: bool = True) -> None:
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


def pad_plane_bottom(arr: np.ndarray, ph: int) -> np.ndarray:
    """Edge-replicate [..., h, w] rows up to ph (the reference's
    pad_picture_to_multiple_of_sb_dimensions bottom padding)."""
    h = arr.shape[-2]
    if h == ph:
        return arr
    pad = [(0, 0)] * (arr.ndim - 2) + [(0, ph - h), (0, 0)]
    return np.pad(arr, pad, mode="edge")
