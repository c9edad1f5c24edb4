"""Loop-restoration unit syntax (tile level, write_lr_unit / read_lr_unit).

Copy of ``svtav1_tpu/ec/lr_syntax.py``.  Spec §5.11.57; reference
EbEntropyCoding.c:4064-4215 loop_restoration_write_sb_coeffs (write path),
EbDecParseBlock.c:2532-2680 (read path).  One restoration unit per plane
per superblock at the fixed unit sizes (64 luma / 32 chroma).
Coefficients are subexp-coded relative to a per-plane reference that
resets to defaults at tile start.
"""

from __future__ import annotations

from .subexp import read_signed_refsubexpfin, write_signed_refsubexpfin

RESTORE_NONE = 0
RESTORE_WIENER = 1
RESTORE_SGRPROJ = 2
RESTORE_SWITCHABLE = 3

SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_PRJ_SUBEXP_K = 4
SGRPROJ_PRJ_MIN0 = -96
SGRPROJ_PRJ_MAX0 = 31
SGRPROJ_PRJ_MIN1 = -32
SGRPROJ_PRJ_MAX1 = 95

WIENER_TAP_MIN = (-5, -23, -17)
WIENER_TAP_MAX = (10, 8, 46)
WIENER_TAP_K = (1, 2, 3)
WIENER_TAP_MID = (3, -7, 15)

# sgr_params r-pattern per ep (ops/restoration.py SGR_PARAMS radii)
SGR_R = [(2, 1)] * 10 + [(0, 1)] * 4 + [(2, 0)] * 2


def default_ref_state():
    """Per-plane chained reference (reset at tile start,
    set_default_wiener/set_default_sgrproj)."""
    # C truncates toward zero: (-96 + 31) / 2 == -32, not Python's -33
    return {"wiener_v": list(WIENER_TAP_MID),
            "wiener_h": list(WIENER_TAP_MID),
            "sgr_xqd": [int((SGRPROJ_PRJ_MIN0 + SGRPROJ_PRJ_MAX0) / 2),
                        int((SGRPROJ_PRJ_MIN1 + SGRPROJ_PRJ_MAX1) / 2)]}


def _clamp(v, lo, hi):
    return max(lo, min(hi, int(v)))


def write_wiener_taps(enc, taps, ref, chroma: bool) -> None:
    """taps/ref: 3 coded taps (outermost first); chroma drops tap0."""
    start = 1 if chroma else 0
    for i in range(start, 3):
        write_signed_refsubexpfin(enc, WIENER_TAP_MIN[i],
                                  WIENER_TAP_MAX[i] + 1, WIENER_TAP_K[i],
                                  int(ref[i]), int(taps[i]))
    ref[:] = list(taps)


def read_wiener_taps(dec, ref, chroma: bool):
    taps = [0, 0, 0]
    start = 1 if chroma else 0
    for i in range(start, 3):
        taps[i] = read_signed_refsubexpfin(
            dec, WIENER_TAP_MIN[i], WIENER_TAP_MAX[i] + 1,
            WIENER_TAP_K[i], int(ref[i]))
    ref[:] = list(taps)
    return taps


def write_sgr_params(enc, ep: int, xqd, ref) -> None:
    enc.encode_literal(ep, SGRPROJ_PARAMS_BITS)
    r0, r1 = SGR_R[ep]
    if r0 == 0:
        write_signed_refsubexpfin(enc, SGRPROJ_PRJ_MIN1,
                                  SGRPROJ_PRJ_MAX1 + 1,
                                  SGRPROJ_PRJ_SUBEXP_K, int(ref[1]),
                                  int(xqd[1]))
    elif r1 == 0:
        write_signed_refsubexpfin(enc, SGRPROJ_PRJ_MIN0,
                                  SGRPROJ_PRJ_MAX0 + 1,
                                  SGRPROJ_PRJ_SUBEXP_K, int(ref[0]),
                                  int(xqd[0]))
    else:
        write_signed_refsubexpfin(enc, SGRPROJ_PRJ_MIN0,
                                  SGRPROJ_PRJ_MAX0 + 1,
                                  SGRPROJ_PRJ_SUBEXP_K, int(ref[0]),
                                  int(xqd[0]))
        write_signed_refsubexpfin(enc, SGRPROJ_PRJ_MIN1,
                                  SGRPROJ_PRJ_MAX1 + 1,
                                  SGRPROJ_PRJ_SUBEXP_K, int(ref[1]),
                                  int(xqd[1]))
    ref[:] = [int(xqd[0]), int(xqd[1])]


def read_sgr_params(dec, ref):
    ep = dec.decode_literal(SGRPROJ_PARAMS_BITS)
    r0, r1 = SGR_R[ep]
    if r0 == 0:
        xqd0 = 0
        xqd1 = read_signed_refsubexpfin(dec, SGRPROJ_PRJ_MIN1,
                                        SGRPROJ_PRJ_MAX1 + 1,
                                        SGRPROJ_PRJ_SUBEXP_K, int(ref[1]))
    elif r1 == 0:
        xqd0 = read_signed_refsubexpfin(dec, SGRPROJ_PRJ_MIN0,
                                        SGRPROJ_PRJ_MAX0 + 1,
                                        SGRPROJ_PRJ_SUBEXP_K, int(ref[0]))
        xqd1 = _clamp((1 << SGRPROJ_PRJ_BITS) - xqd0, SGRPROJ_PRJ_MIN1,
                      SGRPROJ_PRJ_MAX1)
    else:
        xqd0 = read_signed_refsubexpfin(dec, SGRPROJ_PRJ_MIN0,
                                        SGRPROJ_PRJ_MAX0 + 1,
                                        SGRPROJ_PRJ_SUBEXP_K, int(ref[0]))
        xqd1 = read_signed_refsubexpfin(dec, SGRPROJ_PRJ_MIN1,
                                        SGRPROJ_PRJ_MAX1 + 1,
                                        SGRPROJ_PRJ_SUBEXP_K, int(ref[1]))
    ref[:] = [xqd0, xqd1]
    return ep, (xqd0, xqd1)


def write_lr_unit(enc, cdf, frame_type: int, unit_type: int, unit,
                  ref, chroma: bool) -> None:
    """unit: dict-like with eps/xqd/taps_v/taps_h fields for this unit."""
    if frame_type == RESTORE_NONE:
        return
    if frame_type == RESTORE_SWITCHABLE:
        t = cdf.switchable_restore_cdf
        enc.encode_symbol(unit_type, t, 3)
        cdf.update(t, unit_type)
    elif frame_type == RESTORE_WIENER:
        t = cdf.wiener_restore_cdf
        v = 1 if unit_type == RESTORE_WIENER else 0
        enc.encode_symbol(v, t, 2)
        cdf.update(t, v)
    else:
        t = cdf.sgrproj_restore_cdf
        v = 1 if unit_type == RESTORE_SGRPROJ else 0
        enc.encode_symbol(v, t, 2)
        cdf.update(t, v)
    if unit_type == RESTORE_WIENER:
        write_wiener_taps(enc, unit["taps_v"], ref["wiener_v"], chroma)
        write_wiener_taps(enc, unit["taps_h"], ref["wiener_h"], chroma)
    elif unit_type == RESTORE_SGRPROJ:
        write_sgr_params(enc, int(unit["eps"]), unit["xqd"],
                         ref["sgr_xqd"])


def read_lr_unit(dec, cdf, frame_type: int, ref, chroma: bool):
    """Returns (unit_type, eps, xqd, taps_v, taps_h)."""
    if frame_type == RESTORE_NONE:
        return RESTORE_NONE, 0, (0, 0), (0, 0, 0), (0, 0, 0)
    if frame_type == RESTORE_SWITCHABLE:
        t = cdf.switchable_restore_cdf
        unit_type = dec.decode_symbol(t, 3)
        cdf.update(t, unit_type)
    elif frame_type == RESTORE_WIENER:
        t = cdf.wiener_restore_cdf
        v = dec.decode_symbol(t, 2)
        cdf.update(t, v)
        unit_type = RESTORE_WIENER if v else RESTORE_NONE
    else:
        t = cdf.sgrproj_restore_cdf
        v = dec.decode_symbol(t, 2)
        cdf.update(t, v)
        unit_type = RESTORE_SGRPROJ if v else RESTORE_NONE
    eps, xqd = 0, (0, 0)
    tv = th = (0, 0, 0)
    if unit_type == RESTORE_WIENER:
        tv = tuple(read_wiener_taps(dec, ref["wiener_v"], chroma))
        th = tuple(read_wiener_taps(dec, ref["wiener_h"], chroma))
    elif unit_type == RESTORE_SGRPROJ:
        eps, xqd = read_sgr_params(dec, ref["sgr_xqd"])
    return unit_type, eps, xqd, tv, th
