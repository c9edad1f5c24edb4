"""Normative AV1 transform configuration (spec §7.13.2-7.13.3).

Copy of ``svtav1_tpu/spec/txfm.py``, cut to the square sizes 8..64 and
the DCT, ADST and identity kinds of the intra paths: 1D-type mapping,
shifts, cos bits and the butterfly stage networks.  The networks are
normative (every conforming AV1 codec reproduces them bit-exactly,
intermediate roundings included) and are stored as data in
``data/txfm_stages.json``; each stage compiles to five vectors (ia, wa,
ib, wb, mode), one gather + multiply-add over a batch of vectors.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import numpy as np

from . import tables as _tbl

_DATA = Path(__file__).parent / "data"

TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = 0, 1, 2, 3, 4
TX_W, TX_H = _tbl.TX_W, _tbl.TX_H

# Transform types (spec §6.8.21)
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
 FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
 V_ADST, H_ADST, V_FLIPADST, H_FLIPADST) = range(16)

# 1D transform kinds
DCT_1D, ADST_1D, FLIPADST_1D, IDTX_1D = range(4)

# chroma-intra implied transform type per uv_mode (spec compute_tx_type):
# chroma intra txbs do not signal a tx type; it derives from the uv
# prediction mode, clamped to DCT_DCT when the (sqr-up) tx size exceeds
# 16x16.
UV_MODE_TX_TYPE = (DCT_DCT,    # DC
                   ADST_DCT,   # V
                   DCT_ADST,   # H
                   DCT_DCT,    # D45
                   ADST_ADST,  # D135
                   ADST_DCT,   # D113
                   DCT_ADST,   # D157
                   DCT_ADST,   # D203
                   ADST_DCT,   # D67
                   ADST_ADST,  # SMOOTH
                   ADST_DCT,   # SMOOTH_V
                   DCT_ADST,   # SMOOTH_H
                   ADST_ADST)  # PAETH


def uv_intra_tx_type(uv_mode: int, tx_size: int) -> int:
    """Implied chroma-intra tx type, with the size clamp (sqr-up > 16x16
    -> DCT_DCT)."""
    if _tbl.txsize_sqr_up(tx_size) > TX_16X16:
        return DCT_DCT
    return UV_MODE_TX_TYPE[uv_mode]


# vertical (column) / horizontal (row) 1D kind per 2D type
VTX_TAB = [DCT_1D, ADST_1D, DCT_1D, ADST_1D, FLIPADST_1D, DCT_1D,
           FLIPADST_1D, ADST_1D, FLIPADST_1D, IDTX_1D, DCT_1D, IDTX_1D,
           ADST_1D, IDTX_1D, FLIPADST_1D, IDTX_1D]
HTX_TAB = [DCT_1D, DCT_1D, ADST_1D, ADST_1D, DCT_1D, FLIPADST_1D,
           FLIPADST_1D, FLIPADST_1D, ADST_1D, IDTX_1D, IDTX_1D, DCT_1D,
           IDTX_1D, ADST_1D, IDTX_1D, FLIPADST_1D]

# inverse shifts [row, col] and forward shifts [pre-col, post-col,
# post-row] of the square sizes (EbInvTransforms.c:17-35,
# EbTransforms.h:26-44)
INV_SHIFT = {(8, 8): (-1, -4), (16, 16): (-2, -4), (32, 32): (-2, -4),
             (64, 64): (-2, -4)}
FWD_SHIFT = {(8, 8): (2, -1, 0), (16, 16): (2, -2, 0), (32, 32): (2, -4, 0),
             (64, 64): (0, -2, -2)}

INV_COS_BIT = 12
# forward cos bits indexed [log2(w)-2][log2(h)-2] (EbTransforms.h:46-49)
FWD_COS_BIT_COL = [[13, 13, 13, 0, 0], [13, 13, 13, 12, 0],
                   [13, 13, 13, 12, 13], [0, 13, 13, 12, 13],
                   [0, 0, 13, 12, 13]]
FWD_COS_BIT_ROW = [[13, 13, 12, 0, 0], [13, 13, 13, 12, 0],
                   [13, 13, 12, 13, 12], [0, 12, 13, 12, 11],
                   [0, 0, 12, 11, 10]]

NEW_SQRT2 = 5793       # 2^12 * sqrt(2)
NEW_SQRT2_BITS = 12


@lru_cache(maxsize=None)
def _trig():
    return _tbl.read_npz(_DATA / "trig_tables.npz")


def cospi_arr(cos_bit: int) -> np.ndarray:
    """cospi[i] ≈ cos(i*pi/128) * 2^cos_bit, i = 0..63 (normative constants)."""
    return _trig()["cospi"][cos_bit - 10].astype(np.int64)


MODE_ADD_CLAMP = 0   # out = clamp(wa*x[ia] + wb*x[ib])
MODE_BTF = 1         # out = round2(wa*x[ia] + wb*x[ib], cos_bit)
MODE_LIN = 2         # out = wa*x[ia] + wb*x[ib]   (no clamp, no round)


@lru_cache(maxsize=None)
def _raw_stages():
    return json.loads((_DATA / "txfm_stages.json").read_text())


_NAME = {(kind, n, d): f"svt_av1_{d[0]}{kind}{n}_new"
         for kind, sizes in (("dct", (8, 16, 32, 64)), ("adst", (8, 16)))
         for n in sizes for d in ("inv", "fwd")}


@lru_cache(maxsize=None)
def compiled_stages(kind: str, n: int, direction: str, cos_bit: int):
    """Compile the stage network to per-stage arrays (ia, wa, ib, wb, mode).

    Returns a tuple of stages; each stage is a 5-tuple of int32 np.ndarrays of
    length n (mode is int8).
    """
    rows_all = _raw_stages()[_NAME[(kind, n, direction)]]
    cospi = cospi_arr(cos_bit)
    out = []
    for stage in rows_all:
        ia = np.zeros(n, np.int32)
        wa = np.zeros(n, np.int32)
        ib = np.zeros(n, np.int32)
        wb = np.zeros(n, np.int32)
        mode = np.zeros(n, np.int8)
        for r, op in enumerate(stage):
            tag = op[0]
            if tag == "btf":
                (sa, ka), i0, (sb, kb), i1 = op[1], op[2], op[3], op[4]
                ia[r], ib[r] = i0, i1
                wa[r] = int(cospi[ka]) * (-1 if sa == "-c" else 1)
                wb[r] = int(cospi[kb]) * (-1 if sb == "-c" else 1)
                mode[r] = MODE_BTF
            elif tag == "add":
                _, s0, i0, s1, i1 = op
                ia[r], wa[r], ib[r], wb[r] = i0, s0, i1, s1
                mode[r] = MODE_ADD_CLAMP
            elif tag == "addnc":
                _, s0, i0, s1, i1 = op
                ia[r], wa[r], ib[r], wb[r] = i0, s0, i1, s1
                mode[r] = MODE_LIN
            elif tag == "pass":
                ia[r], wa[r] = op[1], 1
                mode[r] = MODE_LIN
            elif tag == "neg":
                ia[r], wa[r] = op[1], -1
                mode[r] = MODE_LIN
            else:
                raise ValueError(tag)
        out.append((ia, wa, ib, wb, mode))
    return tuple(out)


def opt_range(bd: int, is_col: bool) -> int:
    """Inverse-transform per-stage clamp range (EbInvTransforms.c:42-84)."""
    if bd == 8:
        return 16
    if bd == 10:
        return 16 if is_col else 18
    return 18 if is_col else 20
