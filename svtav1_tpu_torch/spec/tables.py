"""Loaders for normative AV1 constant tables (spec data in ``data/``).

Copy of ``svtav1_tpu/spec/tables.py``:
- scan orders (spec §5.11.40) per (tx_size, tx_type), over the adjusted
  tx area (64-dim transforms code only their 32-dim low band);
- quant lookup (spec §7.12.2): dc/ac dequant step per qindex and bit depth.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data"

TX_W = [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64]
TX_H = [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16]

def adjusted_tx_wh(tx_size: int):
    """Coded coefficient area (64-dim clamped to 32)."""
    return min(TX_W[tx_size], 32), min(TX_H[tx_size], 32)


_SQ_OF = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}


def txsize_sqr(tx_size: int) -> int:
    """Square TX of the smaller dimension."""
    return _SQ_OF[min(TX_W[tx_size], TX_H[tx_size])]


def txsize_sqr_up(tx_size: int) -> int:
    """Square TX of the larger dimension."""
    return _SQ_OF[max(TX_W[tx_size], TX_H[tx_size])]


def txs_ctx(tx_size: int) -> int:
    """Coefficient-coding size context (EbEntropyCoding.c:492)."""
    return (txsize_sqr(tx_size) + txsize_sqr_up(tx_size) + 1) >> 1


def tx_scale_shift(tx_size: int) -> int:
    """Dequant downshift: 0/1/2 by tx area (EbCoefficients.h:2575)."""
    pels = TX_W[tx_size] * TX_H[tx_size]
    return (pels > 256) + (pels > 1024)


def read_npz(path) -> dict:
    """Every array of an npz file, read at once (an open npz file is not
    safe to read from several threads)."""
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@lru_cache(maxsize=None)
def _scan_npz():
    return read_npz(_DATA / "scan_tables.npz")


@lru_cache(maxsize=None)
def scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Scan order: position-in-block for each coded index (int16)."""
    return _scan_npz()[f"scan_{tx_size}_{tx_type}"]


@lru_cache(maxsize=None)
def _quant_npz():
    return read_npz(_DATA / "quant_tables.npz")


@lru_cache(maxsize=None)
def dc_q(bd: int = 8) -> np.ndarray:
    return _quant_npz()[f"dc_{bd}"]


@lru_cache(maxsize=None)
def ac_q(bd: int = 8) -> np.ndarray:
    return _quant_npz()[f"ac_{bd}"]


def qindex_to_dq(qindex: int, bd: int = 8):
    """(dc_dequant, ac_dequant) step sizes for a base qindex (no deltas)."""
    q = int(np.clip(qindex, 0, 255))
    return int(dc_q(bd)[q]), int(ac_q(bd)[q])
