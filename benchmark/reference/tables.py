"""Normative AV1 tables of the reference, read from ``data/``.

``data/spec.npz`` holds the default CDFs that the flat all-intra syntax
codes with, the dc/ac quantizer lookups at 8 and 10 bits and the cospi
constants; ``data/txfm_stages.json`` the butterfly networks of the 16- and
32-point DCT and the 16-point ADST.  Both are frozen copies of the spec
tables, so that no change to the program under test moves them.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import numpy as np

DATA = Path(__file__).parent / "data"


@lru_cache(maxsize=None)
def spec() -> dict:
    with np.load(DATA / "spec.npz") as d:
        return {k: d[k] for k in d.files}


@lru_cache(maxsize=None)
def stages() -> dict:
    return json.loads((DATA / "txfm_stages.json").read_text())


def qindex_to_dq(qindex: int, bd: int) -> tuple:
    """(dc, ac) dequantizer steps of a base qindex (spec §7.12.2)."""
    t = spec()
    return int(t[f"q_dc_{bd}"][qindex]), int(t[f"q_ac_{bd}"][qindex])


@lru_cache(maxsize=None)
def zigzag(n: int) -> np.ndarray:
    """The default scan of a square n x n 2D transform (positions r*n+c in
    coding order): anti-diagonals, odd ones walked down, even ones up."""
    out = []
    for d in range(2 * n - 1):
        rows = range(max(0, d - n + 1), min(d, n - 1) + 1)
        rows = rows if d % 2 else reversed(rows)
        out.extend(r * n + d - r for r in rows)
    return np.asarray(out, np.int64)


def q_ctx(qindex: int) -> int:
    """Coefficient CDF class of a base qindex."""
    return 0 if qindex <= 20 else 1 if qindex <= 60 else 2 if qindex <= 120 \
        else 3
