"""Default frame CDF tables (spec §8.4).

Copy of ``svtav1_tpu/spec/cdf.py``, cut to what the flat path reads: the
normative defaults from ``data/default_cdfs.npz``, with the coefficient
tables of the frame's qindex class.  The port codes with the native tile
coder, which copies these tables and adapts its own copies, so the
adaptation rule and the per-tile snapshots are not needed here.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data" / "default_cdfs.npz"


def q_ctx(base_qindex: int) -> int:
    """Coefficient CDF qindex class (EbCabacContextModel.c:2270)."""
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


_COEF_FIELDS = ("txb_skip_cdf", "eob_extra_cdf", "dc_sign_cdf",
                "eob_flag_cdf16", "eob_flag_cdf32", "eob_flag_cdf64",
                "eob_flag_cdf128", "eob_flag_cdf256", "eob_flag_cdf512",
                "eob_flag_cdf1024", "coeff_base_eob_cdf", "coeff_base_cdf",
                "coeff_br_cdf")


@lru_cache(maxsize=None)
def _npz():
    return np.load(_DATA)


class CdfContext:
    """Default CDF set of one frame.  Attribute access returns the ndarray
    whose last axis is [icdf_0..icdf_{n-1}, counter] (icdf[n-1] == 0)."""

    def __init__(self, base_qindex: int):
        d = _npz()
        qc = q_ctx(base_qindex)
        self._t = {}
        for k in d.files:
            if k.startswith("raw_"):
                continue
            arr = d[k].astype(np.uint16)
            if k in _COEF_FIELDS:
                arr = arr[qc]
            self._t[k] = arr.copy()

    def __getattr__(self, name):
        if name == "_t":           # not yet set (e.g. during unpickle)
            raise AttributeError(name)
        try:
            return self._t[name]
        except KeyError:
            raise AttributeError(name)
