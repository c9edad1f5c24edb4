"""AV1 subpel interpolation constants and kernels (spec §7.11.3.4).

Counterpart of the constants and ``kernels`` of
``svtav1_tpu/ops/convolve.py``: the rounding shifts of the normative 2D
subpel filter and its 16-phase 8-tap kernels per filter type (reference
EbInterPrediction.c:320-427).  Motion compensation (``ops/mc.py``) gathers
a kernel per block from these tables.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

FILTER_BITS = 7
ROUND0 = 3
ROUND1 = 11

EIGHTTAP_REGULAR, EIGHTTAP_SMOOTH, MULTITAP_SHARP, BILINEAR = range(4)
_NAMES = {0: "regular", 1: "smooth", 2: "sharp", 3: "bilinear"}


@lru_cache(maxsize=None)
def kernels(filter_type: int) -> np.ndarray:
    """[16 phases, 8 taps] int32 (normative subpel filter kernels)."""
    d = np.load(Path(__file__).parent.parent / "spec/data/interp_filters.npz")
    return d[_NAMES[filter_type]].astype(np.int32)
