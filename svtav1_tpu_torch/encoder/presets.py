"""Preset system: the reference's M0-M13 speed/quality axis.

Copy of ``svtav1_tpu/encoder/presets.py`` (the preset table and
``apply_preset``).  The axis gates search breadth knobs that trade encode
speed against BD-rate, monotonically:

  knob                         slow (M0)            fast (M13)
  angle_deltas                 ±3,±2,±1             none (base angles)
  partition RD search          on                   off (flat 32x32)
  tx-type RD search            on                   off (DCT only)
  CDEF search                  on                   off
  per-symbol CDF update        on                   off (default CDFs)
"""

from __future__ import annotations

from dataclasses import replace

# enc_mode -> (angle_deltas, part_search, tx_search, cdef, cdf_update,
#              filter_search)
_PRESETS = {
    0:  ((-3, -2, -1, 0, 1, 2, 3), True, True, True, True, True),
    1:  ((-3, -2, -1, 0, 1, 2, 3), True, True, True, True, True),
    2:  ((-3, -1, 0, 1, 3), True, True, True, True, True),
    3:  ((-2, 0, 2), True, True, True, True, True),
    4:  ((-2, 0, 2), True, True, True, True, True),
    5:  ((-2, 0, 2), True, True, True, True, True),
    6:  ((0,), True, True, True, True, True),
    7:  ((0,), True, True, True, True, True),
    8:  ((0,), True, True, True, True, True),
    9:  ((0,), True, False, True, True, True),
    10: ((0,), True, False, False, True, True),
    11: ((0,), False, False, False, True, False),
    12: ((0,), False, False, False, True, False),
    13: ((0,), False, False, False, False, False),
}

MAX_ENC_MODE = max(_PRESETS)


def apply_preset(cfg, enc_mode: int):
    """Return a copy of cfg with the preset's feature gates applied
    (explicit user overrides should be re-applied on top, like the
    reference's CLI-over-preset precedence)."""
    if not 0 <= enc_mode <= MAX_ENC_MODE:
        raise ValueError(f"preset must be 0..{MAX_ENC_MODE}, "
                         f"got {enc_mode}")
    ad, part, tx, cdef, cdf, ifs = _PRESETS[enc_mode]
    return replace(cfg, angle_deltas=ad, part_search=part, tx_search=tx,
                   enable_cdef=cdef, cdf_update=cdf, filter_search=ifs)
