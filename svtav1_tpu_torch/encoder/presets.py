"""Preset system: the reference's M0-M13 speed/quality axis.

Copy of ``svtav1_tpu/encoder/presets.py`` (the preset table,
``apply_preset`` and ``verify_settings``).  The axis gates search breadth knobs that trade encode
speed against BD-rate, monotonically:

  knob                         slow (M0)            fast (M13)
  angle_deltas                 ±3,±2,±1             none (base angles)
  partition RD search          on                   off (flat 32x32)
  tx-type RD search            on                   off (DCT only)
  CDEF search                  on                   off
  per-symbol CDF update        on                   off (default CDFs)

Validation mirrors svt_av1_verify_settings (EbEncSettings.c:1858): every
externally-settable field is range-checked with the JAX package's message
before any device work is queued.
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


def verify_settings(cfg, keyint: int = 64) -> None:
    """Range/consistency validation (EbEncSettings.c:1858 analogue).
    Raises ValueError with the offending field named."""
    if cfg.width <= 0 or cfg.height <= 0:
        raise ValueError("width/height must be positive")
    from .geometry import check_dims
    check_dims(cfg.width, cfg.height, cfg.part_search,
               inloop_extras=(cfg.enable_cdef or cfg.enable_lr or
                              cfg.enable_ccso))
    if cfg.width > 4096:
        raise ValueError("width > 4096 requires mandatory tile columns")
    if not 0 <= cfg.qindex <= 255:
        raise ValueError(f"qindex must be 0..255, got {cfg.qindex}")
    if cfg.bit_depth not in (8, 10):
        raise ValueError(f"bit_depth must be 8 or 10, got {cfg.bit_depth}")
    t = cfg.tile_cols
    if t < 1 or (t & (t - 1)):
        raise ValueError(f"tile_cols must be a power of two, got {t}")
    if t > 1 and (cfg.width // t) % 64:
        raise ValueError("tile columns must be SB-aligned equal widths")
    for d in cfg.angle_deltas:
        if not -3 <= d <= 3:
            raise ValueError(f"angle delta out of range: {d}")
    if keyint < 1:
        raise ValueError(f"keyint must be >= 1, got {keyint}")
