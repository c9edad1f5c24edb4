"""Film grain template generation, AV1 spec §7.18.3.3; reference
grainSynthesis.c.

Copy of the numpy parts of ``svtav1_tpu/ops/film_grain.py`` that the
grain estimator (``encoder/noise_model.py``) runs: the 16-bit LFSR, the
gaussian sequence draw and the AR-filtered luma/chroma grain templates.
The encoder only signals grain parameters; synthesis on a decoded frame
is the decoder's.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np


@lru_cache(maxsize=None)
def gaussian_sequence() -> np.ndarray:
    d = np.load(Path(__file__).parent.parent / "spec/data/film_grain.npz")
    return d["gaussian_sequence"].astype(np.int32)


class GrainRng:
    """16-bit LFSR (grainSynthesis.c:360-378)."""

    def __init__(self, seed: int):
        self.reg = seed & 0xFFFF

    def reseed_line(self, luma_line: int, seed: int):
        self.reg = seed & 0xFFFF
        luma_num = luma_line >> 5
        self.reg ^= ((luma_num * 37 + 178) & 255) << 8
        self.reg ^= (luma_num * 173 + 105) & 255

    def bits(self, n: int) -> int:
        r = self.reg
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = ((r >> 1) | (bit << 15)) & 0xFFFF
        self.reg = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _pred_pos(lag: int):
    pos = []
    for row in range(-lag, 0):
        for col in range(-lag, lag + 1):
            pos.append((row, col, 0))
    for col in range(-lag, 0):
        pos.append((0, col, 0))
    return pos


def generate_luma_grain(params: dict) -> np.ndarray:
    """73x82 luma grain template (8-bit geometry), int32."""
    bd = params["bit_depth"]
    if params["num_y_points"] == 0:
        return np.zeros((73, 82), np.int32)
    gauss_shift = 12 - bd + params["grain_scale_shift"]
    lag = params["ar_coeff_lag"]
    coeffs = params["ar_coeffs_y"]
    shift = params["ar_coeff_shift"]
    gmin = -(128 << (bd - 8))
    gmax = (256 << (bd - 8)) - 1 - (128 << (bd - 8))
    h, w = 73, 82
    rng = GrainRng(params["random_seed"])
    gs = gaussian_sequence()
    blk = np.empty((h, w), np.int32)
    for i in range(h):
        for j in range(w):
            blk[i, j] = (int(gs[rng.bits(11)]) +
                         ((1 << gauss_shift) >> 1)) >> gauss_shift
    pos = _pred_pos(lag)
    rnd = 1 << (shift - 1)
    for i in range(3, h):
        for j in range(3, w - 3):
            wsum = 0
            for p, (dr, dc, _) in enumerate(pos):
                wsum += coeffs[p] * blk[i + dr, j + dc]
            blk[i, j] = min(max(blk[i, j] + ((wsum + rnd) >> shift), gmin),
                            gmax)
    return blk


def generate_chroma_grain(params: dict, luma_blk: np.ndarray,
                          subsamp: int = 1):
    """(cb, cr) grain templates for 4:2:0 (subsamp 1): 38x44."""
    bd = params["bit_depth"]
    gauss_shift = 12 - bd + params["grain_scale_shift"]
    lag = params["ar_coeff_lag"]
    shift = params["ar_coeff_shift"]
    gmin = -(128 << (bd - 8))
    gmax = (256 << (bd - 8)) - 1 - (128 << (bd - 8))
    # chroma block geometry for 4:2:0: 3+3+32 = 38 rows, 3+3+32+3+3 = 44 cols
    h, w = 38, 44
    gs = gaussian_sequence()
    cb = np.zeros((h, w), np.int32)
    cr = np.zeros((h, w), np.int32)
    if params["num_cb_points"] or params["chroma_scaling_from_luma"]:
        rng = GrainRng(0)
        rng.reseed_line(7 << 5, params["random_seed"])
        for i in range(h):
            for j in range(w):
                cb[i, j] = (int(gs[rng.bits(11)]) +
                            ((1 << gauss_shift) >> 1)) >> gauss_shift
    if params["num_cr_points"] or params["chroma_scaling_from_luma"]:
        rng = GrainRng(0)
        rng.reseed_line(11 << 5, params["random_seed"])
        for i in range(h):
            for j in range(w):
                cr[i, j] = (int(gs[rng.bits(11)]) +
                            ((1 << gauss_shift) >> 1)) >> gauss_shift
    pos = _pred_pos(lag)
    has_luma = params["num_y_points"] > 0
    rnd = 1 << (shift - 1)
    apply_cb = params["num_cb_points"] or params["chroma_scaling_from_luma"]
    apply_cr = params["num_cr_points"] or params["chroma_scaling_from_luma"]
    for i in range(3, h):
        for j in range(3, w - 3):
            wcb = wcr = 0
            for p, (dr, dc, _) in enumerate(pos):
                wcb += params["ar_coeffs_cb"][p] * cb[i + dr, j + dc]
                wcr += params["ar_coeffs_cr"][p] * cr[i + dr, j + dc]
            if has_luma:
                ly = ((i - 3) << subsamp) + 3
                lx = ((j - 3) << subsamp) + 3
                av = int(luma_blk[ly:ly + subsamp + 1,
                                  lx:lx + subsamp + 1].sum())
                av = (av + ((1 << (2 * subsamp)) >> 1)) >> (2 * subsamp)
                p_idx = len(pos)
                wcb += params["ar_coeffs_cb"][p_idx] * av
                wcr += params["ar_coeffs_cr"][p_idx] * av
            if apply_cb:
                cb[i, j] = min(max(cb[i, j] + ((wcb + rnd) >> shift), gmin),
                               gmax)
            if apply_cr:
                cr[i, j] = min(max(cr[i, j] + ((wcr + rnd) >> shift), gmin),
                               gmax)
    return cb, cr
