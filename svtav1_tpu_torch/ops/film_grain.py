"""Film grain template generation, AV1 spec §7.18.3.3; reference
grainSynthesis.c.

Copy of ``svtav1_tpu/ops/film_grain.py`` (host numpy): the 16-bit LFSR,
the gaussian sequence draw and the AR-filtered luma/chroma grain
templates, which the grain estimator (``encoder/noise_model.py``) runs,
and the synthesis on a decoded frame (scaling LUTs, per-stripe noise
images with overlap blending, the per-pixel blend; spec §7.18.3.5-12,
grainSynthesis.c:506-1260), which the decoder applies to its output only.
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


def init_scaling_lut(points) -> np.ndarray:
    """Piecewise-linear scaling LUT (grainSynthesis.c:506-530)."""
    lut = np.zeros(256, np.int32)
    n = len(points)
    if n == 0:
        return lut
    lut[:points[0][0]] = points[0][1]
    for p in range(n - 1):
        dy = points[p + 1][1] - points[p][1]
        dx = points[p + 1][0] - points[p][0]
        delta = dy * ((65536 + (dx >> 1)) // dx)
        for x in range(dx):
            lut[points[p][0] + x] = points[p][1] + ((x * delta + 32768) >> 16)
    lut[points[n - 1][0]:] = points[n - 1][1]
    return lut


def add_noise_to_block(params: dict, luma, cb, cr, luma_grain, cb_grain,
                       cr_grain, luts, subsamp: int = 1):
    """Vectorized add_noise_to_block (8-bit, grainSynthesis.c:541-640);
    mutates nothing — returns (luma', cb', cr')."""
    lut_y, lut_cb, lut_cr = luts
    sh = params["scaling_shift"]
    rnd = 1 << (sh - 1)
    if params["clip_to_restricted_range"]:
        min_l, max_l, min_c, max_c = 16, 235, 16, 240
    else:
        min_l, max_l, min_c, max_c = 0, 255, 0, 255
    if params["chroma_scaling_from_luma"]:
        cb_mult, cb_lmult, cb_off = 0, 64, 0
        cr_mult, cr_lmult, cr_off = 0, 64, 0
    else:
        cb_mult = params["cb_mult"] - 128
        cb_lmult = params["cb_luma_mult"] - 128
        cb_off = params["cb_offset"] - 256
        cr_mult = params["cr_mult"] - 128
        cr_lmult = params["cr_luma_mult"] - 128
        cr_off = params["cr_offset"] - 256

    luma = luma.astype(np.int32)
    out_l = luma
    if params["num_y_points"] > 0:
        s = lut_y[luma]
        out_l = np.clip(luma + ((s * luma_grain + rnd) >> sh), min_l, max_l)

    if subsamp:
        avg = (luma[::2, ::2] + luma[::2, 1::2] + 1) >> 1
    else:
        avg = luma
    res = [out_l]
    for plane, grain, mult, lmult, off, lut, apply in (
            (cb, cb_grain, cb_mult, cb_lmult, cb_off, lut_cb,
             params["num_cb_points"] or params["chroma_scaling_from_luma"]),
            (cr, cr_grain, cr_mult, cr_lmult, cr_off, lut_cr,
             params["num_cr_points"] or params["chroma_scaling_from_luma"])):
        plane = plane.astype(np.int32)
        if apply:
            idx = np.clip(((avg * lmult + mult * plane) >> 6) + off, 0, 255)
            s = lut[idx]
            plane = np.clip(plane + ((s * grain + rnd) >> sh), min_c, max_c)
        res.append(plane)
    return tuple(res)


# ---------------- whole-frame noise assembly (§7.18.3.11-12) ------------- #

def _blend_cols(old, new, ov: int, gmin: int, gmax: int):
    """Vertical boundary (left-overlap) blend, ver_boundary_overlap."""
    if ov == 1:
        v = (old * 23 + new * 22 + 16) >> 5
    else:
        v = np.empty_like(old)
        v[:, 0] = (old[:, 0] * 27 + new[:, 0] * 17 + 16) >> 5
        v[:, 1] = (old[:, 1] * 17 + new[:, 1] * 27 + 16) >> 5
    return np.clip(v, gmin, gmax)


def _blend_rows(old, new, ov: int, gmin: int, gmax: int):
    """Horizontal boundary (top-overlap) blend, hor_boundary_overlap."""
    if ov == 1:
        v = (old * 23 + new * 22 + 16) >> 5
    else:
        v = np.empty_like(old)
        v[0] = (old[0] * 27 + new[0] * 17 + 16) >> 5
        v[1] = (old[1] * 17 + new[1] * 27 + 16) >> 5
    return np.clip(v, gmin, gmax)


def _plane_noise(template, W: int, H: int, offsets, base: int, step: int,
                 blk: int, ov: int, overlap: bool, gmin: int, gmax: int):
    """Noise image for one plane.  offsets: [stripes, blocks, 2] (oy, ox)
    template draws shared across planes; base/step map offsets into the
    template (luma 9/2, chroma-420 6/1); blk 32/16; ov 2/1."""
    n_stripes = (H + blk - 1) // blk
    n_blocks = (W + blk - 1) // blk
    stripes = []
    for s in range(n_stripes):
        rows = min(blk + ov, H - s * blk)
        stripe = np.zeros((rows, W), np.int32)
        overhang = None
        for j in range(n_blocks):
            oy, ox = offsets[s][j]
            r0 = base + step * oy
            c0 = base + step * ox
            win = template[r0:r0 + rows, c0:c0 + blk + ov]
            x0 = j * blk
            w_cols = min(blk, W - x0)
            if overlap and j > 0:
                stripe[:, x0:x0 + ov] = _blend_cols(overhang,
                                                    win[:, :ov], ov,
                                                    gmin, gmax)
                stripe[:, x0 + ov:x0 + w_cols] = win[:, ov:w_cols]
            else:
                stripe[:, x0:x0 + w_cols] = win[:, :w_cols]
            # next block blends against THIS block's unblended template
            # columns [blk, blk+ov) (copy_area → col_buf in the reference)
            overhang = np.array(win[:, blk:blk + ov])
        stripes.append(stripe)
    img = np.zeros((H, W), np.int32)
    for s in range(n_stripes):
        y0 = s * blk
        rows = min(blk, H - y0)
        st = stripes[s]
        if overlap and s > 0:
            prev = stripes[s - 1]
            r = min(ov, rows)
            img[y0:y0 + r] = _blend_rows(prev[blk:blk + r], st[:r], ov,
                                         gmin, gmax)[:r]
            img[y0 + r:y0 + rows] = st[r:rows]
        else:
            img[y0:y0 + rows] = st[:rows]
    return img


def film_grain_noise_planes(params: dict, W: int, H: int,
                            subsamp: int = 1):
    """(noise_y, noise_cb, noise_cr) int32 images for a WxH 8-bit 4:2:0
    frame (spec §7.18.3.11-12: per-stripe reseeded RNG, one offset draw
    per 32x32 luma block shared by all planes, overlap blending)."""
    bd = params["bit_depth"]
    gmin = -(128 << (bd - 8))
    gmax = (256 << (bd - 8)) - 1 - (128 << (bd - 8))
    luma = generate_luma_grain(params)
    cb_t, cr_t = generate_chroma_grain(params, luma, subsamp)
    n_stripes = (H + 31) // 32
    n_blocks = (W + 31) // 32
    offsets = []
    for s in range(n_stripes):
        rng = GrainRng(0)
        rng.reseed_line(s << 5, params["random_seed"])
        row = []
        for _ in range(n_blocks):
            r = rng.bits(8)
            row.append((r & 15, (r >> 4) & 15))
        offsets.append(row)
    overlap = bool(params["overlap_flag"])
    ny = _plane_noise(luma, W, H, offsets, 9, 2, 32, 2, overlap, gmin,
                      gmax)
    cw, ch = W >> subsamp, H >> subsamp
    ncb = _plane_noise(cb_t, cw, ch, offsets, 6, 1, 32 >> subsamp,
                       2 >> subsamp, overlap, gmin, gmax)
    ncr = _plane_noise(cr_t, cw, ch, offsets, 6, 1, 32 >> subsamp,
                       2 >> subsamp, overlap, gmin, gmax)
    return ny, ncb, ncr


def apply_film_grain(params: dict, planes, subsamp: int = 1):
    """Film grain synthesis on a full decoded frame (y, u, v) — §7.18.
    Returns new uint8 planes; inputs are not modified."""
    y, u, v = (np.asarray(p) for p in planes)
    H, W = y.shape
    ny, ncb, ncr = film_grain_noise_planes(params, W, H, subsamp)
    lut_y = init_scaling_lut(params.get("scaling_points_y", ()))
    if params["chroma_scaling_from_luma"]:
        lut_cb = lut_cr = lut_y
    else:
        lut_cb = init_scaling_lut(params.get("scaling_points_cb", ()))
        lut_cr = init_scaling_lut(params.get("scaling_points_cr", ()))
    out = add_noise_to_block(params, y, u, v, ny, ncb, ncr,
                             (lut_y, lut_cb, lut_cr), subsamp)
    return tuple(p.astype(np.uint8) for p in out)
