"""Film grain estimation from source frames.

Copy of ``svtav1_tpu/encoder/noise_model.py``.  Maps the reference's
noise-model flow (noise_model.c:392-505: flat-block selection, AR
coefficient least-squares fit, strength-LUT fit) onto a compact numpy
pipeline:

1. high-pass residual = source - 5x5 box mean;
2. flat 16x16 blocks chosen by low smoothed-gradient energy (the
   reference's av1_noise_model_update flat-block classifier);
3. AR(lag) coefficients by least squares over residual neighborhoods in
   flat blocks (Yule-Walker normal equations, the same objective
   noise_model.c's equation-system solver minimizes), quantized to the
   bitstream's int8 domain at ar_coeff_shift;
4. the scaling (strength) points calibrated in closed loop: generate
   the actual grain template with the fitted coefficients, measure its
   std, and set the piecewise-linear scaling so synthesized noise std
   matches the measured per-intensity residual std.

Returns a film_grain params dict (ops/film_grain naming) or None when
the source shows no usable grain.
"""

from __future__ import annotations

import numpy as np

from ..ops.film_grain import (generate_chroma_grain, generate_luma_grain,
                              _pred_pos)


def _box(x, r):
    """(2r+1)^2 box mean via cumsum, edge-clamped."""
    x = x.astype(np.float64)
    xp = np.pad(x, r, mode="edge")
    c = xp.cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0)))
    n = 2 * r + 1
    s = (c[n:, n:] - c[:-n, n:] - c[n:, :-n] + c[:-n, :-n])
    return s / (n * n)


def _flat_mask(plane, blk=16, frac=0.35):
    """Boolean [H//blk, W//blk]: lowest-gradient-energy blocks."""
    sm = _box(plane, 2)
    gy, gx = np.gradient(sm)
    energy = gy * gy + gx * gx
    h, w = plane.shape
    bh, bw = h // blk, w // blk
    be = energy[:bh * blk, :bw * blk].reshape(bh, blk, bw, blk)
    be = be.mean(axis=(1, 3))
    thr = np.quantile(be, frac)
    return be <= thr


def _ar_fit(resid, mask, lag, blk=16):
    """Least-squares AR fit over flat blocks.  resid [H,W] float;
    returns (coeffs float array, sample std, samples)."""
    pos = _pred_pos(lag)
    rows, cols = [], []
    h, w = resid.shape
    bh, bw = mask.shape
    samples_X, samples_y = [], []
    for br in range(bh):
        for bc in range(bw):
            if not mask[br, bc]:
                continue
            y0, x0 = br * blk, bc * blk
            # interior sample grid (margin = lag)
            ys = np.arange(y0 + lag, min(y0 + blk, h - lag))
            xs = np.arange(x0 + lag, min(x0 + blk, w - lag))
            if not len(ys) or not len(xs):
                continue
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            cols_k = [resid[Y + dr, X + dc].ravel() for dr, dc, _ in pos]
            samples_X.append(np.stack(cols_k, -1))
            samples_y.append(resid[Y, X].ravel())
    if not samples_X:
        return None, 0.0, 0
    A = np.concatenate(samples_X)
    b = np.concatenate(samples_y)
    if len(b) < 16 * len(pos):
        return None, 0.0, len(b)
    coef, *_ = np.linalg.lstsq(A, b, rcond=None)
    return coef, float(b.std()), len(b)


def _sigma_by_intensity(plane, resid, mask, points=6, blk=16):
    """Per-intensity-bin residual std over flat blocks → list of
    (intensity, sigma) anchors (monotone x)."""
    h, w = plane.shape
    bh, bw = mask.shape
    m = np.zeros((h, w), bool)
    for br in range(bh):
        for bc in range(bw):
            if mask[br, bc]:
                m[br * blk:(br + 1) * blk, bc * blk:(bc + 1) * blk] = True
    vals = plane[m].astype(np.float64)
    res = resid[m]
    if len(vals) == 0:
        return []
    edges = np.linspace(0, 256, points + 1)
    out = []
    for i in range(points):
        sel = (vals >= edges[i]) & (vals < edges[i + 1])
        if sel.sum() < 64:
            continue
        x = int((edges[i] + edges[i + 1]) / 2)
        out.append((x, float(res[sel].std())))
    return out


def estimate_grain_params(y, u, v, strength: float = 1.0,
                          seed: int = 7391):
    """Estimate film grain parameters from one 8-bit 4:2:0 source frame.
    strength scales the synthesized grain amplitude (CLI --film-grain
    N maps to N/8).  Returns params dict or None."""
    y = np.asarray(y, np.float64)
    lag = 2
    resid = y - _box(y, 2)
    mask = _flat_mask(y)
    coef, sigma, n = _ar_fit(resid, mask, lag)
    if coef is None or sigma < 0.4:
        return None
    shift = 7
    ar_y = np.clip(np.round(coef * (1 << shift)), -128, 127).astype(int)
    # chroma: AR fit reuse (luma-correlation coeff 0), own sigma
    params = dict(
        num_y_points=0, num_cb_points=0, num_cr_points=0,
        scaling_points_y=[], scaling_points_cb=[], scaling_points_cr=[],
        ar_coeff_lag=lag, ar_coeff_shift=shift, grain_scale_shift=0,
        random_seed=seed, grain_seed=seed, bit_depth=8,
        chroma_scaling_from_luma=0, scaling_shift=8,
        cb_mult=128, cb_luma_mult=192, cb_offset=256,
        cr_mult=128, cr_luma_mult=192, cr_offset=256,
        overlap_flag=1, clip_to_restricted_range=0,
        ar_coeffs_y=list(ar_y) + [0] * (24 - len(ar_y)),
        ar_coeffs_cb=[0] * 25, ar_coeffs_cr=[0] * 25)
    # closed loop: measure the template the decoder will synthesize
    params["num_y_points"] = 1        # enable template generation
    tmpl = generate_luma_grain(params)
    core = tmpl[9:, 9:73]             # steady-state AR region
    sig_g = float(core.std())
    if sig_g < 1e-3:
        return None
    pts = _sigma_by_intensity(y, resid, mask)
    if not pts:
        return None
    sc = []
    last_x = -1
    for x, s in pts:
        if x <= last_x:
            continue
        val = int(np.clip(round(s * strength * 256.0 / sig_g), 0, 255))
        sc.append((x, val))
        last_x = x
    if not sc or all(v == 0 for _, v in sc):
        return None
    params["scaling_points_y"] = sc
    params["num_y_points"] = len(sc)

    # chroma strength from the chroma residual (flat mask at half res)
    cpts = []
    for plane, key_n, key_p in ((u, "num_cb_points", "scaling_points_cb"),
                                (v, "num_cr_points", "scaling_points_cr")):
        c = np.asarray(plane, np.float64)
        cres = c - _box(c, 2)
        cmask = _flat_mask(c, blk=8)
        csig = float(cres[np.repeat(np.repeat(cmask, 8, 0), 8, 1)
                          [:c.shape[0], :c.shape[1]]].std())
        # chroma template needs its own AR pass: reuse luma fit on the
        # chroma residual statistics via the luma-correlation tap = 0
        params[key_n] = 0
        params[key_p] = []
        cpts.append(csig)
    # single flat chroma point when chroma noise is material
    if max(cpts) * strength * 256.0 / sig_g >= 4.0:
        ar_c = np.clip(np.round(coef * (1 << shift) * 0.7), -128,
                       127).astype(int)
        params["ar_coeffs_cb"] = list(ar_c) + [0] * (25 - len(ar_c))
        params["ar_coeffs_cr"] = list(ar_c) + [0] * (25 - len(ar_c))
        params["num_cb_points"] = params["num_cr_points"] = 1
        cb_t, cr_t = generate_chroma_grain(params, tmpl, 1)
        params["num_cb_points"] = params["num_cr_points"] = 0
        for key_n, key_p, tpl, csig in (
                ("num_cb_points", "scaling_points_cb", cb_t, cpts[0]),
                ("num_cr_points", "scaling_points_cr", cr_t, cpts[1])):
            sgc = float(tpl[6:, 6:38].std())
            if sgc < 1e-3:
                continue
            val = int(np.clip(round(csig * strength * 256.0 / sgc), 0,
                              255))
            if val:
                params[key_p] = [(0, val), (255, val)]
                params[key_n] = 2
    return params
