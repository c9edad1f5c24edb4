"""Loop-restoration RDO: per-unit SGR and Wiener parameter search.

Counterpart of ``svtav1_tpu/encoder/lr_search.py``; reference
svt_av1_pick_filter_restoration / search_sgrproj (EbRestorationPick.c).
For each restoration unit: fit the self-guided projection weights by
least squares, clamp them to the signalable xqd range, then fit separable
symmetric Wiener taps and keep NONE, SGRPROJ or WIENER per unit by rate
and distortion.

Device work: the guided-filter components of all 16 eps over the whole
plane and their per-unit normal-equation sums (exact int64 sums; the JAX
package sums float32, whose rounding depends on the order of summation),
and the normative filters of every unit at its fitted parameters (windows
of one shape in one call).  Host numpy: the 2x2 solves, the Wiener solves
and the RD picks, as in the JAX package.  The search approximates stripe
boundaries with plane-edge replication; the apply is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import upload
from ..ec.lr_syntax import (RESTORE_NONE, RESTORE_SGRPROJ,
                            RESTORE_SWITCHABLE, RESTORE_WIENER, SGR_R,
                            SGRPROJ_PRJ_MAX0, SGRPROJ_PRJ_MAX1,
                            SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MIN1,
                            WIENER_TAP_MAX, WIENER_TAP_MIN)
from ..ops.ccso import edge_pad
from ..ops.lr_frame import _wiener_kernel, unit_count
from ..ops.restoration import (SGR_PARAMS, _sgr_filter_r1, _sgr_filter_r2,
                               apply_sgr, wiener_filter)

PRJ = 7            # SGRPROJ_PRJ_BITS
RST = 4            # SGRPROJ_RST_BITS

# approximate signalling cost in bits (ep literal + two subexp values +
# use flag; the reference uses exact CDF costs)
SGR_BITS = 18.0
NONE_BITS = 1.0
WIENER_BITS = 32.0


def _unit_sums(x, uh, uw, usize):
    """Per-unit int64 sums of x [H, W] -> [uh, uw] (SB-aligned planes)."""
    return x.reshape(uh, usize, uw, usize).sum((1, 3), dtype=torch.int64)


def _ep_stats(ext, src, dgd, eps: int, uh: int, uw: int, usize: int,
              bd: int):
    """Normal-equation per-unit sums for one ep candidate, [6, uh, uw]
    int64: f0.f0, f1.f1, f0.f1, f0.b, f1.b, b.b."""
    r0, r1 = SGR_R[eps]
    (_, _), (s0, s1) = SGR_PARAMS[eps]
    u = dgd.to(torch.int64) << RST
    b = (src.to(torch.int64) << RST) - u
    zeros = torch.zeros_like(u)
    f0 = _sgr_filter_r2(ext, s0, bd).to(torch.int64) - u if r0 else zeros
    f1 = _sgr_filter_r1(ext, s1, bd).to(torch.int64) - u if r1 else zeros
    return torch.stack([_unit_sums(a * c, uh, uw, usize) for a, c in (
        (f0, f0), (f1, f1), (f0, f1), (f0, b), (f1, b), (b, b))])


def sgr_search(src, dgd, lam: float, usize: int, bd: int = 8):
    """Per-unit SGR search for one plane (src vs the post-CDEF recon dgd,
    tensors on one device); returns the units dict or None if every unit
    chose NONE."""
    H, W = dgd.shape
    uh, uw = unit_count(usize, H), unit_count(usize, W)
    if uh * usize != H or uw * usize != W:
        # only SB-aligned planes are searched (the encoder enforces it)
        return None
    src = src.to(torch.int32)
    dgd = dgd.to(torch.int32)
    ext = edge_pad(dgd, 3)
    stats = torch.stack([_ep_stats(ext, src, dgd, eps, uh, uw, usize, bd)
                         for eps in range(16)])
    d = (src - dgd).to(torch.int64)
    none = _unit_sums(d * d, uh, uw, usize)
    stats, none = stats.cpu().numpy(), none.cpu().numpy()  # one read
    return _sgr_pick(stats.astype(np.float64), none.astype(np.float64), lam)


def _sgr_pick(stats, none_err, lam):
    """The JAX package's per-eps solves and RD pick on the host: stats
    [16, 6, uh, uw] and none_err [uh, uw] float64."""
    uh, uw = none_err.shape
    best = None                                # (eps, xqd0, xqd1) arrays
    scale2 = float(1 << (2 * PRJ))
    for eps in range(16):
        h00, h11, h01, c0, c1, bb = stats[eps]
        r0, r1 = SGR_R[eps]
        x0 = np.zeros((uh, uw))
        x1 = np.zeros((uh, uw))
        if r0 and r1:
            det = h00 * h11 - h01 * h01
            ok = det > 1e-9
            x0 = np.where(ok, (c0 * h11 - c1 * h01) / np.where(ok, det, 1),
                          0)
            x1 = np.where(ok, (c1 * h00 - c0 * h01) / np.where(ok, det, 1),
                          0)
        elif r0:
            ok = h00 > 1e-9
            x0 = np.where(ok, c0 / np.where(ok, h00, 1), 0)
        else:
            ok = h11 > 1e-9
            x1 = np.where(ok, c1 / np.where(ok, h11, 1), 0)
        xq0 = np.round(x0 * (1 << PRJ)).astype(np.int64)
        xq1 = np.round(x1 * (1 << PRJ)).astype(np.int64)
        # clamp through the signalable xqd domain (decode_xq inverse)
        if r0 and r1:
            xqd0 = np.clip(xq0, SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0)
            xqd1 = np.clip((1 << PRJ) - xqd0 - xq1, SGRPROJ_PRJ_MIN1,
                           SGRPROJ_PRJ_MAX1)
            q0, q1 = xqd0, (1 << PRJ) - xqd0 - xqd1
        elif r1 == 0:
            xqd0 = np.clip(xq0, SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0)
            xqd1 = np.clip((1 << PRJ) - xqd0, SGRPROJ_PRJ_MIN1,
                           SGRPROJ_PRJ_MAX1)
            q0, q1 = xqd0, np.zeros_like(xqd0)
        else:
            xqd1 = np.clip((1 << PRJ) - xq1, SGRPROJ_PRJ_MIN1,
                           SGRPROJ_PRJ_MAX1)
            xqd0 = np.zeros_like(xqd1)
            q0, q1 = xqd0, (1 << PRJ) - xqd1
        # quadratic error in the (<<RST, <<PRJ) domain, per unit
        err = (bb * scale2 + q0 * q0 * h00 + q1 * q1 * h11 +
               2.0 * q0 * q1 * h01 - 2.0 * q0 * c0 * (1 << PRJ) -
               2.0 * q1 * c1 * (1 << PRJ)) / scale2
        if best is None:
            best = (np.full((uh, uw), eps, np.int32),
                    xqd0.astype(np.int32), xqd1.astype(np.int32))
            sgr_err = err
        else:
            take = err < sgr_err
            best = (np.where(take, eps, best[0]),
                    np.where(take, xqd0, best[1]).astype(np.int32),
                    np.where(take, xqd1, best[2]).astype(np.int32))
            sgr_err = np.minimum(sgr_err, err)
    # RD pick per unit: NONE vs best SGR (errors in <<RST^2 domain)
    sc = float(1 << (2 * RST))
    use = (sgr_err / sc + lam * SGR_BITS) < (none_err + lam * NONE_BITS)
    if not use.any():
        return None
    return {"type": np.where(use, RESTORE_SGRPROJ,
                             RESTORE_NONE).astype(np.int32),
            "eps": best[0], "xqd": np.stack(best[1:], -1),
            "taps_v": np.zeros((uh, uw, 3), np.int32),
            "taps_h": np.zeros((uh, uw, 3), np.int32)}


# ------------------------------------------------------------------ #
# Wiener: alternating separable least squares (wiener_decompose_sep_sym,
# EbRestorationPick.c:906; float equivalent - taps are quantized to the
# signalable grid and the final error is measured with the normative
# integer filter)
# ------------------------------------------------------------------ #

def _solve_sym3(z, x):
    """z: [7, N] filtered rows/cols; solve symmetric normalized 7-tap:
    f[k]=f[6-k], f3 = 1-2(f0+f1+f2).  Returns float taps [7]."""
    g = np.stack([z[0] + z[6], z[1] + z[5], z[2] + z[4]]) - 2 * z[3]
    t = x - z[3]
    A = g @ g.T
    c = g @ t
    try:
        f3 = np.linalg.solve(A + 1e-6 * np.eye(3), c)
    except np.linalg.LinAlgError:
        return None
    f = np.empty(7)
    f[:3] = f3
    f[4:] = f3[::-1]
    f[3] = 1.0 - 2.0 * f3.sum()
    return f


def _wiener_solve_unit(src_w, ext_w, chroma: bool, iters: int = 5):
    """Solve separable Wiener taps for one unit.  src_w [h, w];
    ext_w [h+6, w+6].  Returns (taps_v3, taps_h3) coded taps or None."""
    avg = ext_w.mean()
    d = ext_w.astype(np.float64) - avg
    x = (src_w.astype(np.float64) - avg).ravel()
    h, w = src_w.shape
    # start from the midpoint filter
    fv = np.array([3, -7, 15, 106, 15, -7, 3], np.float64) / 128.0
    fh = fv.copy()
    for _ in range(iters):
        # fix fh -> rows convolved horizontally at each dy
        zc = np.stack([
            sum(fh[k] * d[dy:dy + h, k:k + w] for k in range(7)).ravel()
            for dy in range(7)])
        f = _solve_sym3(zc, x)
        if f is not None:
            fv = f
        zr = np.stack([
            sum(fv[k] * d[k:k + h, dx:dx + w] for k in range(7)).ravel()
            for dx in range(7)])
        f = _solve_sym3(zr, x)
        if f is not None:
            fh = f

    def quant(fl, chroma):
        t = np.round(fl * 128).astype(np.int64)
        out = []
        for i in range(3):
            v = 0 if (chroma and i == 0) else int(
                np.clip(t[i], WIENER_TAP_MIN[i], WIENER_TAP_MAX[i]))
            out.append(v)
        return out

    return quant(fv, chroma), quant(fh, chroma)


def _window_sse(flt, src_w):
    """Per-window int64 SSE of filtered windows [N, h, w] against the
    source windows [N, h, w]."""
    d = flt.to(torch.int64) - src_w.to(torch.int64)
    return (d * d).sum((1, 2))


def wiener_refine(src, dgd, units, lam: float, usize: int,
                  chroma: bool, bd: int = 8):
    """Per unit: solve Wiener taps on the host, measure the exact filtered
    error with the normative kernel on the device (all units in one call;
    the current SGR units' exact errors in one call per eps), and upgrade
    the units where Wiener beats the current choice (NONE or SGR) in RD.
    Mutates and returns units."""
    H, W = dgd.shape
    uh, uw = unit_count(usize, H), unit_count(usize, W)
    if uh * usize != H or uw * usize != W:
        return units
    dev = dgd.device
    dgd_t = dgd.to(torch.int32)
    ext_t = edge_pad(dgd_t, 3)
    src_n = src.cpu().numpy().astype(np.int64)
    dgd_n = dgd_t.cpu().numpy().astype(np.int64)
    ext = np.pad(dgd_n.astype(np.int32), 3, mode="edge")
    created = False
    if units is None:
        units = {"type": np.zeros((uh, uw), np.int32),
                 "eps": np.zeros((uh, uw), np.int32),
                 "xqd": np.zeros((uh, uw, 2), np.int32),
                 "taps_v": np.zeros((uh, uw, 3), np.int32),
                 "taps_h": np.zeros((uh, uw, 3), np.int32)}
        created = True
    tv = np.zeros((uh, uw, 3), np.int64)
    th = np.zeros((uh, uw, 3), np.int64)
    for ur in range(uh):
        for uc in range(uw):
            r0, c0 = ur * usize, uc * usize
            tv[ur, uc], th[ur, uc] = _wiener_solve_unit(
                src_n[r0:r0 + usize, c0:c0 + usize],
                ext[r0:r0 + usize + 6, c0:c0 + usize + 6], chroma)
    # every unit's windows: [uh*uw, usize+6, usize+6] and its source
    win = ext_t.unfold(0, usize + 6, usize).unfold(1, usize + 6, usize)
    win = win.reshape(uh * uw, usize + 6, usize + 6)
    src_w = src.to(torch.int32).reshape(uh, usize, uw, usize).transpose(
        1, 2).reshape(uh * uw, usize, usize)
    kern = lambda t: upload(np.stack([_wiener_kernel(k) for k in
                                      t.reshape(-1, 3)]), dev)
    werr = _window_sse(wiener_filter(win, kern(th), kern(tv), bd), src_w)
    sgr = np.nonzero(units["type"].reshape(-1) == RESTORE_SGRPROJ)[0]
    serr = torch.zeros(uh * uw, dtype=torch.int64, device=dev)
    eps_flat = units["eps"].reshape(-1)
    xqd_flat = units["xqd"].reshape(-1, 2)
    for eps in np.unique(eps_flat[sgr]):
        sel = sgr[eps_flat[sgr] == eps]
        xq = upload(xqd_flat[sel].astype(np.int32), dev)
        idx = upload(sel.astype(np.int64), dev)
        serr[idx] = _window_sse(apply_sgr(win[idx], int(eps),
                                          xq[:, 0, None, None],
                                          xq[:, 1, None, None], bd),
                                src_w[idx])
    werr = werr.cpu().numpy().astype(np.float64).reshape(uh, uw)
    serr = serr.cpu().numpy().astype(np.float64).reshape(uh, uw)
    d2 = (dgd_n - src_n) ** 2
    none_err = d2.reshape(uh, usize, uw, usize).sum((1, 3)).astype(
        np.float64)
    for ur in range(uh):
        for uc in range(uw):
            if int(units["type"][ur, uc]) == RESTORE_NONE:
                cur_cost = float(none_err[ur, uc]) + lam * NONE_BITS
            else:
                # keep SGR unless Wiener clearly wins (exact SGR error)
                cur_cost = float(serr[ur, uc]) + lam * SGR_BITS
            if float(werr[ur, uc]) + lam * WIENER_BITS < cur_cost:
                units["type"][ur, uc] = RESTORE_WIENER
                units["taps_v"][ur, uc] = tv[ur, uc]
                units["taps_h"][ur, uc] = th[ur, uc]
    if created and not units["type"].any():
        return None
    return units


def lr_search_frame(src_planes, cdef_planes, lam: float, bd: int = 8):
    """Search all planes (tensors on one device); returns (frame_types
    tuple, per-plane units list) - units[p] is None when the plane is
    NONE."""
    types = []
    infos = []
    for p in range(3):
        usize = 64 if p == 0 else 32
        units = sgr_search(src_planes[p], cdef_planes[p], lam, usize, bd)
        units = wiener_refine(src_planes[p], cdef_planes[p], units, lam,
                              usize, p > 0, bd)
        infos.append(units)
        if units is None:
            types.append(RESTORE_NONE)
        else:
            has_w = (units["type"] == RESTORE_WIENER).any()
            has_s = (units["type"] == RESTORE_SGRPROJ).any()
            if has_w and has_s:
                types.append(RESTORE_SWITCHABLE)
            elif has_w:
                types.append(RESTORE_WIENER)
            else:
                types.append(RESTORE_SGRPROJ)
    return tuple(types), infos
