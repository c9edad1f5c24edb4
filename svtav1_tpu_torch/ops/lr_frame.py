"""Loop-restoration frame assembly: striped filtering with boundary rules.

Counterpart of ``svtav1_tpu/ops/lr_frame.py`` (spec §7.17; reference
svt_av1_loop_restoration_filter_frame with the stripe boundary handling
of EbRestoration.c:257-420 and the saved boundary lines of
EbRestoration.c:1522-1704).

Geometry (single tile, no superres):
- stripes are 64>>ss_y rows tall, offset up by 8>>ss_y (the first stripe
  is short);
- a stripe's 3 context rows above/below come from
  * the frame edge: the replicated outermost CDEF row,
  * otherwise: the 2 saved post-deblock (pre-CDEF) rows adjacent to the
    stripe edge, expanded 2 -> 3 by duplicating the outermost row;
- horizontal context is 3 replicated columns (frame edges) or the
  neighbouring unit's CDEF pixels;
- restoration units are 64 luma px (32 chroma at 4:2:0), one per
  superblock; the last unit in a row/column absorbs the remainder.

The stripe and unit loops are the JAX package's; each (stripe, unit)
window is a row/column index list into the CDEF and deblocked rows.
Windows of one shape and filter are then gathered, filtered and written
back in one call each (the windows never overlap, so every output is the
per-window result).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import upload
from ..ec.lr_syntax import RESTORE_NONE, RESTORE_SGRPROJ
from .restoration import BORDER, apply_sgr, wiener_filter


def unit_count(size: int, extent: int) -> int:
    """count_units_in_frame (spec): offset grid, >= 1."""
    return max((extent + (size >> 1)) // size, 1)


def _unit_range(i: int, n: int, size: int, extent: int):
    """Pixel span of unit i of n along one axis (last absorbs tail)."""
    lo = i * size
    hi = extent if i == n - 1 else (i + 1) * size
    return lo, hi


def _unit_range_v(i: int, n: int, size: int, extent: int, off: int):
    """Vertical span of unit row i, shifted up by the stripe offset so unit
    rows align with processing stripes (EbRestoration.c:1266-1273)."""
    lo = max(0, i * size - off)
    hi = extent if i == n - 1 else (i + 1) * size - off
    return lo, hi


def _stripes(H: int, sh: int, off: int):
    """Yield (y0, y1) stripe row ranges."""
    s = 0
    while True:
        y0 = max(0, s * sh - off)
        if y0 >= H:
            return
        y1 = min((s + 1) * sh - off, H)
        yield y0, y1
        s += 1


def _stripe_rows(y0: int, y1: int, H: int) -> np.ndarray:
    """Source rows of the [y1-y0+6]-row extended stripe, as indices into
    cat([cdef, db]): CDEF interior rows (0..H-1) and boundary-rule
    context rows (deblocked rows are H + r)."""
    above = [0, 0, 0] if y0 == 0 else [H + y0 - 2, H + y0 - 2, H + y0 - 1]
    if y1 >= H:
        below = [H - 1] * 3
    else:
        b1 = H + min(y1 + 1, H - 1)
        below = [H + y1, b1, b1]
    return np.array(above + list(range(y0, y1)) + below, np.int64)


def _wiener_kernel(taps3):
    """3 coded taps -> 7-tap kernel (centre from normalization,
    EbDecParseBlock.c read_wiener_filter centre rule)."""
    t0, t1, t2 = (int(t) for t in taps3)
    c = -2 * (t0 + t1 + t2)
    return np.array([t0, t1, t2, c, t2, t1, t0], np.int32)


def lr_apply_plane(cdef, db, units: dict, ss_y: int, usize: int,
                   bd: int = 8):
    """Apply per-unit restoration to one plane.

    cdef: post-CDEF plane tensor (LR input); db: post-deblock pre-CDEF plane
    tensor (stripe context source); units: {"type": [uh, uw], "eps": [uh,
    uw], "xqd": [uh, uw, 2], "taps_v": [uh, uw, 3], "taps_h": [uh, uw, 3]}
    numpy arrays.  Returns the restored plane, int32."""
    H, W = cdef.shape
    sh = 64 >> ss_y
    off = 8 >> ss_y
    types = units["type"]
    uh, uw = types.shape
    out = cdef.to(torch.int32).clone()
    if not types.any():
        return out
    rows_src = torch.cat([cdef.to(torch.int32), db.to(torch.int32)])
    groups = {}                # (type, eps, h, w) -> window index lists
    for y0, y1 in _stripes(H, sh, off):
        srows = _stripe_rows(y0, y1, H)
        for uc in range(uw):
            # units whose row range intersects this stripe, per column
            for ur in range(uh):
                r0, r1 = _unit_range_v(ur, uh, usize, H, off)
                if r1 <= y0 or r0 >= y1:
                    continue
                t = int(types[ur, uc])
                if t == RESTORE_NONE:
                    continue
                c0, c1 = _unit_range(uc, uw, usize, W)
                ry0, ry1 = max(r0, y0), min(r1, y1)
                eps = int(units["eps"][ur, uc]) if t == RESTORE_SGRPROJ \
                    else -1
                g = groups.setdefault((t, eps, ry1 - ry0, c1 - c0),
                                      ([], [], [], []))
                g[0].append(srows[ry0 - y0:ry1 - y0 + 2 * BORDER])
                g[1].append(np.clip(np.arange(c0 - BORDER, c1 + BORDER),
                                    0, W - 1))
                g[2].append((ry0, c0))
                g[3].append((ur, uc))
    dev = cdef.device
    for (t, eps, h, w), (wr, wc, org, uidx) in groups.items():
        R = upload(np.stack(wr), dev)
        C = upload(np.stack(wc), dev)
        win = rows_src[R[:, :, None], C[:, None, :]]      # [N, h+6, w+6]
        ur, uc = np.array(uidx).T
        if t == RESTORE_SGRPROJ:
            xqd = upload(units["xqd"][ur, uc].astype(np.int32), dev)
            flt = apply_sgr(win, eps, xqd[:, 0, None, None],
                            xqd[:, 1, None, None], bd)
        else:
            kv = np.stack([_wiener_kernel(k) for k in units["taps_v"][ur, uc]])
            kh = np.stack([_wiener_kernel(k) for k in units["taps_h"][ur, uc]])
            flt = wiener_filter(win, upload(kh, dev), upload(kv, dev), bd)
        oy, ox = np.array(org).T
        OR = upload(oy[:, None] + np.arange(h), dev)
        OC = upload(ox[:, None] + np.arange(w), dev)
        out[OR[:, :, None], OC[:, None, :]] = flt
    return out


def lr_apply_frame(cdef_planes, db_planes, unit_infos, bd: int = 8):
    """(y, u, v) plane tensors; unit_infos: per-plane units dict or None.
    Returns int32 tensors."""
    out = []
    for p, (cd, dbp) in enumerate(zip(cdef_planes, db_planes)):
        info = unit_infos[p]
        if info is None:
            out.append(cd.to(torch.int32))
            continue
        ss = 0 if p == 0 else 1
        out.append(lr_apply_plane(cd, dbp, info, ss, 64 >> ss, bd))
    return tuple(out)
