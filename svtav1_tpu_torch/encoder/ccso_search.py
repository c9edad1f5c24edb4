"""CCSO RD search — the fork's grafted AV2/AVM coding tool.

Copy of ``svtav1_tpu/encoder/ccso_search.py`` (host numpy).  Analogue of
the reference's EbPickccso.c:785 (ccso_search → derive_ccso_filter): for
each plane we sweep the signalable (quant_idx, filter_support) space with
edge_clf = 0 and a single band (max_band_log2 = 0), derive per-edge-class
least-squares offsets snapped to the signalable offset set, then pick
per-256x256-luma-unit on/off flags where the SSE drop beats the flag-bit
cost, iterating offsets↔flags once (the reference's joint loop,
EbPickccso.c derive_ccso_filter).  The filtering math itself is the
golden-tested ops/ccso.ccso_filter_plane.

Vectorized host-side numpy: classification is one gather+compare pass per
candidate config; per-class stats come from bincount.  CCSO is an opt-in
tool (non-standard AV1 — dav1d rejects CCSO streams just as it rejects the
reference fork's own output), so this stays off the device hot path.
"""

from __future__ import annotations

import numpy as np

from ..ops.ccso import (CCSO_OFFSETS, CCSO_PAD, CCSO_QUANT_SZ,
                        CCSO_UNIT_LOG2, SAMPLE_POS)

_OFFS = np.array(CCSO_OFFSETS, np.int64)


def _classify(ext_y, h, w, sc, support, qstep, edge_clf=0):
    """Per-pixel 9-class (or 4-class) edge index from the extended luma.
    Mirrors EbCcso.c:204-296 (derive_ccso_sample_pos + cal_filter_support)."""
    ys = (np.arange(h) << sc) + CCSO_PAD
    xs = (np.arange(w) << sc) + CCSO_PAD
    c = ext_y[np.ix_(ys, xs)]
    (dy0, dx0), (dy1, dx1) = SAMPLE_POS[support]

    def cls(dy, dx):
        d = ext_y[np.ix_(ys + dy, xs + dx)].astype(np.int64) - c
        if edge_clf == 0:
            return np.where(d > qstep, 2, np.where(d < -qstep, 0, 1))
        return (d >= -qstep).astype(np.int64)

    return cls(dy0, dx0) * 3 + cls(dy1, dx1)      # lut class = d0*3+d1


def _unit_sums(a, uh, uw, u):
    h, w = a.shape
    p = np.zeros((uh * u, uw * u), np.int64)
    p[:h, :w] = a
    return p.reshape(uh, u, uw, u).sum(axis=(1, 3))


def _best_offsets(cls9, err, mask=None):
    """Least-squares per-class offset snapped to the signalable set:
    for offset o the SSE delta is -2*o*sum(err) + o^2*count."""
    if mask is not None:
        c, e = cls9[mask], err[mask]
    else:
        c, e = cls9.ravel(), err.ravel()
    cnt = np.bincount(c, minlength=9).astype(np.int64)
    se = np.bincount(c, weights=e.astype(np.float64), minlength=9)
    d = -2.0 * se[:, None] * _OFFS[None, :] + \
        (_OFFS[None, :] ** 2) * cnt[:, None].astype(np.float64)
    oidx = d.argmin(axis=1)
    return oidx, _OFFS[oidx]


def _search_plane(org, rec, ext_y, sc, lam, bit_depth):
    org = np.asarray(org, np.int64)
    rec = np.asarray(rec, np.int64)
    h, w = rec.shape
    maxv = (1 << bit_depth) - 1
    err = org - rec
    base = err * err
    u = 1 << (CCSO_UNIT_LOG2 - sc)
    uh, uw = -(-h // u), -(-w // u)
    best = None
    for quant_idx in range(4):
        for support in range(6):
            cls9 = _classify(ext_y, h, w, sc, support,
                             CCSO_QUANT_SZ[quant_idx])
            oidx, off9 = _best_offsets(cls9, err)
            flags = None
            for _ in range(2):          # offsets ↔ flags joint refinement
                filt = np.clip(rec + off9[cls9], 0, maxv)
                dunit = _unit_sums((org - filt) ** 2 - base, uh, uw, u)
                flags = dunit + lam < 0  # ~1 flag bit per unit
                if not flags.any():
                    break
                m = np.repeat(np.repeat(flags, u, 0), u, 1)[:h, :w]
                oidx, off9 = _best_offsets(cls9, err, m)
            if flags is None or not flags.any():
                continue
            filt = np.clip(rec + off9[cls9], 0, maxv)
            dunit = _unit_sums((org - filt) ** 2 - base, uh, uw, u)
            flags = dunit + lam < 0
            if not flags.any():
                continue
            sse_delta = float(dunit[flags].sum())
            hdr_bits = float(np.minimum(oidx + 1, 7).sum()) + 9 + uh * uw
            rd = sse_delta + lam * hdr_bits
            if rd < 0 and (best is None or rd < best["rd"]):
                lut = np.zeros(128, np.int32)
                for d0 in range(3):
                    for d1 in range(3):
                        lut[(d0 << 2) + d1] = off9[d0 * 3 + d1]
                best = dict(quant_idx=quant_idx, support=support,
                            edge_clf=0, max_band_log2=0, bo_only=0,
                            lut=lut, flags=flags.copy(), rd=rd)
    return best


def ccso_search_frame(src, rec, pre_cdef_y, lam, bit_depth=8):
    """Full-frame CCSO search.  Returns None (frame flag off) or the info
    dict consumed by ops/ccso.ccso_apply_frame, headers._write_ccso and the
    tile coder's per-unit flag symbols."""
    ext = np.pad(np.asarray(pre_cdef_y, np.int64), CCSO_PAD, mode="edge")
    planes = []
    for p in range(3):
        sc = 0 if p == 0 else 1
        planes.append(_search_plane(src[p], rec[p], ext, sc, lam,
                                    bit_depth))
    if not any(pi is not None for pi in planes):
        return None
    return {"planes": planes}

