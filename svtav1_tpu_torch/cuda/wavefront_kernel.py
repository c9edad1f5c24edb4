"""ctypes wrapper of the CUDA wavefront kernel (csrc/wavefront.cu).

``wavefront_cuda`` has the contract of ``encoder.wavefront
._wavefront_body`` for a plane stack on a CUDA device, 8-bit (uint8) or
10-bit (int16; the kernel's uint16 form reads the same bits): the flat
intra wavefront, and with ``extra`` its mixed form, whose inter lanes
(precomputed predictions, a rate and a mask a block each, and a mask of
the intra candidates) follow the intra candidates; either with angle
deltas (presets 0-5: up to 61 intra candidates, 64 with the lanes).  It
checks what the kernel takes and raises on anything else, allocates every
output with ``torch.empty`` and the ticket counter and ready flags with
one ``torch.zeros``, and makes one persistent launch on the current
stream without synchronising.  ``LAUNCHES`` counts the kernel launches, and
``FORMS`` the same launches by (bs, bd, intra candidates, inter lanes).

The kernel sets a sticky error word on the device when a wait for a
neighbour's flag exceeds its cap; ``raise_on_error`` reads it (a host
copy, so call it where the caller copies to the host anyway).

Host-side tables, built once per (shape, candidate list): the block list
in ticket order with each block's dependencies (``schedule``), the
predictor maps (``linear_pred_maps``), the deadzone reciprocals
(``reciprocal``) and the transform shifts and bd's clamps
(``tx_params``).  The launch's geometry is decided here too, and the
kernel only follows it: ``launch_geometry`` picks the cluster width and
the warps a CTA for C candidates, ``warp_map`` which warp of which CTA
runs each candidate and where the write-out finds a winner.  ``work``
counts the operations and bytes of one call for the kernel's bound.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from .. import pix_dtype
from ..encoder.wavefront import _quad_tables, _tx_types, expand_candidates
from ..ops.intra import SM_WEIGHTS
from ..ops.intra_dir import MODE_ANGLE, _z1_maps, _z2_maps, _z3_maps
from ..ops.transforms import inv_ranges
from ..spec import tables as tbl
from ..spec import txfm as T

LAUNCHES = 0          # kernel launches so far
FORMS = Counter()     # the same by (bs, bd, intra candidates, inter lanes)

MAXC = 64             # these four must match csrc/wavefront.cu
MAXK = 16             # CTAs a cluster at most
MAXW = 4              # warps a CTA at most
MAXDEP = 8
_TX_OF_BS = {16: T.TX_16X16, 32: T.TX_32X32}
LANE = (-1, 0)        # an inter lane's (mode, delta) in the kernel's list
_KIND_NAME = {T.DCT_1D: "dct", T.ADST_1D: "adst"}

# the H100 SXM's int32 ALU rate (64 lanes x 132 SMs x 1.98 GHz boost
# clock) and HBM rate (NVIDIA's data sheet), for the kernel's bound
INT32_OPS_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


class _Params(ctypes.Structure):
    """Field-for-field mirror of struct WfParams in csrc/wavefront.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "src", "rowbuf", "colbuf", "blocks", "dirmap", "smw", "sync", "err",
        "mode_idx", "levels", "recon", "trace", "xpred", "xrate", "xok",
        "iok")] +
        [("mdc", ctypes.c_uint64), ("mac", ctypes.c_uint64)] +
        [(n, ctypes.c_int) for n in (
            "sdc", "sac", "B", "NU", "h", "w", "bh", "bw", "vh", "C",
            "paired", "nblk", "NI", "nE", "dqdc", "dqac", "qshift", "fwd_s0",
            "fwd_s1", "fwd_s2", "inv_s0", "inv_s1", "base", "pix_max",
            "dq_lo", "dq_hi", "row_lo", "row_hi", "mid_lo", "mid_hi",
            "col_lo", "col_hi", "res_lo", "res_hi")] +
        [("lam", ctypes.c_float), ("K", ctypes.c_int), ("wpc", ctypes.c_int),
         ("cand", ctypes.c_int * (MAXK * MAXW)),
         ("home", ctypes.c_int * MAXC),
         ("cand_mode", ctypes.c_int * MAXC),
         ("cand_kind", ctypes.c_int * MAXC),
         ("rate", ctypes.c_float * MAXC)])


@lru_cache(maxsize=None)
def _lib():
    from .build import load_library
    lib = load_library()
    lib.wf_params_size.restype = ctypes.c_int
    lib.wf_params_size.argtypes = []
    if lib.wf_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("WfParams layout differs between csrc/"
                           "wavefront.cu and _Params")
    lib.wf_plane.restype = ctypes.c_int
    lib.wf_plane.argtypes = [ctypes.POINTER(_Params), ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.wf_info.restype = ctypes.c_int
    lib.wf_info.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    return lib


def launch_geometry(C: int) -> tuple:
    """(K, wpc) of the launch for C candidates: clusters of K CTAs of wpc
    warps, one candidate a warp, so that every candidate of a block runs
    at once: 4 CTAs up to 16 candidates, 8 up to 32, 16 up to 64."""
    if not 1 <= C <= MAXC:
        raise ValueError(f"{C} candidates outside 1..{MAXC}")
    K = 4 if C <= 16 else 8 if C <= 32 else 16
    return K, -(-C // K)


def warp_map(C: int, K: int, wpc: int) -> tuple:
    """(cand, home) of C candidates on clusters of K CTAs of wpc warps:
    warp w of CTA rank runs candidate cand[rank * MAXW + w] = w * K + rank
    (-1: none), and home[c] = rank | w << 8 is where the write-out finds
    the winner c."""
    if not (1 <= K <= MAXK and 1 <= wpc <= MAXW and K * wpc >= C):
        raise ValueError(f"{C} candidates do not fit clusters of {K} CTAs "
                         f"of {wpc} warps")
    cand = [-1] * (MAXK * MAXW)
    home = [0] * MAXC
    for c in range(C):
        rank, w = c % K, c // K
        cand[rank * MAXW + w] = c
        home[c] = rank | w << 8
    return cand, home


def kernel_info(bs: int, C: int, bd: int = 8, geometry=None) -> dict:
    """Registers and local (spill) bytes per thread, CTAs per SM, dynamic
    shared bytes per CTA, the SM count, clusters resident at once, warps
    per CTA and CTAs per cluster of the kernel's bs, bd form for C
    candidates (geometry: (K, wpc), else launch_geometry(C))."""
    K, wpc = geometry or launch_geometry(C)
    warp_map(C, K, wpc)
    out = (ctypes.c_int * 8)()
    err = _lib().wf_info(bs, bd, K, wpc, out)
    if err:
        raise RuntimeError(f"wf_info failed: CUDA error {err} (clusters of "
                           f"{K} CTAs of {wpc} warps)")
    return dict(zip(("regs", "local_bytes", "ctas_per_sm", "smem_bytes",
                     "sms", "clusters", "warps_per_cta", "cluster"), out))


@lru_cache(maxsize=None)
def _error_word_on(device: str) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32, device=device)


def _error_word(device) -> torch.Tensor:
    """The sticky error word of one card ("cuda" is the current one)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return _error_word_on(str(dev))


def raise_on_error(device) -> None:
    """Raise if a kernel on `device` set its error word (reads it to the
    host, which waits for the work queued before)."""
    word = int(_error_word(device).item())
    if word:
        raise RuntimeError(f"wavefront kernel error word {word:#x}: a wait "
                           "for a neighbour's ready flag ran past its cap")


def linear_pred_maps(bs: int, cands) -> np.ndarray:
    """[C, bs*bs] int32 packed i0 | i1 << 8 | shift << 16 for V, H and the
    directional candidates: pred = (E[i0]*(32-shift) + E[i1]*shift + 16)
    >> 5 over the edge array E = [corner, above_ext(2bs), left_ext(2bs)].
    Other candidates get 0 (the kernel computes them directly)."""
    A, L = 1, 2 * bs + 1
    rows, cols = np.mgrid[0:bs, 0:bs]
    out = np.zeros((len(cands), bs, bs), np.int32)
    for ci, (mode, delta) in enumerate(cands):
        if not 1 <= mode <= 8:
            continue
        angle = MODE_ANGLE[mode] + 3 * delta
        sh = np.zeros((bs, bs), np.int64)
        if angle == 90:
            i0 = i1 = A + cols
        elif angle == 180:
            i0 = i1 = L + rows
        elif angle < 90 or angle > 180:
            z0, z1, sh, over = (_z1_maps if angle < 90 else _z3_maps)(
                bs, angle)
            off = A if angle < 90 else L
            i0 = off + np.where(over, 2 * bs - 1, z0)
            i1 = off + np.where(over, 2 * bs - 1, z1)
            sh = np.where(over, 0, sh)
        else:
            ua, a0, a1, s1, l0, l1, s2 = _z2_maps(bs, angle)
            # [corner | above_ext] index k is E[k]; [corner | left_ext]
            # index k is E[0] for k = 0, else E[L + k - 1]
            lm = lambda k: np.where(k == 0, 0, L + k - 1)
            i0 = np.where(ua, a0, lm(l0))
            i1 = np.where(ua, a1, lm(l1))
            sh = np.where(ua, s1, s2)
        out[ci] = i0 | (i1 << 8) | (sh << 16)
    return out.reshape(len(cands), bs * bs)


def block_deps(bs: int, h: int, w: int, vh: int, r: int, c: int,
               has_tr: bool, has_bl: bool) -> list:
    """Raster ids (row * bw + col) of the blocks whose boundary pixels
    block (r, c) reads: above-left, above, above-right (has_tr), and the
    blocks of the left and below-left (has_bl) columns, whose rows clamp
    at vh - 1."""
    bw = w // bs
    cells = []
    if r > 0:
        cells += [(r - 1, c)] + ([(r - 1, c - 1)] if c > 0 else [])
        if has_tr:
            cells.append((r - 1, min(c + 1, bw - 1)))
    if c > 0:
        y = r * bs
        rows = [min(y + k, vh - 1) for k in range(bs)]
        if has_bl:
            rows += [min(min(y + bs, h - bs) + k, vh - 1) for k in range(bs)]
        cells += [(yy // bs, c - 1) for yy in rows]
    return sorted({rr * bw + cc for rr, cc in cells})


@lru_cache(maxsize=None)
def schedule(bs: int, h: int, w: int, vh: int) -> np.ndarray:
    """[nblk, 4 + MAXDEP] int32: every block in the wavefront's sub-step
    order (valid lanes of each sub-step in lane order) as r, c, has_tr,
    has_bl and the raster ids of its dependencies, -1 padded.  Tickets go
    out in this order, so it must be a topological order."""
    rs, cs, valid, has_tr, has_bl = (
        a.reshape(-1, a.shape[-1]) for a in _quad_tables(h // bs, w // bs))
    rows = []
    for k in range(rs.shape[0]):
        for i in np.flatnonzero(valid[k]):
            r, c = int(rs[k, i]), int(cs[k, i])
            tr, bl = bool(has_tr[k, i]), bool(has_bl[k, i])
            deps = block_deps(bs, h, w, vh, r, c, tr, bl)
            if len(deps) > MAXDEP:
                raise AssertionError(f"block ({r}, {c}): {len(deps)} deps")
            rows.append([r, c, int(tr), int(bl)] + deps +
                        [-1] * (MAXDEP - len(deps)))
    return np.asarray(rows, np.int32)


def reciprocal(d: int) -> tuple:
    """(m, s) with (n * m) >> s == n // d for every 0 <= n < 2**31
    (Granlund and Montgomery's round-up reciprocal, l = ceil(log2 d))."""
    l = (d - 1).bit_length()
    return (1 << (31 + l)) // d + 1, 31 + l


def tx_params(bs: int, bd: int = 8) -> dict:
    """The kernel's transform and pixel constants for bs x bs blocks of
    bd-bit pixels: shifts s in round_shift_array form (s > 0 rounds right,
    s < 0 scales left); each clamp as (lo, hi) from the port's inverse
    transform at bd (ops.transforms.inv_ranges); the edge base and the
    pixel maximum."""
    fwd, inv = T.FWD_SHIFT[(bs, bs)], T.INV_SHIFT[(bs, bs)]
    r = inv_ranges(bd)
    bits = lambda n: (-(1 << (n - 1)), (1 << (n - 1)) - 1)
    (dq_lo, dq_hi), (row_lo, row_hi), (mid_lo, mid_hi), (col_lo, col_hi) = (
        bits(r[k]) for k in ("inp", "row", "mid", "col"))
    return dict(qshift=tbl.tx_scale_shift({8: T.TX_8X8, **_TX_OF_BS}[bs]),
                fwd_s0=-fwd[0], fwd_s1=-fwd[1], fwd_s2=-fwd[2],
                inv_s0=-inv[0], inv_s1=-inv[1],
                base=1 << (bd - 1), pix_max=(1 << bd) - 1,
                dq_lo=dq_lo, dq_hi=dq_hi, row_lo=row_lo, row_hi=row_hi,
                mid_lo=mid_lo, mid_hi=mid_hi, col_lo=col_lo, col_hi=col_hi,
                res_lo=-r["res_max"] - 1, res_hi=r["res_max"])


def _kinds_of(tx_type: int):
    rk, ck = T.HTX_TAB[tx_type], T.VTX_TAB[tx_type]
    if rk not in _KIND_NAME or ck not in _KIND_NAME:
        raise NotImplementedError(f"tx type {tx_type} in the CUDA wavefront")
    return rk, ck


def _net_ops(kind: str, n: int, direction: str) -> int:
    """int32 operations of one 1D network on n values: a butterfly 2
    multiplies, 2 adds and a shift; an add 1 (3 with the inverse clamp);
    a negation 1; a pass-through 0."""
    ops = 0
    for ia, wa, ib, wb, mode in T.compiled_stages(kind, n, direction,
                                                  T.INV_COS_BIT):
        for r in range(n):
            if mode[r] == T.MODE_BTF:
                ops += 5
            elif mode[r] == T.MODE_ADD_CLAMP:
                ops += 3 if direction == "inv" else 1
            elif wb[r] or wa[r] != 1 or ia[r] != r:
                ops += 1
    return ops


# per pixel and candidate besides the networks: prediction, the shifts
# and clamps around the networks, quantizer, dequantizer, reconstruction,
# SSE and the bit estimate; the prediction's share, which an inter lane
# (a prediction read, not made) does not do
_PIXEL_OPS = 30
_PRED_OPS = 6


def work(bs: int, B: int, h: int, w: int, modes, uv_tx: bool = False,
         n_extra: int = 0, live=None, bd: int = 8, angle_deltas=(0,)):
    """(int32 operations, bytes) of one call: the chain of every candidate
    (the intra ones, expand_candidates(modes, angle_deltas), then n_extra
    inter lanes without the prediction) on every pixel, the source, the
    lanes' predictions (1 byte a pixel at 8 bits, 2 at 10), rates and
    masks read once and the outputs written once.  live: each candidate's
    share of the blocks whose masks let it compete (what this call's data
    needs; None: every block)."""
    types = _tx_types(expand_candidates(modes, angle_deltas), _TX_OF_BS[bs],
                      uv_tx)
    n_intra = len(types)
    types = types + [T.DCT_DCT] * n_extra
    live = [1.0] * len(types) if live is None else list(live)
    per_px = 0.0
    for k, (tt, share) in enumerate(zip(types, live)):
        rk, ck = (_KIND_NAME[x] for x in _kinds_of(tt))
        chain = (_net_ops(ck, bs, "fwd") + _net_ops(rk, bs, "fwd") +
                 _net_ops(rk, bs, "inv") + _net_ops(ck, bs, "inv")) / bs
        chain += _PIXEL_OPS - (_PRED_OPS if k >= n_intra else 0)
        per_px += share * chain
    px = B * h * w
    blocks = px // (bs * bs)
    pb = 1 if bd == 8 else 2
    lanes = n_extra * (pb * px + 5 * blocks) + (blocks if n_extra else 0)
    return int(per_px * px), px * (pb + 4 + 4) + 4 * blocks + lanes


def bound_ms(bs: int, B: int, h: int, w: int, modes, uv_tx=False,
             n_extra: int = 0, live=None, bd: int = 8, angle_deltas=(0,)):
    """(least time on the card in ms, "operations" or "bytes")."""
    ops, nbytes = work(bs, B, h, w, modes, uv_tx, n_extra, live, bd,
                       angle_deltas)
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


@lru_cache(maxsize=None)
def _tables(bs: int, cands: tuple, uv_tx: bool, h: int, w: int, vh: int,
            device: str, rows: int = None):
    """Device tables of one (shape, candidate list), uploaded once; rows:
    the block rows scheduled (None: all), a prefix of whole SB rows, whose
    blocks read nothing below it."""
    kinds = [_kinds_of(tt) for tt in _tx_types(cands, _TX_OF_BS[bs], uv_tx)]
    if bs == 32 and any(T.ADST_1D in k for k in kinds):
        raise NotImplementedError("32-point ADST does not exist in AV1")
    dev = torch.device(device)
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    blocks = (schedule(bs, h, w, vh) if rows is None else
              schedule(bs, rows * bs, w, rows * bs))
    return {"blocks": up(blocks), "dirmap": up(linear_pred_maps(bs, cands)),
            "smw": up(np.asarray(SM_WEIGHTS[bs:2 * bs], np.int32)),
            "kind": [rk | (ck << 1) for rk, ck in kinds],
            "nblk": blocks.shape[0]}


def wavefront_cuda(src, rd, bs: int, tx_size: int, modes, bd: int = 8,
                   angle_deltas=(0,), valid_h: int = None,
                   paired: bool = False, uv_tx: bool = False, extra=None):
    """Run the wavefront kernel: src [B, h, w] on a CUDA device, uint8 at
    bd=8 or int16 at bd=10 -> (mode_idx [B, bh, bw] int32, levels [B, bh,
    bw, bs, bs] int32, recon [B, h, w] int32).  extra: the mixed form's
    (extra_preds [B, nE, bh, bw, bs, bs] int32 or the pixel dtype, in [0,
    2^bd - 1], extra_rate [B, nE, bh, bw] float32, extra_ok [B, nE, bh,
    bw] bool, intra_ok [B, bh, bw] bool), on src's device; mode_idx >= the
    intra count then selects a lane.  Where valid_h leaves m = 12 (valid_h
    = h - bs / 2: the flat path's edge strip, encoder/edge.py), the kernel
    codes the SB rows above the bottom one alone, and leaves that row's
    outputs as torch.empty made them for encode_edge.  Asynchronous on the
    current stream."""
    return launch(src, rd, bs, tx_size, modes, bd, angle_deltas, valid_h,
                  paired, uv_tx, extra=extra)[:3]


def _lane_tensors(extra, B: int, bh: int, bw: int, bs: int, dev, bd: int):
    """The mixed form's inputs as the kernel reads them: predictions in
    bd's pixel dtype, rates float32, masks bool, each contiguous on dev."""
    preds, rate, ok, intra_ok = extra
    nE = preds.shape[1]
    want = [(preds, (B, nE, bh, bw, bs, bs), (torch.int32, pix_dtype(bd))),
            (rate, (B, nE, bh, bw), (torch.float32,)),
            (ok, (B, nE, bh, bw), (torch.bool,)),
            (intra_ok, (B, bh, bw), (torch.bool,))]
    for t, shape, dtypes in want:
        if t.device != dev or tuple(t.shape) != shape or \
                t.dtype not in dtypes:
            raise ValueError(f"inter lane input {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}: the kernel takes {shape} "
                             f"{dtypes} on {dev}")
    return (preds.to(pix_dtype(bd)).contiguous(), rate.contiguous(),
            ok.contiguous(), intra_ok.contiguous())


def launch(src, rd, bs: int, tx_size: int, modes, bd: int = 8,
           angle_deltas=(0,), valid_h: int = None, paired: bool = False,
           uv_tx: bool = False, trace: bool = False, extra=None,
           geometry=None):
    """wavefront_cuda plus the kernel's per-ticket timestamps when trace
    is set, on clusters of K CTAs of wpc warps when geometry = (K, wpc)
    is given (launch_geometry(C) otherwise).  Returns (mode_idx, levels,
    recon, trace): trace is [NU * nblk, 16] int64 %globaltimer ns in
    ticket order, or None; columns 0-3 ticket taken, neighbours ready,
    costs chosen, flag published; 4-10 one warp's phases (start,
    prediction, forward transform, quantizer, inverse transform,
    reconstruction, cost); 11 the lead warp's cost computed (before the
    cluster barrier of the cost exchange); 12 the lead's ticket asked
    for (before the ticket's cluster barrier)."""
    global LAUNCHES
    if src.device.type != "cuda":
        raise ValueError(f"wavefront_cuda needs a CUDA tensor, got "
                         f"{src.device}")
    if bd not in (8, 10):
        raise NotImplementedError("the CUDA wavefront covers bd 8 and 10")
    if any(not -3 <= d <= 3 for d in angle_deltas):
        raise ValueError(f"angle deltas {tuple(angle_deltas)} outside -3..3")
    pix = pix_dtype(bd)     # the uint16_t form reads int16's bits
    if src.dtype != pix or src.dim() != 3 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous [B, h, w] {pix} tensor "
                         f"at bd={bd}, got {src.dtype}")
    if bs not in _TX_OF_BS or tx_size != _TX_OF_BS[bs]:
        raise NotImplementedError(f"bs {bs} / tx_size {tx_size}: the kernel "
                                  "takes 16/TX_16X16 and 32/TX_32X32")
    if paired and bs != 16:
        raise NotImplementedError("paired planes run as 16x16 blocks")
    if extra is not None and (paired or uv_tx):
        raise NotImplementedError("inter lanes run on unpaired planes with "
                                  "DCT_DCT (the flat P frame's); the mixed "
                                  "form has no paired or uv_tx variant")
    B, h, w = src.shape
    if h % (2 * bs) or w % (2 * bs) or (paired and B % 2):
        raise ValueError(f"shape {tuple(src.shape)} is not whole quads of "
                         f"{bs}x{bs} blocks (or an odd paired batch)")
    vh = h if valid_h is None else int(valid_h)
    if not 0 < vh <= h:
        raise ValueError(f"valid_h {valid_h} outside (0, {h}]")
    cands = expand_candidates(modes, angle_deltas)
    NI = len(cands)
    dqdc, dqac, lam, mode_rate = rd
    dqdc, dqac = int(dqdc), int(dqac)
    bh, bw = h // bs, w // bs
    dev = src.device
    lanes = None if extra is None else _lane_tensors(extra, B, bh, bw, bs,
                                                     dev, bd)
    nE = 0 if lanes is None else lanes[0].shape[1]
    cands = cands + (LANE,) * nE
    C = len(cands)
    if C > MAXC:
        raise ValueError(f"{C} candidates > {MAXC}")
    K, wpc = geometry or launch_geometry(C)
    cand, home = warp_map(C, K, wpc)
    # m = 12: the bottom SB row is the edge strip's
    rows = h // bs - 2 if vh == h - bs // 2 else None
    empty = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    if rows == 0:
        # nothing above the frame's one SB row: no launch
        return empty(B, bh, bw), empty(B, bh, bw, bs, bs), empty(B, h, w), \
            None
    tabs = _tables(bs, cands, bool(uv_tx), h, w, vh, str(dev), rows)
    # 16x16: two frames a unit (u and u + NU, or a U/V pair)
    NU = (B + 1) // 2 if bs == 16 else B
    sync = torch.zeros(1 + NU * tabs["nblk"], dtype=torch.int32, device=dev)
    rowbuf = torch.empty((B, bh, w), dtype=torch.int32, device=dev)
    colbuf = torch.empty((B, h, bw), dtype=torch.int32, device=dev)
    mode_idx, levels, recon = (empty(B, bh, bw), empty(B, bh, bw, bs, bs),
                               empty(B, h, w))
    (mdc, sdc), (mac, sac) = reciprocal(dqdc), reciprocal(dqac)
    tr = torch.zeros((NU * tabs["nblk"], 16), dtype=torch.int64,
                     device=dev) if trace else None

    p = _Params(
        src=src.data_ptr(), rowbuf=rowbuf.data_ptr(),
        colbuf=colbuf.data_ptr(), blocks=tabs["blocks"].data_ptr(),
        dirmap=tabs["dirmap"].data_ptr(), smw=tabs["smw"].data_ptr(),
        sync=sync.data_ptr(), err=_error_word(dev).data_ptr(),
        mode_idx=mode_idx.data_ptr(), levels=levels.data_ptr(),
        recon=recon.data_ptr(), trace=tr.data_ptr() if trace else None,
        **({} if lanes is None else dict(zip(
            ("xpred", "xrate", "xok", "iok"),
            (t.data_ptr() for t in lanes)))),
        mdc=mdc, mac=mac, sdc=sdc, sac=sac,
        B=B, NU=NU, h=h, w=w, bh=bh, bw=bw, vh=vh, C=C,
        paired=int(bool(paired)), nblk=tabs["nblk"], NI=NI, nE=nE,
        dqdc=dqdc, dqac=dqac, lam=float(lam), K=K, wpc=wpc,
        **tx_params(bs, bd))
    p.cand[:] = cand
    p.home[:] = home
    p.cand_mode[:C] = [m for m, _ in cands]
    p.cand_kind[:C] = tabs["kind"]
    p.rate[:NI] = [float(v) for v in np.asarray(mode_rate, np.float32)]

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().wf_plane(ctypes.byref(p), bs, bd, stream)
    if err:
        raise RuntimeError(f"wf_plane launch failed: CUDA error {err} "
                           f"({C} candidates on clusters of {K} CTAs of "
                           f"{wpc} warps)")
    LAUNCHES += 1
    FORMS[(bs, bd, NI, nE)] += 1
    return mode_idx, levels, recon, tr
