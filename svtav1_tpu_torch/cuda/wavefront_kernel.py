"""ctypes wrapper of the CUDA intra wavefront kernel (csrc/wavefront.cu).

``wavefront_cuda`` has the contract of ``encoder.wavefront
._wavefront_body`` for a uint8 plane stack on a CUDA device.  It checks
what the kernel takes and raises on anything else, allocates every output
and scratch buffer with ``torch.empty``, and launches on the current
stream without synchronising: per sub-step of the schedule one
``wf_eval`` launch (every candidate of every lane) and one ``wf_select``
launch (first-minimum select, outputs, boundary update).  ``LAUNCHES``
counts the kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from svtav1_tpu.spec import tables as tbl
from svtav1_tpu.spec import txfm as T

from ..encoder.wavefront import _quad_tables, _tx_types, expand_candidates
from ..ops.intra import SM_WEIGHTS
from ..ops.intra_dir import MODE_ANGLE, _z1_maps, _z2_maps, _z3_maps

LAUNCHES = 0          # kernel launches (wf_eval + wf_select) so far

MAXC = 16             # must match csrc/wavefront.cu
MAXST = 12
NNET = 6
_TX_OF_BS = {16: T.TX_16X16, 32: T.TX_32X32}
_KIND_NAME = {T.DCT_1D: "dct", T.ADST_1D: "adst"}


class _Params(ctypes.Structure):
    """Field-for-field mirror of struct WfParams in csrc/wavefront.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "src", "rowbuf", "colbuf", "sched", "dirmap", "smw", "stages",
        "cost", "lev_scr", "rec_scr", "mode_idx", "levels", "recon")] +
        [(n, ctypes.c_int) for n in (
            "s", "D", "B", "h", "w", "bh", "bw", "vh", "C", "paired",
            "dqdc", "dqac", "qshift", "fwd_cos_col", "fwd_cos_row",
            "inv_cos", "inv_clamp_row", "inv_clamp_col", "fwd_s0", "fwd_s1",
            "fwd_s2", "inv_s0", "inv_s1")] +
        [("lam", ctypes.c_float), ("nst", ctypes.c_int * NNET),
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
    for fn in (lib.wf_eval, lib.wf_select):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int,
                       ctypes.c_void_p]
    return lib


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


def stage_tables(bs: int, kinds):
    """([NNET, MAXST, bs, 5] int32, nst[NNET]) butterfly tables: nets
    0/1 forward column DCT/ADST, 2/3 forward row DCT/ADST, 4/5 inverse
    DCT/ADST.  Only the kinds in `kinds` are filled."""
    wi = bs.bit_length() - 3
    cos = (T.FWD_COS_BIT_COL[wi][wi], T.FWD_COS_BIT_ROW[wi][wi],
           T.INV_COS_BIT)
    tab = np.zeros((NNET, MAXST, bs, 5), np.int32)
    nst = [0] * NNET
    for g, direction in enumerate(("fwd", "fwd", "inv")):
        for kind in kinds:
            net = 2 * g + kind
            stages = T.compiled_stages(_KIND_NAME[kind], bs, direction,
                                       cos[g])
            for st, (ia, wa, ib, wb, mode) in enumerate(stages):
                tab[net, st] = np.stack([ia, wa, ib, wb, mode], axis=-1)
            nst[net] = len(stages)
    return tab, nst


def tx_params(bs: int, bd: int = 8) -> dict:
    """The kernel's transform and quantizer constants for bs x bs blocks
    (shifts s in round_shift_array form: s > 0 rounds right, s < 0
    scales left)."""
    fwd, inv = T.FWD_SHIFT[(bs, bs)], T.INV_SHIFT[(bs, bs)]
    wi = bs.bit_length() - 3
    return dict(qshift=tbl.tx_scale_shift(_TX_OF_BS[bs]),
                fwd_cos_col=T.FWD_COS_BIT_COL[wi][wi],
                fwd_cos_row=T.FWD_COS_BIT_ROW[wi][wi],
                inv_cos=T.INV_COS_BIT,
                inv_clamp_row=T.opt_range(bd, False),
                inv_clamp_col=T.opt_range(bd, True),
                fwd_s0=-fwd[0], fwd_s1=-fwd[1], fwd_s2=-fwd[2],
                inv_s0=-inv[0], inv_s1=-inv[1])


def _kinds_of(tx_type: int):
    rk, ck = T.HTX_TAB[tx_type], T.VTX_TAB[tx_type]
    if rk not in _KIND_NAME or ck not in _KIND_NAME:
        raise NotImplementedError(f"tx type {tx_type} in the CUDA wavefront")
    return rk, ck


@lru_cache(maxsize=None)
def _tables(bs: int, cands: tuple, uv_tx: bool, bh: int, bw: int,
            device: str):
    """Device tables of one (shape, candidate list) — uploaded once."""
    rs, cs, valid, has_tr, has_bl = _quad_tables(bh, bw)
    nsteps, _, D = rs.shape
    sched = np.stack([rs, cs, valid, has_tr, has_bl], axis=-1).astype(
        np.int32).reshape(nsteps * 4, D, 5)
    kinds = [_kinds_of(tt) for tt in _tx_types(cands, _TX_OF_BS[bs], uv_tx)]
    if bs == 32 and any(T.ADST_1D in k for k in kinds):
        raise NotImplementedError("32-point ADST does not exist in AV1")
    stab, nst = stage_tables(bs, sorted({k for rk_ck in kinds
                                         for k in rk_ck}))
    dev = torch.device(device)
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return {"sched": up(sched), "dirmap": up(linear_pred_maps(bs, cands)),
            "smw": up(SM_WEIGHTS[bs:2 * bs]), "stages": up(stab),
            "nst": nst, "kind": [rk | (ck << 1) for rk, ck in kinds],
            "S": sched.shape[0], "D": D}


def wavefront_cuda(src, rd, bs: int, tx_size: int, modes, bd: int = 8,
                   angle_deltas=(0,), valid_h: int = None,
                   paired: bool = False, uv_tx: bool = False):
    """Run the wavefront kernel: src [B, h, w] uint8 on a CUDA device ->
    (mode_idx [B, bh, bw] int32, levels [B, bh, bw, bs, bs] int32,
    recon [B, h, w] int32).  Asynchronous on the current stream."""
    global LAUNCHES
    if src.device.type != "cuda":
        raise ValueError(f"wavefront_cuda needs a CUDA tensor, got "
                         f"{src.device}")
    if src.dtype != torch.uint8 or src.dim() != 3 or \
            not src.is_contiguous():
        raise ValueError("src must be a contiguous [B, h, w] uint8 tensor")
    if bs not in _TX_OF_BS or tx_size != _TX_OF_BS[bs]:
        raise NotImplementedError(f"bs {bs} / tx_size {tx_size}: the kernel "
                                  "takes 16/TX_16X16 and 32/TX_32X32")
    if bd != 8 or tuple(angle_deltas) != (0,):
        raise NotImplementedError("the CUDA wavefront covers bd=8 and "
                                  "angle_deltas=(0,); svtav1_tpu has the rest")
    B, h, w = src.shape
    if h % (2 * bs) or w % (2 * bs) or (paired and B % 2):
        raise ValueError(f"shape {tuple(src.shape)} is not whole quads of "
                         f"{bs}x{bs} blocks (or an odd paired batch)")
    vh = h if valid_h is None else int(valid_h)
    if not 0 < vh <= h:
        raise ValueError(f"valid_h {valid_h} outside (0, {h}]")
    cands = expand_candidates(modes, angle_deltas)
    C = len(cands)
    if C > MAXC:
        raise ValueError(f"{C} candidates > {MAXC}")
    dqdc, dqac, lam, mode_rate = rd
    bh, bw = h // bs, w // bs
    tabs = _tables(bs, cands, bool(uv_tx), bh, bw, str(src.device))
    D, S = tabs["D"], tabs["S"]
    BD = B * D
    dev = src.device
    cost = torch.empty((C, BD), dtype=torch.float32, device=dev)
    lev_scr = torch.empty((C, BD, bs * bs), dtype=torch.int16, device=dev)
    rec_scr = torch.empty((C, BD, bs * bs), dtype=torch.uint8, device=dev)
    rowbuf = torch.empty((B, bh, w), dtype=torch.int32, device=dev)
    colbuf = torch.empty((B, h, bw), dtype=torch.int32, device=dev)
    mode_idx = torch.empty((B, bh, bw), dtype=torch.int32, device=dev)
    levels = torch.empty((B, bh, bw, bs, bs), dtype=torch.int32, device=dev)
    recon = torch.empty((B, h, w), dtype=torch.int32, device=dev)

    p = _Params(
        src=src.data_ptr(), rowbuf=rowbuf.data_ptr(),
        colbuf=colbuf.data_ptr(), sched=tabs["sched"].data_ptr(),
        dirmap=tabs["dirmap"].data_ptr(), smw=tabs["smw"].data_ptr(),
        stages=tabs["stages"].data_ptr(), cost=cost.data_ptr(),
        lev_scr=lev_scr.data_ptr(), rec_scr=rec_scr.data_ptr(),
        mode_idx=mode_idx.data_ptr(), levels=levels.data_ptr(),
        recon=recon.data_ptr(),
        s=0, D=D, B=B, h=h, w=w, bh=bh, bw=bw, vh=vh, C=C,
        paired=int(bool(paired)), dqdc=int(dqdc), dqac=int(dqac),
        lam=float(lam), **tx_params(bs, bd))
    p.nst[:] = tabs["nst"]
    p.cand_mode[:C] = [m for m, _ in cands]
    p.cand_kind[:C] = tabs["kind"]
    p.rate[:C] = [float(v) for v in np.asarray(mode_rate, np.float32)]

    lib = _lib()
    ref = ctypes.byref(p)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for s in range(S):
            p.s = s
            for fn in (lib.wf_eval, lib.wf_select):
                err = fn(ref, bs, stream)
                if err:
                    raise RuntimeError(f"{fn.__name__} launch failed: CUDA "
                                       f"error {err} at sub-step {s}")
                LAUNCHES += 1
    return mode_idx, levels, recon
