"""ctypes wrapper of the edge strip's kernel (csrc/wf_edge.cu).

``edge_cuda`` has the contract of ``encoder.edge._edge_body`` for planes
on a CUDA device, 8-bit (uint8) or 10-bit (int16, read as the kernel's
uint16): the bottom SB row of an m = 12 plane, coded as one chain per
frame (or U/V pair) after the plane kernel coded every SB row above it.
It allocates the strip's outputs with ``torch.empty``, writes the plane's
in place and makes one launch on the current stream without
synchronising.  ``LAUNCHES`` counts the launches.  ``edge_work`` counts
the operations and bytes of one launch for the kernel's bound.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import pix_dtype
from ..encoder.edge import _TX_OF, edge_blocks, strip_count
from ..encoder.wavefront import _tx_types, expand_candidates
from ..ops.intra import SM_WEIGHTS
from .wavefront_kernel import (INT32_OPS_PER_S, _kinds_of, _net_ops,
                               _KIND_NAME, _PIXEL_OPS, linear_pred_maps,
                               reciprocal, tx_params)

LAUNCHES = 0
EMAXC = 64            # these must match csrc/wf_edge.cu
EMAXW = 13
ECOLS = 6


class _EdgeParams(ctypes.Structure):
    """Field-for-field mirror of struct EdgeParams in csrc/wf_edge.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "src", "recon", "mode_idx", "levels", "e_mode", "e_lev", "blocks",
        "dirmap0", "dirmap1", "smw0", "smw1")] +
        [("mdc", ctypes.c_uint64), ("mac", ctypes.c_uint64)] +
        [(n, ctypes.c_int) for n in (
            "sdc", "sac", "B", "NU", "h", "w", "bh", "bw", "vh", "C",
            "paired", "nblk", "n", "big", "nw", "dqdc", "dqac")] +
        [(n, ctypes.c_int * 2) for n in (
            "qshift", "fwd_s0", "fwd_s1", "fwd_s2", "inv_s0", "inv_s1")] +
        [(n, ctypes.c_int) for n in (
            "base", "pix_max", "dq_lo", "dq_hi", "row_lo", "row_hi",
            "mid_lo", "mid_hi", "col_lo", "col_hi", "res_lo", "res_hi")] +
        [("lam", ctypes.c_float), ("cand_mode", ctypes.c_int * EMAXC),
         ("cand_kind", ctypes.c_int * (2 * EMAXC)),
         ("rate", ctypes.c_float * EMAXC)])


@lru_cache(maxsize=None)
def _lib():
    from .build import load_library
    lib = load_library()
    lib.wf_edge_params_size.restype = ctypes.c_int
    lib.wf_edge_params_size.argtypes = []
    if lib.wf_edge_params_size() != ctypes.sizeof(_EdgeParams):
        raise RuntimeError("EdgeParams layout differs between csrc/"
                           "wf_edge.cu and _EdgeParams")
    lib.wf_edge.restype = ctypes.c_int
    lib.wf_edge.argtypes = [ctypes.POINTER(_EdgeParams), ctypes.c_int,
                            ctypes.c_void_p]
    lib.wf_edge_info.restype = ctypes.c_int
    lib.wf_edge_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]
    return lib


def block_table(w: int, big: int) -> np.ndarray:
    """[nblk, ECOLS] int32: edge_blocks(w, big) as the kernel reads it:
    dy, x, small, has_tr, has_bl, out."""
    return np.asarray([[dy, x, int(n != big), int(tr), int(bl), out]
                       for dy, x, n, tr, bl, out in edge_blocks(w, big)],
                      np.int32).reshape(-1, ECOLS)


@lru_cache(maxsize=None)
def _tables(big: int, cands: tuple, uv_tx: bool, w: int, device: str):
    """Device tables of one (width, candidate list), uploaded once."""
    dev = torch.device(device)
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    sizes = (big, big // 2)
    kinds = [[rk | (ck << 1) for rk, ck in (
        _kinds_of(tt) for tt in _tx_types(cands, _TX_OF[n], uv_tx))]
        for n in sizes]
    return {"blocks": up(block_table(w, big)),
            "dirmap": [up(linear_pred_maps(n, cands)) for n in sizes],
            "smw": [up(np.asarray(SM_WEIGHTS[n:2 * n], np.int32))
                    for n in sizes],
            "kind": kinds}


def kernel_info(bd: int = 8, C: int = 13) -> dict:
    """Registers and local (spill) bytes per thread and dynamic shared
    bytes per CTA of the kernel's bd form for C candidates."""
    out = (ctypes.c_int * 3)()
    err = _lib().wf_edge_info(bd, min(C, EMAXW), out)
    if err:
        raise RuntimeError(f"wf_edge_info failed: CUDA error {err}")
    return dict(zip(("regs", "local_bytes", "smem_bytes"), out))


def edge_cuda(src, rd, mode_idx, levels, recon, big: int, cands, bd: int,
              valid_h, paired: bool, uv_tx: bool):
    """Run the chain kernel; the contract of encoder.edge._edge_body."""
    global LAUNCHES
    if src.device.type != "cuda":
        raise ValueError(f"edge_cuda needs a CUDA tensor, got {src.device}")
    pix = pix_dtype(bd)
    B, h, w = src.shape
    if src.dtype != pix or not src.is_contiguous() or big not in (32, 16):
        raise ValueError(f"src must be a contiguous [B, h, w] {pix} tensor "
                         f"of {big}x{big} big blocks")
    if paired and B % 2:
        raise ValueError("an odd paired batch")
    bh, bw = h // big, w // big
    vh = h if valid_h is None else int(valid_h)
    if vh != h - big // 2:
        raise ValueError(f"valid_h {valid_h}: the strip needs m = 12 "
                         f"(valid_h = {h - big // 2})")
    for t, shape in ((mode_idx, (B, bh, bw)), (levels, (B, bh, bw, big, big)),
                     (recon, (B, h, w))):
        if tuple(t.shape) != shape or t.dtype != torch.int32 or \
                not t.is_contiguous() or t.device != src.device:
            raise ValueError(f"plane output {tuple(t.shape)} {t.dtype}: the "
                             f"kernel writes a contiguous int32 {shape}")
    C = len(cands)
    if C > EMAXC:
        raise ValueError(f"{C} candidates > {EMAXC}")
    dqdc, dqac, lam, mode_rate = rd
    dqdc, dqac = int(dqdc), int(dqac)
    dev = src.device
    tabs = _tables(big, tuple(cands), bool(uv_tx), w, str(dev))
    s = big // 2
    n = strip_count(w, big)
    e_mode = torch.empty((B, n), dtype=torch.int32, device=dev)
    e_lev = torch.empty((B, n, s, s), dtype=torch.int32, device=dev)
    (mdc, sdc), (mac, sac) = reciprocal(dqdc), reciprocal(dqac)
    tp = [tx_params(sz, bd) for sz in (big, s)]
    per = {k: (ctypes.c_int * 2)(*(t[k] for t in tp)) for k in (
        "qshift", "fwd_s0", "fwd_s1", "fwd_s2", "inv_s0", "inv_s1")}
    shared = {k: tp[0][k] for k in (
        "base", "pix_max", "dq_lo", "dq_hi", "row_lo", "row_hi", "mid_lo",
        "mid_hi", "col_lo", "col_hi", "res_lo", "res_hi")}
    p = _EdgeParams(
        src=src.data_ptr(), recon=recon.data_ptr(),
        mode_idx=mode_idx.data_ptr(), levels=levels.data_ptr(),
        e_mode=e_mode.data_ptr(), e_lev=e_lev.data_ptr(),
        blocks=tabs["blocks"].data_ptr(),
        dirmap0=tabs["dirmap"][0].data_ptr(),
        dirmap1=tabs["dirmap"][1].data_ptr(),
        smw0=tabs["smw"][0].data_ptr(), smw1=tabs["smw"][1].data_ptr(),
        mdc=mdc, mac=mac, sdc=sdc, sac=sac, B=B,
        NU=B // 2 if paired else B, h=h, w=w, bh=bh, bw=bw, vh=vh, C=C,
        paired=int(bool(paired)), nblk=int(tabs["blocks"].shape[0]), n=n,
        big=big, nw=min(C, EMAXW), dqdc=dqdc, dqac=dqac, lam=float(lam),
        **per, **shared)
    p.cand_mode[:C] = [m for m, _ in cands]
    p.cand_kind[:C] = tabs["kind"][0]
    p.cand_kind[EMAXC:EMAXC + C] = tabs["kind"][1]
    p.rate[:C] = [float(v) for v in np.asarray(mode_rate, np.float32)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().wf_edge(ctypes.byref(p), bd, stream)
    if err:
        raise RuntimeError(f"wf_edge launch failed: CUDA error {err}")
    LAUNCHES += 1
    return e_mode, e_lev


def edge_work(big: int, B: int, w: int, modes, uv_tx: bool = False,
              bd: int = 8) -> tuple:
    """(int32 operations, bytes) of one launch on B planes of width w:
    every candidate's chain on every pixel of the bottom SB row's coded
    blocks (the plane kernel's per-pixel count, at each block's size), the
    source read, levels and recon written once."""
    cands = expand_candidates(modes)
    ops = 0.0
    s = big // 2
    for n, px in ((big, B * big * w), (s, B * s * w)):
        for tt in _tx_types(cands, _TX_OF[n], uv_tx):
            rk, ck = (_KIND_NAME[x] for x in _kinds_of(tt))
            chain = (_net_ops(ck, n, "fwd") + _net_ops(rk, n, "fwd") +
                     _net_ops(rk, n, "inv") + _net_ops(ck, n, "inv")) / n
            ops += (chain + _PIXEL_OPS) * px
    px = B * (big + s) * w
    pb = 1 if bd == 8 else 2
    return int(ops), px * (pb + 4 + 4)


def bound_ms(big: int, B: int, w: int, modes, uv_tx=False, bd=8) -> float:
    """The least time of one launch on the card in ms (operations-bound)."""
    ops, _ = edge_work(big, B, w, modes, uv_tx, bd)
    return 1e3 * ops / INT32_OPS_PER_S
