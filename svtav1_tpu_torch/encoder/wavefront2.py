"""Partition wavefront: 64x64 SB NONE vs the 32x32 tree, and each 32x32
block NONE vs SPLIT into four 16x16 leaves, decided by closed-loop RD in
one z-order scan.

Counterpart of ``svtav1_tpu/encoder/wavefront2.py``.  Two forms: the
key-frame form (every block intra, the key-frame rates) and the inter form
of P frames (``InterLanes``): precomputed inter predictions join the intra
candidates at each depth as extra lanes with their own rates, masks gate
the lanes and intra per block, and the rates are the inter frame's
(y_mode CDF, tx-type bits on every coded txb).  The RD lambda takes a
weight (``lam_scale``, the pyramid's per-layer weighting) and a per-block
map (``lam_map``, the pyramid anchor's TPL map; the SB takes its first
block's).  Each quad step of the flat path's 2:1 wavefront
(``wavefront._quad_tables``) evaluates the superblock as one block
(``eval_sb``) from the boundary state as the step finds it, then the four
z-order blocks (``sub_step``): the whole block with every candidate, and
its four sub-blocks with the Z2-safe mode set, their neighbour recon
threaded through a local buffer; the cheaper tree wins at each depth, and
the boundary buffers end the step holding the chosen content.

Every candidate runs the normative integer chain, so levels and recon are
bit-final, and the float32 RD sums keep the JAX package's association.
Used for luma (bs=32, tx search on the 16x16 leaves) and for paired U+V
chroma (bs=16, partition forced by luma).

The scan is plain PyTorch on src's device: the JAX package runs it as
XLA code, with no Pallas kernel.  A call is split as the JAX package's
jit boundary splits it: a prepare step (``PartScan.fill``) writes the
host tables of the qindex and every lambda-dependent value into static
device buffers without a synchronisation, and the steps read those
buffers alone.  On a CUDA device each step runs as a CUDA graph captured
once a shape and step width and replayed after that (``PartScan``), so a
plane's tens of thousands of launches a step cost one graph launch.
"""

from __future__ import annotations

from typing import NamedTuple

import ctypes
import threading
import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import upload
from ..ec.coeffs import EXT_TX_IND
from ..ec.modes import PARTITION_NONE, PARTITION_SPLIT
from ..ops import intra
from ..ops.intra_dir import dr_pred
from ..ops.quant import dequantize_dq, quantize_dq_opt
from ..ops.transforms import add_residual_clip, fwd_txfm2d, inv_txfm2d
from ..spec import tables as tbl
from ..spec.cdf import CdfContext
from ..spec.txfm import (DCT_DCT, TX_8X8, TX_16X16, TX_32X32, TX_64X64,
                         uv_intra_tx_type)
from .wavefront import (DEFAULT_MODES, DIRECTIONAL, _edges, _lambda,
                        _quad_tables, _resid_bits, expand_candidates,
                        intra_mode_rate_table)

# sub-block intra modes: everything that never reads the above-right /
# below-left extended edges (Z2 directional keeps above/left/corner only)
SUB_MODES = (intra.DC_PRED, intra.V_PRED, intra.H_PRED,
             intra.D135_PRED, intra.D113_PRED, intra.D157_PRED,
             intra.SMOOTH_PRED, intra.SMOOTH_V_PRED, intra.SMOOTH_H_PRED,
             intra.PAETH_PRED)

# chroma mode lists of the paired U+V wavefront: 32x32-tree blocks sit at
# quad z-positions with full extended-edge availability; 8x8 sub-blocks
# and the SB-depth block keep the Z2-safe set
CHROMA_TOP_MODES = (intra.DC_PRED, intra.V_PRED, intra.H_PRED,
                    intra.D45_PRED, intra.D135_PRED, intra.D113_PRED,
                    intra.D157_PRED, intra.D203_PRED, intra.D67_PRED,
                    intra.SMOOTH_PRED, intra.SMOOTH_V_PRED,
                    intra.SMOOTH_H_PRED, intra.PAETH_PRED)
CHROMA_SUB_MODES = SUB_MODES
CHROMA_SB_MODES = SUB_MODES

# tx types searched on 16x16 intra luma leaves: the reduced intra set
# EXT_TX_SET_DTT4_IDTX (DCT, ADST_ADST, ADST_DCT, DCT_ADST, IDTX)
TX_SEARCH_TYPES = (0, 3, 1, 2, 9)

# square tx size of an n x n block
_SQ_TX = {8: TX_8X8, 16: TX_16X16, 32: TX_32X32, 64: TX_64X64}
BIG = 3e38                    # RD cost of a gated-off candidate (float32)


class InterLanes(NamedTuple):
    """The inter form's candidate lanes, tensors on the scan's device, nE
    lanes, z-order sub-blocks.  Predictions int32: top [B, nE, bh, bw, bs,
    bs], sub [B, nE, bh, bw, 4, bs/2, bs/2], sb [B, nE, sh, sw, 2bs, 2bs];
    their rates (bits) float32 and masks bool [B, nE, bh, bw] / [B, nE, bh,
    bw, 4] / [B, nE, sh, sw]; intra_ok_* [B, bh, bw] / [B, bh, bw, 4] /
    [B, sh, sw] gate the intra candidates.  Candidate index space: the
    intra candidates, then the lanes."""
    top: torch.Tensor
    rate_top: torch.Tensor
    ok_top: torch.Tensor
    sub: torch.Tensor
    rate_sub: torch.Tensor
    ok_sub: torch.Tensor
    sb: torch.Tensor
    rate_sb: torch.Tensor
    ok_sb: torch.Tensor
    intra_ok_top: torch.Tensor
    intra_ok_sub: torch.Tensor
    intra_ok_sb: torch.Tensor


def _cdf_sym_bits(table, sym: int, nsyms: int = None) -> float:
    """-log2 P(sym) from a default [icdf..., counter] table slice."""
    hi = 32768 if sym == 0 else int(table[sym - 1])
    lo = 0 if nsyms is not None and sym >= nsyms - 1 else int(table[sym])
    return -np.log2(max(hi - lo, 1) / 32768.0)


def txt_rate_table(qindex: int, cdf: CdfContext = None) -> np.ndarray:
    """[13 intra modes, 5 search types] signalling bits of the 16x16
    intra tx-type symbol from the default CDFs (intra_ext_tx_cdf set 2)."""
    cdf = cdf or CdfContext(qindex)
    out = np.zeros((13, len(TX_SEARCH_TYPES)), np.float32)
    sq = tbl.txsize_sqr(TX_16X16)
    for mode in range(13):
        t = cdf.intra_ext_tx_cdf[2][sq][mode]
        for i, tt in enumerate(TX_SEARCH_TYPES):
            out[mode, i] = _cdf_sym_bits(t, EXT_TX_IND[2][tt], 5)
    return out


def partition_bits(qindex: int, bs: int, cdf: CdfContext = None):
    """(bits_none, bits_split_total) at the top block size from the default
    partition CDFs (the split total includes the four leaf NONE symbols)."""
    cdf = cdf or CdfContext(qindex)
    bsl_top = {32: 2, 16: 1}[bs]
    t_top = cdf.partition_cdf[bsl_top * 4]
    t_leaf = cdf.partition_cdf[(bsl_top - 1) * 4]
    b_none = _cdf_sym_bits(t_top, PARTITION_NONE)
    b_split = _cdf_sym_bits(t_top, PARTITION_SPLIT) + \
        4 * _cdf_sym_bits(t_leaf, PARTITION_NONE)
    return float(b_none), float(b_split)


def partition_bits_sb(qindex: int, bs2: int, cdf: CdfContext = None):
    """(bits_none, bits_split) of the superblock-level partition symbol
    alone (the sub-tree costs already include their own partition bits)."""
    cdf = cdf or CdfContext(qindex)
    t = cdf.partition_cdf[{64: 3, 32: 2}[bs2] * 4]
    return (float(_cdf_sym_bits(t, PARTITION_NONE)),
            float(_cdf_sym_bits(t, PARTITION_SPLIT)))


def rd_params_part(qindex: int, bs: int, cands_top, cands_sub, cands_sbl,
                   uv_rates: bool = False, kf: bool = True, bd: int = 8,
                   lam_scale: float = 1.0):
    """RD inputs of a partition wavefront call, as numpy on the host: (dc
    step, ac step, lambda times lam_scale, top / sub / SB mode-rate
    tables, NONE and SPLIT bits at the 32 and the SB depth, the tx-type
    rate table, the sub candidates' mode ids).  kf=False takes the inter
    frame's intra-mode rates (chroma keeps the uv_mode rates).  The steps
    are bd's; the lambda is the 8-bit ac step's at every bd, as in the JAX
    package."""
    cdf = CdfContext(qindex)
    dc, ac = tbl.qindex_to_dq(qindex, bd)
    rate_kf = "uv" if uv_rates else kf
    rate = lambda c: intra_mode_rate_table(c, qindex, kf=rate_kf, cdf=cdf)
    f32 = np.float32
    bn, bsp = partition_bits(qindex, bs, cdf)
    bn2, bsp2 = partition_bits_sb(qindex, 2 * bs, cdf)
    return dict(dc=np.int32(dc), ac=np.int32(ac),
                lam=f32(_lambda(qindex) * lam_scale),
                rate_top=rate(cands_top), rate_sub=rate(cands_sub),
                rate_sb=rate(cands_sbl), bits_none=f32(bn),
                bits_split=f32(bsp), bits_none_sb=f32(bn2),
                bits_split_sb=f32(bsp2), txt=txt_rate_table(qindex, cdf),
                mode_ids=np.array([m for m, _ in cands_sub], np.int64))


def _mode_lists(chroma: bool, angle_deltas=(0,)):
    """The (top, sub, SB) candidate lists: the angle deltas expand the
    luma whole-block and SB lists only; the luma sub-blocks and every
    chroma list keep the base angles, as in the JAX package."""
    if chroma:
        if tuple(angle_deltas) != (0,):
            raise ValueError("the chroma scan takes no angle deltas")
        return tuple(expand_candidates(m) for m in (
            CHROMA_TOP_MODES, CHROMA_SUB_MODES, CHROMA_SB_MODES))
    return (expand_candidates(DEFAULT_MODES, angle_deltas),
            expand_candidates(SUB_MODES),
            expand_candidates(DEFAULT_MODES, angle_deltas))


# the scan's CUDA graphs (cumulative): step graphs captured, step graphs
# replayed, scan calls that ran on graphs, the host seconds of the
# captures (instantiation included) and of the calls' replay loops; "log"
# holds one entry per capture: its scan key, step width D, node count
# (None where the driver could not be asked), capture and instantiate
# seconds, the device memory reserved after it and the host RSS
GRAPHS = dict(captures=0, replays=0, calls=0, capture_s=0.0, replay_s=0.0,
              log=[])
_SCANS = {}          # key -> PartScan of the card's shapes (for the process)
_KEEP = ("cuda",)    # device types whose scans _SCANS keeps
# guards _SCANS; each kept scan has its own lock, held from its fill to
# its outputs' copies, so that threads (parallel.mesh) with one shape on
# one card take turns on its static buffers
_SCANS_LOCK = threading.Lock()
_GRAPHS_LOCK = threading.Lock()     # guards GRAPHS (threads' scans add up)
_OUTPUTS = ("part", "mi_top", "lev_top", "mi_sub", "lev_sub", "stx_sub",
            "recon", "part_sb", "mi_sb", "lev_sb")


class PartScan:
    """One shape of the partition scan, keyed by (device, B, h, w, bs,
    chroma, bd, tx_search, valid_h, n_extra, angle_deltas) with n_extra
    None for the key-frame form; angle_deltas sets the luma candidate
    lists (``_mode_lists``), so scans of one shape with other deltas have
    graphs of their own.  It holds static buffers on the device: the inputs,
    which ``fill`` writes (the prepare step: the host tables of the
    qindex, the lambda times lam_scale, the lambda map, the source, the
    force masks and the inter lanes), the scan's state and outputs, and
    the step schedule.  ``run`` zeroes the state and runs the scan's
    steps, each a function of those buffers and of its row of the
    schedule alone.

    On a CUDA device a step runs as a CUDA graph: one graph for each step
    width D (the number of superblocks on the step's anti-diagonal), its
    schedule row copied into the graph's step buffer before each replay,
    captured at the first step of that width and replayed by every later
    step and call of the shape (the steps of a width launch the same
    kernels on other blocks, and the qindex and lambdas are buffer
    contents).  A 1080p plane has 62 steps of 17 widths.  The graphs of a
    shape share one memory pool.  ``run(eager=True)`` runs the same steps
    eagerly on the same buffers.  A failed capture or replay raises.  On
    the CPU the steps run eagerly."""

    def __init__(self, device, B: int, h: int, w: int, bs: int,
                 chroma: bool, bd: int, tx_search: bool, valid_h,
                 n_extra=None, angle_deltas=(0,)):
        self.key = (str(device), B, h, w, bs, chroma, bd, tx_search,
                    valid_h, n_extra, tuple(angle_deltas))
        dev = self.dev = torch.device(device)
        self.bs, self.chroma, self.bd = bs, chroma, bd
        self.cands = _mode_lists(chroma, angle_deltas)
        bh, bw, sh, sw, hs = h // bs, w // bs, h // (2 * bs), w // (2 * bs), \
            bs // 2
        bs2 = 2 * bs
        nC = 32 if bs2 == 64 else bs2      # coded coefficient area of tx_sb
        z = lambda shape, dt=torch.int32: torch.zeros(shape, dtype=dt,
                                                      device=dev)
        f32, b8 = torch.float32, torch.bool
        self.src = z((B, h, w))
        self.force_part, self.force_sb = z((B, bh, bw)), z((B, sh, sw))
        self.lam_map = z((B, bh, bw), f32)
        ct, cs_, cb = (len(c) for c in self.cands)
        self.rd = dict(dc=z(()), ac=z(()), lam=z((), f32),
                       rate_top=z((ct,), f32), rate_sub=z((cs_,), f32),
                       rate_sb=z((cb,), f32), bits_none=z((), f32),
                       bits_split=z((), f32), bits_none_sb=z((), f32),
                       bits_split_sb=z((), f32),
                       txt=z((13, len(TX_SEARCH_TYPES)), f32),
                       mode_ids=z((cs_,), torch.int64))
        self.inter = None
        if n_extra is not None:
            nE = n_extra
            self.inter = InterLanes(
                z((B, nE, bh, bw, bs, bs)), z((B, nE, bh, bw), f32),
                z((B, nE, bh, bw), b8), z((B, nE, bh, bw, 4, hs, hs)),
                z((B, nE, bh, bw, 4), f32), z((B, nE, bh, bw, 4), b8),
                z((B, nE, sh, sw, bs2, bs2)), z((B, nE, sh, sw), f32),
                z((B, nE, sh, sw), b8), z((B, bh, bw), b8),
                z((B, bh, bw, 4), b8), z((B, sh, sw), b8))
        # coding-order boundary state: bottom row of every completed block
        # (rowbuf [B, bh, w]) and its right column (colbuf [B, h, bw]);
        # the outputs, written in place by the steps
        self.state = dict(
            rowbuf=z((B, bh, w)), colbuf=z((B, h, bw)), part=z((B, bh, bw)),
            mi_top=z((B, bh, bw)), lev_top=z((B, bh, bw, bs, bs)),
            mi_sub=z((B, bh, bw, 4)), lev_sub=z((B, bh, bw, 4, hs, hs)),
            stx_sub=z((B, bh, bw, 4)), part_sb=z((B, sh, sw)),
            mi_sb=z((B, sh, sw)), lev_sb=z((B, sh, sw, nC, nC)),
            rec_sb=z((B, sh, sw, bs2, bs2)))
        # the schedule [steps, (rs, cs, has_tr, has_bl), 4 z, D], uploaded
        # once; the valid lanes of a step are a prefix, the same for its
        # four z
        rs_t, cs_t, valid_t, has_tr_t, has_bl_t = _quad_tables(bh, bw)
        self.widths = [int(d) for d in valid_t[:, 0].sum(1)]
        self.sched = upload(np.stack([rs_t, cs_t, has_tr_t, has_bl_t],
                                     1).astype(np.int64), dev)
        # the chroma candidates' tx-type groups fill at the first step,
        # outside any capture
        self.step = _scan_step(self.src, self.rd, self.force_part,
                               self.force_sb, self.lam_map, bs, *self.cands,
                               tx_search, valid_h, chroma, self.inter, bd,
                               {}, self.state)
        self.graphs = {}             # D -> (CUDAGraph, its step buffer)
        self.pool = None
        self.warm = False
        self.lock = threading.Lock()

    def fill(self, src, qindex: int, force_part, force_sb, inter=None,
             lam_scale: float = 1.0, lam_map=None):
        """The prepare step: the call's inputs into the static buffers, on
        the device's stream without a synchronisation.  lam_map [B, bh,
        bw] float32 tensor (None: all ones) scales the RD lambda of each
        bs x bs block (the SB takes its first block's)."""
        rd = rd_params_part(qindex, self.bs, *self.cands, self.chroma,
                            kf=self.inter is None, bd=self.bd,
                            lam_scale=lam_scale)
        for k, buf in self.rd.items():
            buf.copy_(upload(np.asarray(rd[k]), self.dev).reshape(buf.shape))
        self.src.copy_(src)
        self.force_part.copy_(force_part)
        self.force_sb.copy_(force_sb)
        if lam_map is None:
            self.lam_map.fill_(1.0)
        else:
            self.lam_map.copy_(lam_map)
        if self.inter is not None:
            for buf, t in zip(self.inter, inter):
                buf.copy_(t)

    def run(self, eager: bool = False):
        """The scan on the filled buffers: its ten outputs (new tensors)."""
        graphs = self.dev.type == "cuda" and not eager
        if graphs and not self.warm:
            # one eager step first: the per-device tables the steps read
            # are made outside any capture
            self.step(self.sched[0, :, :, :self.widths[0]])
            self.warm = True
        for t in self.state.values():
            t.zero_()
        t0, cap, replays = time.perf_counter(), 0.0, 0
        for k, D in enumerate(self.widths):
            sk = self.sched[k, :, :, :D]
            if not graphs:
                self.step(sk)
                continue
            if D not in self.graphs:
                cap += self._capture(D, sk)
            g, buf = self.graphs[D]
            buf.copy_(sk)
            g.replay()
            replays += 1
        if graphs:
            with _GRAPHS_LOCK:
                GRAPHS["replays"] += replays
                GRAPHS["calls"] += 1
                GRAPHS["replay_s"] += time.perf_counter() - t0 - cap
        st = self.state
        B, h, w = self.src.shape
        out = {k: st[k].clone() for k in _OUTPUTS if k != "recon"}
        out["recon"] = st["rec_sb"].permute(0, 1, 3, 2, 4).reshape(
            B, h, w).clone()
        return tuple(out[k] for k in _OUTPUTS)

    def _capture(self, D: int, sk) -> float:
        """Capture the step of width D on a step buffer of its own (in the
        shape's pool); returns its seconds."""
        buf = sk.clone()
        g = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # thread-local capture: other threads' work on the card (another
        # scan shape, motion search, copies) neither fails nor joins it
        with torch.cuda.graph(g, pool=self.pool,
                              capture_error_mode="thread_local"):
            self.step(buf)
            nodes = _captured_nodes()
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        if self.pool is None:
            self.pool = g.pool()
        self.graphs[D] = (g, buf)
        entry = dict(key=self.key, D=D, nodes=nodes, capture_s=t1 - t0,
                     instantiate_s=t2 - t1,
                     reserved_bytes=torch.cuda.memory_reserved(self.dev),
                     rss_bytes=_host_rss())
        with _GRAPHS_LOCK:
            GRAPHS["captures"] += 1
            GRAPHS["capture_s"] += t2 - t0
            GRAPHS["log"].append(entry)
        return t2 - t0


def drop_scans(drop) -> int:
    """Forget the kept scans whose key satisfies drop(key), with their
    graphs, pool and static buffers (a long-lived process that is done
    with a shape); returns how many went."""
    with _SCANS_LOCK:
        keys = [k for k in _SCANS if drop(k)]
        for k in keys:
            scan = _SCANS.pop(k)
            with scan.lock:
                for g, _ in scan.graphs.values():
                    g.reset()
                scan.graphs.clear()
    return len(keys)


def _captured_nodes():
    """Node count of the graph being captured on the current stream, from
    the CUDA driver (None where it cannot be asked)."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        status = ctypes.c_int()
        graph = ctypes.c_void_p()
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if cu.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status), None,
                                        ctypes.byref(graph), None, None):
            return None
        n = ctypes.c_size_t()
        if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
            return None
        return int(n.value)
    except (OSError, AttributeError):
        return None


def _host_rss():
    """The process's resident host memory in bytes (Linux), or None."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def encode_plane_wavefront_part(src, bs: int, qindex: int, force_part,
                                force_sb, chroma: bool = False,
                                tx_search: bool = False,
                                valid_h: int = None,
                                inter: InterLanes = None, bd: int = 8,
                                lam_scale: float = 1.0, lam_map=None,
                                eager: bool = False,
                                angle_deltas: tuple = (0,)):
    """src [B, h, w] pixel tensor (h, w multiples of 2*bs) ->
    (part [B, bh, bw] int32 (1 = SPLIT), mi_top [B, bh, bw],
    lev_top [B, bh, bw, bs, bs], mi_sub [B, bh, bw, 4],
    lev_sub [B, bh, bw, 4, bs/2, bs/2], stx_sub [B, bh, bw, 4] (index into
    TX_SEARCH_TYPES), recon [B, h, w], part_sb [B, sh, sw] (1 = split),
    mi_sb [B, sh, sw], lev_sb [B, sh, sw, nC, nC]), with bs x bs blocks
    transformed at bs, their sub-blocks at bs/2 and the SB at 2*bs, and nC
    the SB's coded area (TX_64X64 codes its low 32x32 band).

    force_part [B, bh, bw] / force_sb [B, sh, sw] int32: -1 free, 0 NONE,
    1 SPLIT.  chroma: src stacks [U..., V...] and each (u, v) pair picks
    one candidate from the chroma mode lists, with uv_mode rates and each
    candidate's implied tx type; otherwise luma with the 13 DEFAULT_MODES
    at the 32x32 and SB depths, their directional modes expanded by
    angle_deltas (presets 0-5; the chroma scan takes (0,)), and SUB_MODES
    below.  tx_search: RD-refine
    the tx type of the sub-block winners over TX_SEARCH_TYPES.  valid_h:
    true (unpadded) frame height; left edge rows clamp at valid_h-1.
    inter: the P frame's lanes (the inter form; mode indices past the
    intra candidates are lanes).  bd: the bit depth (8 or 10) of src
    and of the lanes' predictions.  lam_scale multiplies the RD lambda
    (the pyramid's per-layer weighting); lam_map [B, bh, bw] float32
    scales it per block (the pyramid anchor's TPL map).

    On a CUDA device the call goes through ``PartScan``'s graph of its
    shape (captured at the shape's first call); eager=True runs the body
    on the same buffers instead, to hold a replay against it."""
    B, h, w = src.shape
    key = (str(src.device), B, h, w, bs, chroma, bd, tx_search, valid_h,
           None if inter is None else inter.top.shape[1],
           tuple(angle_deltas))
    keep = src.device.type in _KEEP
    cuda = src.device.type == "cuda"
    with torch.cuda.device(src.device) if cuda else nullcontext():
        with _SCANS_LOCK:
            scan = _SCANS.get(key) if keep else None
            if scan is None:
                scan = PartScan(*key)
                if keep:
                    _SCANS[key] = scan
        with scan.lock:
            scan.fill(src, qindex, force_part, force_sb, inter, lam_scale,
                      lam_map)
            return scan.run(eager)


def _intra_pred(mode, delta, above, left, corner, ha, hl, n, bd,
                above_ext=None, left_ext=None):
    """One intra candidate's prediction [BD, n, n]; ha/hl [BD] bool."""
    if mode == intra.DC_PRED:
        p = [intra.dc_pred(above, left, a, l, bd)
             for a, l in ((True, True), (True, False), (False, True),
                          (False, False))]
        haa, hll = ha[:, None, None], hl[:, None, None]
        return torch.where(haa & hll, p[0],
                           torch.where(haa, p[1],
                                       torch.where(hll, p[2], p[3])))
    if mode in DIRECTIONAL and (delta != 0 or mode not in
                                (intra.V_PRED, intra.H_PRED)):
        if above_ext is None:
            above_ext = torch.cat([above, above[..., -1:].expand(
                above.shape[:-1] + (n,))], -1)
            left_ext = torch.cat([left, left[..., -1:].expand(
                left.shape[:-1] + (n,))], -1)
        return dr_pred(mode, delta, above_ext, left_ext, corner, n, bd)
    return intra.predict(mode, above, left, corner)


def _scan_step(src, rd, force_part, force_sb, lam_map, bs: int, cands_top,
               cands_sub, cands_sbl, tx_search: bool, valid_h: int,
               chroma: bool, inter, bd: int, groups, state):
    """The scan's step, plain PyTorch on src's device: step(sk) codes the
    blocks of one quad step, sk [4 (rs, cs, has_tr, has_bl), 4 (z), D]
    int64, with device ops on its inputs and on `state` alone (no upload
    and no read-back), so that it can be captured.  rd holds
    rd_params_part's values as tensors on that device (dc and ac 0-d
    int32); lam_map [B, bh, bw] float32; chroma: paired U/V lanes and
    implied uv tx types; inter: InterLanes (the inter form), or None;
    groups: the tx-type index tensors, filled at first use; state: the
    boundary buffers and outputs (PartScan.state), written in place."""
    dqdc, dqac, lam = rd["dc"], rd["ac"], rd["lam"]
    paired, uv_tx = chroma, chroma
    dev = src.device
    B, h, w = src.shape
    vh = h if valid_h is None else valid_h
    hs, bs2 = bs // 2, 2 * bs
    tx_top, tx_sub, tx_sb = _SQ_TX[bs], _SQ_TX[hs], _SQ_TX[bs2]
    bh, bw = h // bs, w // bs
    sh, sw = h // bs2, w // bs2
    nC = 32 if bs2 == 64 else bs2          # coded coefficient area of tx_sb
    base = 1 << (bd - 1)
    i32 = torch.int32
    # tx-type signalling overhead per coded txb
    kf = inter is None
    txb_top = 0.0 if (bs >= 32 and kf) else 1.0
    txb_sub = 2.4 if kf else 1.0
    txb_sb = 0.0 if kf else 1.0
    n_extra = 0 if kf else inter.top.shape[1]
    n_mode_ids = len(cands_sub)

    src_b = src.reshape(B, bh, bs, bw, bs).permute(0, 1, 3, 2, 4)
    src_sb = src.reshape(B, sh, bs2, sw, bs2).permute(0, 1, 3, 2, 4)
    ar = torch.arange(bs, device=dev)
    ar2 = torch.arange(bs2, device=dev)
    rowbuf, colbuf = state["rowbuf"], state["colbuf"]
    part, mi_top, lev_top = state["part"], state["mi_top"], state["lev_top"]
    mi_sub, lev_sub, stx_sub = (state["mi_sub"], state["lev_sub"],
                                state["stx_sub"])
    part_sb, mi_sb, lev_sb, rec_sb = (state["part_sb"], state["mi_sb"],
                                      state["lev_sb"], state["rec_sb"])

    def txq(pred, f_src, tx_size, n, tx_bits, tx_type=DCT_DCT):
        lev = quantize_dq_opt(fwd_txfm2d(f_src - pred, tx_size, tx_type, bd),
                              tx_size, dqdc, dqac, lam, bd)
        dq = dequantize_dq(lev, tx_size, dqdc, dqac, bd)
        recb = add_residual_clip(pred, inv_txfm2d(dq, tx_size, tx_type, bd),
                                 bd)
        sse = ((f_src - recb) ** 2).sum((-1, -2)).to(torch.float32)
        rb = _resid_bits(lev, n)
        if tx_bits:
            nnz = (lev != 0).sum((-1, -2))
            rb = rb + torch.where(nnz > 0, tx_bits, 0.0)
        return lev, recb, sse, rb

    def txq_sb(pred, f_src):
        coeff = fwd_txfm2d(f_src - pred, tx_sb, DCT_DCT, bd)
        if bs2 == 64:
            # TX_64X64 codes only its low 32x32 band
            coeff[..., nC:, :] = 0
            coeff[..., :, nC:] = 0
        lev = quantize_dq_opt(coeff, tx_sb, dqdc, dqac, lam, bd)
        dq = dequantize_dq(lev, tx_sb, dqdc, dqac, bd)
        recb = add_residual_clip(pred, inv_txfm2d(dq, tx_sb, DCT_DCT, bd),
                                 bd)
        sse = ((f_src - recb) ** 2).sum((-1, -2)).to(torch.float32)
        lev_c = lev[..., :nC, :nC]
        rb = _resid_bits(lev_c, 32)
        if txb_sb:
            nnz = (lev_c != 0).sum((-1, -2))
            rb = rb + torch.where(nnz > 0, txb_sb, 0.0)
        return lev_c, recb, sse, rb

    def candidates(preds, table, iok, extras):
        """The inter form's candidate list: intra predictions then the
        lanes' (pred, rate, ok); returns (preds, rates [C, BD], oks [C, BD]).
        The key-frame form keeps the rate table [C] and no mask."""
        if kf:
            return preds, table, None
        n = preds[0].shape[0]
        rates = torch.cat([table[:, None].expand(len(table), n),
                           torch.stack([r for _, r, _ in extras])])
        oks = torch.cat([iok[None].expand(len(table), n),
                         torch.stack([o for _, _, o in extras])])
        return preds + [p for p, _, _ in extras], rates, oks

    def step_lanes(pred, rate, ok, idx):
        """The n_extra lanes of a step's blocks, each [B*D, ...]."""
        fl = lambda t: t.reshape((-1,) + t.shape[2:])
        return [(fl(pred[:, e][idx]), fl(rate[:, e][idx]), fl(ok[:, e][idx]))
                for e in range(n_extra)]

    def tx_groups(tx_types):
        """[(tx type, candidate indices)] in type order, the indices as a
        tensor on the scan's device (uploaded at the first use of the
        buffers: a list index would copy from pageable memory and
        synchronise every step)."""
        if tx_types not in groups:
            groups[tx_types] = [
                (tt, upload(np.array([i for i, t in enumerate(tx_types)
                                      if t == tt], np.int64), dev))
                for tt in sorted(set(tx_types))]
        return groups[tx_types]

    def stack_eval(preds, rates, f_src, txq_fn, f_lam, tx_types=None,
                   oks=None):
        """All candidates through one txq chain per distinct tx type; the
        first minimum of the RD cost wins.  rates: [C] or [C, BD]; f_lam
        [BD] the lanes' lambda-map factors; oks [C, BD] or None gates
        candidates (a gated one costs BIG).  paired:
        the u/v halves of the lane axis pick one candidate on the pair's
        summed cost.  Returns (cost, mi, lev, rec, pred, rcost) of the
        winners."""
        C, BD, n = len(preds), preds[0].shape[0], preds[0].shape[-1]
        pred_s = torch.stack(preds)                    # [C, BD, n, n]
        if tx_types is None or len(set(tx_types)) == 1:
            tt0 = DCT_DCT if tx_types is None else tx_types[0]
            lev, recb, sse, rb = txq_fn(pred_s.reshape(C * BD, n, n),
                                        f_src.repeat(C, 1, 1), tt0)
            lev = lev.reshape((C, BD) + lev.shape[1:])
            recb, sse, rb = (recb.reshape(C, BD, n, n), sse.reshape(C, BD),
                             rb.reshape(C, BD))
        else:
            outs = [None] * 4
            for tt, idx in tx_groups(tuple(tx_types)):
                o = txq_fn(pred_s[idx].reshape(len(idx) * BD, n, n),
                           f_src.repeat(len(idx), 1, 1), tt)
                for k, a in enumerate(o):
                    if outs[k] is None:
                        outs[k] = a.new_empty((C, BD) + a.shape[1:])
                    outs[k][idx] = a.reshape((len(idx), BD) + a.shape[1:])
            lev, recb, sse, rb = outs
        lamv = lam * f_lam[None, :]
        rcost_s = sse + lamv * rb
        cost_s = rcost_s + lamv * (rates[:, None] if rates.dim() == 1
                                   else rates)
        if oks is not None:
            cost_s = torch.where(oks, cost_s, BIG)
        if paired:
            cp = cost_s.reshape(C, 2, BD // 2).sum(1)
            mi = torch.argmin(cp, 0).repeat(2)
        else:
            mi = torch.argmin(cost_s, 0)               # first minimum
        lanes = torch.arange(BD, device=dev)
        return (cost_s[mi, lanes], mi.to(i32), lev[mi, lanes],
                recb[mi, lanes], pred_s[mi, lanes], rcost_s[mi, lanes])

    def eval_set(f_src, above, left, corner, ha, hl, n, tx_size, f_lam,
                 iok=None, extras=()):
        """Best sub-block candidate (intra, then the inter form's lanes
        extras [(pred, rate, ok)]), then (tx_search) the RD tx-type
        refinement of an intra winner.  Returns (cost, mi, lev, rec,
        tx_idx)."""
        preds, rates, oks = candidates(
            [_intra_pred(m, d, above, left, corner, ha, hl, n, bd)
             for m, d in cands_sub], rd["rate_sub"], iok, extras)
        ttypes = ([uv_intra_tx_type(m, tx_size) for m, _ in cands_sub] +
                  [DCT_DCT] * len(extras) if uv_tx else None)
        cost, mi, lev, recb, pred, rcost = stack_eval(
            preds, rates, f_src,
            lambda p, s, tt: txq(p, s, tx_size, n, txb_sub, tt), f_lam,
            ttypes, oks)
        tx_idx = torch.zeros_like(mi)
        if tx_search:
            m_ids = rd["mode_ids"][mi.clamp(0, n_mode_ids - 1)]
            txt = rd["txt"][m_ids]                     # [BD, 5]
            lamv = lam * f_lam
            cur_eff = rcost + lamv * txt[:, 0]
            for ti in range(1, len(TX_SEARCH_TYPES)):
                lev2, recb2, sse2, rb2 = txq(pred, f_src, tx_size, n, 0.0,
                                             TX_SEARCH_TYPES[ti])
                new_eff = sse2 + lamv * (rb2 + txt[:, ti])
                take = new_eff < cur_eff
                if not kf:
                    take = take & (mi < len(cands_sub))
                t3 = take[:, None, None]
                cost = torch.where(take, cost - cur_eff + new_eff, cost)
                lev = torch.where(t3, lev2, lev)
                recb = torch.where(t3, recb2, recb)
                tx_idx = torch.where(take, ti, tx_idx)
                cur_eff = torch.where(take, new_eff, cur_eff)
        return cost, mi, lev, recb, tx_idx

    def sub_step(rs, cs, has_tr, has_bl):
        """One z-position's blocks (rs[i], cs[i]): NONE over every top
        candidate against SPLIT into four sub-blocks.  Writes the block's
        outputs and boundary rows; returns (tree cost [B, D], recon
        [B, D, bs, bs])."""
        D = rs.shape[0]
        y, x = rs * bs, cs * bs
        above, left, corner, above_ext, left_ext = _edges(
            rowbuf, colbuf, rs, cs, has_tr, has_bl, bs, vh, base)
        fb = lambda t: t.reshape((B * D,) + t.shape[2:])
        f_src = fb(src_b[:, rs, cs])
        f_above, f_left, f_corner = fb(above), fb(left), fb(corner)
        f_above_ext, f_left_ext = fb(above_ext), fb(left_ext)
        f_ha = (rs > 0).expand(B, D).reshape(-1)
        f_hl = (cs > 0).expand(B, D).reshape(-1)
        f_lam = lam_map[:, rs, cs].reshape(-1)

        blk = (slice(None), rs, cs)
        if not kf:
            f_iok = inter.intra_ok_top[blk].reshape(-1)
            f_iok_sub = inter.intra_ok_sub[blk].reshape(B * D, 4)
            sub_lanes = step_lanes(inter.sub, inter.rate_sub, inter.ok_sub,
                                   blk)
        # whole-block (NONE) evaluation, extended-edge modes included
        preds_t, rates_t, oks_t = candidates(
            [_intra_pred(m, d, f_above, f_left, f_corner, f_ha, f_hl, bs, bd,
                         f_above_ext, f_left_ext) for m, d in cands_top],
            rd["rate_top"], None if kf else f_iok,
            None if kf else step_lanes(inter.top, inter.rate_top,
                                       inter.ok_top, blk))
        tt_top = ([uv_intra_tx_type(m, tx_top) for m, _ in cands_top] +
                  [DCT_DCT] * n_extra if uv_tx else None)
        best_top = stack_eval(
            preds_t, rates_t, f_src,
            lambda p, s, tt: txq(p, s, tx_top, bs, txb_top, tt), f_lam,
            tt_top, oks_t)

        # SPLIT evaluation: 4 z-order sub-blocks
        loc = torch.zeros((B * D, bs, bs), dtype=i32, device=dev)
        one = torch.ones_like(f_ha)
        sub_cost = 0.0
        sub_mi, sub_lev, sub_tx = [], [], []
        for sr, sc in ((0, 0), (0, 1), (1, 0), (1, 1)):
            oy, ox = sr * hs, sc * hs
            s_src = f_src[:, oy:oy + hs, ox:ox + hs]
            if sr == 0:
                s_above_real, s_ha = f_above[..., ox:ox + hs], f_ha
            else:
                s_above_real, s_ha = loc[:, oy - 1, ox:ox + hs], one
            if sc == 0:
                s_left_real, s_hl = f_left[..., oy:oy + hs], f_hl
            else:
                s_left_real, s_hl = loc[:, oy:oy + hs, ox - 1], one
            if sr == 0 and sc == 0:
                s_corner = f_corner
            elif sr == 0:
                s_corner = f_above[..., ox - 1]
            elif sc == 0:
                s_corner = f_left[..., oy - 1]
            else:
                s_corner = loc[:, oy - 1, ox - 1]
            s_above = torch.where(
                s_ha[:, None], s_above_real,
                torch.where(s_hl[:, None], s_left_real[..., 0:1], base - 1))
            s_left = torch.where(
                s_hl[:, None], s_left_real,
                torch.where(s_ha[:, None], s_above_real[..., 0:1], base + 1))
            s_corner = torch.where(
                s_ha & s_hl, s_corner,
                torch.where(s_ha, s_above_real[..., 0],
                            torch.where(s_hl, s_left_real[..., 0], base)))
            z = 2 * sr + sc
            cost, mi, lev, recb, stx = eval_set(
                s_src, s_above, s_left, s_corner, s_ha, s_hl, hs, tx_sub,
                f_lam, *(() if kf else (f_iok_sub[:, z], [
                    (p[:, z], r[:, z], o[:, z]) for p, r, o in sub_lanes])))
            sub_cost = sub_cost + cost
            sub_mi.append(mi)
            sub_lev.append(lev)
            sub_tx.append(stx)
            loc[:, oy:oy + hs, ox:ox + hs] = recb

        # choose
        cost_none = best_top[0] + lam * f_lam * rd["bits_none"]
        cost_split = sub_cost + lam * f_lam * rd["bits_split"]
        fp = force_part[:, rs, cs].reshape(-1)
        split = torch.where(fp < 0, cost_split < cost_none, fp == 1)
        cost_tree = torch.minimum(cost_none, cost_split)
        rec_d = torch.where(split[:, None, None], loc,
                            best_top[3]).reshape(B, D, bs, bs)

        part[:, rs, cs] = split.to(i32).reshape(B, D)
        mi_top[:, rs, cs] = best_top[1].reshape(B, D)
        lev_top[:, rs, cs] = best_top[2].reshape(B, D, bs, bs)
        mi_sub[:, rs, cs] = torch.stack(sub_mi, -1).reshape(B, D, 4)
        lev_sub[:, rs, cs] = torch.stack(sub_lev, -3).reshape(
            B, D, 4, hs, hs)
        stx_sub[:, rs, cs] = torch.stack(sub_tx, -1).reshape(B, D, 4)
        rowbuf[:, rs[:, None], x[:, None] + ar[None, :]] = rec_d[:, :, -1]
        colbuf[:, y[:, None] + ar[None, :], cs[:, None]] = rec_d[..., -1]
        return cost_tree.reshape(B, D), rec_d

    def eval_sb(sbr, sbc):
        """The SB (2bs x 2bs) as one block with a single tx_sb transform,
        from the boundary buffers as the step finds them: the SB's above
        row is the bottom row of block-row 2*sbr-1, its left column the
        right column of block-column 2*sbc-1; above-right exists when
        sbr > 0 and sbc + 1 < sw, below-left never (replicated).
        Returns (cost [B*D], mi [B*D], lev [B*D, nC, nC], rec)."""
        D = sbr.shape[0]
        y, x = sbr * bs2, sbc * bs2
        ha = (sbr > 0)[None, :, None]
        hl = (sbc > 0)[None, :, None]
        rm1 = (2 * sbr - 1).clamp(min=0)
        cm1 = (2 * sbc - 1).clamp(min=0)
        above_real = rowbuf[:, rm1[:, None], x[:, None] + ar2[None, :]]
        lrows = (y[:, None] + ar2[None, :]).clamp(max=vh - 1)
        left_real = colbuf[:, lrows, cm1[:, None]]
        corner_real = rowbuf[:, rm1, (x - 1).clamp(min=0)]
        above = torch.where(ha, above_real,
                            torch.where(hl, left_real[..., 0:1], base - 1))
        left = torch.where(hl, left_real,
                           torch.where(ha, above_real[..., 0:1], base + 1))
        ha1, hl1 = ha[..., 0], hl[..., 0]
        corner = torch.where(
            ha1 & hl1, corner_real,
            torch.where(ha1, above_real[..., 0],
                        torch.where(hl1, left_real[..., 0], base)))
        htr = (ha1 & (sbc + 1 < sw)[None, :])[..., None]
        tr_real = rowbuf[:, rm1[:, None],
                         (x + bs2).clamp(max=w - bs2)[:, None] + ar2[None, :]]
        above_ext = torch.cat(
            [above, torch.where(htr, tr_real, above[..., -1:])], -1)
        left_ext = torch.cat(
            [left, left[..., -1:].expand(left.shape[:-1] + (bs2,))], -1)

        fb = lambda t: t.reshape((B * D,) + t.shape[2:])
        f_src = fb(src_sb[:, sbr, sbc])
        f_ha = ha1.expand(B, D).reshape(-1)
        f_hl = hl1.expand(B, D).reshape(-1)
        sbk = (slice(None), sbr, sbc)
        preds, rates, oks = candidates(
            [_intra_pred(m, d, fb(above), fb(left), fb(corner), f_ha, f_hl,
                         bs2, bd, fb(above_ext), fb(left_ext))
             for m, d in cands_sbl], rd["rate_sb"],
            None if kf else inter.intra_ok_sb[sbk].reshape(-1),
            None if kf else step_lanes(inter.sb, inter.rate_sb, inter.ok_sb,
                                       sbk))
        return stack_eval(preds, rates, f_src,
                          lambda p, s, tt: txq_sb(p, s),
                          lam_map[:, 2 * sbr, 2 * sbc].reshape(-1),
                          oks=oks)[:4]

    def step(sk):
        rs4, cs4 = sk[0], sk[1]
        htr4, hbl4 = sk[2] != 0, sk[3] != 0
        D = rs4.shape[1]
        sbr, sbc = rs4[0] // 2, cs4[0] // 2
        sb_cost, sb_mi, sb_lev, sb_rec = eval_sb(sbr, sbc)
        cost_tot = 0.0
        recs = []
        for z in range(4):
            cz, rz = sub_step(rs4[z], cs4[z], htr4[z], hbl4[z])
            cost_tot = cost_tot + cz
            recs.append(rz)
        quad = torch.cat([torch.cat([recs[0], recs[1]], -1),
                          torch.cat([recs[2], recs[3]], -1)], -2)
        lam_sb = lam * lam_map[:, rs4[0], cs4[0]]
        cost_none = sb_cost.reshape(B, D) + lam_sb * rd["bits_none_sb"]
        cost_split = cost_tot + lam_sb * rd["bits_split_sb"]
        fsb = force_sb[:, sbr, sbc]
        use_sb = torch.where(fsb < 0, cost_none < cost_split, fsb == 0)
        rec_fin = torch.where(use_sb[..., None, None],
                              sb_rec.reshape(B, D, bs2, bs2), quad)
        # the boundary buffers take the chosen content (the SB-NONE recon
        # replaces the quad tree's rows and columns when it wins)
        x, y = sbc * bs2, sbr * bs2
        cols2 = x[:, None] + ar2[None, :]
        rows2 = y[:, None] + ar2[None, :]
        rowbuf[:, (2 * sbr)[:, None], cols2] = rec_fin[:, :, bs - 1, :]
        rowbuf[:, (2 * sbr + 1)[:, None], cols2] = rec_fin[:, :, bs2 - 1, :]
        colbuf[:, rows2, (2 * sbc)[:, None]] = rec_fin[:, :, :, bs - 1]
        colbuf[:, rows2, (2 * sbc + 1)[:, None]] = rec_fin[:, :, :, bs2 - 1]
        part_sb[:, sbr, sbc] = (~use_sb).to(i32)
        mi_sb[:, sbr, sbc] = sb_mi.reshape(B, D)
        lev_sb[:, sbr, sbc] = sb_lev.reshape(B, D, nC, nC)
        rec_sb[:, sbr, sbc] = rec_fin

    return step
