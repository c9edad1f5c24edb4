"""All-intra AV1 encoder, flat path (8/10-bit 4:2:0, 32x32 luma blocks).

Counterpart of the flat (part_search=False) path of
``svtav1_tpu/encoder/intra_encoder.py``:
  1. device stage (``device_encode``): the batch's source planes written
     into one of two host staging slots of its size (pinned on a CUDA
     device, reused in turn) and copied to the device from there; one
     luma wavefront (32x32 blocks, TX_32X32, 13 candidate modes, their
     directional ones expanded by the config's angle deltas), one paired
     U+V wavefront (16x16 blocks, TX_16X16, implied chroma tx types, one
     uv_mode per pair), uniform deblocking.  On a CUDA device the wavefronts run the
     hand-written kernel; nothing here synchronises.  Its last step
     queues the batch's host work (``coder_pool``): the copy thread waits
     for the batch's device work, copies its outputs to the host and
     hands each frame to the process's coder pool, where the native C
     tile coder (``ec.native``, each block's angle delta included) codes
     it, while the caller queues the next batch.
  2. host stage (``host_finish``): waits for the batch's frames, then
     writes the key frame OBUs, in call order.
The partition path (``_device_encode_part`` / ``_host_finish_part``, the
default) adds the in-loop filters when they are enabled: per frame, on the
recon's device, CDEF (search, apply), CCSO (search on the host, apply) and
loop restoration (search, apply), in the JAX package's order, then the
Python tile coder signals each tool.  Angle deltas (presets 0-5) expand
the luma candidates of the whole-block and SB depths (the partition path)
or of the flat wavefront; the sub-blocks and chroma keep the base angles.
Every path takes bit_depth 8 or 10 (10-bit: uint16 source and recon
planes, int16 pixel tensors on the device).  The partition path takes
uniform tile columns (``tile_cols``, a power of two dividing the width's
superblocks), as the JAX package does: the tiles ride the scans' batch
axis tile-major (batch index t * n + b), so each codes with its own edges;
the recon planes and partition maps are put back together before the DLF
search and the deblock, which cross tile edges; one tile coder per tile
writes the frame's tile group.  With ``tile_devices`` (a list of devices,
set by ``parallel.mesh``) tile t's scans run on ``tile_devices[t % n]``,
each device's on a host thread of its own, and their outputs are gathered
on the encoder's device before the deblock.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np
import torch

from .. import host_pixels, pix_dtype, resolve_device, upload
from ..ec import native
from ..ops import intra
from ..ops.ccso import ccso_apply_frame
from ..ops.cdef import cdef_apply_params
from ..ops.deblock import (deblock_plane_part, deblock_plane_uniform,
                           dlf_sse_part)
from ..ops.lr_frame import lr_apply_frame
from ..spec import tables as tbl
from ..spec.cdf import CdfContext
from ..spec.txfm import DCT_DCT, TX_16X16, TX_32X32
from ..utils import trace
from . import coder_pool
from .ccso_search import ccso_search_frame
from .cdef_search import (build_skip8, cdef_frame_config_fields,
                          cdef_search_frame)
from .edge import encode_edge, strip_count
from .geometry import (EDGE_M, bottom_force_masks, check_dims, height_m,
                       pad64, pad_plane_bottom)
from .headers import FrameConfig, SequenceConfig, assemble_key_frame
from .lr_search import lr_search_frame
from .tile_codec import TileCoder
from .wavefront import encode_plane_wavefront, expand_candidates
from .wavefront2 import (CHROMA_SB_MODES, CHROMA_SUB_MODES, CHROMA_TOP_MODES,
                         SUB_MODES, encode_plane_wavefront_part)

BLK = 32          # luma block size
CBLK = 16         # chroma block size (4:2:0)

CAND_MODES = (intra.DC_PRED, intra.V_PRED, intra.H_PRED,
              intra.D45_PRED, intra.D135_PRED, intra.D113_PRED,
              intra.D157_PRED, intra.D203_PRED, intra.D67_PRED,
              intra.SMOOTH_PRED, intra.SMOOTH_V_PRED, intra.SMOOTH_H_PRED,
              intra.PAETH_PRED)

# the flat device outputs host_finish copies to the host, and those of
# the edge strip (m = 12 heights: the strip's modes and levels)
_D2H = ("y_mi", "uv_mi", "y_lev", "uv_lev", "y_rec", "uv_rec")
_D2H_EDGE = ("y_emi", "uv_emi", "y_elev", "uv_elev")


def _d2h_keys(dev: dict) -> tuple:
    return _D2H + (_D2H_EDGE if "y_emi" in dev else ())


@lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    return torch.cuda.Stream(device)


def _d2h_stream(dev: dict):
    """The stream (one a card) on which the copy thread copies a flat
    batch's outputs: made to wait for that batch's device work alone, not
    for the kernels queued after it on the main thread's stream, and
    recorded on the tensors it reads."""
    stream = _side_stream(dev["y_rec"].device)
    stream.wait_event(dev["done"])
    for k in _d2h_keys(dev):
        dev[k].record_stream(stream)
    return stream


class _Slot:
    """A flat batch's host staging: its luma [n, ph, w] and U+V
    [2n, ph/2, w/2] (U at 0..n-1, V at n..2n-1) as pixel tensors, pinned
    for a CUDA device; numpy views of the same memory (uint16 at 10 bits,
    the source planes' dtype, so a copy keeps the bits); and the event
    recorded after their H2D (None before the first)."""
    __slots__ = ("y", "uv", "y_np", "uv_np", "event")

    def __init__(self, n: int, ph: int, w: int, bd: int, pinned: bool):
        pix = pix_dtype(bd)
        self.y = torch.empty((n, ph, w), dtype=pix, pin_memory=pinned)
        self.uv = torch.empty((2 * n, ph // 2, w // 2), dtype=pix,
                              pin_memory=pinned)
        view = np.uint8 if bd == 8 else np.uint16
        self.y_np, self.uv_np = (t.numpy().view(view)
                                 for t in (self.y, self.uv))
        self.event = None

    def record(self, device: torch.device) -> None:
        """Mark the end of the H2D copies queued so far on device's
        current stream: the slot may be written again once it has run."""
        if self.event is None:
            self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(device))


def _fill(dst: np.ndarray, planes) -> None:
    """pad_plane_bottom(np.stack(planes), ph) written into dst [k, ph, w]:
    each plane, then its last row repeated down to ph."""
    for b, p in enumerate(planes):
        h = p.shape[0]
        np.copyto(dst[b, :h], p, casting="unsafe")
        dst[b, h:] = dst[b, h - 1]


@dataclass
class EncoderConfig:
    """The JAX package's EncoderConfig, field for field."""
    width: int
    height: int
    qindex: int = 100
    bit_depth: int = 8
    cdf_update: bool = True
    lf_level: int = -1          # -1 -> derive from qindex; 0 -> off
    angle_deltas: tuple = (0,)
    part_search: bool = True
    tile_cols: int = 1
    enable_cdef: bool = False
    enable_lr: bool = False
    enable_ccso: bool = False
    tx_search: bool = True
    filter_search: bool = True
    film_grain: int = 0         # grain synthesis strength 0 (off)..50
    metadata: bytes = b""       # pre-wrapped OBU_METADATA bytes, first TU
    gm_search: bool = True


SB = 64


def tile_stack(a, T: int, axis: int = -1):
    """The T tile columns of a batch of planes or maps (numpy or tensor)
    on the batch axis, tile-major (index t * n + b): [n, ..., w, ...] ->
    [T * n, ..., w / T, ...], w at axis."""
    if T == 1:
        return a
    n = a.shape[axis] // T
    sl = [slice(None)] * a.ndim
    parts = []
    for t in range(T):
        sl[axis] = slice(t * n, (t + 1) * n)
        parts.append(a[tuple(sl)])
    return (torch.cat(parts) if torch.is_tensor(a)
            else np.concatenate(parts))


def tile_unstack(a, T: int, axis: int = 2):
    """tile_stack's inverse (a tensor) along axis (the width axis of a
    [T * n, h, w] plane or a [T * n, bh, bw, ...] map)."""
    if T == 1:
        return a
    n = a.shape[0] // T
    return torch.cat([a[t * n:(t + 1) * n] for t in range(T)], axis)


def _lambda(qindex: int) -> float:
    """The RD lambda of the in-loop filter searches (the JAX package's
    intra_encoder._lambda; mode decision has its own)."""
    dc, ac = tbl.qindex_to_dq(qindex, 8)
    return 0.035 * float(ac) * float(ac) / 16.0


class IntraEncoder:
    # capped CRF: frames over cap_bits re-encode at a higher qindex
    # (set by a caller; 0 disables)
    cap_bits: int = 0
    _CAP_QSTEPS = (24, 48, 88)

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        if cfg.bit_depth not in (8, 10):
            # as the JAX package's verify_settings
            raise ValueError(f"bit_depth must be 8 or 10, got "
                             f"{cfg.bit_depth}")
        filters = cfg.enable_cdef or cfg.enable_lr or cfg.enable_ccso
        check_dims(cfg.width, cfg.height, cfg.part_search,
                   inloop_extras=filters)
        t = cfg.tile_cols
        if t < 1 or (t & (t - 1)):
            raise ValueError("tile_cols must be a power of two")
        if t > 1 and ((cfg.width // SB) % t or not cfg.part_search):
            raise NotImplementedError(
                "tile columns need SB-aligned equal widths and the "
                "partition (general) coding path")
        if filters and not cfg.part_search:
            raise NotImplementedError(
                "CDEF/LR/CCSO ride the partition coding path "
                "(part_search=True)")
        self.cfg = cfg
        self.device = resolve_device(device)
        # the source is padded to SB multiples; the bitstream signals the
        # true frame size and bottom-row blocks overhang it
        self.ph = pad64(cfg.height)
        # the flat path's bottom SB row at m = 12 is the edge strip's
        # chain (encoder/edge.py)
        self.edge = not cfg.part_search and height_m(cfg.height) == EDGE_M
        self.seq = SequenceConfig(cfg.width, cfg.height, cfg.bit_depth,
                                  enable_cdef=cfg.enable_cdef,
                                  enable_restoration=cfg.enable_lr,
                                  ccso_fork_mode=cfg.enable_ccso,
                                  film_grain_params_present=(
                                      cfg.film_grain > 0))
        self._first = True
        self._fg_params = None       # estimated on the first source frame
        self._fg_n = 0               # per-frame grain_seed counter
        # the devices of the tile columns' scans (None: the encoder's)
        self.tile_devices = None
        # the flat path's host staging: {batch size: its two _Slots, the
        # next to use first}
        self._stage_slots = {}
        if not cfg.part_search:
            # the coder pool codes frames in threads, but the native coder's
            # library and the scan tables it reads load lazily and not
            # thread-safely (a first build with gcc, npz reads): load them
            # here, on the constructing thread; a failure raises
            native._load()
            for txs in (TX_32X32, TX_16X16):
                tbl.scan(txs, DCT_DCT)

    def film_grain_for(self, frame):
        """Per-frame film_grain header dict (or None); the grain model is
        estimated from the first frame seen."""
        cfg = self.cfg
        if not cfg.film_grain or cfg.bit_depth != 8:
            return None
        if self._fg_params is None:
            from .noise_model import estimate_grain_params
            p = estimate_grain_params(frame[0], frame[1], frame[2],
                                      strength=cfg.film_grain / 8.0)
            self._fg_params = p if p is not None else False
        if self._fg_params is False:
            return None
        self._fg_n += 1
        seed = (7391 + 3461 * self._fg_n) & 0xFFFF
        return dict(self._fg_params, grain_seed=seed, random_seed=seed)

    def lf_levels(self):
        """(y_vert, y_horz, u, v) filter levels (heuristic from qindex)."""
        if self.cfg.lf_level == 0:
            return (0, 0, 0, 0)
        if self.cfg.lf_level > 0:
            l = min(self.cfg.lf_level, 63)
        else:
            q = self.cfg.qindex
            l = max(0, min(63, (q * q // 1100) + q // 12 - 2))
        lc = max(0, l * 3 // 4)
        return (l, l, lc, lc)

    def _capped_recode(self, frames, payloads, recons, first0: bool):
        if not self.cap_bits:
            return payloads, recons
        for b, p in enumerate(payloads):
            if len(p) * 8 <= self.cap_bits:
                continue
            q0 = self.cfg.qindex
            for step in self._CAP_QSTEPS:
                q2 = min(255, q0 + step)
                sub = IntraEncoder(replace(self.cfg, qindex=q2),
                                   device=self.device)
                sub._first = first0 and b == 0
                sub._fg_params = self._fg_params
                sub.tile_devices = self.tile_devices
                ps, rs = sub.host_finish(sub.device_encode([frames[b]]))
                if len(ps[0]) * 8 <= self.cap_bits or q2 >= 255:
                    break
            payloads[b] = ps[0]
            recons[b] = rs[0]
        return payloads, recons

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        payloads, recons = self.encode_frames([(y, u, v)])
        return payloads[0], recons[0]

    def encode_frames(self, frames):
        return self.host_finish(self.device_encode(frames))

    def _upload(self, planes: np.ndarray, device=None) -> torch.Tensor:
        """Source planes to the device (default the encoder's) as pixel
        tensors (uint8 / int16)."""
        device = self.device if device is None else device
        dt = np.uint8 if self.cfg.bit_depth == 8 else np.int16
        t = torch.from_numpy(np.ascontiguousarray(planes, dt))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def _stage(self, frames) -> _Slot:
        """A flat batch's source planes written into a staging slot of its
        size, bottom rows padded as pad_plane_bottom pads them.  Each size
        has two slots, used in turn and made on first use; a reused slot
        waits for its last H2D first."""
        n = len(frames)
        slots = self._stage_slots.setdefault(n, [])
        reused = len(slots) == 2
        if reused:
            slot = slots.pop(0)
            if slot.event is not None:
                slot.event.synchronize()
        else:
            slot = _Slot(n, self.ph, self.cfg.width, self.cfg.bit_depth,
                         self.device.type == "cuda")
        slots.append(slot)
        trace.count("stage.reused", int(reused))
        _fill(slot.y_np, [f[0] for f in frames])
        _fill(slot.uv_np, [f[1] for f in frames] + [f[2] for f in frames])
        return slot

    def _h2d(self, t: torch.Tensor) -> torch.Tensor:
        """A slot's tensor on the encoder's device: a non-blocking copy on
        a CUDA device, a clone on the CPU (no output shares a slot)."""
        if self.device.type == "cuda":
            return t.to(self.device, non_blocking=True)
        return t.clone()

    def device_encode(self, frames):
        """The device stage of a batch of (y, u, v) frames (uint8, or
        uint16 at 10 bits).  On the flat path it is queued without waiting
        for the device; the partition path waits once, for the DLF level
        search."""
        cfg = self.cfg
        if cfg.part_search:
            return self._device_encode_part(frames)
        # the spans (utils.trace) tile the call: staging (the slot's wait
        # and writes), each plane's upload and launch, the edge strip's
        # enqueue (m = 12 heights), the deblock's enqueue
        with trace.span("enc.stage"):
            slot = self._stage(frames)
        bd = cfg.bit_depth
        vh = None if self.ph == cfg.height else cfg.height
        vhc = None if vh is None else vh // 2
        with trace.span("enc.upload"):
            yt = self._h2d(slot.y)
        with trace.span("enc.launch"):
            y_mi, y_lev, y_rec = encode_plane_wavefront(
                yt, BLK, TX_32X32, cfg.qindex, CAND_MODES, bd,
                tuple(cfg.angle_deltas), valid_h=vh)
        if not self.edge:
            del yt  # each upload is freed once its launches are queued
        # U and V ride one wavefront on the batch axis; paired=True makes
        # each (u, v) pair agree on one uv_mode
        with trace.span("enc.upload"):
            uvt = self._h2d(slot.uv)
            if self.device.type == "cuda":
                slot.record(self.device)
        with trace.span("enc.launch"):
            uv_mi, uv_lev, uv_rec = encode_plane_wavefront(
                uvt, CBLK, TX_16X16, cfg.qindex, CAND_MODES, bd,
                valid_h=vhc, paired=True, kf="uv", uv_tx=True)
        strip = {}
        if self.edge:
            # the bottom SB row, after every SB row above it, on the same
            # stream
            with trace.span("enc.edge"), \
                    trace.device_span("dev.edge", self.device):
                strip["y_emi"], strip["y_elev"] = encode_edge(
                    yt, y_mi, y_lev, y_rec, BLK, cfg.qindex, CAND_MODES, bd,
                    tuple(cfg.angle_deltas), valid_h=vh)
                strip["uv_emi"], strip["uv_elev"] = encode_edge(
                    uvt, uv_mi, uv_lev, uv_rec, CBLK, cfg.qindex,
                    CAND_MODES, bd, valid_h=vhc, paired=True, uv_tx=True)
            trace.count("edge.blocks",
                        len(frames) * strip_count(cfg.width, BLK))
            del yt
        del uvt
        lf = self.lf_levels()
        pix = pix_dtype(bd)
        with trace.span("enc.deblock"), \
                trace.device_span("dev.deblock", self.device):
            if lf[0] or lf[1]:
                y_rec = deblock_plane_uniform(y_rec, BLK, 14, lf[0], lf[1],
                                              bd=bd, valid_h=vh)
                uv_rec = deblock_plane_uniform(uv_rec, CBLK, 6, lf[2], lf[2],
                                               bd=bd, valid_h=vhc)
            y_rec, uv_rec = y_rec.to(pix), uv_rec.to(pix)
        done = None
        if self.device.type == "cuda":
            # the end of the batch's device work, which its copy job waits on
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        dev = {"n": len(frames), "y_mi": y_mi, "uv_mi": uv_mi,
               "y_lev": y_lev, "uv_lev": uv_lev, "y_rec": y_rec,
               "uv_rec": uv_rec, "frames": frames, "done": done, **strip}
        self._queue(dev, threading.Event())
        return dev

    def _queue(self, dev, entered: threading.Event) -> None:
        """Queue a flat batch's host work on the copy thread (_fetch) and
        add its future to dev ("job"), with the event host_finish sets on
        entry ("entered"): a frame whose coder call begins before it is
        set counts one to coder.ahead."""
        cfg, ph = self.cfg, self.ph
        # built on this thread: CdfContext's first load is not
        # thread-safe; the coder copies its tables, so frames share one
        cands = expand_candidates(CAND_MODES, tuple(cfg.angle_deltas))
        cand_mode, cand_delta = (np.array(a, np.int32) for a in zip(*cands))
        uv_mode = np.array([m for m, _ in expand_candidates(CAND_MODES)],
                           np.int32)
        cdf = CdfContext(cfg.qindex)

        def code_one(y_mi, y_lev, u_lev, v_lev, uv_mi, strip=None):
            trace.count("coder.ahead", int(not entered.is_set()))
            edge = None
            if strip is not None:
                e_mi, e_lev, eu_lev, ev_lev, euv_mi = strip
                edge = (cand_mode[e_mi], e_lev, eu_lev, ev_lev,
                        uv_mode[euv_mi], cand_delta[e_mi])
            with trace.span("coder.frame"):
                # through the module attribute, which a caller may wrap
                return native.encode_tile_intra(
                    cfg.width, ph, cfg.cdf_update, cand_mode[y_mi], y_lev,
                    u_lev, v_lev, cdf, true_h=cfg.height,
                    uv_modes=uv_mode[uv_mi], y_deltas=cand_delta[y_mi],
                    edge=edge)

        dev["entered"] = entered
        dev["job"] = coder_pool.copier().submit(self._fetch, dev, code_one)

    def _fetch(self, dev, code_one):
        """A flat batch's copy job, on the copy thread: wait for the
        batch's device work, copy its outputs to the host, read the
        kernel's error word, then submit each frame's code_one to the
        coder pool.  Returns the host recons (luma, U+V) and the frames'
        futures."""
        n, bd, done = dev["n"], self.cfg.bit_depth, dev["done"]
        with trace.span("fin.wait"):
            if done is not None:
                done.synchronize()
        with trace.span("fin.d2h"), (
                nullcontext() if done is None
                else torch.cuda.stream(_d2h_stream(dev))):
            y_mi = dev["y_mi"].cpu().numpy()
            uv_mi = dev["uv_mi"].cpu().numpy()[:n]  # halves agree (paired)
            y_lev = dev["y_lev"].cpu().numpy()
            uv_lev = dev["uv_lev"].cpu().numpy()
            y_rec = host_pixels(dev["y_rec"], bd)
            uv_rec = host_pixels(dev["uv_rec"], bd)
            strip = None
            if "y_emi" in dev:
                strip = [dev[k].cpu().numpy() for k in _D2H_EDGE]
            if done is not None:
                # the kernel's error word; the copies above already waited
                from ..cuda.wavefront_kernel import raise_on_error
                raise_on_error(dev["y_rec"].device)
        pool = coder_pool.coders()
        # the strip's per frame: (modes, luma levels, U levels, V levels,
        # uv modes); U and V ride the batch axis [2n, ...] as the planes
        edge = [None] * n if strip is None else [
            (strip[0][b], strip[2][b], strip[3][b], strip[3][n + b],
             strip[1][b]) for b in range(n)]
        return (y_rec, uv_rec), [
            pool.submit(code_one, y_mi[b], y_lev[b], uv_lev[b],
                        uv_lev[n + b], uv_mi[b], edge[b]) for b in range(n)]

    def _part_scans(self, yt, ut, vt, device):
        """The luma partition scan of yt [N, h, w] and the paired U+V scan
        of (ut, vt) [N, h/2, w/2] on device (numpy planes in, tensors
        out): the luma scan's ten outputs, then U's and V's (lev, slev,
        lev_sb, rec) and (uv_mi, uv_smi, uv_mi_sb), each [N, ...]."""
        cfg = self.cfg
        bd = cfg.bit_depth
        N, h, w = yt.shape
        vh = None if self.ph == cfg.height else cfg.height
        vhc = None if vh is None else vh // 2
        fp, fsb = (upload(np.ascontiguousarray(np.broadcast_to(
            a, (N,) + a.shape)), device) for a in bottom_force_masks(
                h // BLK, w // BLK, h // 64, w // 64, cfg.height // 4))
        luma = encode_plane_wavefront_part(
            self._upload(yt, device), BLK, cfg.qindex, fp, fsb,
            tx_search=cfg.tx_search, valid_h=vh, bd=bd,
            angle_deltas=tuple(cfg.angle_deltas))
        part, part_sb = luma[0], luma[7]
        # U and V ride one paired wavefront: the partition tree is forced
        # by luma and each (u, v) pair picks one uv_mode
        two = lambda a: torch.cat([a, a])
        (_, uv_mi, uv_lev, uv_smi, uv_slev, _, uv_rec,
         _, uv_mi_sb, uv_lev_sb) = encode_plane_wavefront_part(
            self._upload(np.concatenate([ut, vt]), device), CBLK,
            cfg.qindex, two(part), two(part_sb), chroma=True, valid_h=vhc,
            bd=bd)
        return luma + tuple(a[k * N:(k + 1) * N] for k in (0, 1) for a in (
            uv_lev, uv_slev, uv_lev_sb, uv_rec)) + (
                uv_mi[:N], uv_smi[:N], uv_mi_sb[:N])

    def _tile_scans(self, yt, ut, vt, B):
        """_part_scans of the tile-stacked planes ([T * B, ...]), on the
        encoder's device or, with tile_devices (n of them), tile t's on
        tile_devices[t % n]: each device's tiles in one call on a host
        thread of its own, the outputs gathered on the encoder's device in
        tile order."""
        T = self.cfg.tile_cols
        devs = [resolve_device(d)
                for d in (self.tile_devices or [self.device])][:T]
        n = len(devs)

        def group(k):
            idx = slice(None) if n == 1 else np.concatenate(
                [np.arange(t * B, (t + 1) * B) for t in range(k, T, n)])
            with (torch.cuda.device(devs[k]) if devs[k].type == "cuda"
                  else nullcontext()):
                return self._part_scans(yt[idx], ut[idx], vt[idx], devs[k])

        if n == 1:
            return [a.to(self.device) for a in group(0)]
        with ThreadPoolExecutor(max_workers=n) as ex:
            outs = list(ex.map(group, range(n)))
        # tile t is the (t // n)-th of group t % n
        return [torch.cat([outs[t % n][i][t // n * B:(t // n + 1) * B].to(
            self.device) for t in range(T)]) for i in range(len(outs[0]))]

    def _device_encode_part(self, frames):
        """Partition-path device stage.  Returns the JAX package's "part"
        tuple, with tensors on the encoder's device and the recon planes
        as pixel tensors (uint8, or int16 at 10 bits): the maps and levels
        with the tile columns on the batch axis (tile-major, T * n), the
        recon planes whole ([n, h, w])."""
        cfg = self.cfg
        bd = cfg.bit_depth
        B = len(frames)
        T = cfg.tile_cols
        yb = pad_plane_bottom(np.stack([f[0] for f in frames]), self.ph)
        ub, vb = (pad_plane_bottom(np.stack([f[k] for f in frames]),
                                   self.ph // 2) for k in (1, 2))
        vh = None if self.ph == cfg.height else cfg.height
        vhc = None if vh is None else vh // 2
        yt, ut, vt = (tile_stack(a, T) for a in (yb, ub, vb))
        outs = self._tile_scans(yt, ut, vt, B)
        (part, y_mi, y_lev, y_smi, y_slev, y_stx, y_rec, part_sb, y_mi_sb,
         y_lev_sb, u_lev, u_slev, u_lev_sb, u_rec, v_lev, v_slev, v_lev_sb,
         v_rec, uv_mi, uv_smi, uv_mi_sb) = outs
        # the loop filter crosses tile edges: whole planes and maps
        y_rec, u_rec, v_rec, part_f, part_sb_f = (
            tile_unstack(a, T) for a in (y_rec, u_rec, v_rec, part,
                                         part_sb))
        lf = self.lf_levels()
        if cfg.lf_level < 0:
            # frame-level DLF level search: luma levels around the
            # heuristic, SSE summed over the batch; the level is picked on
            # the host (the path's one read from the device)
            base = lf[0]
            cand = [0, max(1, base // 2), max(1, base * 3 // 4),
                    max(1, base), base * 5 // 4 + 1, base * 3 // 2 + 1]
            cand = [min(63, c) for c in cand]
            sse = dlf_sse_part(y_rec, self._upload(yb), part_f, cand, BLK,
                               14, bd=bd, part_sb=part_sb_f,
                               valid_h=vh).cpu().numpy()
            l = int(cand[int(np.argmin(sse))])
            lc = max(0, l * 3 // 4)
            lf = (l, l, lc, lc)
        if lf[0] or lf[1]:
            y_rec = deblock_plane_part(y_rec, part_f, BLK, 14, lf[0], lf[1],
                                       bd=bd, part_sb=part_sb_f, valid_h=vh)
            u_rec = deblock_plane_part(u_rec, part_f, CBLK, 6, lf[2], lf[2],
                                       bd=bd, part_sb=part_sb_f, valid_h=vhc)
            v_rec = deblock_plane_part(v_rec, part_f, CBLK, 6, lf[3], lf[3],
                                       bd=bd, part_sb=part_sb_f, valid_h=vhc)
        pix = lambda a: a.to(pix_dtype(bd))
        return ("part", B, part, y_mi, y_lev, y_smi, y_slev, u_lev, u_slev,
                v_lev, v_slev, y_stx, pix(y_rec), pix(u_rec), pix(v_rec),
                frames, part_sb, y_mi_sb, y_lev_sb, u_lev_sb, v_lev_sb,
                uv_mi, uv_smi, uv_mi_sb, lf)

    def _filter_frame(self, frame, rec, skip8_args, qindex: int = None):
        """The in-loop filters of one frame (those enabled), in the JAX
        package's order, on the recon's device.  rec: the deblocked
        (y, u, v) tensors; skip8_args: build_skip8's arrays (numpy) of
        each tile column, left to right; qindex: the frame's (default the
        config's).  Returns (filtered planes, CDEF params, CCSO info, LR
        frame types, LR units)."""
        cfg = self.cfg
        q = cfg.qindex if qindex is None else qindex
        cdef_params = ccso_info = lr_infos = None
        lr_types = (0, 0, 0)
        if not (cfg.enable_cdef or cfg.enable_ccso or cfg.enable_lr):
            return rec, cdef_params, ccso_info, lr_types, lr_infos
        lam = _lambda(q)
        src = tuple(upload(p, self.device) for p in frame)
        if cfg.enable_cdef:
            skip8 = np.concatenate([build_skip8(*a) for a in skip8_args],
                                   axis=1)
            cdef_params = cdef_search_frame(src, rec, skip8, q, lam,
                                            cfg.bit_depth)
            db = rec
            rec = cdef_apply_params(rec, skip8, cdef_params, cfg.bit_depth)
        if cfg.enable_ccso:
            # the fork's graft, between CDEF and LR: it classifies on the
            # pre-CDEF luma and corrects the post-CDEF planes
            if not cfg.enable_cdef:
                db = rec
            ccso_info = ccso_search_frame(
                tuple(np.asarray(p, np.int64) for p in frame),
                tuple(p.cpu().numpy() for p in rec), db[0].cpu().numpy(),
                lam, cfg.bit_depth)
            if ccso_info is not None:
                rec = ccso_apply_frame(rec, db[0], ccso_info, cfg.bit_depth)
        if cfg.enable_lr:
            # LR filters the post-CDEF/CCSO planes with its stripes'
            # context rows from the pre-CDEF planes
            if not cfg.enable_cdef and not cfg.enable_ccso:
                db = rec
            lr_types, lr_infos = lr_search_frame(src, rec, lam,
                                                 cfg.bit_depth)
            if any(lr_types):
                rec = lr_apply_frame(rec, db, lr_infos, cfg.bit_depth)
        return rec, cdef_params, ccso_info, lr_types, lr_infos

    def _host_finish_part(self, dev):
        """Partition-path host stage: the in-loop filters (when enabled)
        and the Python tile coder of each tile column, per frame."""
        first0 = self._first
        cfg = self.cfg
        n, frames, lfv = dev[1], dev[15], dev[24]
        (part, y_mi, y_lev, y_smi, y_slev, u_lev, u_slev, v_lev, v_slev,
         y_stx) = (t.cpu().numpy() for t in dev[2:12])
        (part_sb, y_mi_sb, y_lev_sb, u_lev_sb, v_lev_sb, uv_mi, uv_smi,
         uv_mi_sb) = (t.cpu().numpy() for t in dev[16:24])
        uv_mode = lambda modes, mi: np.array(
            [m for m, _ in expand_candidates(modes)], np.int32)[mi]
        uv_top = uv_mode(CHROMA_TOP_MODES, uv_mi)
        uv_sub = uv_mode(CHROMA_SUB_MODES, uv_smi)
        uv_sb = uv_mode(CHROMA_SB_MODES, uv_mi_sb)
        cands = expand_candidates(CAND_MODES, tuple(cfg.angle_deltas))
        cands_sub = expand_candidates(SUB_MODES)
        ch, cch = cfg.height, cfg.height // 2
        T = cfg.tile_cols
        tw = cfg.width // T
        sbw_t = tw // SB
        payloads, recons = [], []
        for b in range(n):
            tiles_b = [t * n + b for t in range(T)]     # tile-major batch
            rec, cdef_params, ccso_info, lr_types, lr_infos = \
                self._filter_frame(frames[b], tuple(
                    dev[k][b] for k in (12, 13, 14)), [(
                        part[i], y_lev[i], u_lev[i], v_lev[i], y_slev[i],
                        u_slev[i], v_slev[i], part_sb[i], y_lev_sb[i],
                        u_lev_sb[i], v_lev_sb[i]) for i in tiles_b])
            tiles = []
            for t, i in enumerate(tiles_b):
                sl = slice(t * sbw_t, (t + 1) * sbw_t)
                tc = TileCoder(tw, self.ph, cfg.qindex, cfg.cdf_update,
                               true_h=cfg.height,
                               cdef_bits=(cdef_params["bits"] if cdef_params
                                          else 0),
                               cdef_idx=(cdef_params["idx_map"][:, sl]
                                         if cdef_params else None),
                               mi_col_off=t * tw // 4,
                               frame_mi_cols=cfg.width // 4)
                tc.ccso_info = ccso_info
                if any(lr_types):
                    tc.set_lr(lr_types, [
                        None if u is None else {k: a[:, sl]
                                                for k, a in u.items()}
                        for u in lr_infos])
                tile, _ = tc.encode(
                    part[i], y_mi[i], y_lev[i], u_lev[i], v_lev[i],
                    y_smi[i], y_slev[i], u_slev[i], v_slev[i], cands,
                    cands_sub, y_stx[i], part_sb[i], y_mi_sb[i],
                    y_lev_sb[i], u_lev_sb[i], v_lev_sb[i], uv_top[i],
                    uv_sub[i], uv_sb[i])
                tiles.append(tile)
            fr = FrameConfig(base_q_idx=cfg.qindex,
                             disable_cdf_update=not cfg.cdf_update,
                             filter_level=(lfv[0], lfv[1]),
                             filter_level_u=lfv[2], filter_level_v=lfv[3],
                             tile_cols_log2=T.bit_length() - 1,
                             lr_frame_types=lr_types, ccso=ccso_info,
                             film_grain=self.film_grain_for(frames[b]),
                             **(cdef_frame_config_fields(cdef_params)
                                if cdef_params else {}))
            payloads.append(assemble_key_frame(
                self.seq, fr, tiles if T > 1 else tiles[0],
                first=self._first,
                metadata=cfg.metadata if self._first else b""))
            self._first = False
            y, u, v = (host_pixels(p, cfg.bit_depth) for p in rec)
            recons.append((y[:ch], u[:cch], v[:cch]))
        return self._capped_recode(frames, payloads, recons, first0)

    def host_finish(self, dev):
        """Entropy-code a device batch: wait for its host work, which
        device_encode queued (queue it again if a call before collected
        it), then write its OBUs.  Returns (payloads, recons) with recons
        as numpy planes, uint8 (or uint16 at 10 bits); an error of the
        batch's copies or coder calls is raised here."""
        if isinstance(dev, tuple) and dev and dev[0] == "part":
            return self._host_finish_part(dev)
        cfg = self.cfg
        first0 = self._first
        n, frames = dev["n"], dev["frames"]
        if "job" not in dev:
            entered = threading.Event()
            entered.set()
            self._queue(dev, entered)
        dev["entered"].set()
        job = dev.pop("job")
        # the spans (utils.trace): the wait for the batch's copies and
        # frames (fin.wait and fin.d2h are the copy job's), the OBUs
        with trace.span("fin.coder"):
            (y_rec, uv_rec), coded = job.result()
            tiles = [f.result() for f in coded]
        trace.count("d2h.bytes",
                    sum(dev[k].nbytes for k in _d2h_keys(dev)))
        u_rec, v_rec = uv_rec[:n], uv_rec[n:]

        with trace.span("fin.obu"):
            lfv = self.lf_levels()
            ch, cch = cfg.height, cfg.height // 2
            payloads, recons = [], []
            for b in range(n):
                fr = FrameConfig(base_q_idx=cfg.qindex,
                                 disable_cdf_update=not cfg.cdf_update,
                                 filter_level=(lfv[0], lfv[1]),
                                 filter_level_u=lfv[2], filter_level_v=lfv[3],
                                 film_grain=self.film_grain_for(frames[b]))
                payloads.append(assemble_key_frame(
                    self.seq, fr, tiles[b], first=self._first,
                    metadata=cfg.metadata if self._first else b""))
                self._first = False
                recons.append((y_rec[b][:ch], u_rec[b][:cch],
                               v_rec[b][:cch]))
            return self._capped_recode(frames, payloads, recons, first0)
