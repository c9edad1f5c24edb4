"""Low-delay video encoder: a key frame, then P frames that each reference
the previous frame's reconstruction.

Counterpart of the low-delay partition path of
``svtav1_tpu/encoder/video_encoder.py`` (the reference's flat prediction
structure, EbPredictionStructure.c:77 low-delay P): key frames go through
the port's ``IntraEncoder`` at the boosted key-frame qindex; a P frame
(``_encode_p_part``) runs on the planes' device
  1. motion estimation at 32, 16 and 64 against the previous recon, and
     the median-of-neighbours mv predictors;
  2. the translation global-motion fit and the frame's interpolation
     filter pick (both read back to the host, as in the JAX package);
  3. motion compensation of three single-reference lanes per block (NEWMV
     at the searched mv, GLOBALMV at the fit, the predicted mv) at each
     depth, with their rate estimates;
  4. the luma partition scan with those lanes (``wavefront2.InterLanes``),
     then chroma motion compensation at the luma decisions' mvs and the
     paired U+V scan with the inter/intra choice forced by luma;
  5. the DLF level search (one host read) and the partition deblock;
then on the host the in-loop filters when enabled (``IntraEncoder.
_filter_frame``), the Python tile coder's inter branch and the inter frame
header.  The frame's end-of-frame CDFs seed the next P frame's
(primary_ref_frame 0; with cdf_update off there is no chain and it is 7).

With part_search off (presets M11-M13, ``--no-part-search``) a P frame
(``_encode_p_flat``, the JAX package's flat ``_encode_p``) codes 32x32
blocks: motion estimation at 32, the GM fit and the filter pick, motion
compensation of two lanes (NEWMV at the searched mv, GLOBALMV at the fit),
one mixed luma wavefront (13 intra candidates and the two lanes), chroma
motion compensation at the chosen mvs and one wavefront for U and V (DC or
the inter lane, as luma chose), uniform deblocking at the heuristic level,
then the flat inter tile coder (``tile_inter.encode_inter_tile``).  On a
CUDA device both wavefronts run the hand-written kernel.

Rate control (``rate_control.RateControl``, CQ / CRF / CBR / VBR) sets the
base qindex on every low-delay path: a key frame at 0.7 of it, a P frame at
it, the controller fed each frame's bytes.

With ``pyramid=True``, frames buffer into hierarchical mini-GoPs (the
reference's prediction structures, EbPredictionStructure.c:77-161): a
scene cut or the key frame interval starts a key frame; each mini-GoP (the
largest power of two, up to ``gop``, that crosses neither) codes its last
frame first as a no-show anchor referencing the previous anchor, then
bisects; show_existing overlays display them in order.  Each layer has its
own qindex (the anchor's from a TPL-lite measure of how well the GoP is
predicted), its own DPB slot, CDF snapshot and GM parameters; references
more than 4 frames away search with the long-range level of ``me.py``.
On the flat path each interior frame is a no-show P frame referencing the
nearer (by decimated SAD) of its interval's two ends.  On the partition
path (the compound pyramid) each interior frame is compound: LAST is its
interval's low end and ALTREF its high end, a second motion search runs
against ALTREF, two compound lanes (NEW_NEWMV at both searched mvs,
GLOBAL_GLOBALMV) join the three single-reference lanes at each depth and
their chroma predictions are compound too; its RD lambda carries the
layer's weight (``LAYER_LAM``), and the anchor's scans take the GoP's
per-block TPL lambda map.  With ``tf=True`` the anchors' and key frames'
sources are temporally filtered first (``ops/tf.py``).  Every path takes
bit_depth 8 or 10 (the DPB then holds uint16 planes), and the config's
angle deltas (presets 0-5): they expand the luma intra candidates of the
partition scan's whole-block and SB depths, or of the flat P frame's
mixed wavefront; the sub-blocks and chroma keep the base angles.  On the
partition path every frame takes the config's tile columns, as the JAX
package's does: motion estimation, the mv predictors and motion
compensation run over the whole frame (the predictors are not cut at tile
edges, as in the JAX package), then the scans' inputs ride the batch axis
tile-major, their outputs are put back together for the mvs, the chroma
prediction, the DLF search and the deblock, and one tile coder per tile
writes the frame (the frame's end CDFs are tile 0's, context_update_tile_id
0).
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import replace
from functools import lru_cache

import numpy as np
import torch

from .. import host_pixels, pix_dtype, upload
from ..ops.deblock import (deblock_plane_part, deblock_plane_uniform,
                           dlf_sse_part)
from ..ops.mc import (pad_plane, predict_inter_blocks,
                      predict_inter_blocks_compound)
from ..ops.tf import temporal_filter_frame
from ..spec.txfm import TX_16X16, TX_32X32
from .cdef_search import cdef_frame_config_fields
from .geometry import bottom_force_masks, pad_plane_bottom
from .headers import FrameConfig, assemble_frame, assemble_show_existing
from .intra_encoder import (CAND_MODES, EncoderConfig, IntraEncoder,
                            tile_stack, tile_unstack)
from .me import _blocks, motion_estimate
from .tile_codec import TileCoder
from .tile_inter import encode_inter_tile
from .wavefront import encode_plane_wavefront_mixed, expand_candidates
from .wavefront2 import (CHROMA_SB_MODES, CHROMA_SUB_MODES, CHROMA_TOP_MODES,
                         SUB_MODES, InterLanes, encode_plane_wavefront_part)

BLK = 32
CBLK = 16
# lanes 0 NEWMV (the searched mv), 1 GLOBALMV, 2 the mvp; a compound frame
# adds 3 NEW_NEWMV (the mvs searched against LAST and ALTREF) and 4
# GLOBAL_GLOBALMV
N_LANES = 3
MODE_NEW = 5.0       # NEWMV mode + DRL signalling bits
MODE_NEAR = 3.0      # NEAREST/GLOBAL-class signalling bits
_INV_LN2 = float(np.float32(1.0 / np.log(2.0)))
# the rates of the flat P frame's NEWMV lane (14 + 2.5 (log2(1+|mvy|) +
# log2(1+|mvx|)) bits) and GLOBALMV lane
R_NEW, R_NEW_MV, R_ZERO = 14.0, 2.5, 6.0
# |mv| of a 32x32 ME field, in 1/8 pel, stays below (2 (2 * 16 + 2) + 2) *
# 8 + 6 = 566 (motion_estimate's ranges)
LOG2_N = 1024
# the P frame's host maps on the superblock grid (the others are on the
# 32x32 grid)
_SB_MAPS = ("part_sb", "y_mi_sb", "y_lev_sb", "u_lev_sb", "v_lev_sb",
            "uv_mi_sb", "mv_sb", "mv64")


def _pick_interp_filt(src, refp, y0, x0, mv8f, h, w, bd=8):
    """Frame-level interpolation filter: the SAD of the luma prediction at
    the 32x32 blocks' searched mvs under REGULAR / SMOOTH / SHARP, summed
    over the blocks with a subpel mv (an integer mv predicts the same under
    every filter), argmin; 0 when no mv is subpel.  Reads back to the host
    (the JAX package's does too)."""
    src_b = _blocks(src.to(torch.int32), BLK)
    subpel = ((mv8f & 7) != 0).any(-1)
    if not bool(subpel.any()):
        return 0
    costs = torch.stack([
        ((predict_inter_blocks(refp, y0, x0, mv8f, h, w, BLK, 0, bd, f) -
          src_b).abs().sum((-1, -2)) * subpel).sum() for f in range(3)])
    return int(torch.argmin(costs.cpu()))


def _mv_pred(field):
    """Neighbour-consistent mv predictor of each block: the per-component
    median of its left and above neighbours' mvs and zero (an absent
    neighbour counts as zero).  field [B, bh, bw, 2] int32."""
    z = torch.zeros_like(field)
    left = torch.cat([z[:, :, :1], field[:, :, :-1]], 2)
    above = torch.cat([z[:, :1], field[:, :-1]], 1)
    lo, hi = torch.minimum(left, above), torch.maximum(left, above)
    return torch.maximum(lo, torch.minimum(hi, z))


def _mv_bits(m, pred):
    """NEWMV residual bits against the predicted mv: ~4 + 1.4 log2(1+|d|)
    a nonzero component, 0.7 a zero one (float32, the JAX package's
    expression order).  XLA's float32 log2 is log(x) * (1 / ln 2), which
    this computes the same way."""
    d = (m - pred).to(torch.float32).abs()
    cb = lambda a: torch.where(a > 0, 4.0 + 1.4 * (torch.log(1.0 + a) *
                                                   _INV_LN2), 0.7)
    return cb(d[..., 0]) + cb(d[..., 1])


@lru_cache(maxsize=None)
def _log2_1p(device: str) -> torch.Tensor:
    """log2(1 + d) of the integers 0 <= d < LOG2_N as float32, the way XLA
    computes a float32 log2 (log(x) * f32(1 / ln 2)), made once on the
    host: the flat NEWMV rate gathers from it, so the card's rates equal
    the CPU's by construction."""
    t = torch.log(1.0 + torch.arange(LOG2_N, dtype=torch.float32)) * _INV_LN2
    return upload(t.numpy(), device)


def _flat_new_rate(mv8):
    """The flat NEWMV lane's rate [B, bh, bw] float32 from the ME field
    [B, bh, bw, 2]: two rounded float32 operations on the table's sum, as
    in the JAX package."""
    lg = _log2_1p(str(mv8.device))[mv8.abs().long()]
    return R_NEW + R_NEW_MV * (lg[..., 0] + lg[..., 1])


class VideoEncoder:
    """Low-delay I/P encoder, or hierarchical mini-GoPs with ``pyramid``;
    keyint=1 degenerates to all-intra."""

    # per-layer RD lambda weights of the compound pyramid: interior layers
    # price rate harder (the reference's layer lambda weighting)
    LAYER_LAM = (1.0, 1.0, 1.15, 1.3, 1.45)

    def __init__(self, cfg: EncoderConfig, keyint: int = 64,
                 pyramid: bool = False, gop: int = 16, tf: bool = False,
                 rc=None, device="cuda"):
        self.cfg = cfg
        self.keyint = max(1, keyint)
        self.pyramid = pyramid and self.keyint > 1
        # key frames get a quality boost (the reference's CRF kf_qindex
        # scaling, EbRateControlProcess.c:782)
        kf_q = max(2, int(round(cfg.qindex * 0.7))) if keyint > 1 \
            else cfg.qindex
        self.kf_cfg = replace(cfg, qindex=kf_q)
        self.intra = IntraEncoder(self.kf_cfg, device=device)
        self.device = self.intra.device
        self.seq = self.intra.seq
        self._idx = 0
        self._dpb = None              # (y, u, v) post-filter recon, numpy
        self._cdf_state = None        # frame-end CDFs (primary-ref chain)
        self._slot_gm = {}            # DPB slot -> saved gm_mv dict
        self._fg_n = 0                # inter-frame grain_seed counter
        self.rc = rc                  # RateControl (None: fixed qindex)
        # the pyramid's state: pending sources (lookahead) and, per DPB
        # slot, the recon, frame-end CDFs and display index
        self.gop = min(16, max(1, gop))
        self.tf = tf and self.pyramid
        self._buf = []
        self._slots = {}
        self._slot_cdf = {}
        self._slot_t = {}
        self._anchor_slot = 0
        self._lam_map_np = None       # the GoP anchor's TPL lambda map
        # scene-change state: keyint is the MAX interval, cuts insert key
        # frames (scene_transition_detector analogue)
        self._kf_at = 0               # next forced-KF display index
        self._tail_src = None         # last source luma, decimated 4x
        self._buf_sad = []            # decimated SAD vs previous source
        self._sad_hist = []           # recent non-cut SADs
        self.last_p = None            # host maps of the last P frame

    def mark_continuation(self):
        """A GOP chunk after the first (``parallel.mesh``): its key frame
        writes no sequence header, which the first chunk writes once."""
        self.intra._first = False

    def encode_frames(self, frames):
        """Encode (y, u, v) frames, uint8 (uint16 at 10 bits): (payloads
        in decode order, recons
        in display order).  Low-delay: one of each a frame.  Pyramid: the
        frames buffer until a mini-GoP is complete (call flush() at the end
        of the stream), and the payloads include show_existing overlay
        TUs, so there are more payloads than recons."""
        if self.pyramid:
            for f in frames:
                y = np.asarray(f[0], np.int32)[::4, ::4]
                self._buf_sad.append(0.0 if self._tail_src is None else
                                     float(np.abs(y - self._tail_src).mean()))
                self._tail_src = y
                self._buf.append(f)
            return self._drain(final=False)
        payloads, recons = [], []
        for f in frames:
            p, r = self.encode_frame(*f)
            payloads.append(p)
            recons.append(r)
        return payloads, recons

    def flush(self):
        """Encode whatever is still buffered (the pyramid's tail)."""
        if not self.pyramid:
            return [], []
        return self._drain(final=True)

    def _is_cut(self, sad_pp: float) -> bool:
        """Scene cut: large absolute per-pixel SAD and an outlier against
        the recent motion level."""
        if sad_pp < 26.0:
            return False
        base = np.median(self._sad_hist) if self._sad_hist else 0.0
        return sad_pp > 3.5 * max(base, 2.0)

    def _base_q(self) -> int:
        """The base qindex: rate control's, or the config's."""
        return self.rc.base_q if self.rc is not None else self.cfg.qindex

    def _key_q(self):
        """Under rate control, re-qindex the key frame's encoder at 0.7 of
        the base q (all-intra: at it)."""
        if self.rc is None:
            return
        q = self._base_q()
        kf_q = max(2, int(round(q * 0.7))) if self.keyint > 1 else q
        if kf_q != self.intra.cfg.qindex:
            self.intra.cfg = replace(self.intra.cfg, qindex=kf_q)

    def encode_frame(self, y, u, v):
        yd = np.asarray(y, np.int32)[::4, ::4]
        cut = False
        if self._tail_src is not None:
            s = float(np.abs(yd - self._tail_src).mean())
            cut = self._is_cut(s)
            if not cut:
                self._sad_hist = (self._sad_hist + [s])[-16:]
        self._tail_src = yd
        if self._idx >= self._kf_at or cut or self._dpb is None:
            self._kf_at = self._idx + self.keyint
            self._key_q()
            payloads, recons = self.intra.encode_frames([(y, u, v)])
            payload, rec = payloads[0], recons[0]
            self._cdf_state = None    # key frames reset the CDF chain
        else:
            q = self._base_q()
            if self.cfg.part_search:
                payload, rec, _ = self._encode_p_part(y, u, v, qindex=q)
            else:
                payload, rec, _ = self._encode_p_flat(y, u, v, q)
        if self.rc is not None:
            self.rc.update(len(payload), 1)
        self._dpb = tuple(np.asarray(p) for p in rec)
        self._idx += 1
        return payload, rec

    # ------------------------------------------- hierarchical mini-GoPs

    def _consume_sad(self, k: int):
        for s in self._buf_sad[:k]:
            if not self._is_cut(s):
                self._sad_hist = (self._sad_hist + [s])[-16:]
        del self._buf_sad[:k]

    def _drain(self, final: bool):
        payloads, recons = [], []
        while self._buf:
            if (self._idx >= self._kf_at or
                    (self._buf_sad and self._is_cut(self._buf_sad[0]))):
                self._consume_sad(1)
                self._kf_at = self._idx + self.keyint
                f = self._buf.pop(0)
                self._key_q()
                if self.tf:
                    f = self._tf_filter(f, [], self._buf[:3],
                                        self.intra.cfg.qindex)
                ps, rs = self.intra.encode_frames([f])
                if self.rc is not None:
                    self.rc.update(sum(len(p) for p in ps), 1)
                # a key frame refreshes every slot: its recon, no CDF
                # snapshot, identity GM
                self._slots = {0: tuple(np.asarray(p) for p in rs[0])}
                self._slot_cdf = {}
                self._slot_t = {0: self._idx}
                self._slot_gm = {}
                self._anchor_slot = 0
                self._idx += 1
                payloads += ps
                recons.append(rs[0])
                continue
            target = min(self.gop, self._kf_at - self._idx)
            avail = len(self._buf)
            if avail < target and not final:
                break
            n = min(target, avail)
            # a mini-GoP never crosses a scene cut: the cut frame starts
            # the next (key) GoP
            for i in range(1, n):
                if self._is_cut(self._buf_sad[i]):
                    n = i
                    break
            g = 1 << (n.bit_length() - 1)      # largest power of 2 <= n
            self._consume_sad(g)
            gf = [self._buf.pop(0) for _ in range(g)]
            ps, rs = self._encode_gop(gf)
            if self.rc is not None:
                self.rc.update(sum(len(p) for p in ps), g)
            payloads += ps
            recons += rs
        return payloads, recons

    _anchor_mult = 0.85                # set per GoP by _tpl_boost

    def _layer_lam(self, layer: int) -> float:
        return self.LAYER_LAM[min(layer, len(self.LAYER_LAM) - 1)]

    def _layer_q(self, layer: int) -> int:
        """Per-layer qindex (the reference's hierarchical-layer q offsets):
        anchors below the base q (by the GoP's TPL-lite multiplier), top
        layers above."""
        if layer == 0:
            mult = self._anchor_mult
        else:
            mult = (0.85, 0.96, 1.04, 1.10, 1.16)[min(layer, 4)]
        return max(1, min(255, int(round(self._base_q() * mult))))

    def _tpl_boost(self, gframes):
        """TPL-lite: how well the GoP's interior frames are predicted from
        its anchor (decimated SAD against a spatial activity proxy) (a)
        deepens the anchor's q boost (EbSourceBasedOperationsProcess.c
        tpl_mc_flow r0 boost) and (b) gives the anchor a per-32x32-block
        lambda map (_lam_map_np, float32 on the SB-padded block grid):
        blocks whose pixels propagate price rate cheaper, chaotic ones
        dearer.  SVT_TPU_NO_TPL set keeps the map off, as in the JAX
        package.  Only the partition path's scans read the map."""
        self._lam_map_np = None
        if len(gframes) < 2:
            self._anchor_mult = 0.85
            return
        anchor = np.asarray(gframes[-1][0], np.int32)[::4, ::4]
        act = (np.abs(np.diff(anchor, axis=0)).mean() +
               np.abs(np.diff(anchor, axis=1)).mean()) + 1e-3
        pq = 0.0
        for f in gframes[:-1]:
            d = np.abs(np.asarray(f[0], np.int32)[::4, ::4] - anchor).mean()
            pq += max(0.0, 1.0 - d / (4.0 * act))
        pq /= (len(gframes) - 1)
        self._anchor_mult = float(np.clip(0.92 - 0.18 * pq, 0.72, 0.92))
        if os.environ.get("SVT_TPU_NO_TPL"):
            return
        # 8x8 decimated pixels a 32x32 block, edge-padded to the grid
        bh, bw = self.intra.ph // BLK, anchor.shape[1] * 4 // BLK
        H8, W8 = bh * 8, bw * 8
        pad = lambda a: np.pad(a, ((0, max(0, H8 - a.shape[0])),
                                   (0, max(0, W8 - a.shape[1]))),
                               mode="edge")[:H8, :W8]
        blk = lambda a: a.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        ab = blk(pad(anchor)).astype(np.float32)
        act_b = (np.abs(np.diff(ab, axis=2)).mean((2, 3)) +
                 np.abs(np.diff(ab, axis=3)).mean((2, 3)) + 1e-3)
        p_b = np.zeros((bh, bw), np.float32)
        for f in gframes[:-1]:
            fd = pad(np.asarray(f[0], np.int32)[::4, ::4])
            d_b = np.abs(blk(fd).astype(np.float32) - ab).mean((2, 3))
            p_b += np.clip(1.0 - d_b / (4.0 * act_b), 0.0, 1.0)
        p_b /= (len(gframes) - 1)
        self._lam_map_np = np.clip(1.18 - 0.55 * p_b, 0.68,
                                   1.18).astype(np.float32)

    def _pick_ref(self, y, cand_slots):
        """The reference slot of least decimated-luma SAD against the
        source (frame-level single-reference choice)."""
        if len(cand_slots) == 1:
            return cand_slots[0]
        src = np.asarray(y, np.int32)[::4, ::4]
        best, best_s = None, None
        for s in cand_slots:
            ref = np.asarray(self._slots[s][0], np.int32)[::4, ::4]
            sad = int(np.abs(src - ref).sum())
            if best_s is None or sad < best_s:
                best, best_s = s, sad
        return best

    def _tf_filter(self, frame, past, future, q):
        """MCTF of an anchor's source against its neighbours."""
        return temporal_filter_frame(frame, list(past) + list(future), q,
                                     bd=self.cfg.bit_depth,
                                     device=self.device)

    def _encode_ref_frame(self, frame, cand_slots, layer, refresh_slot,
                          show, refresh_t):
        """Code one pyramid frame at its layer's qindex into DPB slot
        refresh_slot (display index refresh_t).  On the partition path a
        frame between two distinct slots is compound (LAST the interval's
        low end, ALTREF its high end, the CDFs of the nearer by decimated
        SAD) at its layer's lambda weight; otherwise a P frame on the
        nearer of cand_slots, on the partition path at the layer's weight
        and, for the anchor, the GoP's TPL lambda map."""
        q = self._layer_q(layer)
        dist = lambda s: max(1, abs(refresh_t -
                                    self._slot_t.get(s, refresh_t)))
        part = self.cfg.part_search
        if part and len(cand_slots) == 2 and cand_slots[0] != cand_slots[1]:
            lo, hi = cand_slots
            chain = self._pick_ref(frame[0], cand_slots)
            primary = ((0 if chain == lo else 6)
                       if self._slot_cdf.get(chain) is not None else 7)
            hdr = dict(show_frame=show, refresh_frame_flags=1 << refresh_slot,
                       ref_frame_idx=(lo,) * 6 + (hi,), reference_select=True,
                       primary_ref_frame=primary)
            payload, rec, snap = self._encode_p_part(
                *frame, ref=self._slots[lo], qindex=q,
                cdf_init=self._slot_cdf.get(chain), hdr_extra=hdr,
                ref_dist=dist(lo), ref2=self._slots[hi], ref2_dist=dist(hi),
                lam_scale=self._layer_lam(layer))
        else:
            slot = self._pick_ref(frame[0], cand_slots)
            hdr = dict(show_frame=show, refresh_frame_flags=1 << refresh_slot,
                       ref_frame_idx=(slot,) * 7)
            kw = dict(ref=self._slots[slot], cdf_init=self._slot_cdf.get(slot),
                      hdr_extra=hdr, ref_dist=dist(slot))
            if part:
                payload, rec, snap = self._encode_p_part(
                    *frame, qindex=q, lam_scale=self._layer_lam(layer),
                    lam_map=self._lam_map_np if layer == 0 else None, **kw)
            else:
                payload, rec, snap = self._encode_p_flat(*frame, q, **kw)
        rec = tuple(np.asarray(p) for p in rec)
        self._slots[refresh_slot] = rec
        self._slot_cdf[refresh_slot] = snap
        self._slot_t[refresh_slot] = refresh_t
        return payload, rec

    def _encode_gop(self, gframes):
        """One mini-GoP: the anchor at its far end references the previous
        anchor; the interior frames bisect recursively.  Every frame but a
        lone one is coded no-show and displayed by a show_existing
        overlay in display order."""
        G = len(gframes)
        self._tpl_boost(gframes)
        t0 = self._idx - 1            # display index of the lo anchor
        lo = self._anchor_slot
        hi = 1 - lo if lo in (0, 1) else 0
        if G == 1:
            p, rec = self._encode_ref_frame(gframes[0], [lo], 0, hi, True,
                                            t0 + 1)
            self._anchor_slot = hi
            self._idx += 1
            return [p], [rec]
        out_p, out_r = [], [None] * G
        anchor = gframes[-1]
        if self.tf:
            anchor = self._tf_filter(anchor, gframes[-3:-1], self._buf[:2],
                                     self._layer_q(0))
        p, rec = self._encode_ref_frame(anchor, [lo], 0, hi, False, t0 + G)
        out_p.append(p)
        out_r[G - 1] = rec
        self._bisect(gframes, 0, lo, G, hi, 0, out_p, out_r, t0)
        out_p.append(assemble_show_existing(hi))
        self._anchor_slot = hi
        self._idx += G
        return out_p, out_r

    def _bisect(self, gframes, lo_i, lo_slot, hi_i, hi_slot, depth, out_p,
                out_r, t0):
        if hi_i - lo_i <= 1:
            return
        mid = (lo_i + hi_i) // 2
        slot = 2 + depth
        p, rec = self._encode_ref_frame(gframes[mid - 1], [lo_slot, hi_slot],
                                        depth + 1, slot, False, t0 + mid)
        out_p.append(p)
        out_r[mid - 1] = rec
        self._bisect(gframes, lo_i, lo_slot, mid, slot, depth + 1, out_p,
                     out_r, t0)
        out_p.append(assemble_show_existing(slot))
        self._bisect(gframes, mid, slot, hi_i, hi_slot, depth + 1, out_p,
                     out_r, t0)

    def _p_lf_levels(self, q):
        """Deblock levels from the P frame's qindex (the intra encoder's
        heuristic at the inter quantizer)."""
        cfg = self.cfg
        if cfg.lf_level == 0:
            return (0, 0, 0, 0)
        if cfg.lf_level > 0:
            l = min(cfg.lf_level, 63)
        else:
            l = max(0, min(63, (q * q // 1100) + q // 12 - 2))
        lc = max(0, l * 3 // 4)
        return (l, l, lc, lc)

    def _dlf_levels(self, q, y_rec, part, part_sb, src_y, bd, valid_h=None):
        """Frame-level DLF level search: the luma level of least SSE
        against the source among levels around the qindex heuristic,
        chroma at 3/4 (an explicit cfg.lf_level overrides).  One host
        read."""
        if self.cfg.lf_level >= 0:
            return self._p_lf_levels(q)
        base = self._p_lf_levels(q)[0]
        cand = [0, max(1, base // 2), max(1, base * 3 // 4),
                max(1, base), base * 5 // 4 + 1, base * 3 // 2 + 1]
        cand = [min(63, c) for c in cand]
        sse = dlf_sse_part(y_rec, src_y, part, cand, BLK, 14, bd=bd,
                           part_sb=part_sb, valid_h=valid_h).cpu().numpy()
        l = int(cand[int(np.argmin(sse))])
        lc = max(0, l * 3 // 4)
        return (l, l, lc, lc)

    def _fit_gm(self, mv_field):
        """Translation-only global motion from the 32x32 ME field: the
        coordinate-wise median, rounded to even 1/8 pel, kept when most
        blocks move with it (EbGlobalMotionEstimation.c:126 analogue).
        Returns (row, col) or None (identity).  Reads back to the host."""
        f = mv_field.cpu().numpy().reshape(-1, 2).astype(np.int64)
        if f.shape[0] < 4:
            return None
        med = np.median(f, axis=0)
        gm = (int(np.round(med[0] / 2.0)) * 2,
              int(np.round(med[1] / 2.0)) * 2)
        if gm == (0, 0) or max(abs(gm[0]), abs(gm[1])) > 510:
            return None
        inl = (np.abs(f - np.array(gm)).max(axis=1) <= 16).mean()
        if inl < 0.5:
            return None
        return gm

    def _gm_prev_for(self, primary_ref, ref_idx):
        """PrevGmParams source: the primary-ref frame's saved gm dict."""
        if primary_ref == 7:
            return {}
        return self._slot_gm.get(ref_idx[primary_ref]) or {}

    def _gm_save(self, refresh_flags, gm_dict):
        for slot in range(8):
            if (refresh_flags >> slot) & 1:
                self._slot_gm[slot] = dict(gm_dict)

    def _fg_inter(self, hdr_extra=None):
        """Inter-frame film grain: update_grain=0, the parameters loaded
        from the primary reference's slot; each frame keeps its own
        grain_seed."""
        if not self.cfg.film_grain or not self.intra._fg_params:
            return None
        self._fg_n += 1
        seed = (17027 + 2897 * self._fg_n) & 0xFFFF
        slot = (hdr_extra or {}).get("ref_frame_idx", (0,) * 7)[0]
        return {"grain_seed": seed, "load_ref_idx": slot}

    # ------------------------------------------------------------ P frame

    def _me(self, ys, rj, long_range=False):
        """Motion search at 32, 16 and 64: mv fields [1, h/bs, w/bs, 2]."""
        return tuple(motion_estimate(ys, rj, bs, long_range=long_range)[0]
                     for bs in (BLK, 16, 64))

    @staticmethod
    def _sub_origins(bh, bw, dev):
        """Luma origins [1, 4N] of the 16x16 sub-blocks, z-order within
        each 32x32 block (index (r * bw + c) * 4 + z)."""
        zi = torch.arange(bh * bw * 4, device=dev)
        b_r, b_c, zz = zi // (bw * 4), (zi // 4) % bw, zi % 4
        return ((b_r * BLK + (zz >> 1) * 16)[None],
                (b_c * BLK + (zz & 1) * 16)[None])

    def _luma_lanes(self, ryp, mvs, mvps, gmv, origins, h, w, filt,
                    free, free_sb, bd, comp=None):
        """Motion compensation and rates of the three lanes at the 32, 16
        and 64 depths, as the scan's InterLanes.  comp (a compound frame):
        (ALTREF's padded luma, its mv fields, their mvps), adding the
        NEW_NEWMV and GLOBAL_GLOBALMV lanes."""
        preds, rates = [], []
        for d, ((y0, x0, bs), mv, mvp) in enumerate(zip(origins, mvs, mvps)):
            shape = mv.shape[:-1]
            mvf, mvpf = mv.reshape(1, -1, 2), mvp.reshape(1, -1, 2)
            gm = upload(np.array(gmv, np.int32), mvf.device).expand_as(mvf)
            n = mvf.shape[1]
            p = predict_inter_blocks(
                ryp.expand(N_LANES, -1, -1), y0.expand(N_LANES, n),
                x0.expand(N_LANES, n), torch.cat([mvf, gm, mvpf]), h, w, bs,
                0, bd, filt)
            r = [MODE_NEW + _mv_bits(mv, mvp),
                 torch.full(shape, MODE_NEAR + 1.0, device=mv.device),
                 torch.full(shape, MODE_NEAR + 1.4, device=mv.device)]
            if comp is not None:
                r2yp, mv_b, mvp_b = comp[0], comp[1][d], comp[2][d]
                z = torch.zeros_like(mvf)
                p = torch.cat([p, predict_inter_blocks_compound(
                    ryp.expand(2, -1, -1), r2yp.expand(2, -1, -1),
                    y0.expand(2, n), x0.expand(2, n), torch.cat([mvf, z]),
                    torch.cat([mv_b.reshape(1, -1, 2), z]), h, w, bs, 0, bd,
                    filt)])
                r += [2 * MODE_NEW + _mv_bits(mv, mvp) + _mv_bits(mv_b, mvp_b),
                      torch.full(shape, MODE_NEAR + 2.0, device=mv.device)]
            preds.append(p.reshape((1, p.shape[0]) + shape[1:] + (bs, bs)))
            rates.append(torch.stack(r, 1))
        (top, sub, sb), (r_top, r_sub, r_sb) = preds, rates
        one = lambda a: torch.ones(a.shape, dtype=torch.bool,
                                   device=a.device)
        return InterLanes(top, r_top, one(r_top), sub, r_sub, one(r_sub), sb,
                          r_sb, one(r_sb), one(free), one(free)[..., None]
                          .expand(-1, -1, -1, 4), one(free_sb))

    def _chroma_lanes(self, rup, rvp, mvs, origins, h, w, filt, lanes, bd,
                      comp=None):
        """Chroma motion compensation at the luma decisions' mvs (U and V
        in one call each depth): [U, V] predictions of the top, sub and
        SB blocks, as the paired scan's InterLanes; lanes (the top, sub
        and SB lane maps of luma, < 0 intra) gate the inter lane and
        intra.  comp (a compound frame): ALTREF's padded (U, V); blocks on
        lanes 3-4 take the compound prediction at their 4-component mvs."""
        ref = torch.cat([rup, rvp])
        preds = []
        for (y0, x0, bs), mv, lane in zip(origins, mvs, lanes):
            mvf = mv.reshape(1, -1, mv.shape[-1])
            n, cbs = mvf.shape[1], bs // 2
            org = ((y0 // 2).expand(2, n), (x0 // 2).expand(2, n))
            p = predict_inter_blocks(ref, *org,
                                     mvf[..., :2].expand(2, -1, -1), h, w,
                                     cbs, 1, bd, filt)
            if comp is not None:
                pc = predict_inter_blocks_compound(
                    ref, torch.cat(comp), *org, mvf[..., :2].expand(2, -1, -1),
                    mvf[..., 2:].expand(2, -1, -1), h, w, cbs, 1, bd, filt)
                c = (lane >= 3).reshape(1, n, 1, 1)
                p = torch.where(c, pc, p)
            preds.append(p.reshape((2, 1) + mv.shape[1:-1] + (cbs, cbs)))
        top, sub, sb = preds
        two = lambda a: torch.cat([a, a])
        zero = lambda a: torch.zeros((2, 1) + a.shape[1:], device=a.device)
        t_in, s_in, b_in = (l >= 0 for l in lanes)
        return InterLanes(top, zero(t_in), two(t_in[:, None]), sub,
                          zero(s_in), two(s_in[:, None]), sb, zero(b_in),
                          two(b_in[:, None]), two(~t_in), two(~s_in),
                          two(~b_in))

    def _fetch(self, tensors):
        """The P frame's maps, levels and recon to the host."""
        return {k: v.cpu().numpy() for k, v in tensors.items()}

    def _encode_p_part(self, y, u, v, ref=None, qindex=None,
                       cdf_init="chain", hdr_extra=None, ref_dist=1,
                       ref2=None, ref2_dist=1, lam_scale=1.0, lam_map=None):
        """A partition P frame: (payload, recon, end-CDF snapshot or None).

        The defaults code the low-delay frame: against the previous frame,
        at the base qindex, on the CDF chain.  The pyramid's arguments (as
        _encode_p_flat's): the reference's recon, qindex, the CDFs it
        starts from ("chain", a slot's snapshot or None), header fields
        and the reference's distance in frames (long-range ME beyond 4);
        ref2 (with ref2_dist) makes the frame compound, its ALTREF ref2;
        lam_scale multiplies the RD lambda and lam_map [bh, bw] float32
        (the anchor's TPL map) scales it per 32x32 block."""
        cfg = self.cfg
        bd = cfg.bit_depth
        deltas = tuple(cfg.angle_deltas)
        q = self._base_q() if qindex is None else qindex
        chain = cdf_init == "chain"
        cdf0 = self._cdf_state if chain else cdf_init
        comp = ref2 is not None
        dev = self.device
        # h is the true (signalled) height: the MC clamp's and the DPB's;
        # hp the SB-padded plane height of the block grids
        h, w = y.shape
        hp = self.intra.ph
        vh = None if hp == h else h
        vhc = None if vh is None else vh // 2
        y, u, v = (pad_plane_bottom(np.asarray(p), n)
                   for p, n in ((y, hp), (u, hp // 2), (v, hp // 2)))
        bh, bw, sh, sw = hp // BLK, w // BLK, hp // 64, w // 64
        N, Nsb = bh * bw, sh * sw

        i32 = torch.int32
        ys, us, vs = (upload(p[None], dev) for p in (y, u, v))

        def planes(r):
            """A reference's padded planes and its luma on the source
            grid (ME)."""
            return tuple(pad_plane(upload(p[None], dev).to(i32))
                         for p in r) + (upload(pad_plane_bottom(
                             np.asarray(r[0]), hp)[None], dev),)

        ryp, rup, rvp, rj = planes(self._dpb if ref is None else ref)
        mv32, mv16, mv64 = self._me(ys, rj, long_range=ref_dist > 4)
        # translation GM on single-reference frames only (the compound
        # GLOBAL_GLOBALMV lane keeps identity)
        gm = self._fit_gm(mv32) if cfg.gm_search and not comp else None
        gmv = gm or (0, 0)
        z4 = lambda m32: m32[:, :, :, None].expand(-1, -1, -1, 4, -1)
        zorder = lambda m16: m16.reshape(1, bh, 2, bw, 2, 2).permute(
            0, 1, 3, 2, 4, 5).reshape(1, bh, bw, 4, 2)
        mvp32, mvp64 = _mv_pred(mv32), _mv_pred(mv64)
        mvp16z, mv16z = z4(mvp32), zorder(mv16)
        if comp:
            r2yp, r2up, r2vp, rj2 = planes(ref2)
            mv32b, mv16b, mv64b = self._me(ys, rj2,
                                           long_range=ref2_dist > 4)
            mvp32b, mvp64b = _mv_pred(mv32b), _mv_pred(mv64b)
            mv16zb = zorder(mv16b)

        ar = torch.arange(N, device=dev)
        y0, x0 = (ar // bw * BLK)[None], (ar % bw * BLK)[None]
        sy0, sx0 = self._sub_origins(bh, bw, dev)
        ars = torch.arange(Nsb, device=dev)
        y0s, x0s = (ars // sw * 64)[None], (ars % sw * 64)[None]
        origins = ((y0, x0, BLK), (sy0, sx0, 16), (y0s, x0s, 64))
        filt = _pick_interp_filt(ys, ryp, y0, x0, mv32.reshape(1, N, 2), h,
                                 w, bd) if cfg.filter_search else 0

        free_np, free_sb_np = bottom_force_masks(bh, bw, sh, sw, h // 4)
        free, free_sb = (upload(a[None], dev) for a in (free_np, free_sb_np))
        lanes = self._luma_lanes(
            ryp, (mv32, mv16z, mv64), (mvp32, mvp16z, mvp64), gmv, origins,
            h, w, filt, free, free_sb, bd,
            comp=(r2yp, (mv32b, mv16zb, mv64b),
                  (mvp32b, z4(mvp32b), mvp64b)) if comp else None)
        lmap = None if lam_map is None else upload(
            np.asarray(lam_map, np.float32)[None], dev)
        # tile columns ride the scans' batch axis, tile-major; the
        # lanes' predictions and rates are the whole frame's, sliced
        T = cfg.tile_cols
        ts = lambda a, axis=2: tile_stack(a, T, axis)
        lmap_t = None if lmap is None else ts(lmap)
        scan = encode_plane_wavefront_part(
            ts(ys), BLK, q, ts(free), ts(free_sb), tx_search=cfg.tx_search,
            valid_h=vh, inter=InterLanes(*(ts(a, 3 if k < 9 else 2)
                                           for k, a in enumerate(lanes))),
            bd=bd, lam_scale=lam_scale, lam_map=lmap_t, angle_deltas=deltas)
        part_t, part_sb_t = scan[0], scan[7]
        (part, y_mi, y_lev, y_smi, y_slev, y_stx, y_rec,
         part_sb, y_mi_sb, y_lev_sb) = (tile_unstack(a, T) for a in scan)

        n_i_top = len(expand_candidates(CAND_MODES, deltas))
        n_i_sub = len(expand_candidates(SUB_MODES))
        lane_t, lane_s, lane_b = y_mi - n_i_top, y_smi - n_i_sub, \
            y_mi_sb - n_i_top
        gm_t = upload(np.array(gmv, np.int32), dev)

        def first_mv(lane, new, pred, new_b=None):
            # lanes 0 and 3 carry the searched mv, 2 the mvp; lanes 1 and 4
            # (GLOBALMV, GLOBAL_GLOBALMV) and intra blocks the frame's gm
            # mv; a compound frame's second mv is ALTREF's on lane 3, else 0
            m = torch.where(((lane == 0) | (lane == 3))[..., None], new,
                            torch.where((lane == 2)[..., None], pred, gm_t))
            if new_b is None:
                return m
            return torch.cat([m, torch.where((lane == 3)[..., None], new_b,
                                             0)], -1)

        mv_top = first_mv(lane_t, mv32, mvp32, mv32b if comp else None)
        mv_sub = first_mv(lane_s, mv16z, mvp16z, mv16zb if comp else None)
        mv_sb = first_mv(lane_b, mv64, mvp64, mv64b if comp else None)

        c_lanes = self._chroma_lanes(
            rup, rvp, (mv_top, mv_sub, mv_sb), origins, h, w, filt,
            (lane_t, lane_s, lane_b), bd, comp=(r2up, r2vp) if comp else None)
        two = lambda a: torch.cat([a, a])
        # [U, V] -> [U's tiles, V's tiles]
        uv_ts = lambda a, axis=2: torch.cat([ts(a[:1], axis),
                                             ts(a[1:], axis)])
        uv_scan = encode_plane_wavefront_part(
            uv_ts(torch.cat([us, vs])), CBLK, q, two(part_t),
            two(part_sb_t), chroma=True, valid_h=vhc,
            inter=InterLanes(*(uv_ts(a, 3 if k < 9 else 2)
                               for k, a in enumerate(c_lanes))), bd=bd,
            lam_scale=lam_scale,
            lam_map=None if lmap_t is None else two(lmap_t))
        (_, uv_mi, uv_lev, uv_smi, uv_slev, _, uv_rec,
         _, uv_mi_sb, uv_lev_sb) = (torch.cat([
             tile_unstack(a[:T], T), tile_unstack(a[T:], T)])
             for a in uv_scan)

        lf = self._dlf_levels(q, y_rec, part, part_sb, ys, bd, valid_h=vh)
        u_rec, v_rec = uv_rec[:1], uv_rec[1:]
        if lf[0] or lf[1]:
            y_rec = deblock_plane_part(y_rec, part, BLK, 14, lf[0], lf[1],
                                       bd=bd, part_sb=part_sb, valid_h=vh)
            u_rec = deblock_plane_part(u_rec, part, CBLK, 6, lf[2], lf[2],
                                       bd=bd, part_sb=part_sb, valid_h=vhc)
            v_rec = deblock_plane_part(v_rec, part, CBLK, 6, lf[3], lf[3],
                                       bd=bd, part_sb=part_sb, valid_h=vhc)
        pix = lambda a: a.to(pix_dtype(bd))
        m = self._fetch(dict(
            part=part[0], y_mi=y_mi[0], y_lev=y_lev[0], y_smi=y_smi[0],
            y_slev=y_slev[0], y_stx=y_stx[0], part_sb=part_sb[0],
            y_mi_sb=y_mi_sb[0], y_lev_sb=y_lev_sb[0], u_lev=uv_lev[0],
            v_lev=uv_lev[1], u_slev=uv_slev[0], v_slev=uv_slev[1],
            u_lev_sb=uv_lev_sb[0], v_lev_sb=uv_lev_sb[1], uv_mi=uv_mi[0],
            uv_smi=uv_smi[0], uv_mi_sb=uv_mi_sb[0], mv_t=mv_top[0],
            mv_s=mv_sub[0], mv_sb=mv_sb[0], mv32=mv32[0], mv16=mv16[0],
            mv64=mv64[0]))
        m.update(gm=gm, filt=filt, lf=lf, q=q, comp=comp, lam_scale=lam_scale,
                 lam_map=lam_map, ref_dist=ref_dist)
        self.last_p = m

        bw_t, sw_t = bw // T, sw // T

        def tile(k, t):
            """Tile t's columns of the host map k (on the 32x32 grid, or
            the SB grid for _SB_MAPS)."""
            n = sw_t if k in _SB_MAPS else bw_t
            return m[k][:, t * n:(t + 1) * n]

        rec, cdef_params, ccso_info, lr_types, lr_infos = \
            self.intra._filter_frame((y, u, v), (
                pix(y_rec[0]), pix(u_rec[0]), pix(v_rec[0])), [tuple(
                    tile(k, t) for k in (
                        "part", "y_lev", "u_lev", "v_lev", "y_slev",
                        "u_slev", "v_slev", "part_sb", "y_lev_sb",
                        "u_lev_sb", "v_lev_sb")) for t in range(T)],
            qindex=q)
        uv_mode = lambda modes, mi: np.array(
            [c for c, _ in expand_candidates(modes)], np.int32)[
                np.clip(mi, 0, len(modes) - 1)]
        tiles = []
        m["mode_counts"], m["n_intra"] = Counter(), 0
        for t in range(T):
            sl = slice(t * sw_t, (t + 1) * sw_t)
            tc = TileCoder(w // T, hp, q, cfg.cdf_update, true_h=h,
                           cdef_bits=cdef_params["bits"] if cdef_params
                           else 0,
                           cdef_idx=(cdef_params["idx_map"][:, sl]
                                     if cdef_params else None),
                           kf=False, cdf_init=cdf0, gm_mv=gmv, comp=comp,
                           mi_col_off=t * w // T // 4, frame_mi_cols=w // 4)
            tc.ccso_info = ccso_info
            if any(lr_types):
                tc.set_lr(lr_types, [
                    None if un is None else {k: a[:, sl]
                                             for k, a in un.items()}
                    for un in lr_infos])
            data, tcdf = tc.encode(
                *(tile(k, t) for k in ("part", "y_mi", "y_lev", "u_lev",
                                       "v_lev", "y_smi", "y_slev", "u_slev",
                                       "v_slev")),
                expand_candidates(CAND_MODES, deltas),
                expand_candidates(SUB_MODES),
                *(tile(k, t) for k in ("y_stx", "part_sb", "y_mi_sb",
                                       "y_lev_sb", "u_lev_sb", "v_lev_sb")),
                uv_mode(CHROMA_TOP_MODES, tile("uv_mi", t)),
                uv_mode(CHROMA_SUB_MODES, tile("uv_smi", t)),
                uv_mode(CHROMA_SB_MODES, tile("uv_mi_sb", t)),
                mv_top=tile("mv_t", t), mv_sub=tile("mv_s", t),
                mv_sb=tile("mv_sb", t))
            tiles.append(data)
            if t == 0:
                # the frame's end CDFs: tile 0's (context_update_tile_id 0)
                end_cdf = tcdf
            m["mode_counts"].update(tc.mode_counts)
            m["n_intra"] += tc.n_intra
        m["mode_counts"] = dict(m["mode_counts"])

        hdr = dict(hdr_extra or {})
        hdr.setdefault("film_grain", self._fg_inter(hdr))
        primary_ref = hdr.pop("primary_ref_frame",
                              0 if cdf0 is not None else 7)
        ref_idx = hdr.get("ref_frame_idx", (0,) * 7)
        refresh = hdr.get("refresh_frame_flags", 0x01)
        gm_dict = {1: gmv} if gm else {}
        fr = FrameConfig(frame_type=1, base_q_idx=q,
                         disable_cdf_update=not cfg.cdf_update,
                         disable_frame_end_update_cdf=not cfg.cdf_update,
                         primary_ref_frame=primary_ref,
                         filter_level=(lf[0], lf[1]),
                         filter_level_u=lf[2], filter_level_v=lf[3],
                         interpolation_filter=filt,
                         tile_cols_log2=T.bit_length() - 1,
                         lr_frame_types=lr_types, ccso=ccso_info,
                         gm_mv=gm_dict or None,
                         gm_prev=self._gm_prev_for(primary_ref, ref_idx),
                         **(cdef_frame_config_fields(cdef_params)
                            if cdef_params else {}), **hdr)
        self._gm_save(refresh, gm_dict)
        snap = end_cdf.snapshot() if cfg.cdf_update else None
        if chain and cfg.cdf_update:
            self._cdf_state = snap
        m.update(ref_slot=ref_idx[0], refresh=refresh)
        payload = assemble_frame(self.seq, fr, tiles if T > 1 else tiles[0],
                                 first=False)
        y_n, u_n, v_n = (host_pixels(p, bd) for p in rec)
        return payload, (y_n[:h], u_n[:h // 2], v_n[:h // 2]), snap

    # ------------------------------------------------------- flat P frame

    def _flat_luma_lanes(self, ryp, mv8, gmv, y0, x0, h, w, filt, bd):
        """The flat P frame's two luma lanes, NEWMV at the searched mv and
        GLOBALMV at the fit (one MC call): predictions [1, 2, bh, bw, 32,
        32] int32, rates [1, 2, bh, bw] float32."""
        _, bh, bw, _ = mv8.shape
        n = bh * bw
        mvf = mv8.reshape(1, n, 2)
        gm = upload(np.array(gmv, np.int32), mvf.device).expand_as(mvf)
        pred = predict_inter_blocks(ryp.expand(2, -1, -1), y0.expand(2, n),
                                    x0.expand(2, n), torch.cat([mvf, gm]), h,
                                    w, BLK, 0, bd, filt)
        rate = torch.stack([_flat_new_rate(mv8),
                            torch.full((1, bh, bw), R_ZERO,
                                       device=mv8.device)], 1)
        return pred.reshape(1, 2, bh, bw, BLK, BLK), rate

    def _flat_chroma_lanes(self, rup, rvp, mv, y0, x0, h, w, filt, bd):
        """Chroma motion compensation at the luma decisions' mvs [1, bh,
        bw, 2], U and V in one call: [2, 1, bh, bw, 16, 16] int32."""
        _, bh, bw, _ = mv.shape
        n = bh * bw
        pred = predict_inter_blocks(
            torch.cat([rup, rvp]), (y0 // 2).expand(2, n),
            (x0 // 2).expand(2, n), mv.reshape(1, n, 2).expand(2, -1, -1), h,
            w, CBLK, 1, bd, filt)
        return pred.reshape(2, 1, bh, bw, CBLK, CBLK)

    def _p_flat_device(self, y, u, v, q, ref=None, ref_dist=1):
        """The flat P frame's device stage at qindex q against ref (the
        DPB's frame by default), queued but for the GM fit's and the filter
        pick's reads: a dict of its decisions, levels and deblocked recons
        (tensors), and gm, filt, lf.  A reference more than 4 frames away
        searches long-range."""
        cfg = self.cfg
        bd = cfg.bit_depth
        dev = self.device
        # h is the true (signalled) height: the MC clamp's and the DPB's;
        # hp the SB-padded plane height of the block grid
        h, w = y.shape
        hp = self.intra.ph
        vh = None if hp == h else h
        vhc = None if vh is None else vh // 2
        y, u, v = (pad_plane_bottom(np.asarray(p), n)
                   for p, n in ((y, hp), (u, hp // 2), (v, hp // 2)))
        bh, bw = hp // BLK, w // BLK
        N = bh * bw
        ry, ru, rv = self._dpb if ref is None else ref

        ys, us, vs = (upload(p[None], dev) for p in (y, u, v))
        ryp, rup, rvp = (pad_plane(upload(p[None], dev).to(torch.int32))
                         for p in (ry, ru, rv))
        rj = upload(pad_plane_bottom(np.asarray(ry), hp)[None], dev)

        mv8 = motion_estimate(ys, rj, BLK,
                              long_range=ref_dist > 4)[0]  # [1, bh, bw, 2]
        gm = self._fit_gm(mv8) if cfg.gm_search else None
        gmv = gm or (0, 0)
        ar = torch.arange(N, device=dev)
        y0, x0 = (ar // bw * BLK)[None], (ar % bw * BLK)[None]
        filt = _pick_interp_filt(ys, ryp, y0, x0, mv8.reshape(1, N, 2), h,
                                 w, bd) if cfg.filter_search else 0

        # luma: the 13 intra candidates (their directional ones expanded by
        # the angle deltas) and the two lanes, every one allowed
        pred, rate = self._flat_luma_lanes(ryp, mv8, gmv, y0, x0, h, w, filt,
                                           bd)
        ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device=dev)
        pix = pix_dtype(bd)             # the kernel's source dtype
        deltas = tuple(cfg.angle_deltas)
        y_mi, y_lev, y_rec = encode_plane_wavefront_mixed(
            ys.to(pix), BLK, TX_32X32, q, pred, rate, ones(1, 2, bh, bw),
            ones(1, bh, bw), 2, CAND_MODES, bd, deltas, valid_h=vh)
        n_intra = len(expand_candidates(CAND_MODES, deltas))
        is_inter = y_mi >= n_intra                       # [1, bh, bw]
        gm_t = upload(np.array(gmv, np.int32), dev)
        mv_final = torch.where((y_mi == n_intra)[..., None], mv8, gm_t)

        # chroma: U and V in one call, each its own choice of DC (where
        # luma is intra) or the inter lane (where luma is inter)
        two = lambda a: torch.cat([a, a])
        c_pred = self._flat_chroma_lanes(rup, rvp, mv_final, y0, x0, h, w,
                                         filt, bd)
        uv_mi, uv_lev, uv_rec = encode_plane_wavefront_mixed(
            torch.cat([us, vs]).to(pix), CBLK, TX_16X16, q, c_pred,
            torch.zeros((2, 1, bh, bw), device=dev), two(is_inter[:, None]),
            two(~is_inter), 1, (0,), bd, valid_h=vhc)

        lf = self._p_lf_levels(q)
        if lf[0] or lf[1]:
            y_rec = deblock_plane_uniform(y_rec, BLK, 14, lf[0], lf[1], bd=bd,
                                          valid_h=vh)
            # U and V share one level (lf[2] == lf[3])
            uv_rec = deblock_plane_uniform(uv_rec, CBLK, 6, lf[2], lf[2],
                                           bd=bd, valid_h=vhc)
        return dict(y_mi=y_mi[0], y_lev=y_lev[0], u_lev=uv_lev[0],
                    v_lev=uv_lev[1], uv_mi=uv_mi, mv_t=mv_final[0],
                    mv32=mv8[0], y_rec=y_rec, uv_rec=uv_rec, gm=gm,
                    filt=filt, lf=lf)

    def _encode_p_flat(self, y, u, v, q, ref=None, cdf_init="chain",
                       hdr_extra=None, ref_dist=1):
        """A flat P frame at qindex q: (payload, recon, end-CDF snapshot or
        None).

        ref, cdf_init, hdr_extra and ref_dist parameterise the frame for
        the pyramid: the reference's recon (default the previous frame's),
        the CDFs it starts from ("chain": the low-delay chain, which it then advances;
        else a slot's snapshot, or None for the defaults), header fields
        (show_frame, refresh_frame_flags, ref_frame_idx, primary_ref_frame)
        and the reference's distance in frames."""
        cfg = self.cfg
        chain = cdf_init == "chain"
        cdf0 = self._cdf_state if chain else cdf_init
        h, w = y.shape
        hp = self.intra.ph
        d = self._p_flat_device(y, u, v, q, ref=ref, ref_dist=ref_dist)
        gm, filt, lf = d["gm"], d["filt"], d["lf"]
        gmv = gm or (0, 0)
        m = self._fetch({k: d[k] for k in ("y_mi", "y_lev", "u_lev", "v_lev",
                                           "uv_mi", "mv_t", "mv32")})
        m.update(gm=gm, filt=filt, lf=lf, mode_counts={}, q=q,
                 ref_dist=ref_dist)
        self.last_p = m

        cands = expand_candidates(CAND_MODES, tuple(cfg.angle_deltas))
        tile, end_cdf = encode_inter_tile(
            w, hp, q, cfg.cdf_update, m["y_mi"], m["y_lev"], m["u_lev"],
            m["v_lev"], m["mv_t"], cands, len(cands), cdf_init=cdf0,
            true_h=h, gm_mv=gmv, mode_counts=m["mode_counts"])
        hdr = dict(hdr_extra or {})
        hdr.setdefault("film_grain", self._fg_inter(hdr))
        primary_ref = hdr.pop("primary_ref_frame",
                              0 if cdf0 is not None else 7)
        ref_idx = hdr.get("ref_frame_idx", (0,) * 7)
        refresh = hdr.get("refresh_frame_flags", 0x01)
        gm_dict = {1: gmv} if gm else {}
        fr = FrameConfig(frame_type=1, base_q_idx=q,
                         disable_cdf_update=not cfg.cdf_update,
                         disable_frame_end_update_cdf=not cfg.cdf_update,
                         primary_ref_frame=primary_ref,
                         filter_level=(lf[0], lf[1]),
                         filter_level_u=lf[2], filter_level_v=lf[3],
                         interpolation_filter=filt, gm_mv=gm_dict or None,
                         gm_prev=self._gm_prev_for(primary_ref, ref_idx),
                         **hdr)
        self._gm_save(refresh, gm_dict)
        snap = end_cdf.snapshot() if cfg.cdf_update else None
        if chain and cfg.cdf_update:
            self._cdf_state = snap
        m.update(ref_slot=ref_idx[0], refresh=refresh)
        payload = assemble_frame(self.seq, fr, tile, first=False)
        y_n, uv_n = (host_pixels(d[k], cfg.bit_depth)
                     for k in ("y_rec", "uv_rec"))
        return payload, (y_n[0, :h], uv_n[0, :h // 2], uv_n[1, :h // 2]), \
            snap
