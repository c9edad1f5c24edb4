"""Drive the PyTorch port's 1080p encode on one CUDA card: the flat
all-intra path through the hand-written wavefront kernel, the partition
intra path with and without the in-loop filters, the low-delay inter path
(the CLI's default --keyint 64), these three as plain PyTorch on the card,
and the flat low-delay path (presets M11-M13, --no-part-search) and the
flat pyramid (--pyramid --tf, hierarchical mini-GoPs with temporal
filtering, long-range motion search and rate control), whose P frames run
the kernel with inter lanes; then decode the card's streams on the card
with the port's decoder; then the same at 10 bits: the 10-bit form of the
kernel, the 10-bit main path and flat I+P at 1080p, their decode, and the
four 10-bit paths card against CPU at 256x128; and the compound partition
pyramid (--pyramid --tf on the partition path) at 1080p and card against
CPU at 256x128 at 8 and 10 bits; and angle deltas (presets 0-5): the
kernel's delta form, the flat path with deltas at 1080p, preset 4 at
1920x1088 and card against CPU at 256x128.  The partition scans run as
CUDA graphs (``wavefront2.PartScan``: one graph a scan shape and step
width, captured at its first step and replayed after that), held against
their eager steps in phase 24.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and never prints
its last line):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from svtav1_tpu_torch/csrc (and the native tile
     coder); registers, spills, CTAs per SM and clusters that fit of the
     wavefront kernel's 8-bit (uint8_t) and 10-bit (uint16_t) forms, and
     each form's cluster width and warps a CTA (4-CTA clusters up to 16
     candidates, 8 for 29, 16 for 61-63), which must hold;
  2. the kernel against its plain PyTorch version on the card, under the
     agreement bar of the wavefront tests (>= 99% equal modes, levels
     equal where the mode agrees, recon equal when every mode agrees), at
     the test shapes and at the 1080p shapes of the main path; every
     shape runs the kernel 3 times and requires identical outputs and a
     clear error word each time; kernel times (two blocks of 10 by CUDA
     events), the plain version's from its one run, and the kernel's
     bound at 1080p;
  3. the main path: IntraEncoder(1920, 1080, qindex=100,
     part_search=False) on 12 synthetic frames, batch 4, device stage of
     batch k+1 overlapped with the entropy coding of batch k.  Checks the
     kernel launch count, that every payload parses as OBUs, luma PSNR >
     30 dB, and byte-identical payloads against the plain version on the
     card when every mode agrees; prints e2e and device-only fps;
     (2b, before 3) the kernel with inter lanes against its plain version
     at the flat P frame's shapes (luma 1x1088x1920, 13 intra candidates
     and 2 lanes; U and V 2x544x960 in one call, DC and 1 lane), on the
     calls of a 1080p flat P frame of ``moving_frames`` (frame 1 against
     frame 0: ME, GM fit, filter pick and MC on the card, the masks as the
     encoder builds them), under phase 2's bar, with kernel and plain
     times and the bound;
     (2c, before 3) the kernel's 10-bit form against its plain version at
     the 10-bit main path's shapes (luma 1x and 4x1088x1920, paired
     chroma 2x and 8x544x960, ``cuda/inputs.plane_src10``) and at the
     10-bit flat P frame's lane shapes (``moving_frames10``), under phase
     2's bar, 3 identical runs a shape with a clear error word; kernel ms
     by CUDA events, plain ms from its one run, the bound;
  4. a torch.profiler window over one device_encode batch: device time by
     kernel and the device's busy share of the window, both from the
     events that ran on the card (kernels, copies, memsets), the busy time
     as the union of their intervals;
  5. the partition path: IntraEncoder(1920, 1080, qindex=100) with its
     defaults (64/32/16 partition search, tx-type search, DLF level
     search) on one frame of the synthetic clip with busy
     bands (the clip alone codes as 64x64 blocks); wall time of each stage
     after a synchronize (luma and chroma wavefronts, DLF search, deblock,
     tile coder per frame) and e2e fps; every payload parses as OBUs,
     luma PSNR > 30 dB, the maps hold 32x32 NONE and SPLIT and a non-DCT
     tx type; the count of 64x64 SB NONE blocks;
  6. the partition path at 256x128 (2 frames) on the card and on the CPU:
     the agreement fraction of each decision map, and byte-identical
     payloads whenever every map agrees;
  7. one luma partition wavefront call on a 512x128 crop under
     torch.profiler, its steps run eagerly: device events per scan step
     and the device's busy share of the window (the plain scan is
     launch-bound);
 24. (after 7) the scan's graphs against its eager steps on that crop:
     the key-frame form and seeded inter lanes of 3 and 5 (compound),
     each replayed at q100 (weight 1.0, no map) and q140 (weight 1.15, a
     seeded lambda map): all ten outputs equal the eager steps' on the
     same buffers, bit for bit; call and eager times, step graphs, nodes,
     capture and instantiate seconds, device memory and host RSS;
  8. the partition path with the in-loop filters (CDEF, CCSO, loop
     restoration) at 1920x1088, q100, on the first frame of the edge clip
     (``cuda/inputs.edge_frames``: CCSO stays off on the smooth clip; the
     edge frame turns all three filters on).
     Wall time of each stage after a synchronize (device stage, CDEF
     search and apply, CCSO search and apply, LR search with its SGR and
     Wiener parts, LR apply, tile coder) and e2e fps; the chosen CDEF bits
     and strengths, LR types and unit counts, CCSO planes; device events
     of each device-side stage of one frame (CDEF search and apply, CCSO
     apply, LR search and apply; torch.profiler) and the device syncs of
     one frame's filter stage.  Every payload parses, luma PSNR
     > 30 dB, and CDEF (a nonzero strength), CCSO (a plane on) and LR (a
     unit on) each fired;
  9. the filtered partition path at 256x128 on the card and on the CPU
     (the two clips' first frames, q100), as chosen and with Wiener units
     forced (SGR priced out, Wiener free): decision-map agreement as in
     phase 6; LR agreement per unit; when the maps agree, equal CDEF
     params, CCSO info and LR units, and byte-identical payloads;
 10. the low-delay path: VideoEncoder(1920, 1080, qindex=100, keyint=64)
     on 2 frames of ``cuda/inputs.moving_frames`` (a panned texture with a
     patch moving at a half-pel velocity), a key frame and a P frame.  Wall
     time of each stage after a synchronize (key frame: scans, DLF search,
     deblock, tile coder; P frame: ME at 32/16/64, GM fit, interp-filter
     pick, luma MC, luma scan, chroma MC, chroma scan, DLF search, deblock,
     read-back, tile coder) and e2e fps; device events of the P frame's ME,
     luma and chroma MC and of one inter luma scan step (a 512x128 crop of
     its inputs, its steps run eagerly; torch.profiler); the device
     syncs of the P frame by source line; the GM fit, the filter, the
     inter share at each depth and the inter modes coded.  Checks:
     payloads parse, KEY then INTER, luma PSNR > 30 dB, more than half
     the P frame's luma area inter, a NEWMV and a non-NEWMV block, the P
     payload smaller than the key payload;
 11. the low-delay path at 256x128 (I, P, P) on the card and on the CPU,
     with the defaults (P frames with CDEF on: phase 28's preset 4, which
     also searches angle deltas): per frame the agreement of every
     decision map, the ME fields (integer SADs: exact whenever the frame's
     reference agrees) and the final mvs; when every map of a frame agrees,
     byte-identical payloads and equal recons, else the first frame that
     differs is reported (the frames after it have other references);
 12. the flat low-delay path: VideoEncoder(1920, 1080, qindex=100,
     part_search=False, keyint=64) on 2 frames of ``moving_frames`` (I,
     P), with the kernel launch counts set to 0 before and read after.
     Wall time of each P-frame stage after a synchronize (ME, GM fit,
     filter pick, luma MC, luma wavefront, chroma MC, chroma wavefront,
     deblock, read-back, tile coder), the kernel launches of each wavefront
     kind, the device syncs of the last P frame by source line, the
     inter share and the inter modes coded, e2e fps.  Checks: KEY, then
     INTER; one luma and one U+V launch a P frame; more than half of each
     P frame's luma blocks inter; payloads parse; luma PSNR > 30 dB;
 13. the flat low-delay path at 256x128 (I, P, P) on the card and on the
     CPU, with --no-part-search's defaults and with preset 13: per frame
     the agreement of the decision maps (>= 99% of the modes, phase 2's
     bar), the ME field and the final mvs; when every map of a frame
     agrees, byte-identical payloads and equal recons;
 14. the flat pyramid: VideoEncoder(1920, 1080, qindex=100,
     part_search=False, keyint=64, pyramid=True, gop=8, tf=True) on 9
     frames of ``moving_frames`` (a key frame and one mini-GoP of 8, the
     anchor 8 frames from its reference, so it searches long-range), with
     the kernel launch counts set to 0 before and read after.  Per coded
     frame in decode order: layer, q, reference slot, ME ms (long-range
     or not), TF ms, device stage ms, coder ms, bytes and kernel launches;
     the overlay count, e2e fps over the 9 source frames (first
     encode_frames to the end of flush), the device syncs of the layer-2
     frame by source line, peak device memory.  Checks: 9 recons, 17 TUs
     (the key frame, 8 no-show inter frames, 8 show_existing overlays),
     one luma and one U+V launch a P frame, luma PSNR > 30 dB;
 15. the flat pyramid (TF on, gop 8) at 256x128 on the card and on the
     CPU: CQ q100 on 17 frames, CBR at half the bitrate CQ reached (q
     moves between the GoPs), and a clip with a scene cut inside a
     mini-GoP.  Each filtered anchor of the card against the CPU's (the
     count of pixels that differ, at most one off: exp is not correctly
     rounded), then the card's planes fed to the CPU encoder, and every
     map, mv, q, reference slot, payload and recon must be equal.
 22. (after 15) the compound partition pyramid: VideoEncoder(1920, 1080,
     qindex=100, keyint=64, pyramid=True, gop=2, tf=True) on 3 frames of
     ``moving_frames``: the key frame, the no-show anchor (layer 0, the
     TPL lambda map), the no-show compound frame (LAST + ALTREF), two
     overlays.  Per frame: the stage times after a synchronize (key
     frame: scans, DLF search, deblock, tile coder; anchor and compound
     frame: ME against each reference, GM fit, filter pick, luma MC,
     compound MC, luma scan, chroma MC, chroma scan, DLF search, deblock,
     read-back, tile coder), the scans' step graphs captured and
     replayed with their seconds, q, bytes, the lambda weight and the
     map's min and max, the compound (NEW_NEW, GLOBAL_GLOBAL,
     NEAREST_NEAREST), single-reference and intra blocks coded; the
     compound frame's device syncs by source line; e2e fps over the 3
     frames.  Checks: TU kinds key, no-show inter twice, two overlays;
     payloads parse; luma PSNR > 30 dB on every shown frame; at least one
     compound block; the stream goes to phase 16;
 23. (after 22) the compound partition pyramid at 256x128 on the card and
     on the CPU, TF on (the card's filtered anchors fed to the CPU
     encoder): gop 4 at 8 bits (5 frames: layers 0-2, lambda weights 1.0
     and 1.15) under CQ q100 and under CBR at half the bitrate CQ
     reached, and gop 2 at 10 bits (3 frames of ``moving_frames10``): per
     coded frame the agreement of every map, and byte-identical payloads
     and equal recons whenever every map agrees;
 16. the decoder on the card: a fresh Decoder(device="cuda") (CCSO on
     for phase 8's stream) decodes the 1080p streams that phases 3 (the
     first TU), 8 (the filtered edge frame), 10 (I+P), 14 (the pyramid in
     decode order up to its first overlay) and 22 (the compound
     partition pyramid) encoded on the card.  Every output equals the
     encoder's recon in display order, every no-show frame's DPB entry
     its recon, and the frame count is right.  Per TU: kind, q, bytes,
     parse / residual / inter / intra / filters / output ms (each between
     two synchronizes) and device syncs; per stream decode fps and peak
     device memory;
 17. the decoder's full syntax, card against CPU: the JAX encoder's
     fixture streams (``tests/data/torch_dec``: compound pyramid, two
     tile columns, 10-bit, angle deltas; their outputs also equal the
     MD5s stored beside them) and two 256x128 streams the port encodes
     on the card (film grain; CDEF + CCSO + LR), each decoded on the card
     and on the CPU, frame by frame equal; then a stream cut inside its
     frame header raises DecodeError on the card; one-byte seeded flips
     in the tile data, the last 16 tile bytes and the frame OBUs of the
     fixtures and the CCSO stream give the card the CPU's DecodeError or
     frames (some flips decode to changed frames, so corrupt values reach
     the device stages); and a decode after them still succeeds;
 18. the 10-bit main path: IntraEncoder(1920, 1080, qindex=100,
     bit_depth=10, part_search=False) on 8 frames of
     ``cuda/inputs.synth_frames10``, batch 4, overlapped as in phase 3,
     with the launch count set to 0 before and read after: 2 kernel
     launches a batch, payloads parse, luma PSNR (peak 1023) > 30 dB,
     payloads byte-identical to the plain version on the card when every
     mode agrees, e2e and device-only fps;
 19. the 10-bit flat low-delay path at 1080p, I+P of ``moving_frames10``
     (``part_search=False, keyint=64``): stage times as in phase 12, one
     luma and one U+V launch for the P frame, KEY then INTER, more than
     half the P frame's luma blocks inter;
 20. the card decodes the streams of phases 18 (its first TU) and 19 with
     the port's Decoder, as in phase 16: every uint16 output equals the
     encoder's recon; decode fps;
 21. the 10-bit paths at 256x128 on the card and on the CPU: partition
     all-intra with CDEF + LR + CCSO (2 frames of ``edge_frames10``),
     low-delay partition I, P, P and flat I, P, P (``moving_frames10``),
     and the flat pyramid (gop 4, TF on, 9 frames; the card's filtered
     anchors fed to the CPU encoder): per coded unit the agreement of
     every decision map, and byte-identical payloads plus equal recons
     whenever every map agrees.
 25. (after 2c) the kernel's delta form (angle deltas, presets 0-5)
     against its plain version: luma 1x1088x1920 (valid_h 1080) with
     preset 0's 61 candidates and preset 4's 29, at 8 and 10 bits, and
     the flat P frame's luma call with preset 0's deltas (61 intra
     candidates and 2 lanes); phase 2's bar, 3 identical kernel runs a
     shape, kernel ms by CUDA events, the plain version's from its one
     run, the bound over every candidate; the blocks that pick a delta;
 26. (after 23) the delta form on the encoder's path at 1920x1080: the
     flat path with preset 0's deltas (part_search off, filters off) on
     I+P of ``moving_frames``, then one flat key frame each with preset
     4's deltas at 8 bits and with preset 0's and 4's at 10 bits, the
     launch counts set to 0 before and read after by form (every luma
     launch a delta form); stage times, e2e fps, the blocks that pick a
     delta; the streams go to phases 16 and 20;
 27. preset 4 low-delay I+P at 1920x1088 (presets 0-5 turn CDEF on, so
     the height is whole superblocks) on ``moving_frames``, q100: stage
     times, the scans' new graph shapes (29 luma candidates: step graphs,
     nodes, capture and instantiate seconds, host RSS), each scan's first
     call and a replay of it on the same inputs (equal outputs), inter
     shares, e2e fps; the stream goes to phase 16;
 28. angle deltas at 256x128, q60, card against CPU: preset 4 I, P, P
     (8 bits) and I, P (10 bits) on ``moving_stripes``, a preset-4
     compound pyramid (gop 2, TF; the card's filtered anchors fed to the
     CPU), the flat path with preset 0's deltas (I, P) and one preset-1
     partition key frame: per coded unit the agreement of every map,
     byte-identical payloads and equal recons whenever every map agrees.
 29. (after 28) tile columns at 1920x1080: the low-delay partition path
     with two 960-px tile columns (``tile_cols=2``), I+P of
     ``moving_frames``, q100: stage times, e2e fps, the four new scan
     shapes (key and P, luma and U+V, the tiles on the batch axis) with
     their first calls and replays (equal outputs), nodes and host RSS;
     the stream goes to phase 16, which decodes it on the card;
 30. tile columns at 256x128, card against CPU: key frames at 2 and 4
     tile columns, preset 4 with LR and CCSO I, P, P and 10-bit I, P at
     2, a compound pyramid (gop 2, TF) at 2: per coded unit the agreement
     of every map, byte-identical payloads and equal recons whenever
     every map agrees;
 31. (after 21) ``parallel.mesh`` on every card (cuda:0 twice on a
     one-card machine): GOP-parallel flat encodes on host threads and a
     key frame's tile columns on the mesh's devices (a host thread each),
     byte for byte against their serial encodes; the encode step (the
     wavefront kernel on each device) and the pipeline step against
     their one-call runs; ``torch.cuda.device_count()``;
 32. the CLI on the card: ``--keyint 1 --mbr`` on the flat path and the
     default partition path with ``--stat-report`` (PSNR and SSIM) on a
     256x128 Y4M: the capped payloads fit the cap.
 33. the flat path at 3840x2160 (m = 12: the edge strip's chain kernel,
     ``csrc/wf_edge.cu``) at 8 and 10 bits: a batch of 4 queued without a
     host sync, 2 chain launches read from that run, its first two frames
     decoded on the card to the recon; the chain kernel on the run's own
     plane outputs against the plain chain on the CPU: 0 differing
     elements; kernel, plain and bound ms;
 34. the CLI at ``--preset 12 --keyint 1`` on a 3840x2160 Y4M at 8 and 10
     bits: the first two payloads decode on the card to the recon Y4M.
The CPU halves of the card-against-CPU phases (6, 9, 11, 13, 15, 21, 23,
28, 30) run in spawned worker processes beside the card's half: those
that need nothing from the card (``cpu_jobs``) are submitted after the
build, those that take the card's filtered anchors when the card's half
has made them, their checks at the end (``finish_deferred``).  The
workers are stopped (SIGSTOP) through every timed phase (``QUIET``: the
kernel comparisons, the 1080p encodes and decodes, the profiles), so
those run with nothing beside them, and continue through the others; the
1080p scan
shapes that no later phase uses are dropped after phases 8, 22, 27 and
29 (``wavefront2.drop_scans``), and each phase prints its time and the
host RSS after it.
Then the script's total time, one JSON line of kernel results and, last,
one JSON line naming the device.  To run only phases 10-11:
``python3 -c "import chip_smoke as cs; cs.CARD = cs.card();
cs.phase_video(); cs.phase_video_card_vs_cpu()"``; phases 2b, 12 and 13
alone: ``python3 -c "import chip_smoke as cs; cs.CARD = cs.card();
cs.phase_compare_lanes(); cs.phase_flat_video();
cs.phase_flat_video_card_vs_cpu()"``; phases 14 and 15 alone:
``python3 -c "import chip_smoke as cs; cs.CARD = cs.card();
cs.phase_flat_pyramid(); cs.phase_flat_pyramid_card_vs_cpu()"``; phases
16 and 17 on the pyramid's stream alone: ``python3 -c "import chip_smoke
as cs; cs.CARD = cs.card(); cs.phase_flat_pyramid(); cs.phase_decode();
cs.phase_decode_card_vs_cpu()"``; the 10-bit phases alone (2c, 18-21):
``python3 -c "import chip_smoke as cs; cs.CARD = cs.card();
cs.phase_build(); cs.phase_compare(); cs.phase_compare_10bit();
cs.phase_main_path(10); cs.phase_flat_video(10);
cs.phase_decode(cs.DECODE10); cs.phase_10bit_card_vs_cpu()"``; the
compound partition pyramid and the graphs alone (phases 24, 22, 23 and
22's decode): ``python3 -c "import chip_smoke as cs; cs.CARD = cs.card();
cs.phase_graph_vs_eager(); cs.phase_part_pyramid();
cs.phase_part_pyramid_card_vs_cpu(); cs.phase_decode()"``; the angle-delta
phases 25-28 alone: ``python3 -c "import chip_smoke as cs; cs.CARD =
cs.card(); cs.phase_build(); cs.phase_compare_deltas();
cs.phase_flat_deltas(); cs.phase_preset4(); cs.phase_deltas_card_vs_cpu();
cs.phase_decode()"``; the tile-column, mesh and CLI phases 29-32 alone:
``python3 -c "import chip_smoke as cs; cs.CARD = cs.card();
cs.phase_build(); cs.phase_tiles(); cs.phase_tiles_card_vs_cpu();
cs.phase_mesh(); cs.cli_flags(); cs.phase_decode();
cs.finish_deferred()"``; the 4K phases 33-34 alone: ``python3 -c "import
chip_smoke as cs; cs.CARD = cs.card(); cs.phase_build(); cs.phase_edge();
cs.cli_edge()"``; the encoder CLI at every preset 0-13 on the card
(not part of the script's run): ``python3 -c "import chip_smoke as cs;
cs.CARD = cs.card(); cs.cli_presets()"``.  Imports nothing of JAX or of
the JAX package.
"""

import gc
import json
import os
import signal
import sys
import threading
import time
import warnings
from collections import Counter
from concurrent import futures
from dataclasses import replace

import numpy as np
import torch

from svtav1_tpu_torch import upload
from svtav1_tpu_torch.cuda import build
from svtav1_tpu_torch.cuda import wavefront_kernel as wk
from svtav1_tpu_torch.cuda.inputs import (SHAPES_1080P, banded_frames,
                                          card, edge_frames, edge_frames10,
                                          lane_arrays, moving_frames,
                                          moving_frames10, moving_stripes,
                                          plane_src, plane_src10, stripes,
                                          synth_frames, synth_frames10)
from svtav1_tpu_torch.ec import native
from svtav1_tpu_torch.encoder import coder_pool
from svtav1_tpu_torch.encoder import intra_encoder as ie
from svtav1_tpu_torch.encoder import lr_search as lrs
from svtav1_tpu_torch.encoder import presets
from svtav1_tpu_torch.encoder import tile_codec
from svtav1_tpu_torch.encoder import video_encoder as ve
from svtav1_tpu_torch.encoder import wavefront2 as wf2
from svtav1_tpu_torch.encoder.geometry import bottom_force_masks
from svtav1_tpu_torch.encoder.wavefront import (
    _quad_tables, _wavefront_body, expand_candidates, rd_params)
from svtav1_tpu_torch.spec.txfm import TX_16X16, TX_32X32
from svtav1_tpu_torch.utils.obu import (OBU_FRAME, OBU_FRAME_HEADER,
                                        parse_obus)

DEV = torch.device("cuda")
W, H = 1920, 1080
BATCH = 4


def agree(ref, got, label):
    """Fraction of equal modes and the max abs difference of levels/recon
    where they must match; raises below the bar."""
    mi_r, lev_r, rec_r = [a.cpu().numpy() for a in ref]
    mi_g, lev_g, rec_g = [a.cpu().numpy() for a in got]
    same = mi_r == mi_g
    frac = float(same.mean())
    if frac < 0.99:
        raise AssertionError(f"{label}: only {frac:.4f} of modes agree")
    err = int(np.abs(lev_r[same] - lev_g[same]).max(initial=0))
    if err:
        raise AssertionError(f"{label}: levels differ by {err} where "
                             "modes agree")
    if frac == 1.0:
        err = int(np.abs(rec_r - rec_g).max(initial=0))
        if err:
            raise AssertionError(f"{label}: recon differs by {err}")
    return frac, err


def wf_args(bs, q, chroma, valid_h=None, bd=8):
    cands = expand_candidates(ie.CAND_MODES)
    rd = rd_params(q, bd, cands, kf="uv" if chroma else True)
    kw = dict(valid_h=valid_h, paired=chroma, uv_tx=chroma)
    return rd, (bs, TX_16X16 if chroma else TX_32X32, ie.CAND_MODES, bd,
                (0,)), kw


def cuda_ms(fn, n):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def run_checked(fn):
    """One kernel call, synchronised, with the error word read."""
    out = fn()
    torch.cuda.synchronize()
    wk.raise_on_error(DEV)
    return out


def phase_compare():
    """Kernel vs plain on the card.  Returns (max_abs_err, kernel ms,
    plain ms, bound ms, bound basis) of one batch's luma + chroma
    wavefronts at 1080p (the main path's shapes)."""
    cases = [  # label, seed, B, h, w, bs, q, chroma, valid_h, timed
        ("luma 2x128x192 q100", 0, 2, 128, 192, 32, 100, False, None, 0),
        ("luma 1x128x128 q120 valid_h=100", 1, 1, 128, 128, 32, 120, False,
         100, 0),
        ("chroma paired 4x64x96 q100", 2, 4, 64, 96, 16, 100, True, None, 0),
    ] + [(label + " q100" + (" (main path)" if main else ""), seed, B, h, w,
          bs, 100, chroma, vh, 2 if main else 1)
         for label, seed, B, h, w, bs, chroma, vh, main in SHAPES_1080P]
    max_err, ms, plain_ms, bound, basis = 0, 0.0, 0.0, 0.0, set()
    for label, seed, B, h, w, bs, q, chroma, vh, timed in cases:
        src = torch.from_numpy(plane_src(seed, B, h, w)).to(DEV)
        rd, pos, kw = wf_args(bs, q, chroma, vh)
        kern = lambda: wk.wavefront_cuda(src, rd, *pos, **kw)
        plain = lambda: _wavefront_body(src, rd, *pos, **kw)
        got = run_checked(kern)
        for rep in range(2):        # a race shows as a run that differs
            again = run_checked(kern)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{label}: run {rep + 2} differs "
                                     "from run 1")
        # the plain version once a shape, timed by CUDA events (it
        # repeats the kernel's arithmetic and is no yardstick of speed)
        ref, p = timed_once(plain)
        frac, err = agree(ref, got, label)
        max_err = max(max_err, err)
        line = (f"compare {label}: modes agree {frac:.4f}, max_abs_err {err}"
                ", 3 identical kernel runs, error word clear")
        if timed:
            k1 = cuda_ms(kern, 10)
            k2 = cuda_ms(kern, 10)
            wk.raise_on_error(DEV)
            k = (k1 + k2) / 2
            b_ms, b_by = wk.bound_ms(bs, B, h, w, ie.CAND_MODES, chroma)
            line += (f"; kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
                     f"{p:.3f} ms (one run), bound {b_ms:.3f} ms "
                     f"({b_by}), {100 * b_ms / k:.1f}% of it [{CARD}]")
            if timed == 2:
                ms += k
                plain_ms += p
                bound += b_ms
                basis.add(b_by)
        print(line, flush=True)
    return max_err, ms, plain_ms, bound, "+".join(sorted(basis))


def plain_wavefront(src, bs, tx_size, qindex, modes, bd=8, angle_deltas=(0,),
                    valid_h=None, paired=False, kf=True, uv_tx=False):
    """The plain PyTorch wavefront with encode_plane_wavefront's
    signature, on whatever device src lies on."""
    rd = rd_params(qindex, bd, expand_candidates(modes, angle_deltas), kf)
    return _wavefront_body(src, rd, bs, tx_size, modes, bd, angle_deltas,
                           valid_h, paired, uv_tx)


def psnr(a, b, bd=8):
    """Luma PSNR at the peak of bd bits."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    peak = float((1 << bd) - 1)
    return 99.0 if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def hold_copies() -> threading.Event:
    """Hold the flat path's copy thread (``coder_pool``), and the
    batches' D2H copies queued behind it, until the event is set."""
    hold = threading.Event()
    coder_pool.copier().submit(hold.wait)
    return hold


def phase_main_path(bd=8):
    """The flat all-intra main path (phase 3; at bd=10 phase 18: 8 frames
    of the 10-bit clip through the kernel's 10-bit form)."""
    cfg = ie.EncoderConfig(W, H, qindex=100, part_search=False,
                           bit_depth=bd)
    frames = synth_frames(W, H, 12) if bd == 8 else synth_frames10(W, H, 8)
    name = "main path" if bd == 8 else "10-bit main path"
    enc = ie.IntraEncoder(cfg, device="cuda")

    def queue(batch, pending):
        # device_encode must not synchronise: host coding of the previous
        # batch overlaps it (set_sync_debug_mode raises on a sync).  The
        # mode is the process's, and the copy thread's D2H copies sync:
        # the previous batch's copies end first, and the copy thread
        # waits until the mode is off again
        if pending is not None:
            pending["job"].result()
        hold = hold_copies()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return enc.device_encode(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            hold.set()

    wk.LAUNCHES = 0
    payloads, recons, first_dev = [], [], None
    marks = [time.perf_counter()]
    pending = None
    for i in range(0, len(frames), BATCH):
        dev = queue(frames[i:i + BATCH], pending)
        if first_dev is None:
            first_dev = dev
        if pending is not None:
            ps, rs = enc.host_finish(pending)
            payloads += ps
            recons += rs
            marks.append(time.perf_counter())
        pending = dev
    ps, rs = enc.host_finish(pending)
    payloads += ps
    recons += rs
    marks.append(time.perf_counter())
    launches = wk.LAUNCHES
    wk.raise_on_error(DEV)
    if bd == 8:
        DECODE["flat key frame (phase 3)"] = (payloads[:1], recons[:1],
                                              False, None)
    else:
        DECODE10["10-bit flat key frame (phase 18)"] = (
            payloads[:1], recons[:1], False, None)
    want = 2 * (len(frames) // BATCH)     # one launch per plane call
    print(f"{name}: {len(payloads)} frames, {sum(map(len, payloads))} "
          f"bytes, kernel launches {launches} (expected {want}), "
          "device_encode queued without a host sync", flush=True)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for k, p in enumerate(payloads):
        obus = list(parse_obus(p))
        if not p or not any(t == OBU_FRAME and len(d) for t, _, _, d in obus):
            raise AssertionError(f"frame {k}: no OBU_FRAME in the payload")
    ps_y = [psnr(f[0], r[0], bd) for f, r in zip(frames, recons)]
    print(f"{name}: luma PSNR min {min(ps_y):.2f} dB, mean "
          f"{np.mean(ps_y):.2f} dB (peak {(1 << bd) - 1})", flush=True)
    if min(ps_y) <= 30.0:
        raise AssertionError(f"luma PSNR {min(ps_y):.2f} dB <= 30")
    steady = marks[-1] - marks[1]
    e2e_fps = (len(frames) - BATCH) / steady

    # the first batch again with the plain wavefront on the card
    ref = ie.IntraEncoder(cfg, device="cuda")
    ie_wf = ie.encode_plane_wavefront
    ie.encode_plane_wavefront = plain_wavefront
    try:
        dev_p = ref.device_encode(frames[:BATCH])
    finally:
        ie.encode_plane_wavefront = ie_wf
    same = all(torch.equal(first_dev[k], dev_p[k]) for k in ("y_mi", "uv_mi"))
    ps_p, _ = ref.host_finish(dev_p)
    print(f"{name}: first batch modes agree with the plain version: "
          f"{same}", flush=True)
    if same and ps_p != payloads[:BATCH]:
        raise AssertionError("payloads differ from the plain version's")
    if same:
        print(f"{name}: first batch payloads byte-identical to the plain "
              "version's", flush=True)

    # device_encode alone: the copy thread, which each call feeds, is
    # held until the timing ends; then the queued batches code
    queued = []

    def device_only():
        queued.append(enc.device_encode(frames[:BATCH]))
        torch.cuda.synchronize()
    hold = hold_copies()
    try:
        device_only()
        t0 = time.perf_counter()
        for _ in range(3):
            device_only()
        dev_fps = 3 * BATCH / (time.perf_counter() - t0)
    finally:
        hold.set()
    for d in queued:
        futures.wait(d["job"].result()[1])
    wk.raise_on_error(DEV)
    nb = len(frames) // BATCH
    print(f"{name}: e2e {e2e_fps:.3f} fps steady (batches 2-{nb} of "
          f"{BATCH} frames), device-only {dev_fps:.3f} fps [{CARD}]",
          flush=True)
    return launches, enc, frames[:BATCH]


def device_events(prof):
    """(start us, end us, name) of every event the profiler recorded on
    the card: kernels, copies and memsets, not the host ops that queued
    them."""
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def kineto_device_spans(prof):
    """(start us, end us) of every event that ran on the card, read from
    the profiler's raw results: a scan of ~1M launches is too many for
    prof.events(), which builds a Python event tree first."""
    from torch.autograd import DeviceType
    return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def busy_us(spans):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def phase_profile(enc, batch):
    """One device_encode batch under torch.profiler: host enqueue time,
    device time by kernel and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    hold = hold_copies()     # the batch's copies stay out of the window
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dev = enc.device_encode(batch)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    finally:
        hold.set()
    futures.wait(dev["job"].result()[1])
    wk.raise_on_error(DEV)
    events = device_events(prof)
    if not events:
        raise AssertionError("the profiler recorded no event on the card")
    by_name = {}
    for s, e, name in events:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s, n + 1)
    busy_ms = busy_us([(s, e) for s, e, _ in events]) / 1e3
    window_ms = 1e3 * (t2 - t0)
    print(f"profile: device_encode batch {len(batch)}: host enqueue "
          f"{1e3 * (t1 - t0):.3f} ms, window to synchronize {window_ms:.3f}"
          f" ms, device busy {busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}"
          f"% of the window; union of {len(events)} device events) "
          f"[{CARD}]", flush=True)
    rows = sorted(((t, n, name) for name, (t, n) in by_name.items()),
                  reverse=True)
    for t, n, name in rows[:10]:
        print(f"profile:   {t / 1e3:9.3f} ms  x{n:<5d} {name[:90]}",
              flush=True)


def check_payloads(payloads, frames, recons, label, bd=8):
    """Every payload holds an OBU_FRAME and luma PSNR > 30 dB."""
    for k, p in enumerate(payloads):
        obus = list(parse_obus(p))
        if not p or not any(t == OBU_FRAME and len(d) for t, _, _, d in obus):
            raise AssertionError(f"{label}: frame {k}: no OBU_FRAME")
    ps_y = [psnr(f[0], r[0], bd) for f, r in zip(frames, recons)]
    if min(ps_y) <= 30.0:
        raise AssertionError(f"{label}: luma PSNR {min(ps_y):.2f} dB <= 30")
    return ps_y


class StageClock:
    """Wraps stage functions (attributes of the encoder's modules, or a
    class's method): each call is timed on the host clock between two
    synchronizes, and its result kept."""
    PART = [(ie, "encode_plane_wavefront_part"), (ie, "dlf_sse_part"),
            (ie, "deblock_plane_part")]
    FILTERS = [(ie, "cdef_search_frame"), (ie, "cdef_apply_params"),
               (ie, "ccso_search_frame"), (ie, "ccso_apply_frame"),
               (ie, "lr_search_frame"), (lrs, "sgr_search"),
               (lrs, "wiener_refine"), (ie, "lr_apply_frame"),
               (tile_codec.TileCoder, "encode")]
    KEY = PART + [(tile_codec.TileCoder, "encode")]
    P_FRAME = [(ve, "motion_estimate"), (ve.VideoEncoder, "_fit_gm"),
               (ve, "_pick_interp_filt"), (ve.VideoEncoder, "_luma_lanes"),
               (ve, "encode_plane_wavefront_part"),
               (ve.VideoEncoder, "_chroma_lanes"),
               (ve.VideoEncoder, "_dlf_levels"), (ve, "deblock_plane_part"),
               (ve.VideoEncoder, "_fetch"), (ie.IntraEncoder, "_filter_frame"),
               (tile_codec.TileCoder, "encode")]
    # a compound frame's: its compound MC calls (inside the MC stages)
    P_COMP = P_FRAME + [(ve, "predict_inter_blocks_compound")]
    FLAT_P = [(ve, "motion_estimate"), (ve.VideoEncoder, "_fit_gm"),
              (ve, "_pick_interp_filt"), (ve.VideoEncoder, "_flat_luma_lanes"),
              (ve, "encode_plane_wavefront_mixed"),
              (ve.VideoEncoder, "_flat_chroma_lanes"),
              (ve, "deblock_plane_uniform"), (ve.VideoEncoder, "_fetch"),
              (ve, "encode_inter_tile")]
    NAMES = {"encode": "tile coder", "_fit_gm": "GM fit",
             "_pick_interp_filt": "interp-filter pick",
             "_luma_lanes": "luma MC", "_chroma_lanes": "chroma MC",
             "_flat_luma_lanes": "luma MC",
             "_flat_chroma_lanes": "chroma MC",
             "deblock_plane_uniform": "deblock",
             "encode_inter_tile": "tile coder",
             "_dlf_levels": "DLF search", "_fetch": "read-back",
             "_filter_frame": "filters",
             "predict_inter_blocks_compound": "compound MC"}

    def __init__(self, targets=PART):
        self.targets = targets
        self.ms = {}
        self.out = {}
        self.args = {}
        self.launches = {}          # wavefront kernel launches by stage
        self.calls = []             # (stage, ms) of every call in order
        self.saved = []

    @classmethod
    def _key(cls, name, a):
        if name in ("encode_plane_wavefront_part",
                    "encode_plane_wavefront_mixed"):
            return "luma wavefront" if a[1] == 32 else "chroma wavefront"
        if name == "motion_estimate":
            return f"ME {a[2]}"
        return cls.NAMES.get(name, name)

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            sync()
            n0 = wk.LAUNCHES
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            key = self._key(name, a)
            ms = 1e3 * (time.perf_counter() - t0)
            self.ms[key] = self.ms.get(key, 0.0) + ms
            self.calls.append((key, ms))
            self.launches[key] = self.launches.get(key, 0) + \
                wk.LAUNCHES - n0
            self.out.setdefault(key, []).append(out)
            self.args.setdefault(key, []).append((a, kw))
            return out
        return timed

    def __enter__(self):
        for obj, name in self.targets:
            fn = getattr(obj, name)
            self.saved.append((obj, name, fn))
            setattr(obj, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def sync():
    """Wait for the card, where this process uses it (a CPU worker never
    initialises CUDA)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---- the CPU halves of the card-against-CPU phases ----------------------
# Each runs in a spawned worker process beside the card's half: the halves
# that need nothing from the card (CPU_JOBS) are submitted when main()
# starts, so they are done when their phases come; those that take the
# card's filtered anchors are submitted when the card's half has made them,
# and their checks run at the end of the script (DEFERRED).

CPU_WORKERS = 3
_POOL = None
_AHEAD = {}          # CPU_JOBS name -> future submitted ahead
DEFERRED = []        # (label, check) run by finish_deferred()


def _worker_init():
    os.environ["CUDA_VISIBLE_DEVICES"] = ""      # the card is the parent's
    os.nice(10)        # the card's half, which is timed, keeps the cores
    torch.set_num_threads(2)


def cpu_submit(fn, *args):
    """The future of fn("cpu", *args) in a worker process."""
    global _POOL
    if _POOL is None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _POOL = ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
    return _POOL.submit(fn, "cpu", *args)


def cpu_half(name):
    """(the future of CPU_JOBS[name]'s CPU half, the job's side function
    and arguments): the future submitted ahead, or a new one."""
    fn, args = cpu_jobs()[name]
    fut = _AHEAD.pop(name, None) or cpu_submit(fn, *args)
    return fut, fn, args


def both_halves(name):
    """{"cuda": the card's half, "cpu": the worker's} of CPU_JOBS[name]."""
    fut, fn, args = cpu_half(name)
    card = fn("cuda", *args)
    return {"cuda": card, "cpu": fut.result()}


def start_cpu_halves():
    for name in cpu_jobs():
        if name not in _AHEAD:
            _AHEAD[name] = cpu_half(name)[0]


def spawn_workers():
    """Start the worker processes (each imports torch and the port as it
    starts, which overlaps the build)."""
    for _ in range(CPU_WORKERS):
        cpu_submit(_no_job)


def _no_job(device):
    return device


def pause_workers(stop: bool):
    """Stop (SIGSTOP) or continue (SIGCONT) the worker processes.  A
    stopped worker takes no CPU time; the parent waits for no result
    while they are stopped (the timed phases use no worker)."""
    if _POOL is None:
        return
    for p in list(getattr(_POOL, "_processes", {}).values()):
        try:
            os.kill(p.pid, signal.SIGSTOP if stop else signal.SIGCONT)
        except ProcessLookupError:
            pass


def finish_deferred():
    """The deferred checks, in order (each waits for its CPU half)."""
    t0 = time.perf_counter()
    while DEFERRED:
        label, check = DEFERRED.pop(0)
        check()
    print(f"deferred card-against-CPU checks: {time.perf_counter() - t0:.1f}"
          " s waiting", flush=True)


def stop_workers():
    """Cancel what the workers have not started and end them."""
    global _POOL
    if _POOL is not None:
        pause_workers(False)        # a stopped process ignores SIGTERM
        procs = list(getattr(_POOL, "_processes", {}).values())
        _POOL.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            p.terminate()
        for p in procs:
            p.join()
        _POOL = None
    _AHEAD.clear()


class FeedTF:
    """A TF hook for the CPU half of a pyramid: returns the card's filtered
    planes in call order, recording per call and plane (pixels that
    differ from the CPU's, the largest difference)."""

    def __init__(self, card_tf):
        self.card_tf = card_tf
        self.diffs = []

    def __call__(self, planes):
        got = self.card_tf[len(self.diffs)]
        d = [np.abs(a.astype(np.int32) - b.astype(np.int32))
             for a, b in zip(got, planes)]
        self.diffs.append([(int((x > 0).sum()), int(x.max())) for x in d])
        return got


def intra_side(device, cfg, frames):
    """An all-intra batch on device: (maps, payloads, recons, seconds)."""
    enc = ie.IntraEncoder(cfg, device=device)
    t0 = time.perf_counter()
    dev = enc.device_encode(frames)
    payloads, recons = enc.host_finish(dev)
    check_payloads(payloads, frames, recons, f"{cfg.width}x{cfg.height} "
                   f"on {device}", cfg.bit_depth)
    return part_maps(dev), payloads, recons, time.perf_counter() - t0


def filters_side(device, cfg, frames, forced):
    """The filtered partition path on device (Wiener units forced or as
    chosen): (maps, payloads, recons, seconds, each search's results)."""
    saved = lrs.SGR_BITS, lrs.WIENER_BITS
    if forced:
        lrs.SGR_BITS, lrs.WIENER_BITS = 1e12, 0.0
    try:
        enc = ie.IntraEncoder(cfg, device=device)
        t0 = time.perf_counter()
        with StageClock([(ie, k) for k in SEARCHES]) as clock:
            dev = enc.device_encode(frames)
            payloads, recons = enc.host_finish(dev)
        secs = time.perf_counter() - t0
    finally:
        lrs.SGR_BITS, lrs.WIENER_BITS = saved
    check_payloads(payloads, frames, recons, f"{cfg.width}x{cfg.height} "
                   f"filtered on {device}", cfg.bit_depth)
    return (part_maps(dev), payloads, recons, secs,
            [clock.out[k] for k in SEARCHES])


def pyramid_side(device, cfg, frames, rc_kbps, card_tf, gop, part):
    """The flat (part False) or partition pyramid, TF on, on device with
    the card's filtered planes (FeedTF), CBR at rc_kbps or none:
    (run_pyramid's or run_part_pyramid's result, the TF differences)."""
    from svtav1_tpu_torch.encoder.rate_control import RateControl
    rc = None if rc_kbps is None else RateControl(
        "cbr", qindex=100, target_kbps=rc_kbps, fps=30.0)
    feed = FeedTF(card_tf)
    if part:
        return run_part_pyramid(cfg, frames, device, rc, feed, gop), \
            feed.diffs
    return run_pyramid(cfg, frames, device, rc, feed, gop), feed.diffs


def cpu_jobs():
    """name -> (side function, arguments) of each card-against-CPU half
    that needs nothing from the card (phases 6, 9, 11, 13, 21, 28, 30)."""
    w, h = 256, 128
    ld = lambda cfg, clip, flat=False: (low_delay_units, (cfg, clip, flat))
    p4 = lambda bd=8, q=60: presets.apply_preset(
        ie.EncoderConfig(w, h, qindex=q, bit_depth=bd), 4)
    cfg10 = lambda **kw: ie.EncoderConfig(w, h, qindex=100, bit_depth=10,
                                          **kw)
    p4t = replace(p4(q=100), tile_cols=2, enable_lr=True, enable_ccso=True)
    jobs = {
        "partition": (intra_side, (ie.EncoderConfig(w, h, qindex=100),
                                   banded_frames(w, h, 2, seed=0))),
        "low-delay I,P,P": ld(ie.EncoderConfig(w, h, qindex=100),
                              moving_frames(w, h, 3)),
        "flat --no-part-search": ld(ie.EncoderConfig(w, h, qindex=100,
                                                     **FLAT),
                                    moving_frames(w, h, 3), True),
        "flat preset 13": ld(presets.apply_preset(
            ie.EncoderConfig(w, h, qindex=100), 13), moving_frames(w, h, 3),
            True),
        "10-bit partition + filters": (filters_side, (
            cfg10(**FILTERS), edge_frames10(w, h, 2), False)),
        "10-bit low-delay partition I,P,P": ld(cfg10(),
                                               moving_frames10(w, h, 3)),
        "10-bit flat low-delay I,P,P": ld(cfg10(**FLAT),
                                          moving_frames10(w, h, 3), True),
        "deltas preset 4 I,P,P": ld(p4(), moving_stripes(w, h, 3)),
        "deltas 10-bit preset 4 I,P": ld(p4(10),
                                         moving_stripes(w, h, 2, bd=10)),
        "deltas flat preset-0 I,P": ld(ie.EncoderConfig(
            w, h, qindex=60, angle_deltas=P0_DELTAS, **FLAT),
            moving_stripes(w, h, 2), True),
        "deltas preset-1 key frame": (intra_side, (presets.apply_preset(
            ie.EncoderConfig(w, h, qindex=60), 1), [stripes(w, h, 51)])),
        "tiles key frames T=2": (intra_side, (replace(
            ie.EncoderConfig(w, h, qindex=100), tile_cols=2),
            banded_frames(w, h, 2))),
        "tiles key frames T=4": (intra_side, (replace(
            ie.EncoderConfig(w, h, qindex=100), tile_cols=4),
            banded_frames(w, h, 2))),
        "tiles preset 4 + LR + CCSO I,P,P": ld(p4t, moving_frames(w, h, 3)),
        "tiles 10-bit I,P": ld(replace(cfg10(), tile_cols=2),
                               moving_frames10(w, h, 2)),
    }
    for forced in (False, True):
        jobs[f"filters {'Wiener forced' if forced else 'as chosen'}"] = (
            filters_side, (ie.EncoderConfig(w, h, qindex=100, **FILTERS),
                           filter_frames(w, h), forced))
    return jobs


def part_maps(dev):
    """The partition path's decision maps of a device_encode result."""
    return {k: dev[i].cpu().numpy() for k, i in (
        ("part", 2), ("part_sb", 16), ("y_mi", 3), ("y_smi", 5),
        ("y_stx", 11), ("uv_mi", 21))}


def phase_partition():
    """The partition path at 1080p on the card, stage by stage, on one
    frame."""
    n = 1
    frames = banded_frames(W, H, n)
    enc = ie.IntraEncoder(ie.EncoderConfig(W, H, qindex=100), device="cuda")
    t0 = time.perf_counter()
    with StageClock() as clock:
        dev = enc.device_encode(frames)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    payloads, recons = enc.host_finish(dev)
    t2 = time.perf_counter()
    maps = part_maps(dev)
    ps_y = check_payloads(payloads, frames, recons, "partition path")
    split_sb = np.repeat(np.repeat(maps["part_sb"], 2, 1), 2, 2) == 1
    in_tree = maps["part"][split_sb]
    leaves = (np.repeat(maps["part"][..., None], 4, -1) == 1) & \
        split_sb[..., None]
    n_none32, n_split32 = int((in_tree == 0).sum()), int((in_tree == 1).sum())
    n_stx = int((maps["y_stx"][leaves] != 0).sum())
    stages = ", ".join(f"{k} {v:.1f} ms" for k, v in clock.ms.items())
    print(f"partition path: {W}x{H} q100 defaults, batch {n}: device "
          f"stage {1e3 * (t1 - t0):.1f} ms ({stages}); tile coder "
          f"{1e3 * (t2 - t1) / n:.1f} ms per frame; e2e {n / (t2 - t0):.4f} "
          f"fps [{CARD}]", flush=True)
    print(f"partition path: {sum(map(len, payloads))} bytes, DLF level "
          f"{dev[24][0]}, luma PSNR min {min(ps_y):.2f} dB; 64x64 SB NONE "
          f"{int((maps['part_sb'] == 0).sum())} of {maps['part_sb'].size}, "
          f"32x32 NONE {n_none32} / SPLIT {n_split32} in split SBs, non-DCT "
          f"16x16 leaves {n_stx}", flush=True)
    if not (n_none32 and n_split32 and n_stx):
        raise AssertionError("partition path: the maps lack 32x32 NONE, "
                             "32x32 SPLIT or a non-DCT tx type")


def phase_card_vs_cpu():
    """The partition path at 256x128 on the card and on the CPU."""
    w, h = 256, 128
    both = both_halves("partition")
    out = {d: (r[0], r[1], r[3]) for d, r in both.items()}
    fracs = {k: float((out["cuda"][0][k] == out["cpu"][0][k]).mean())
             for k in out["cuda"][0]}
    same = all(f == 1.0 for f in fracs.values())
    equal = out["cuda"][1] == out["cpu"][1]
    print(f"card vs CPU, partition path {w}x{h} x2: map agreement "
          + ", ".join(f"{k} {v:.4f}" for k, v in fracs.items())
          + f"; payloads byte-identical: {equal} (card {out['cuda'][2]:.1f} "
          f"s, CPU {out['cpu'][2]:.1f} s)", flush=True)
    if same and not equal:
        raise AssertionError("maps agree but the payloads differ")


# the profiled scan crops: a step's launches do not depend on its width (a
# step's blocks ride the batch axis), and 512 columns keep the profile short
CROP_H, CROP_W = 128, 512


def phase_part_launches():
    """One luma partition wavefront call on a 512x128 crop under
    torch.profiler: device events per scan step."""
    from torch.profiler import ProfilerActivity, profile
    h, w = CROP_H, CROP_W
    src = torch.from_numpy(plane_src(7, 1, h, w)).to(DEV)
    fp, fsb = (torch.from_numpy(a[None].copy()).to(DEV) for a in
               bottom_force_masks(h // 32, w // 32, h // 64, w // 64, h // 4))
    steps = len(_quad_tables(h // 32, w // 32)[0])
    steps_1080 = len(_quad_tables(1088 // 32, W // 32)[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        # the scan queues its work without a host sync (this raises on one)
        torch.cuda.set_sync_debug_mode("error")
        try:
            wf2.encode_plane_wavefront_part(src, 32, 100, fp, fsb,
                                            tx_search=True, eager=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    events = kineto_device_spans(prof)
    busy_ms = busy_us(events) / 1e3
    window_ms = 1e3 * (t1 - t0)
    share = 100 * busy_ms / window_ms
    print(f"partition launches: luma 1x{h}x{w} wavefront, {steps} scan "
          f"steps: {len(events)} device events ({len(events) / steps:.0f} a "
          f"step), window {window_ms:.1f} ms ({window_ms / steps:.2f} ms a "
          f"step), device busy {busy_ms:.1f} ms ({share:.1f}% of the "
          f"window); a 1080p plane call has {steps_1080} steps; queued "
          f"without a host sync [{CARD}]", flush=True)


FILTERS = dict(enable_cdef=True, enable_lr=True, enable_ccso=True)
SEARCHES = ("cdef_search_frame", "ccso_search_frame", "lr_search_frame")


def filter_frames(w, h):
    """Phase 8's and 9's batch: the first frame of each clip."""
    return [banded_frames(w, h, 1)[0], edge_frames(w, h, 1)[0]]


def describe_filters(cdef, ccso, lr):
    """One line per frame of the filter decisions; and whether CDEF, CCSO
    and LR each fired in some frame."""
    fired = [False, False, False]
    lines = []
    for b, (c, o, (types, units)) in enumerate(zip(cdef, ccso, lr)):
        counts = [None if u is None else
                  np.bincount(u["type"].ravel(), minlength=3).tolist()
                  for u in units]
        on = [] if o is None else [p for p in range(3)
                                   if o["planes"][p] is not None]
        fired[0] |= any(p != (0, 0) for p in c["y_strengths"] +
                        c["uv_strengths"])
        fired[1] |= bool(on)
        fired[2] |= any(types)
        lines.append(f"frame {b}: CDEF bits {c['bits']} damping "
                     f"{c['damping']} y {c['y_strengths']} uv "
                     f"{c['uv_strengths']}; CCSO planes on {on}; LR types "
                     f"{tuple(types)}, units [NONE, WIENER, SGR] per plane "
                     f"{counts}")
    return lines, fired


def skip8_args(dev, b):
    """build_skip8's arrays of frame b of a partition-path device tuple."""
    return tuple(dev[i][b].cpu().numpy()
                 for i in (2, 4, 7, 9, 6, 8, 10, 16, 18, 19, 20))


def profile_events(fn):
    """(device events, busy ms, window ms) of one call under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    spans = kineto_device_spans(prof)
    return len(spans), busy_us(spans) / 1e3, 1e3 * (t1 - t0)


def phase_filters():
    """The filtered partition path at 1920x1088 on the card, on the edge
    clip's first frame (phase 9 runs both clips, at 256x128)."""
    h, q = 1088, 100
    frames = filter_frames(W, h)[1:]
    enc = ie.IntraEncoder(ie.EncoderConfig(W, h, qindex=q, **FILTERS),
                          device="cuda")
    t0 = time.perf_counter()
    dev = enc.device_encode(frames)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with StageClock(StageClock.FILTERS) as clock:
        payloads, recons = enc.host_finish(dev)
    t2 = time.perf_counter()
    ps_y = check_payloads(payloads, frames, recons, "filtered path")
    DECODE["filtered partition key frame (phase 8)"] = (payloads, recons,
                                                        True, None)
    n = len(frames)
    ms = clock.ms
    stages = ", ".join(f"{k} {ms[k] / n:.1f}" for k in (
        "cdef_search_frame", "cdef_apply_params", "ccso_search_frame",
        "ccso_apply_frame", "lr_search_frame", "sgr_search",
        "wiener_refine", "lr_apply_frame", "tile coder") if k in ms)
    print(f"filtered path: {W}x{h} q{q}, batch {n} (edge clip frame 0): "
          f"device stage {1e3 * (t1 - t0):.1f} ms; per "
          f"frame (ms): {stages}; host stage {1e3 * (t2 - t1) / n:.1f} ms "
          f"per frame; e2e {n / (t2 - t0):.4f} fps [{CARD}]", flush=True)
    lines, fired = describe_filters(*(clock.out[k] for k in SEARCHES))
    for line in lines:
        print(f"filtered path: {line}", flush=True)
    print(f"filtered path: {sum(map(len, payloads))} bytes, luma PSNR "
          f"{', '.join(f'{p:.2f}' for p in ps_y)} dB", flush=True)
    if not all(fired):
        raise AssertionError("filtered path: CDEF, CCSO, LR fired: "
                             f"{fired}")

    # device events of each device-side filter stage of frame 0, on the
    # planes and decisions of its run above
    src = tuple(upload(p, DEV) for p in frames[0])
    rec = tuple(dev[k][0] for k in (12, 13, 14))
    args = skip8_args(dev, 0)
    skip8 = ie.build_skip8(*args)
    lam = ie._lambda(q)
    out = clock.out
    cdef_rec = out["cdef_apply_params"][0]
    ccso_info = out["ccso_search_frame"][0]
    lr_in = out["ccso_apply_frame"][0] if ccso_info is not None else cdef_rec
    lr_types, lr_infos = out["lr_search_frame"][0]
    stages = [
        ("CDEF search", lambda: ie.cdef_search_frame(src, rec, skip8, q,
                                                     lam)),
        ("CDEF apply", lambda: ie.cdef_apply_params(
            rec, skip8, out["cdef_search_frame"][0])),
        ("CCSO apply", lambda: ie.ccso_apply_frame(cdef_rec, rec[0],
                                                   ccso_info)),
        ("LR search", lambda: ie.lr_search_frame(src, lr_in, lam)),
        ("LR apply", lambda: ie.lr_apply_frame(lr_in, rec, lr_infos))]
    for label, fn in stages:
        if (label == "CCSO apply" and ccso_info is None) or \
                (label == "LR apply" and not any(lr_types)):
            print(f"filtered path: frame 0 ran no {label}", flush=True)
            continue
        n_ev, busy, window = profile_events(fn)
        print(f"filtered path: one {label} ({W}x{h}, frame 0): {n_ev} "
              f"device events, device busy {busy:.1f} ms of a {window:.1f} "
              f"ms window ({100 * busy / window:.1f}%) [{CARD}]", flush=True)
    # host syncs of one frame's filter stage
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            enc._filter_frame(frames[0], rec, [args])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(c.message) for c in caught)
    print(f"filtered path: device syncs of one frame's filter stage: "
          f"{syncs}", flush=True)


def phase_filters_card_vs_cpu():
    """The filtered partition path at 256x128 on the card and on the
    CPU, as chosen and with Wiener units forced."""
    w, h = 256, 128
    for forced in (False, True):
        label = "Wiener forced" if forced else "as chosen"
        both = both_halves(f"filters {label}")
        out = {d: (r[0], r[1], r[4]) for d, r in both.items()}
        fracs = {k: float((out["cuda"][0][k] == out["cpu"][0][k]).mean())
                 for k in out["cuda"][0]}
        maps_same = all(f == 1.0 for f in fracs.values())
        (c_cd, c_cc, c_lr), (p_cd, p_cc, p_lr) = out["cuda"][2], \
            out["cpu"][2]
        cdef_same = all(a["bits"] == b["bits"] and a["damping"] ==
                        b["damping"] and a["y_strengths"] == b["y_strengths"]
                        and a["uv_strengths"] == b["uv_strengths"] and
                        np.array_equal(a["idx_map"], b["idx_map"])
                        for a, b in zip(c_cd, p_cd))
        ccso_same = all(same_ccso(a, b) for a, b in zip(c_cc, p_cc))
        agree, total = lr_agreement(c_lr, p_lr)
        equal = out["cuda"][1] == out["cpu"][1]
        print(f"card vs CPU, filtered path {w}x{h} x2 ({label}): map "
              f"agreement " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        fracs.items()) +
              f"; CDEF params equal {cdef_same}; CCSO info equal "
              f"{ccso_same}; LR units agree {agree} of {total}; payloads "
              f"byte-identical {equal} (card {both['cuda'][3]:.1f} s, CPU "
              f"{both['cpu'][3]:.1f} s)", flush=True)
        lines, fired = describe_filters(c_cd, c_cc, c_lr)
        for line in lines:
            print(f"card vs CPU ({label}): card {line}", flush=True)
        # the LR sums are exact int64 on both devices: with equal maps,
        # every filter decision and so every byte must agree
        if maps_same and not (cdef_same and ccso_same and agree == total):
            raise AssertionError("maps agree but the CDEF, CCSO or LR "
                                 "decisions differ")
        if maps_same and not equal:
            raise AssertionError("maps and filter parameters agree but the "
                                 "payloads differ")
        if forced and not any((u["type"] == 1).any() for _, us in c_lr
                              for u in us if u is not None):
            raise AssertionError("no Wiener unit with Wiener forced")


def same_ccso(a, b):
    if a is None or b is None:
        return a is b
    return all((pa is None) == (pb is None) and (pa is None or all(
        np.array_equal(pa[k], pb[k]) for k in pb))
        for pa, pb in zip(a["planes"], b["planes"]))


def lr_agreement(got, want):
    """(units whose every field agrees, units) over frames and planes;
    a plane left NONE counts as its units set to NONE."""
    agree = total = 0
    for (gt, gu), (wt, wu) in zip(got, want):
        for p in range(3):
            g, w = gu[p], wu[p]
            ref = g if g is not None else w
            if ref is None:
                continue
            same = np.ones(ref["type"].shape, bool)
            for k in ref:
                a = g[k] if g is not None else np.zeros_like(ref[k])
                b = w[k] if w is not None else np.zeros_like(ref[k])
                eq = a == b
                same &= eq if eq.ndim == 2 else eq.all(-1)
            agree += int(same.sum())
            total += same.size
    return agree, total


def frame_type(payload):
    """0 (KEY_FRAME) or 1 (INTER_FRAME): the frame_type bits after
    show_existing_frame in the first OBU_FRAME's header."""
    for t, _, _, d in parse_obus(payload):
        if t == OBU_FRAME:
            return (d[0] >> 5) & 3
    raise AssertionError("no OBU_FRAME in the payload")


N_TOP, N_SUB = (len(expand_candidates(m)) for m in (ie.CAND_MODES,
                                                     wf2.SUB_MODES))
MODE_NAMES = {13: "NEARESTMV", 14: "NEARMV", 15: "GLOBALMV", 16: "NEWMV"}


def inter_shares(m, h, n_top=N_TOP):
    """(inter / coded blocks at the 64, 32 and 16 depths, the share of the
    luma area above row h coded inter) of a P frame's host maps; n_top
    intra candidates at the 32 and 64 depths (more with angle deltas)."""
    sb_none = m["part_sb"] == 0
    split_sb = np.repeat(np.repeat(~sb_none, 2, 0), 2, 1)
    top = split_sb & (m["part"] == 0)
    leaf = (split_sb & (m["part"] == 1))[..., None].repeat(4, -1)
    sb_in = sb_none & (m["y_mi_sb"] >= n_top)
    top_in = top & (m["y_mi"] >= n_top)
    leaf_in = leaf & (m["y_smi"] >= N_SUB)
    bh, bw = top.shape
    units = np.repeat(np.repeat(sb_in, 4, 0), 4, 1) | \
        np.repeat(np.repeat(top_in, 2, 0), 2, 1) | \
        leaf_in.reshape(bh, bw, 2, 2).transpose(0, 2, 1, 3).reshape(
            2 * bh, 2 * bw)
    rows = np.arange(2 * bh) * 16 < h
    return ((int(sb_in.sum()), int(sb_none.sum())),
            (int(top_in.sum()), int(top.sum())),
            (int(leaf_in.sum()), int(leaf.sum())), float(units[rows].mean()))


def crop_blocks(args, kw, nr, nc):
    """An inter luma scan call cut to its top-left nr x nc blocks."""
    (src, bs, q, fp, fsb), lanes = args[:5], kw["inter"]
    cut = lambda t, ax, r, c: t.narrow(ax, 0, r).narrow(ax + 1, 0, c)
    dims = [(2, nr, nc)] * 6 + [(2, nr // 2, nc // 2)] * 3 + \
        [(1, nr, nc)] * 2 + [(1, nr // 2, nc // 2)]
    lanes = wf2.InterLanes(*(cut(t, *d) for t, d in zip(lanes, dims)))
    return (src[:, :nr * bs, :nc * bs], bs, q, cut(fp, 1, nr, nc),
            cut(fsb, 1, nr // 2, nc // 2)), dict(tx_search=kw["tx_search"],
                                                inter=lanes)


def phase_video():
    """The low-delay path at 1920x1080 on the card: a key frame and a P
    frame, stage by stage."""
    frames = moving_frames(W, H, 2)
    enc = ve.VideoEncoder(ie.EncoderConfig(W, H, qindex=100), keyint=64,
                          device="cuda")
    wk.LAUNCHES = 0
    t0 = time.perf_counter()
    with StageClock(StageClock.KEY) as kclock:
        p0, r0 = enc.encode_frame(*frames[0])
    t1 = time.perf_counter()
    here = os.path.basename(__file__)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with StageClock(StageClock.P_FRAME) as pclock:
                p1, r1 = enc.encode_frame(*frames[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t2 = time.perf_counter()
    launches = wk.LAUNCHES
    syncs = Counter(f"{os.path.basename(c.filename)}:{c.lineno}"
                    for c in caught if "synchroniz" in str(c.message) and
                    os.path.basename(c.filename) != here)
    fmt = lambda ms: ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
    print(f"low-delay path: {W}x{H} q100 keyint 64: key frame (q70) "
          f"{1e3 * (t1 - t0):.1f} ms ({fmt(kclock.ms)}); P frame "
          f"{1e3 * (t2 - t1):.1f} ms ({fmt(pclock.ms)}); e2e "
          f"{2 / (t2 - t0):.4f} fps over the 2 frames [{CARD}]", flush=True)
    m = enc.last_p
    (sb_i, sb_n), (t_i, t_n), (l_i, l_n), area = inter_shares(m, H)
    modes = {MODE_NAMES[k]: v for k, v in m["mode_counts"].items()}
    print(f"low-delay path: P frame GM fit {m['gm']}, interpolation filter "
          f"{m['filt']}, DLF level {m['lf'][0]}; inter blocks: 64x64 {sb_i} "
          f"of {sb_n}, 32x32 {t_i} of {t_n}, 16x16 {l_i} of {l_n}; luma area "
          f"inter {100 * area:.1f}%; inter modes coded {modes}; bytes key "
          f"{len(p0)}, P {len(p1)}; flat-kernel launches on this path "
          f"{launches}", flush=True)
    print(f"low-delay path: device syncs of the P frame: "
          f"{sum(syncs.values())} ({dict(syncs)})", flush=True)
    ps_y = check_payloads([p0, p1], frames, [r0, r1], "low-delay path")
    DECODE["partition I+P (phase 10)"] = ([p0, p1], [r0, r1], False, None)
    types = [frame_type(p) for p in (p0, p1)]
    print(f"low-delay path: frame types {types}, luma PSNR "
          f"{', '.join(f'{p:.2f}' for p in ps_y)} dB", flush=True)
    if types != [0, 1]:
        raise AssertionError(f"frame types {types}, not KEY then INTER")
    if area <= 0.5:
        raise AssertionError(f"only {100 * area:.1f}% of the luma is inter")
    if not m["mode_counts"][16] or \
            sum(m["mode_counts"].values()) == m["mode_counts"][16]:
        raise AssertionError(f"inter modes coded {modes}: need a NEWMV "
                             "and a non-NEWMV block")
    if len(p1) >= len(p0):
        raise AssertionError(f"P payload {len(p1)} >= key {len(p0)}")

    # device events of the P frame's stages, on its own inputs
    me_args = [pclock.args[f"ME {bs}"][0][0] for bs in (32, 16, 64)]
    stages = [("ME (32, 16, 64)", lambda: [ve.motion_estimate(*a)
                                           for a in me_args])]
    for key, fn in (("luma MC", ve.VideoEncoder._luma_lanes),
                    ("chroma MC", ve.VideoEncoder._chroma_lanes)):
        a, kw = pclock.args[key][0]
        stages.append((key, lambda fn=fn, a=a, kw=kw: fn(*a, **kw)))
    for label, fn in stages:
        n_ev, busy, window = profile_events(fn)
        print(f"low-delay path: P frame {label}: {n_ev} device events, "
              f"device busy {busy:.1f} ms of a {window:.1f} ms window "
              f"({100 * busy / window:.1f}%) [{CARD}]", flush=True)
    nr, nc = CROP_H // 32, CROP_W // 32
    a, kw = crop_blocks(*pclock.args["luma wavefront"][0], nr, nc)
    steps = len(_quad_tables(nr, nc)[0])

    def scan():
        torch.cuda.set_sync_debug_mode("error")
        try:
            wf2.encode_plane_wavefront_part(*a, eager=True, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n_ev, busy, window = profile_events(scan)
    print(f"low-delay path: inter luma scan on the P frame's "
          f"{CROP_W}x{CROP_H} crop, "
          f"{steps} steps: {n_ev} device events ({n_ev / steps:.0f} a step),"
          f" device busy {busy:.1f} ms of a {window:.1f} ms window "
          f"({100 * busy / window:.1f}%), queued without a host sync "
          f"[{CARD}]", flush=True)


def p_maps(enc):
    """A P frame's decision maps, ME fields and final mvs."""
    m = enc.last_p
    return {k: m[k] for k in (
        "part", "part_sb", "y_mi", "y_smi", "y_stx", "y_mi_sb", "uv_mi",
        "uv_smi", "uv_mi_sb", "mv32", "mv16", "mv64", "mv_t", "mv_s",
        "mv_sb")} | {"gm": np.array(m["gm"] or (0, 0)),
                     "filt": np.array(m["filt"])}


def phase_video_card_vs_cpu():
    """The low-delay path at 256x128 (I, P, P) on the card and on the
    CPU, with the defaults (P frames with CDEF on: phase 28's preset 4)."""
    w, h = 256, 128
    label = "defaults"
    runs = both_halves("low-delay I,P,P")
    out = {d: ([(u[0][0], u[1][0], u[2]) for u in r[0]], r[1])
           for d, r in runs.items()}
    lines, ref_same = [], True
    for k, ((pc, rc, mc), (pp, rp, mp)) in enumerate(zip(out["cuda"][0],
                                                         out["cpu"][0])):
        if not ref_same:
            lines.append(f"frame {k}: not compared (its reference "
                         "differs)")
            continue
        fr = {n: float((mc[n] == mp[n]).mean()) for n in mc}
        same = all(v == 1.0 for v in fr.values())
        equal = pc == pp and all(np.array_equal(a, b)
                                 for a, b in zip(rc, rp))
        lines.append(f"frame {k}: " + ", ".join(
            f"{n} {v:.4f}" for n, v in fr.items()) +
            f"; payload and recon identical {equal}")
        me_same = all(fr[n] == 1.0 for n in ("mv32", "mv16", "mv64")
                      if n in fr)
        if not me_same:
            raise AssertionError(f"{label} frame {k}: ME fields differ "
                                 "on the same reference")
        if same and not equal:
            raise AssertionError(f"{label} frame {k}: maps agree but the "
                                 "payload or recon differs")
        if not same:
            lines[-1] += " (first frame that differs)"
            ref_same = False
    print(f"card vs CPU, low-delay path {w}x{h} I,P,P ({label}; card "
          f"{out['cuda'][1]:.1f} s, CPU {out['cpu'][1]:.1f} s):",
          flush=True)
    for line in lines:
        print(f"card vs CPU ({label}): {line}", flush=True)


# ---- the flat low-delay path ------------------------------------------------

FLAT = dict(part_search=False)
LANE_KERNELS = {"luma": "wavefront, flat P luma (13 intra + 2 inter lanes)",
                "chroma": "wavefront, flat P chroma U+V (DC + 1 inter lane)"}


def flat_p_calls(bd=8, angle_deltas=(0,)):
    """The flat P frame's two wavefront calls at 1080p, as the encoder
    makes them: frame 1 of moving_frames (moving_frames10 at bd=10)
    against frame 0 as its reference (ME, GM fit, filter pick and MC on
    the card), the luma call with angle_deltas.  Returns {"luma" |
    "chroma": (args, kwargs)} of encode_plane_wavefront_mixed."""
    f0, f1 = (moving_frames if bd == 8 else moving_frames10)(W, H, 2)
    enc = ve.VideoEncoder(ie.EncoderConfig(W, H, qindex=100, bit_depth=bd,
                                           angle_deltas=angle_deltas,
                                           **FLAT),
                          keyint=64, device="cuda")
    enc._dpb = f0
    with StageClock([(ve, "encode_plane_wavefront_mixed")]) as clock:
        enc._p_flat_device(*f1, enc.cfg.qindex)
    return {k: clock.args[f"{k} wavefront"][0] for k in ("luma", "chroma")}


def phase_compare_lanes(bd=8, angle_deltas=(0,), kinds=("luma", "chroma")):
    """The kernel with inter lanes against its plain version on the card,
    at the flat P frame's shapes (phase 2b; at bd=10 part of phase 2c,
    and with angle_deltas, the luma call only, part of phase 25), one
    plain run a shape, timed by CUDA events.  Returns {"luma" |
    "chroma": (max_abs_err, kernel ms, plain ms, bound ms, bound basis)}."""
    out = {}
    tag = "" if bd == 8 else "10-bit "
    for kind, (a, kw) in flat_p_calls(bd, angle_deltas).items():
        if kind not in kinds:
            continue
        src, bs, tx, q, preds, rate, ok, iok, n_extra, modes = a[:10]
        deltas = a[11] if len(a) > 11 else (0,)
        vh = kw["valid_h"]
        extra = (preds, rate, ok, iok)
        n_intra = len(expand_candidates(modes, deltas))
        rd = rd_params(q, bd, expand_candidates(modes, deltas), kf=False)
        kern = lambda: wk.wavefront_cuda(src, rd, bs, tx, modes, bd, deltas,
                                         valid_h=vh, extra=extra)
        plain = lambda: _wavefront_body(src, rd, bs, tx, modes, bd, deltas,
                                        valid_h=vh, extra=extra)
        B, h, w = src.shape
        label = f"{tag}{kind} {B}x{h}x{w}, {n_intra} intra + {n_extra} lanes"
        n0 = wk.LAUNCHES
        got = run_checked(kern)
        for rep in range(2):
            again = run_checked(kern)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{label}: run {rep + 2} differs "
                                     "from run 1")
        ref, p = timed_once(plain)
        frac, err = agree(ref, got, label)
        inter = float((got[0] >= n_intra).float().mean())
        k1 = cuda_ms(kern, 10)
        k2 = cuda_ms(kern, 10)
        wk.raise_on_error(DEV)
        k = (k1 + k2) / 2
        n = wk.LAUNCHES - n0
        if n != 23:
            raise AssertionError(f"{label}: {n} kernel launches counted for "
                                 "23 kernel calls")
        # the candidates each block's masks let compete (this data's work)
        live = [float(iok.float().mean())] * n_intra + \
            ok.float().mean((0, 2, 3)).tolist()
        b_ms, b_by = wk.bound_ms(bs, B, h, w, modes, False, n_extra, live,
                                 bd, deltas)
        print(f"compare lanes {label}: modes agree {frac:.4f}, max_abs_err "
              f"{err}, inter share {inter:.4f}, 3 identical kernel runs, "
              f"error word clear, {n} launches counted; kernel {k:.3f} ms "
              f"({k1:.3f}, {k2:.3f}), plain {p:.3f} ms (one run), bound "
              f"{b_ms:.3f} ms "
              f"({b_by}), {100 * b_ms / k:.1f}% of it; "
              f"{wk.kernel_info(bs, n_intra + n_extra, bd)} [{CARD}]",
              flush=True)
        out[kind] = (err, k, p, b_ms, b_by)
    return out


def timed_once(fn):
    """(fn(), its ms by CUDA events): one run, synchronised."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_compare_10bit():
    """Phase 2c: the kernel's 10-bit form (uint16 pixels, bd=10 clamps)
    against its plain version on the card at the 10-bit main path's shapes
    (luma 1088x1920 B=1 and B=4, paired chroma 544x960 B=2 and B=8) and at
    the 10-bit flat P frame's lane shapes, under phase 2's bar; each shape
    runs the kernel 3 times (identical outputs, clear error word).  Kernel
    ms by CUDA events (two blocks of 10), plain ms from its single run.
    Returns (max_abs_err, kernel ms, plain ms, bound ms, basis) of a
    main-path batch (luma B=4 + chroma B=8) and the lanes' results."""
    max_err, ms, plain_ms, bound, basis = 0, 0.0, 0.0, 0.0, set()
    for label, seed, B, h, w, bs, chroma, vh, main in SHAPES_1080P:
        label = f"10-bit {label} q100" + (" (main path)" if main else "")
        src = torch.from_numpy(plane_src10(seed, B, h, w).astype(
            np.int16)).to(DEV)
        rd, pos, kw = wf_args(bs, 100, chroma, vh, bd=10)
        kern = lambda: wk.wavefront_cuda(src, rd, *pos, **kw)
        plain = lambda: _wavefront_body(src, rd, *pos, **kw)
        got = run_checked(kern)
        for rep in range(2):
            again = run_checked(kern)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{label}: run {rep + 2} differs "
                                     "from run 1")
        ref, p = timed_once(plain)
        frac, err = agree(ref, got, label)
        max_err = max(max_err, err)
        k1 = cuda_ms(kern, 10)
        k2 = cuda_ms(kern, 10)
        wk.raise_on_error(DEV)
        k = (k1 + k2) / 2
        b_ms, b_by = wk.bound_ms(bs, B, h, w, ie.CAND_MODES, chroma, bd=10)
        print(f"compare {label}: modes agree {frac:.4f}, max_abs_err {err}, "
              f"3 identical kernel runs, error word clear; kernel {k:.3f} ms "
              f"({k1:.3f}, {k2:.3f}), plain {p:.3f} ms (one run), bound "
              f"{b_ms:.3f} ms ({b_by}), {100 * b_ms / k:.1f}% of it "
              f"[{CARD}]", flush=True)
        if main:
            ms += k
            plain_ms += p
            bound += b_ms
            basis.add(b_by)
    lanes = phase_compare_lanes(bd=10)
    return (max_err, ms, plain_ms, bound, "+".join(sorted(basis))), lanes


def flat_inter_share(y_mi, h):
    """Share of a flat P frame's luma blocks above row h coded inter."""
    rows = np.arange(y_mi.shape[0]) * 32 < h
    return float((y_mi[rows] >= N_TOP).mean())


def phase_flat_video(bd=8, n=2):
    """The flat low-delay path at 1920x1080 on the card: n frames, I then
    P frames (phase 12: I+P; at bd=10 phase 19: I+P of the 10-bit clip,
    through the kernel's 10-bit form).  Returns the wavefront kernel
    launches of its P frames by kind."""
    frames = (moving_frames if bd == 8 else moving_frames10)(W, H, n)
    enc = ve.VideoEncoder(ie.EncoderConfig(W, H, qindex=100, bit_depth=bd,
                                           **FLAT),
                          keyint=64, device="cuda")
    name = "flat low-delay path" + ("" if bd == 8 else " 10-bit")
    here = os.path.basename(__file__)
    wk.LAUNCHES = 0
    t0 = time.perf_counter()
    payloads, recons, clocks, maps, marks = [], [], [], [], [t0]
    for k, f in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if k == n - 1:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with StageClock(StageClock.FLAT_P) as clock:
                    p, r = enc.encode_frame(*f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        payloads.append(p)
        recons.append(r)
        clocks.append(clock)
        maps.append(dict(enc.last_p) if k else None)
        marks.append(time.perf_counter())
    launches = wk.LAUNCHES
    wk.raise_on_error(DEV)
    syncs = Counter(f"{os.path.basename(c.filename)}:{c.lineno}"
                    for c in caught if "synchroniz" in str(c.message) and
                    os.path.basename(c.filename) != here)
    fmt = lambda ms: ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
    print(f"{name}: {W}x{H} q100 --no-part-search keyint 64: "
          f"key frame (q70) {1e3 * (marks[1] - marks[0]):.1f} ms; e2e "
          f"{n / (marks[n] - marks[0]):.4f} fps over the {n} frames "
          f"[{CARD}]", flush=True)
    by_kind = {"luma": 0, "chroma": 0}
    for k in range(1, n):
        c, m = clocks[k], maps[k]
        nl = {kind: c.launches.get(f"{kind} wavefront", 0)
              for kind in by_kind}
        for kind in by_kind:
            by_kind[kind] += nl[kind]
        modes = {MODE_NAMES[x]: v for x, v in m["mode_counts"].items()}
        share = flat_inter_share(m["y_mi"], H)
        print(f"{name}: P frame {k}: "
              f"{1e3 * (marks[k + 1] - marks[k]):.1f} ms ({fmt(c.ms)}); "
              f"kernel launches luma {nl['luma']}, U+V {nl['chroma']}; GM fit "
              f"{m['gm']}, filter {m['filt']}, deblock levels {m['lf']}; "
              f"luma blocks inter {100 * share:.1f}%; inter modes coded "
              f"{modes}; {len(payloads[k])} bytes", flush=True)
        if nl != {"luma": 1, "chroma": 1}:
            raise AssertionError(f"P frame {k}: kernel launches {nl}, not "
                                 "one luma and one U+V")
        if share <= 0.5:
            raise AssertionError(f"P frame {k}: only {100 * share:.1f}% of "
                                 "the luma blocks inter")
    print(f"{name}: device syncs of P frame {n - 1}: "
          f"{sum(syncs.values())} ({dict(syncs)}); kernel launches on the "
          f"path {launches} (key frame {launches - sum(by_kind.values())}), "
          f"key frame {len(payloads[0])} bytes", flush=True)
    ps_y = check_payloads(payloads, frames, recons, name, bd)
    types = [frame_type(p) for p in payloads]
    print(f"{name}: frame types {types}, luma PSNR "
          f"{', '.join(f'{p:.2f}' for p in ps_y)} dB (peak {(1 << bd) - 1})",
          flush=True)
    if types != [0] + [1] * (n - 1):
        raise AssertionError(f"frame types {types}, not KEY then INTER")
    if bd != 8:
        DECODE10["10-bit flat I+P (phase 19)"] = (payloads, recons, False,
                                                  None)
    return by_kind


def flat_maps(enc, key_dev):
    """A flat low-delay frame's decision maps: the key frame's from its
    device_encode, a P frame's from last_p."""
    if key_dev is not None:
        return {k: key_dev[k].cpu().numpy() for k in ("y_mi", "uv_mi")}
    m = enc.last_p
    return {k: m[k] for k in ("y_mi", "uv_mi", "mv32", "mv_t")} | {
        "gm": np.array(m["gm"] or (0, 0)), "filt": np.array(m["filt"])}


def phase_flat_video_card_vs_cpu():
    """The flat low-delay path at 256x128 (I, P, P) on the card and on the
    CPU, with --no-part-search's defaults and with preset 13."""
    w, h = 256, 128
    for label in ("--no-part-search", "preset 13"):
        runs = both_halves(f"flat {label}")
        out = {d: ([(u[0][0], u[1][0], u[2]) for u in r[0]], r[1])
               for d, r in runs.items()}
        lines = []
        for k, ((pc, rc, mc), (pp, rp, mp)) in enumerate(zip(out["cuda"][0],
                                                             out["cpu"][0])):
            fr = {n: float((mc[n] == mp[n]).mean()) for n in mc}
            same = all(v == 1.0 for v in fr.values())
            equal = pc == pp and all(np.array_equal(a, b)
                                     for a, b in zip(rc, rp))
            lines.append(f"frame {k}: " + ", ".join(
                f"{n} {v:.4f}" for n, v in fr.items()) +
                f"; payload and recon identical {equal}")
            if fr.get("mv32", 1.0) != 1.0:
                raise AssertionError(f"{label} frame {k}: ME fields differ "
                                     "on the same reference")
            if min(fr["y_mi"], fr["uv_mi"]) < 0.99:
                raise AssertionError(f"{label} frame {k}: modes agree "
                                     f"{fr['y_mi']:.4f} / {fr['uv_mi']:.4f}")
            if same and not equal:
                raise AssertionError(f"{label} frame {k}: maps agree but the "
                                     "payload or recon differs")
            if not same:
                lines[-1] += " (first frame that differs: later frames " \
                    "have other references)"
                break
        print(f"card vs CPU, flat low-delay path {w}x{h} I,P,P ({label}; "
              f"card {out['cuda'][1]:.1f} s, CPU {out['cpu'][1]:.1f} s):",
              flush=True)
        for line in lines:
            print(f"card vs CPU ({label}): {line}", flush=True)


# ---- the flat pyramid -------------------------------------------------------

def tu_kind(payload):
    """'overlay' (show_existing_frame), 'key', 'inter' or 'inter, no-show'
    from the first frame header of a temporal unit."""
    for t, _, _, d in parse_obus(payload):
        if t in (OBU_FRAME, OBU_FRAME_HEADER):
            if d[0] >> 7:
                return "overlay"
            kind = ("key", "inter")[min(1, (d[0] >> 5) & 3)]
            return kind if (d[0] >> 4) & 1 else kind + ", no-show"
    raise AssertionError("no frame header in the payload")


def timed(fn, log):
    """fn wrapped: each call is timed between two synchronizes, its wall
    ms and kernel launches appended to log."""
    def call(*a, **kw):
        torch.cuda.synchronize()
        n0, t0 = wk.LAUNCHES, time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log.append((1e3 * (time.perf_counter() - t0), wk.LAUNCHES - n0))
        return out
    return call


def phase_flat_pyramid():
    """The flat pyramid at 1920x1080 on the card: a key frame and one
    mini-GoP of 8 (TF on, long-range ME on the anchor), with the kernel
    launch counts set to 0 before and read after.  Returns the wavefront
    kernel launches of its P frames by kind."""
    n_src = 9
    frames = moving_frames(W, H, n_src)
    enc = ve.VideoEncoder(ie.EncoderConfig(W, H, qindex=100, **FLAT),
                          keyint=64, pyramid=True, gop=8, tf=True,
                          device="cuda")
    here = os.path.basename(__file__)
    coded, tf_log, key_log = [], [], []
    code = enc._encode_ref_frame

    def code_frame(frame, cand_slots, layer, refresh_slot, show, refresh_t):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if len(coded) == 2:              # an interior frame (layer 2)
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with StageClock(StageClock.FLAT_P) as clock:
                    n0, t0 = wk.LAUNCHES, time.perf_counter()
                    out = code(frame, cand_slots, layer, refresh_slot, show,
                               refresh_t)
                    ms = 1e3 * (time.perf_counter() - t0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = Counter(f"{os.path.basename(c.filename)}:{c.lineno}"
                        for c in caught if "synchroniz" in str(c.message) and
                        os.path.basename(c.filename) != here)
        coded.append(dict(layer=layer, slot=refresh_slot, t=refresh_t,
                          ms=ms, clock=clock, m=dict(enc.last_p),
                          bytes=len(out[0]), launches=wk.LAUNCHES - n0,
                          syncs=syncs))
        return out

    enc._encode_ref_frame = code_frame
    enc._tf_filter = timed(enc._tf_filter, tf_log)
    enc.intra.encode_frames = timed(enc.intra.encode_frames, key_log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.LAUNCHES = 0
    t0 = time.perf_counter()
    payloads, recons = enc.encode_frames(frames)
    p, r = enc.flush()
    payloads, recons = payloads + p, recons + r
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = wk.LAUNCHES
    wk.raise_on_error(DEV)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    kinds = [tu_kind(x) for x in payloads]
    print(f"flat pyramid: {W}x{H} q100 --no-part-search --pyramid --tf gop 8 "
          f"keyint 64, {n_src} frames: {len(payloads)} TUs "
          f"({kinds.count('overlay')} overlays), e2e {n_src / dt:.4f} fps "
          f"({dt:.1f} s, first encode_frames to the end of flush), peak "
          f"device memory {peak:.1f} MiB, kernel launches {launches} "
          f"[{CARD}]", flush=True)
    print(f"flat pyramid: key frame (q{enc.intra.cfg.qindex}) "
          f"{key_log[0][0]:.1f} ms, {key_log[0][1]} launches, "
          f"{len(payloads[0])} bytes; TF of the key frame and the anchor "
          f"{', '.join(f'{t:.1f}' for t, _ in tf_log)} ms", flush=True)
    by_kind = {"luma": 0, "chroma": 0}
    for k, c in enumerate(coded):
        st, m = c["clock"].ms, c["m"]
        n = {kind: c["clock"].launches.get(f"{kind} wavefront", 0)
             for kind in by_kind}
        for kind in by_kind:
            by_kind[kind] += n[kind]
        dev_ms = sum(v for key, v in st.items() if key != "tile coder")
        tf_ms = f"{tf_log[1][0]:.1f}" if k == 0 else "-"
        print(f"flat pyramid: decode order {k + 1}: layer {c['layer']}, q "
              f"{m['q']}, reference slot {m['ref_slot']} (distance "
              f"{m['ref_dist']}), refresh slot {c['slot']}; ME "
              f"{st.get('ME 32', 0.0):.1f} ms "
              f"({'long-range' if m['ref_dist'] > 4 else 'standard'}); TF "
              f"{tf_ms} ms; device stage {dev_ms:.1f} ms; coder "
              f"{st.get('tile coder', 0.0):.1f} ms; frame {c['ms']:.1f} ms; "
              f"{c['bytes']} bytes; launches luma {n['luma']}, U+V "
              f"{n['chroma']}; inter "
              f"{100 * flat_inter_share(m['y_mi'], H):.1f}%", flush=True)
        if n != {"luma": 1, "chroma": 1}:
            raise AssertionError(f"coded frame {k + 1}: kernel launches {n},"
                                 " not one luma and one U+V")
    print(f"flat pyramid: device syncs of the layer-2 frame: "
          f"{sum(coded[2]['syncs'].values())} ({dict(coded[2]['syncs'])})",
          flush=True)
    if len(recons) != n_src or len(payloads) != 2 * n_src - 1:
        raise AssertionError(f"{len(recons)} recons, {len(payloads)} TUs: "
                             f"not {n_src} and {2 * n_src - 1}")
    want = ["key"] + ["inter, no-show"] * 8
    if sorted(k for k in kinds if k != "overlay") != sorted(want) or \
            kinds.count("overlay") != 8 or kinds[0] != "key":
        raise AssertionError(f"TU kinds {kinds}")
    if coded[0]["m"]["ref_dist"] != 8:
        raise AssertionError("the anchor's reference is not 8 frames away")
    # the decode-order prefix up to its first overlay, with the display
    # index of each coded inter frame, for phase 16
    first = kinds.index("overlay")
    DECODE["flat pyramid prefix (phase 14)"] = (
        payloads[:first + 1], recons, False,
        [None] + [c["t"] for c in coded[:first - 1]])
    ps_y = [psnr(f[0], r_[0]) for f, r_ in zip(frames, recons)]
    print(f"flat pyramid: luma PSNR (display order) "
          f"{', '.join(f'{x:.2f}' for x in ps_y)} dB", flush=True)
    if min(ps_y) <= 30.0:
        raise AssertionError(f"luma PSNR {min(ps_y):.2f} dB <= 30")
    return by_kind


def pyramid_maps(enc):
    """A pyramid P frame's decision maps, mvs, q and slots from last_p."""
    return flat_maps(enc, None) | {k: np.array(enc.last_p[k]) for k in (
        "q", "ref_slot", "refresh", "lf")}


def run_pyramid(cfg, frames, device, rc, tf_hook, gop=8):
    """The flat pyramid (gop 8, TF on) on `device`: (payloads, recons,
    each coded frame's maps, seconds).  tf_hook(planes) sees each filtered
    anchor and returns the planes to code."""
    enc = ve.VideoEncoder(cfg, keyint=64, pyramid=True, gop=gop, tf=True,
                          rc=rc, device=device)
    coded = []
    code, filt = enc._encode_p_flat, enc._tf_filter

    def code_frame(*a, **kw):
        out = code(*a, **kw)
        coded.append(pyramid_maps(enc))
        return out

    enc._encode_p_flat = code_frame
    enc._tf_filter = lambda *a: tf_hook(filt(*a))
    t0 = time.perf_counter()
    payloads, recons = enc.encode_frames(frames)
    p, r = enc.flush()
    return payloads + p, recons + r, coded, time.perf_counter() - t0


def phase_flat_pyramid_card_vs_cpu():
    """The flat pyramid at 256x128 (TF on, gop 8) on the card and on the
    CPU: CQ q100 on 17 frames, CBR at half the bitrate CQ reached, and a
    scene cut inside a mini-GoP.  The card's filtered anchors are compared
    with the CPU's and then fed to the CPU encoder (a pixel can differ by
    one where exp rounds apart), so every map, mv, q, slot and byte must
    be equal.  The CPU halves run in a worker, their checks at the end of
    the script (DEFERRED)."""
    from svtav1_tpu_torch.encoder.rate_control import RateControl
    w, h = 256, 128
    cfg = ie.EncoderConfig(w, h, qindex=100, **FLAT)
    clip = moving_frames(w, h, 17)
    cut = moving_frames(w, h, 6) + [tuple(255 - p for p in f) for f in
                                    moving_frames(w, h, 6, seed=1)]
    kbps = None
    for label, frames in (("CQ q100", clip), ("CBR", clip),
                          ("scene cut", cut)):
        rc_kbps = kbps if label == "CBR" else None
        rc = None if rc_kbps is None else RateControl(
            "cbr", qindex=100, target_kbps=rc_kbps, fps=30.0)
        card_tf = []
        card = run_pyramid(cfg, frames, "cuda", rc,
                           lambda x: card_tf.append(x) or x)
        fut = cpu_submit(pyramid_side, cfg, frames, rc_kbps, card_tf, 8,
                         False)

        def check(label=label, frames=frames, card=card, card_tf=card_tf,
                  fut=fut):
            cpu, diffs = fut.result()
            n_diff = [n for f in diffs for n, _ in f]
            print(f"card vs CPU, flat pyramid {w}x{h} ({label}, "
                  f"{len(frames)} frames; card {card[3]:.1f} s, CPU "
                  f"{cpu[3]:.1f} s): {len(card_tf)} TF calls, pixels that "
                  f"differ (Y, U, V each) {n_diff}", flush=True)
            if any(m > 1 for f in diffs for _, m in f):
                raise AssertionError(f"{label}: a TF pixel differs by more "
                                     "than one")
            if len(card[2]) != len(cpu[2]):
                raise AssertionError(f"{label}: coded frames differ")
            for k, (mc, mp) in enumerate(zip(card[2], cpu[2])):
                bad = [n for n in mc if not np.array_equal(mc[n], mp[n])]
                if bad:
                    raise AssertionError(f"{label}: coded frame {k + 1}: "
                                         f"{bad} differ")
            if card[0] != cpu[0] or not all(
                    np.array_equal(a, b) for x, y in zip(card[1], cpu[1])
                    for a, b in zip(x, y)):
                raise AssertionError(f"{label}: payloads or recons differ")
            print(f"card vs CPU ({label}): {len(card[2])} coded P frames, "
                  f"maps, mvs, q, slots, {len(card[0])} payloads and "
                  f"{len(card[1])} recons identical", flush=True)
        DEFERRED.append((f"flat pyramid {label}", check))
        nbytes = sum(len(x) for x in card[0])
        qs = [int(m["q"]) for m in card[2]]
        kinds = [tu_kind(x) for x in card[0]]
        print(f"card, flat pyramid {w}x{h} ({label}): {len(card[2])} coded "
              f"P frames, {len(card[0])} payloads; key frames "
              f"{kinds.count('key')}, overlays {kinds.count('overlay')}; q "
              f"in decode order {qs}; "
              f"{nbytes * 8 * 30 / len(frames) / 1000:.1f} kbps (the CPU "
              f"half runs beside)", flush=True)
        if label == "CQ q100":
            kbps = max(1, int(nbytes * 8 * 30 / len(frames) / 1000 / 2))
        if label == "scene cut" and kinds.count("key") != 2:
            raise AssertionError(f"scene cut: {kinds.count('key')} key "
                                 "frames")


DECODE10 = {}        # the same for the 10-bit streams of phases 18-19
DECODE = {}          # label -> (payloads, recons, ccso, display index
#                      of each TU's coded frame or None), from phases
#                      3, 8, 10, 14 and 22
DEC_STAGES = (("_parse_tiles", "parse"), ("_residuals", "residual"),
              ("_predict_inter", "inter"), ("_predict_intra", "intra"),
              ("_filter_frame", "filters"), ("_output_frame", "output"))


def timed_decoder(dec, ms):
    """Wrap the decoder's stages: each call is timed between two
    synchronizes into ms[stage name]."""
    for attr, name in DEC_STAGES:
        def call(*a, _fn=getattr(dec, attr), _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            ms[_name] = ms.get(_name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out
        setattr(dec, attr, call)
    return dec


def same_planes(a, b):
    return all(np.array_equal(x, np.asarray(y)) for x, y in zip(a, b))


def phase_decode(streams=None):
    """The port's Decoder on the card over the 1080p streams that phases
    3, 8, 10, 14 and 22 encoded on the card (phase 16; phase 20: the 10-bit
    streams of phases 18 and 19, whose uint16 outputs must equal the
    encoder's recons): every output equals the encoder's recon in display
    order, every no-show frame's DPB entry its recon, and the frame count
    is right.  Per TU: stage times (each between two synchronizes), device
    syncs (set_sync_debug_mode, this script's own synchronizes excluded),
    bytes and q."""
    from svtav1_tpu_torch.decoder.decoder import Decoder
    here = os.path.basename(__file__)
    streams = DECODE if streams is None else streams
    if not streams:
        raise AssertionError("no stream to decode")
    for label, (payloads, recons, ccso, display) in streams.items():
        ms = {}
        dec = timed_decoder(Decoder(ccso=ccso, device="cuda"), ms)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outs, total = [], 0.0
        for k, p in enumerate(payloads):
            ms.clear()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    t0 = time.perf_counter()
                    out = dec.decode_frame_obus(p)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            total += dt
            syncs = sum("synchroniz" in str(c.message) and
                        os.path.basename(c.filename) != here
                        for c in caught)
            kind = tu_kind(p)
            q = "-" if kind == "overlay" else dec.frame_header.base_q_idx
            stages = ", ".join(f"{n} {ms.get(n, 0.0):.1f}"
                               for _, n in DEC_STAGES)
            print(f"decode {label}: TU {k + 1} {kind}, q {q}, {len(p)} "
                  f"bytes: {1e3 * dt:.1f} ms ({stages} ms), device syncs "
                  f"{syncs} [{CARD}]", flush=True)
            if out is not None:
                if not same_planes(out, recons[len(outs)]):
                    raise AssertionError(f"decode {label}: output "
                                         f"{len(outs)} differs from the "
                                         "encoder's recon")
                outs.append(out)
            if kind == "inter, no-show":
                flags = dec.frame_header.refresh_frame_flags
                slot = (flags & -flags).bit_length() - 1
                if not same_planes(dec.reference(slot),
                                   recons[display[k]]):
                    raise AssertionError(f"decode {label}: TU {k + 1}'s DPB "
                                         "entry differs from its recon")
        want = sum(tu_kind(p) != "inter, no-show" for p in payloads)
        if len(outs) != want:
            raise AssertionError(f"decode {label}: {len(outs)} frames, not "
                                 f"{want}")
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        print(f"decode {label}: {len(payloads)} TUs, {len(outs)} frames "
              f"equal to the encoder's recons (no-show DPB entries too), "
              f"{len(outs) / total:.4f} fps ({total:.2f} s), peak device "
              f"memory {peak:.1f} MiB above what was allocated before "
              f"[{CARD}]", flush=True)


def read_stream(path):
    from svtav1_tpu_torch.utils.ivf import read_ivf
    with open(path, "rb") as f:
        return [p for p, _ in read_ivf(f)[1]]


def decode_all(payloads, device, ccso=False):
    """(the shown frames, the decoder) of a stream on `device`."""
    from svtav1_tpu_torch.decoder.decoder import Decoder
    dec = Decoder(ccso=ccso, device=device)
    return [o for o in map(dec.decode_frame_obus, payloads)
            if o is not None], dec


def frame_md5(planes):
    import hashlib
    m = hashlib.md5()
    for p in planes:
        m.update(p.tobytes())
    return m.hexdigest()


def tile_spans(payloads, ccso):
    """Per TU, the lengths of its frame OBU's payload and of the tile data
    at its end (a CPU decode), or None for a TU without a frame OBU (the
    frame OBU is each TU's last)."""
    from svtav1_tpu_torch.decoder.decoder import Decoder
    dec, spans = Decoder(ccso=ccso, device="cpu"), []
    parse = dec._parse_tiles

    def record(tile_data, seq, fr):
        spans[-1] = (spans[-1], len(tile_data))
        return parse(tile_data, seq, fr)

    dec._parse_tiles = record
    for p in payloads:
        last = list(parse_obus(p))[-1]
        spans.append(len(last[3]) if last[0] == OBU_FRAME else None)
        dec.decode_frame_obus(p)
    return spans


FLIP_SPANS = {"tile data": lambda obu, tiles: tiles,
              "tile tail": lambda obu, tiles: min(16, tiles),
              "frame": lambda obu, tiles: obu}


def flip_byte(payload, span, seed):
    """`payload` with one seeded byte among its last `span` XORed."""
    rng = np.random.RandomState(seed)
    b = bytearray(payload)
    b[len(b) - span + int(rng.randint(span))] ^= int(rng.randint(1, 256))
    return bytes(b)


def decode_outcome(payloads, device, ccso):
    """The shown frames of a decode, or the DecodeError's message.  Any
    other exception (a device-side assert surfaces as a RuntimeError)
    fails the phase."""
    from svtav1_tpu_torch.decoder.decoder import DecodeError
    try:
        return decode_all(payloads, device, ccso)[0]
    except DecodeError as e:
        return str(e)


def corrupt_card_vs_cpu(label, payloads, ccso):
    """Seeded one-byte flips in each TU's tile data, in its last 16 tile
    bytes, and anywhere in its frame OBU: the card raises the CPU's
    DecodeError or decodes the CPU's frames.  Returns (cases, errors,
    full decodes, full decodes whose output the flip changed)."""
    clean = decode_outcome(payloads, "cpu", ccso)
    n = [0, 0, 0, 0]
    for k, span in enumerate(tile_spans(payloads, ccso)):
        if span is None:
            continue
        for where, seed in [(w, s) for w in FLIP_SPANS for s in range(2)]:
            bad = flip_byte(payloads[k], FLIP_SPANS[where](*span), seed)
            stream = payloads[:k] + [bad] + payloads[k + 1:]
            card = decode_outcome(stream, "cuda", ccso)
            cpu = decode_outcome(stream, "cpu", ccso)
            case = f"{label}, TU {k + 1}, {where}, seed {seed}"
            n[0] += 1
            if isinstance(card, str) or isinstance(cpu, str):
                if card != cpu:
                    raise AssertionError(f"corrupt {case}: card {card!r}, "
                                         f"CPU {cpu!r}")
                n[1] += 1
                continue
            if len(card) != len(cpu) or not all(
                    same_planes(a, b) for a, b in zip(card, cpu)):
                raise AssertionError(f"corrupt {case}: card and CPU differ")
            n[2] += 1
            n[3] += not all(same_planes(a, b) for a, b in zip(card, clean))
    return n


def phase_decode_card_vs_cpu():
    """The decoder's full syntax on the card and on the CPU: the JAX
    encoder's fixture streams (compound pyramid, two tile columns,
    10-bit, angle deltas; and the angle-delta fixtures of
    ``tests/data/torch_deltas`` too, V_PRED / H_PRED with a delta among
    them; outputs also equal the MD5s stored beside them) and two
    port-encoded 256x128 streams (film grain on the flat
    low-delay path; CDEF + CCSO + LR on the partition path).
    Then a stream cut inside its frame header raises DecodeError on the
    card; seeded byte flips in the fixtures' and the CCSO stream's tile
    data and frame OBUs give the card the CPU's DecodeError or frames
    (stream-derived values reach the device stages); and a decode after
    them still succeeds."""
    from svtav1_tpu_torch.decoder.decoder import DecodeError
    from svtav1_tpu_torch.utils.obu import OBU_SEQUENCE_HEADER, wrap_obu
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "torch_dec")
    with open(os.path.join(fix, "md5.json")) as f:
        md5 = json.load(f)
    w, h = 256, 128
    fg = ve.VideoEncoder(ie.EncoderConfig(w, h, film_grain=20, **FLAT),
                         keyint=64, device="cuda")
    ccso = ie.IntraEncoder(ie.EncoderConfig(w, h, **FILTERS), device="cuda")
    streams = {name: (read_stream(os.path.join(fix, f"{name}.ivf")), False,
                      md5[name]["frames"]) for name in sorted(md5)}
    # the angle-delta fixtures (presets 0-5; one codes V_PRED / H_PRED with
    # a delta, which the port's decoder predicts as the spec does)
    fix_d = os.path.join(os.path.dirname(fix), "torch_deltas")
    with open(os.path.join(fix_d, "md5.json")) as f:
        md5_d = json.load(f)
    for name in sorted(md5_d):
        streams[f"deltas {name}"] = (
            read_stream(os.path.join(fix_d, f"{name}.ivf")), False,
            md5_d[name]["frames"])
    streams["film grain 256x128 (port)"] = (
        fg.encode_frames(moving_frames(w, h, 3))[0], False, None)
    streams["CDEF + CCSO + LR 256x128 (port)"] = (
        ccso.encode_frames(edge_frames(w, h, 1))[0], True, None)
    for label, (payloads, use_ccso, want) in streams.items():
        t0 = time.perf_counter()
        card, dec = decode_all(payloads, "cuda", use_ccso)
        t1 = time.perf_counter()
        cpu, _ = decode_all(payloads, "cpu", use_ccso)
        t2 = time.perf_counter()
        fr = dec.frame_header
        if "film grain" in label and fr.film_grain is None:
            raise AssertionError(f"decode {label}: no film grain signalled")
        if "CCSO" in label and (fr.ccso is None or not any(
                fr.lr_frame_types) or not any(sum(fr.cdef_y_strengths +
                                                  fr.cdef_uv_strengths, ()))):
            raise AssertionError(f"decode {label}: a filter is off")
        if len(card) != len(cpu) or not all(
                same_planes(a, b) for a, b in zip(card, cpu)):
            raise AssertionError(f"decode {label}: card and CPU differ")
        if want is not None and [frame_md5(o) for o in card] != want:
            raise AssertionError(f"decode {label}: MD5s differ from the "
                                 "JAX encoder's recons")
        print(f"decode card vs CPU, {label}: {len(payloads)} TUs, "
              f"{len(card)} frames equal"
              f"{'' if want is None else ', MD5s as stored'} (card "
              f"{t1 - t0:.2f} s, CPU {t2 - t1:.2f} s)", flush=True)
    pyr = streams["compound_pyramid"][0]
    seq = [wrap_obu(t, d) for t, _, _, d in parse_obus(pyr[0])
           if t == OBU_SEQUENCE_HEADER][0]
    key = [wrap_obu(t, d) for t, _, _, d in parse_obus(pyr[0])
           if t == OBU_FRAME][0]
    try:
        decode_all([seq + key[:8]], "cuda")        # cut in its header
    except DecodeError as e:
        print(f"decode card: a key frame cut in its header raises "
              f"DecodeError({e})", flush=True)
    else:
        raise AssertionError("the cut stream decoded")
    changed = 0
    for label in sorted(md5) + ["CDEF + CCSO + LR 256x128 (port)"]:
        payloads, use_ccso, _ = streams[label]
        t0 = time.perf_counter()
        cases, errors, full, diff = corrupt_card_vs_cpu(label, payloads,
                                                        use_ccso)
        changed += diff
        print(f"decode card vs CPU, {label} with a byte flipped: {cases} "
              f"cases, {errors} equal DecodeErrors, {full} equal full "
              f"decodes ({diff} of them changed by the flip) "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if not changed:
        raise AssertionError("no corrupt stream reached the device stages")
    again, _ = decode_all(streams["two_tiles"][0], "cuda")
    if [frame_md5(o) for o in again] != md5["two_tiles"]["frames"]:
        raise AssertionError("a decode after the DecodeErrors differs")
    print("decode card: the two-tile stream decodes after them, MD5s as "
          "stored (the context is not poisoned)", flush=True)


def frames_agree(label, card, cpu, modes_bar=False, tag="10-bit"):
    """card / cpu: (payload(s), recon(s), maps) of each coded unit in
    coding order, from the card and the CPU.  Per unit the agreement of
    every map; byte-identical payloads and equal recons whenever every map
    agrees; the units after the first whose maps differ are not compared
    (their references differ).  modes_bar: the kernel's modes (y_mi,
    uv_mi) must agree on >= 99% (phase 2's bar)."""
    lines = []
    for k, ((pc, rc, mc), (pp, rp, mp)) in enumerate(zip(card, cpu)):
        fr = {n: float((np.asarray(mc[n]) == np.asarray(mp[n])).mean())
              for n in mc}
        same = all(v == 1.0 for v in fr.values())
        equal = pc == pp and all(np.array_equal(a, b) for x, y in
                                 zip(rc, rp) for a, b in zip(x, y))
        lines.append(f"unit {k}: " + ", ".join(
            f"{n} {v:.4f}" for n, v in fr.items()) +
            f"; payloads and recons identical {equal}")
        if modes_bar and min(fr.get("y_mi", 1.0), fr.get("uv_mi", 1.0)) < \
                0.99:
            raise AssertionError(f"{label} unit {k}: modes agree "
                                 f"{fr.get('y_mi')} / {fr.get('uv_mi')}")
        if same and not equal:
            raise AssertionError(f"{label} unit {k}: maps agree but the "
                                 "payloads or recons differ")
        if not same:
            lines[-1] += " (the first unit that differs: later ones have " \
                "other references)"
            break
    for line in lines:
        print(f"card vs CPU, {tag} {label}: {line}", flush=True)


def low_delay_units(device, cfg, clip, flat, hook=None):
    """A low-delay encode of clip on device: (units, seconds), a unit a
    frame ([payload], [recon], maps): the key frame's maps from its
    device_encode, a P frame's from last_p (flat or partition maps).
    hook(enc, key_dev) runs after each frame."""
    enc = ve.VideoEncoder(cfg, keyint=64, device=device)
    key_dev = []
    run = enc.intra.device_encode
    enc.intra.device_encode = lambda fr: key_dev.append(run(fr)) or \
        key_dev[-1]
    t0 = time.perf_counter()
    units = []
    for f in clip:
        p, r = enc.encode_frame(*f)
        if units:
            m = flat_maps(enc, None) if flat else p_maps(enc)
        else:
            m = flat_maps(enc, key_dev[-1]) if flat else \
                part_maps(key_dev[-1])
        units.append(([p], [r], m))
        if hook is not None:
            hook(enc, key_dev)
    check_payloads([x[0][0] for x in units], clip, [x[1][0] for x in units],
                   f"{cfg.width}x{cfg.height} low-delay on {device}",
                   cfg.bit_depth)
    return units, time.perf_counter() - t0


def phase_10bit_card_vs_cpu():
    """Phase 21: the four 10-bit paths at 256x128 on the card and on the
    CPU: partition all-intra with CDEF + LR + CCSO (2 frames of the 10-bit
    edge clip, one batch), low-delay partition I, P, P and flat I, P, P
    (the 10-bit moving clip), and the flat pyramid (gop 4, TF on, 9
    frames; the card's filtered anchors fed to the CPU encoder, its checks
    at the end of the script).  Per coded unit the agreement of every
    decision map, and byte-identical payloads plus equal recons whenever
    every map agrees."""
    w, h = 256, 128
    bd = 10
    cfg = lambda **kw: ie.EncoderConfig(w, h, qindex=100, bit_depth=bd,
                                        **kw)
    # partition all-intra with the three filters
    runs = {d: ([(r[1], r[2], r[0])], r[3], r[4]) for d, r in
            both_halves("10-bit partition + filters").items()}
    lines, _ = describe_filters(*runs["cuda"][2])
    print(f"card vs CPU, 10-bit partition all-intra {w}x{h} x2 with CDEF + "
          f"LR + CCSO (card {runs['cuda'][1]:.1f} s, CPU "
          f"{runs['cpu'][1]:.1f} s); card: {'; '.join(lines)}", flush=True)
    frames_agree("partition all-intra + filters", runs["cuda"][0],
                 runs["cpu"][0])

    # the low-delay paths, I, P, P
    for label, flat in (("low-delay partition I,P,P", False),
                        ("flat low-delay I,P,P", True)):
        runs = both_halves(f"10-bit {label}")
        types = [frame_type(x[0][0]) for x in runs["cuda"][0]]
        print(f"card vs CPU, 10-bit {label} {w}x{h} (card "
              f"{runs['cuda'][1]:.1f} s, CPU {runs['cpu'][1]:.1f} s): frame "
              f"types {types}", flush=True)
        if types != [0, 1, 1]:
            raise AssertionError(f"10-bit {label}: frame types {types}")
        frames_agree(label, runs["cuda"][0], runs["cpu"][0],
                     modes_bar=flat)

    # the flat pyramid, gop 4, TF on
    clip = moving_frames10(w, h, 9)
    card_tf = []
    card = run_pyramid(cfg(**FLAT), clip, "cuda", None,
                       lambda x: card_tf.append(x) or x, gop=4)
    kinds = [tu_kind(x) for x in card[0]]
    if kinds.count("overlay") < 2 or len(card[1]) != 9:
        raise AssertionError(f"10-bit pyramid: TUs {kinds}")
    fut = cpu_submit(pyramid_side, cfg(**FLAT), clip, None, card_tf, 4,
                     False)

    def check(fut=fut, card=card, card_tf=card_tf):
        cpu, diffs = fut.result()
        print(f"card vs CPU, 10-bit flat pyramid {w}x{h} gop 4 TF (9 "
              f"frames; card {card[3]:.1f} s, CPU {cpu[3]:.1f} s): "
              f"{len(card_tf)} TF calls, pixels the card's TF planes differ "
              f"by from the CPU's {[[n for n, _ in f] for f in diffs]}; "
              f"{len(card[0])} TUs, overlays {kinds.count('overlay')}",
              flush=True)
        units = lambda r: [(None, [], m) for m in r[2]]
        frames_agree("flat pyramid (coded P frames)", units(card),
                     units(cpu), modes_bar=True)
        if all(all(np.array_equal(mc[n], mp[n]) for n in mc)
               for mc, mp in zip(card[2], cpu[2])):
            same = card[0] == cpu[0] and all(
                np.array_equal(a, b) for x, y in zip(card[1], cpu[1])
                for a, b in zip(x, y))
            print(f"card vs CPU, 10-bit flat pyramid: every map agrees; "
                  f"{len(card[0])} payloads and 9 recons identical {same}",
                  flush=True)
            if not same:
                raise AssertionError("10-bit pyramid: maps agree but "
                                     "payloads or recons differ")
    DEFERRED.append(("10-bit flat pyramid", check))


# ---- the compound partition pyramid and the scan's graphs -------------------

COMP_MODES = {17: "NEAREST_NEAREST", 23: "GLOBAL_GLOBAL", 24: "NEW_NEW"}


def graph_snapshot():
    return {k: v for k, v in wf2.GRAPHS.items() if k != "log"}


def graph_delta(g0):
    """The scan's graph captures and replays since the GRAPHS snapshot g0,
    with their seconds."""
    g = wf2.GRAPHS
    return (f"step graphs captured {g['captures'] - g0['captures']} "
            f"({g['capture_s'] - g0['capture_s']:.1f} s), replayed "
            f"{g['replays'] - g0['replays']} times in "
            f"{g['calls'] - g0['calls']} scan calls "
            f"({g['replay_s'] - g0['replay_s']:.3f} s to enqueue)")


def print_captures(label, log):
    """One line per scan shape captured in log (wf2.GRAPHS["log"]
    entries, one a step graph): its step graphs, nodes, capture and
    instantiate seconds, the device memory reserved and the host RSS after
    its last capture."""
    shapes = {}
    for c in log:
        shapes.setdefault(c["key"], []).append(c)
    for key, cs in shapes.items():
        _, B, h, w, bs, chroma, bd, _, _, n_extra, deltas = key
        form = "key-frame" if n_extra is None else f"{n_extra} lanes"
        if deltas != (0,):
            form += (f", angle deltas {deltas} ("
                     f"{len(expand_candidates(ie.CAND_MODES, deltas))} "
                     "luma candidates)")
        nodes = [c["nodes"] for c in cs]
        n_txt = "not read" if None in nodes else f"{sum(nodes)}"
        rss = cs[-1]["rss_bytes"]
        rss = "not read" if rss is None else f"{rss / 2 ** 30:.2f} GiB"
        print(f"{label}: captured {'U+V' if chroma else 'luma'} scan "
              f"{B}x{h}x{w} bs {bs} bd {bd} {form}: {len(cs)} step graphs "
              f"(widths {sorted(c['D'] for c in cs)}), {n_txt} nodes, "
              f"capture {sum(c['capture_s'] for c in cs):.1f} s, "
              f"instantiate {sum(c['instantiate_s'] for c in cs):.1f} s; "
              f"device memory reserved "
              f"{cs[-1]['reserved_bytes'] / 2 ** 20:.0f} MiB, host RSS "
              f"{rss} after it [{CARD}]", flush=True)


def block_counts(m):
    """(compound blocks by mode, single-reference blocks, intra blocks)
    that a P frame's tile coder coded."""
    mc = m["mode_counts"]
    comp = {n: mc.get(k, 0) for k, n in COMP_MODES.items()}
    single = sum(v for k, v in mc.items() if k in MODE_NAMES)
    return comp, single, m["n_intra"]


def phase_part_pyramid():
    """Phase 22: the compound partition pyramid at 1920x1080 on the card,
    VideoEncoder(qindex=100, keyint=64, pyramid=True, gop=2, tf=True) on 3
    frames of moving_frames: the key frame, the no-show anchor (layer 0,
    the TPL lambda map), the no-show compound frame, the overlays.  Stage
    times of each frame after a synchronize, the scan's graph captures
    and replays, q and bytes, the block counts, the compound frame's
    device syncs, e2e fps; the stream goes to phase 16."""
    n_src = 3
    frames = moving_frames(W, H, n_src)
    enc = ve.VideoEncoder(ie.EncoderConfig(W, H, qindex=100), keyint=64,
                          pyramid=True, gop=2, tf=True, device="cuda")
    here = os.path.basename(__file__)
    coded, tf_log, key_log, coded_t = [], [], [], []
    code, ref_frame = enc._encode_p_part, enc._encode_ref_frame
    key_clock = StageClock(StageClock.KEY)
    key_run = timed(enc.intra.encode_frames, key_log)
    n_log = len(wf2.GRAPHS["log"])

    def key_frames(fr):
        g0 = graph_snapshot()
        with key_clock:
            out = key_run(fr)
        key_log[-1] += (graph_delta(g0),)
        return out

    def code_frame(*a, **kw):
        comp = kw.get("ref2") is not None
        g0 = graph_snapshot()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if comp:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with StageClock(StageClock.P_COMP) as clock:
                    t0 = time.perf_counter()
                    out = code(*a, **kw)
                    ms = 1e3 * (time.perf_counter() - t0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = Counter(f"{os.path.basename(c.filename)}:{c.lineno}"
                        for c in caught if "synchroniz" in str(c.message) and
                        os.path.basename(c.filename) != here)
        coded.append(dict(ms=ms, clock=clock, m=dict(enc.last_p),
                          bytes=len(out[0]), syncs=syncs,
                          graphs=graph_delta(g0)))
        return out

    def ref_frame_t(frame, cand_slots, layer, refresh_slot, show,
                    refresh_t):
        coded_t.append(refresh_t)
        return ref_frame(frame, cand_slots, layer, refresh_slot, show,
                         refresh_t)

    enc._encode_p_part, enc._encode_ref_frame = code_frame, ref_frame_t
    enc._tf_filter = timed(enc._tf_filter, tf_log)
    enc.intra.encode_frames = key_frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads, recons = enc.encode_frames(frames)
    p, r = enc.flush()
    payloads, recons = payloads + p, recons + r
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    kinds = [tu_kind(x) for x in payloads]
    fmt = lambda d: ", ".join(f"{k} {v:.1f}" for k, v in d.items())
    print(f"partition pyramid: {W}x{H} q100 --pyramid --tf gop 2 keyint "
          f"64, {n_src} frames: {len(payloads)} TUs {kinds}, e2e "
          f"{n_src / dt:.4f} fps ({dt:.1f} s, first encode_frames to the "
          f"end of flush) [{CARD}]", flush=True)
    print(f"partition pyramid: key frame (q{enc.intra.cfg.qindex}) "
          f"{key_log[0][0]:.1f} ms ({fmt(key_clock.ms)} ms), "
          f"{len(payloads[0])} bytes, {key_log[0][2]}; TF of the key frame "
          f"and the anchor {', '.join(f'{t[0]:.1f}' for t in tf_log)} ms",
          flush=True)
    n_comp = 0
    for k, c in enumerate(coded):
        m, st = c["m"], c["clock"]
        me = [ms for key, ms in st.calls if key.startswith("ME ")]
        me_txt = (f"ME vs LAST {sum(me[:3]):.1f} ms (32/16/64 "
                  + "/".join(f"{x:.1f}" for x in me[:3]) + ")")
        if m["comp"]:
            me_txt += (f", vs ALTREF {sum(me[3:]):.1f} ms ("
                       + "/".join(f"{x:.1f}" for x in me[3:]) + ")")
        rest = {k_: v for k_, v in st.ms.items() if not k_.startswith("ME ")}
        comp, single, intra = block_counts(m)
        if m["comp"]:
            n_comp += sum(comp.values())
        lm = m["lam_map"]
        lm_txt = "" if lm is None else \
            f", TPL lambda map min {lm.min():.4f} max {lm.max():.4f}"
        print(f"partition pyramid: decode order {k + 1}: "
              f"{'compound' if m['comp'] else 'anchor'}, q {m['q']}, lambda "
              f"weight {m['lam_scale']}{lm_txt}, reference distance "
              f"{m['ref_dist']}; {me_txt}; {fmt(rest)} ms (luma and chroma "
              f"MC include the compound MC); frame {c['ms']:.1f} ms; "
              f"{c['bytes']} bytes; blocks: compound {comp}, "
              f"single-reference {single}, intra {intra}; {c['graphs']} "
              f"[{CARD}]", flush=True)
    comp_frame = next(c for c in coded if c["m"]["comp"])
    print(f"partition pyramid: device syncs of the compound frame: "
          f"{sum(comp_frame['syncs'].values())} "
          f"({dict(comp_frame['syncs'])})", flush=True)
    print_captures("partition pyramid", wf2.GRAPHS["log"][n_log:])
    want = ["key", "inter, no-show", "inter, no-show", "overlay", "overlay"]
    if kinds != want or len(recons) != n_src:
        raise AssertionError(f"partition pyramid: TU kinds {kinds}, "
                             f"{len(recons)} recons")
    for k, x in enumerate(payloads[:3]):
        if not any(t == OBU_FRAME and len(d) for t, _, _, d in
                   parse_obus(x)):
            raise AssertionError(f"partition pyramid: TU {k}: no OBU_FRAME")
    ps_y = [psnr(f[0], r_[0]) for f, r_ in zip(frames, recons)]
    print(f"partition pyramid: luma PSNR (display order) "
          f"{', '.join(f'{x:.2f}' for x in ps_y)} dB", flush=True)
    if min(ps_y) <= 30.0:
        raise AssertionError(f"luma PSNR {min(ps_y):.2f} dB <= 30")
    if not n_comp:
        raise AssertionError("partition pyramid: no compound block coded")
    DECODE["partition compound pyramid (phase 22)"] = (
        payloads, recons, False, [None] + coded_t + [None, None])


def part_pyramid_maps(enc):
    """A partition pyramid frame's maps, mvs, q, lambdas and slots (a
    frame without a lambda map holds [0])."""
    m = enc.last_p
    lm = m["lam_map"]
    return p_maps(enc) | {k: np.array(m[k]) for k in (
        "q", "lf", "lam_scale", "ref_slot", "refresh")} | {
        "lam_map": np.zeros(1, np.float32) if lm is None else lm}


def run_part_pyramid(cfg, frames, device, rc, tf_hook, gop):
    """The partition pyramid (TF on) on `device`: (units: (payloads,
    recons, maps) of the key frame, then (None, [], maps) of each coded P
    frame; every payload; every recon; seconds)."""
    enc = ve.VideoEncoder(cfg, keyint=64, pyramid=True, gop=gop, tf=True,
                          rc=rc, device=device)
    key_dev, units = [], []
    run, code, filt = (enc.intra.device_encode, enc._encode_p_part,
                       enc._tf_filter)
    enc.intra.device_encode = lambda fr: key_dev.append(run(fr)) or \
        key_dev[-1]

    def code_frame(*a, **kw):
        out = code(*a, **kw)
        units.append((None, [], part_pyramid_maps(enc)))
        return out

    enc._encode_p_part = code_frame
    enc._tf_filter = lambda *a: tf_hook(filt(*a))
    t0 = time.perf_counter()
    payloads, recons = enc.encode_frames(frames)
    p, r = enc.flush()
    payloads, recons = payloads + p, recons + r
    units.insert(0, ([payloads[0]], [recons[0]], part_maps(key_dev[0])))
    return units, payloads, recons, time.perf_counter() - t0


def phase_part_pyramid_card_vs_cpu():
    """Phase 23: the compound partition pyramid at 256x128 on the card and
    on the CPU, TF on: gop 4 at 8 bits (5 frames: layers 0-2, lambda
    weights 1.0 and 1.15) under CQ q100 and under CBR at half the bitrate
    CQ reached; gop 2 at 10 bits (3 frames of moving_frames10).  The
    card's filtered anchors go to the CPU encoder (in a worker; the checks
    at the end of the script); per coded frame the agreement of every
    map, and when every map agrees, byte-identical payloads and equal
    recons."""
    from svtav1_tpu_torch.encoder.rate_control import RateControl
    w, h = 256, 128
    kbps = None
    for label, bd, gop, frames, mode in (
            ("8-bit gop 4 CQ q100", 8, 4, moving_frames(w, h, 5), None),
            ("8-bit gop 4 CBR", 8, 4, moving_frames(w, h, 5), "cbr"),
            ("10-bit gop 2 CQ q100", 10, 2, moving_frames10(w, h, 3),
             None)):
        cfg = ie.EncoderConfig(w, h, qindex=100, bit_depth=bd)
        rc_kbps = kbps if mode else None
        rc = None if rc_kbps is None else RateControl(
            "cbr", qindex=100, target_kbps=rc_kbps, fps=30.0)
        card_tf = []
        card = run_part_pyramid(cfg, frames, "cuda", rc,
                                lambda x: card_tf.append(x) or x, gop)
        kinds = [tu_kind(x) for x in card[1]]
        qs = [int(u[2]["q"]) for u in card[0][1:]]
        lams = [float(u[2]["lam_scale"]) for u in card[0][1:]]
        nbytes = sum(len(x) for x in card[1])
        print(f"card, partition pyramid {w}x{h} {label} TF ({len(frames)} "
              f"frames, {card[3]:.1f} s): {len(card_tf)} TF calls; "
              f"{len(card[1])} TUs ({kinds.count('overlay')} overlays); "
              f"P-frame q {qs}, lambda weights {lams}; "
              f"{nbytes * 8 * 30 / len(frames) / 1000:.1f} kbps", flush=True)
        if kinds.count("overlay") != len(frames) - 1 or \
                len(card[2]) != len(frames):
            raise AssertionError(f"partition pyramid {label}: TUs {kinds}")
        fut = cpu_submit(pyramid_side, cfg, frames, rc_kbps, card_tf, gop,
                         True)

        def check(label=label, card=card, fut=fut):
            cpu, diffs = fut.result()
            print(f"card vs CPU, partition pyramid {label} (CPU "
                  f"{cpu[3]:.1f} s): pixels the card's TF planes differ by "
                  f"from the CPU's {[[n for n, _ in f] for f in diffs]}",
                  flush=True)
            frames_agree(label, card[0], cpu[0], tag="partition pyramid")
            if all(all(np.array_equal(mc[n], mp[n]) for n in mc)
                   for (_, _, mc), (_, _, mp) in zip(card[0], cpu[0])):
                same = card[1] == cpu[1] and all(
                    np.array_equal(a, b) for x, y in zip(card[2], cpu[2])
                    for a, b in zip(x, y))
                print(f"card vs CPU, partition pyramid {label}: every map "
                      f"agrees; {len(card[1])} payloads and {len(card[2])} "
                      f"recons identical {same}", flush=True)
                if not same:
                    raise AssertionError(f"partition pyramid {label}: maps "
                                         "agree but payloads or recons "
                                         "differ")
        DEFERRED.append((f"partition pyramid {label}", check))
        if mode is None and bd == 8:
            kbps = max(1, int(nbytes * 8 * 30 / len(frames) / 1000 / 2))


def phase_graph_vs_eager():
    """Phase 24: one captured scan graph against the eager body on the
    card, on the 512x128 crop of phases 7 and 10, in the key-frame form
    and with 3 (inter) and 5 (compound) seeded lanes: each form's graph
    replayed at q100 with weight 1.0 and no map, then at q140 with weight
    1.15 and a seeded non-uniform lambda map; all ten outputs of every
    replay equal the eager body's on the same buffers, bit for bit."""
    h, w = CROP_H, CROP_W
    bh, bw = h // 32, w // 32
    src = torch.from_numpy(plane_src(11, 1, h, w)).to(DEV)
    fp, fsb = (torch.from_numpy(a[None].copy()).to(DEV) for a in
               bottom_force_masks(bh, bw, h // 64, w // 64, h // 4))
    rng = np.random.RandomState(24)
    lam_map = upload(rng.uniform(0.68, 1.18, (1, bh, bw)).astype(
        np.float32), DEV)
    n_log = len(wf2.GRAPHS["log"])
    for form, n in (("key-frame", None), ("inter, 3 lanes", 3),
                    ("compound, 5 lanes", 5)):
        inter = None if n is None else wf2.InterLanes(*(
            upload(a, DEV) for a in lane_arrays(src[0].cpu().numpy(), n,
                                                 rng)))
        for q, scale, lm in ((100, 1.0, None), (140, 1.15, lam_map)):
            kw = dict(tx_search=True, inter=inter, lam_scale=scale,
                      lam_map=lm)
            g0 = graph_snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = wf2.encode_plane_wavefront_part(src, 32, q, fp, fsb, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = wf2.encode_plane_wavefront_part(src, 32, q, fp, fsb,
                                                   eager=True, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if not torch.equal(a, b)]
            print(f"graph vs eager: luma 1x{h}x{w} {form}, q{q}, weight "
                  f"{scale}, {'a seeded' if lm is not None else 'no'} "
                  f"lambda map: graph call {1e3 * (t1 - t0):.1f} ms "
                  f"({graph_delta(g0)}), eager body "
                  f"{1e3 * (t2 - t1):.1f} ms; outputs equal "
                  f"{10 - len(bad)} of 10 [{CARD}]", flush=True)
            if bad:
                raise AssertionError(f"graph vs eager {form} q{q}: outputs "
                                     f"{bad} differ")
    print_captures("graph vs eager", wf2.GRAPHS["log"][n_log:])


# ---- angle deltas (presets 0-5) ----------------------------------------------

P0_DELTAS = (-3, -2, -1, 0, 1, 2, 3)
P4_DELTAS = (-2, 0, 2)
H88 = 1088          # presets 0-5 turn CDEF on: a height that is whole SBs


def delta_row(bd, deltas, n_extra=0):
    """The kernels-line name of a delta form of the kernel."""
    n = len(expand_candidates(ie.CAND_MODES, deltas))
    tag = "wavefront" + ("" if bd == 8 else " 10-bit")
    if n_extra:
        return f"{tag} delta form, flat P luma ({n} intra + {n_extra} lanes)"
    return f"{tag} delta form, luma ({n} candidates, deltas {deltas})"


def phase_compare_deltas():
    """Phase 25: the kernel's delta form against its plain version on the
    card: a luma plane 1x1088x1920 (valid_h 1080) with preset 0's
    candidates (61) and preset 4's (29), at 8 and 10 bits, and the flat P
    frame's luma call with preset 0's deltas (61 intra candidates and 2
    lanes).  The bar of phase 2, 3 identical kernel runs a shape with a
    clear error word; kernel ms by CUDA events (two blocks of 10), the
    plain version's from its one run; the bound counts every candidate.
    Returns {row name: (max_abs_err, kernel ms, plain ms, bound ms,
    basis)}."""
    out = {}
    for bd in (8, 10):
        src_np = plane_src(3, 1, 1088, W) if bd == 8 else \
            plane_src10(3, 1, 1088, W).astype(np.int16)
        src = torch.from_numpy(src_np).to(DEV)
        for deltas in (P0_DELTAS, P4_DELTAS):
            cands = expand_candidates(ie.CAND_MODES, deltas)
            rd = rd_params(100, bd, cands, kf=True)
            pos = (32, TX_32X32, ie.CAND_MODES, bd, deltas)
            kern = lambda: wk.wavefront_cuda(src, rd, *pos, valid_h=H)
            plain = lambda: _wavefront_body(src, rd, *pos, valid_h=H)
            label = f"{'' if bd == 8 else '10-bit '}luma 1x1088x{W} q100, " \
                f"{len(cands)} candidates (deltas {deltas})"
            got = run_checked(kern)
            for rep in range(2):
                again = run_checked(kern)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: run {rep + 2} differs "
                                         "from run 1")
            ref, p = timed_once(plain)
            frac, err = agree(ref, got, label)
            k1 = cuda_ms(kern, 10)
            k2 = cuda_ms(kern, 10)
            wk.raise_on_error(DEV)
            k = (k1 + k2) / 2
            b_ms, b_by = wk.bound_ms(32, 1, 1088, W, ie.CAND_MODES, bd=bd,
                                     angle_deltas=deltas)
            mi = got[0].cpu().numpy()
            picked = int(np.array([d for _, d in cands])[mi].astype(bool)
                         .sum())
            print(f"compare deltas {label}: modes agree {frac:.4f}, "
                  f"max_abs_err {err}, 3 identical kernel runs, error word "
                  f"clear, {picked} of {mi.size} blocks pick a non-zero "
                  f"delta; kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
                  f"{p:.3f} ms (one run), bound {b_ms:.3f} ms ({b_by}), "
                  f"{100 * b_ms / k:.1f}% of it; "
                  f"{wk.kernel_info(32, len(cands), bd)} [{CARD}]",
                  flush=True)
            out[delta_row(bd, deltas)] = (err, k, p, b_ms, b_by)
    lanes = phase_compare_lanes(8, P0_DELTAS, kinds=("luma",))
    out[delta_row(8, P0_DELTAS, 2)] = lanes["luma"]
    return out


def delta_blocks(cands, y_mi, part=None, part_sb=None, y_mi_sb=None):
    """The coded luma blocks whose mode index picks a non-zero angle delta:
    every 32x32 block of a flat map, or a partition map's 32x32 NONE
    blocks and 64x64 blocks (one frame's host maps; a lane index past the
    intra candidates picks none)."""
    d = np.array([x for _, x in cands] + [0] * 8).astype(bool)
    if part is None:
        return int(d[np.asarray(y_mi)].sum())
    sb_none = np.asarray(part_sb) == 0
    top = np.repeat(np.repeat(~sb_none, 2, 0), 2, 1) & (np.asarray(part) ==
                                                        0)
    return int((d[np.asarray(y_mi)] & top).sum() +
               (d[np.asarray(y_mi_sb)] & sb_none).sum())


def key_deltas(dev, cands):
    """delta_blocks of the first frame of a partition key frame's
    device_encode tuple."""
    return delta_blocks(cands, *(dev[i][0].cpu().numpy()
                                 for i in (3, 2, 16, 17)))


def p_deltas(m, cands):
    """delta_blocks of a partition P frame's host maps (enc.last_p)."""
    return delta_blocks(cands, *(m[k] for k in ("y_mi", "part", "part_sb",
                                                "y_mi_sb")))


def phase_flat_deltas():
    """Phase 26: the delta form on the encoder's path, at 1920x1080: the
    flat path with preset 0's deltas (``EncoderConfig(part_search=False,
    angle_deltas=(-3..3))``, filters off) on I+P of ``moving_frames``
    (stage times of the P frame as in phase 12, e2e fps), then one flat
    key frame each with preset 4's deltas at 8 bits and with preset 0's
    and preset 4's at 10 bits (``IntraEncoder``), with the kernel's
    launch counts set to 0 before and read after, by form.  Checks: KEY
    then INTER, one luma and one U+V launch a frame, every luma launch a
    delta form, payloads parse, luma PSNR > 30 dB, some blocks pick a
    non-zero delta; the streams go to phases 16 and 20.  Returns the
    launches by kernels-line row."""
    wk.LAUNCHES = 0
    wk.FORMS.clear()
    frames = moving_frames(W, H, 2)
    cfg = ie.EncoderConfig(W, H, qindex=100, angle_deltas=P0_DELTAS, **FLAT)
    enc = ve.VideoEncoder(cfg, keyint=64, device="cuda")
    key_dev = []
    run = enc.intra.device_encode
    enc.intra.device_encode = lambda fr: key_dev.append(run(fr)) or \
        key_dev[-1]
    t0 = time.perf_counter()
    p0, r0 = enc.encode_frame(*frames[0])
    t1 = time.perf_counter()
    with StageClock(StageClock.FLAT_P) as clock:
        p1, r1 = enc.encode_frame(*frames[1])
    t2 = time.perf_counter()
    cands = expand_candidates(ie.CAND_MODES, P0_DELTAS)
    d_key = delta_blocks(cands, key_dev[0]["y_mi"][0].cpu().numpy())
    d_p = delta_blocks(cands, enc.last_p["y_mi"])
    fmt = lambda ms: ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
    print(f"flat path, preset 0's deltas: {W}x{H} q100 keyint 64: key frame "
          f"(q70) {1e3 * (t1 - t0):.1f} ms, {len(p0)} bytes, {d_key} blocks "
          f"with a non-zero delta; P frame {1e3 * (t2 - t1):.1f} ms "
          f"({fmt(clock.ms)}), {len(p1)} bytes, {d_p} intra blocks with a "
          f"non-zero delta, luma blocks inter "
          f"{100 * flat_inter_share(enc.last_p['y_mi'], H):.1f}%; e2e "
          f"{2 / (t2 - t0):.4f} fps over the 2 frames [{CARD}]", flush=True)
    ps_y = check_payloads([p0, p1], frames, [r0, r1], "flat deltas")
    types = [frame_type(p) for p in (p0, p1)]
    if types != [0, 1] or not d_key:
        raise AssertionError(f"flat deltas: frame types {types}, {d_key} "
                             "key-frame blocks with a delta")
    DECODE["flat preset-0 deltas I+P (phase 26)"] = ([p0, p1], [r0, r1],
                                                      False, None)
    lines = []
    for bd, deltas in ((8, P4_DELTAS), (10, P0_DELTAS), (10, P4_DELTAS)):
        f = frames[:1] if bd == 8 else moving_frames10(W, H, 1)
        ienc = ie.IntraEncoder(replace(cfg, angle_deltas=deltas,
                                       bit_depth=bd), device="cuda")
        t0 = time.perf_counter()
        dev = ienc.device_encode(f)
        payloads, recons = ienc.host_finish(dev)
        dt = time.perf_counter() - t0
        n = delta_blocks(expand_candidates(ie.CAND_MODES, deltas),
                         dev["y_mi"][0].cpu().numpy())
        ps = check_payloads(payloads, f, recons, f"flat key {bd} {deltas}",
                            bd)
        lines.append(f"{bd}-bit deltas {deltas}: {1e3 * dt:.1f} ms, "
                     f"{len(payloads[0])} bytes, PSNR {ps[0]:.2f} dB, {n} "
                     "blocks with a non-zero delta")
        if bd == 10:
            DECODE10[f"10-bit flat key frame, deltas {deltas} (phase 26)"] = \
                (payloads, recons, False, None)
    wk.raise_on_error(DEV)
    print(f"flat path key frames: {'; '.join(lines)} [{CARD}]", flush=True)
    forms = dict(wk.FORMS)
    print(f"flat path with deltas: kernel launches {wk.LAUNCHES} by (bs, "
          f"bd, intra candidates, lanes) {forms}", flush=True)
    rows = {delta_row(8, P0_DELTAS): forms.get((32, 8, 61, 0), 0),
            delta_row(8, P4_DELTAS): forms.get((32, 8, 29, 0), 0),
            delta_row(10, P0_DELTAS): forms.get((32, 10, 61, 0), 0),
            delta_row(10, P4_DELTAS): forms.get((32, 10, 29, 0), 0),
            delta_row(8, P0_DELTAS, 2): forms.get((32, 8, 61, 2), 0)}
    want = {(32, 8, 61, 0): 1, (32, 8, 29, 0): 1, (32, 10, 61, 0): 1,
            (32, 10, 29, 0): 1, (32, 8, 61, 2): 1, (16, 8, 13, 0): 2,
            (16, 10, 13, 0): 2, (16, 8, 1, 1): 1}
    if forms != want:
        raise AssertionError(f"kernel launches by form {forms}, not {want}")
    return rows


def phase_preset4():
    """Phase 27: preset 4 (angle deltas -2, 0, 2 on the partition path,
    CDEF, the tx-type search) low-delay I+P at 1920x1088 on
    ``moving_frames``, q100.  Stage times of each frame after a
    synchronize, the scans' graph captures (step graphs, nodes, capture
    and instantiate seconds, host RSS after each new shape), each scan
    shape's first call and a replay of it on the same inputs, the inter
    shares and the blocks with a non-zero delta, e2e fps.  Checks: KEY
    then INTER, payloads parse, luma PSNR > 30 dB, each replay equal to
    its first call, the P frame's luma area more than half inter; the
    stream goes to phase 16."""
    h = H88
    frames = moving_frames(W, h, 2)
    cfg = presets.apply_preset(ie.EncoderConfig(W, h, qindex=100), 4)
    presets.verify_settings(cfg)
    enc = ve.VideoEncoder(cfg, keyint=64, device="cuda")
    key_dev = []
    run = enc.intra.device_encode
    enc.intra.device_encode = lambda fr: key_dev.append(run(fr)) or \
        key_dev[-1]
    n_log = len(wf2.GRAPHS["log"])
    g0 = graph_snapshot()
    t0 = time.perf_counter()
    with StageClock(StageClock.KEY + StageClock.FILTERS[:2]) as kclock:
        p0, r0 = enc.encode_frame(*frames[0])
    t1 = time.perf_counter()
    key_graphs = graph_delta(g0)
    g0 = graph_snapshot()
    with StageClock(StageClock.P_FRAME) as pclock:
        p1, r1 = enc.encode_frame(*frames[1])
    t2 = time.perf_counter()
    p_graphs = graph_delta(g0)
    fmt = lambda ms: ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
    print(f"preset 4: {W}x{h} q100 keyint 64 (deltas {cfg.angle_deltas}, "
          f"CDEF, tx search): key frame (q70) {1e3 * (t1 - t0):.1f} ms "
          f"({fmt(kclock.ms)}; {key_graphs}); P frame "
          f"{1e3 * (t2 - t1):.1f} ms ({fmt(pclock.ms)}; {p_graphs}); e2e "
          f"{2 / (t2 - t0):.4f} fps over the 2 frames [{CARD}]", flush=True)
    print_captures("preset 4", wf2.GRAPHS["log"][n_log:])
    # each scan call again on its own inputs: a replay of its graphs
    for frame, clock in (("key frame", kclock), ("P frame", pclock)):
        for kind in ("luma wavefront", "chroma wavefront"):
            a, kw = clock.args[kind][0]
            first = next(ms for key, ms in clock.calls if key == kind)
            torch.cuda.synchronize()
            t = time.perf_counter()
            again = wf2.encode_plane_wavefront_part(*a, **kw)
            torch.cuda.synchronize()
            rep = time.perf_counter() - t
            same = all(torch.equal(x, y) for x, y in
                       zip(again, clock.out[kind][0]))
            print(f"preset 4: {frame} {kind.split()[0]} scan "
                  f"{tuple(a[0].shape)}: first call {first / 1e3:.2f} s, "
                  f"replay {rep:.3f} s, outputs equal {same} [{CARD}]",
                  flush=True)
            if not same:
                raise AssertionError(f"preset 4 {frame} {kind}: the replay "
                                     "differs from the first call")
    cands = expand_candidates(ie.CAND_MODES, cfg.angle_deltas)
    m = enc.last_p
    d_key, d_p = key_deltas(key_dev[0], cands), p_deltas(m, cands)
    (sb_i, sb_n), (t_i, t_n), (l_i, l_n), area = inter_shares(m, h,
                                                              len(cands))
    print(f"preset 4: key frame {len(p0)} bytes, {d_key} coded 32x32 and "
          f"64x64 blocks with a non-zero delta; P frame {len(p1)} bytes, "
          f"{d_p} intra blocks with a non-zero delta, "
          f"inter blocks 64x64 {sb_i} of {sb_n}, 32x32 {t_i} of {t_n}, "
          f"16x16 {l_i} of {l_n}, luma area inter {100 * area:.1f}%; host "
          f"RSS {wf2._host_rss() / 2 ** 30:.2f} GiB", flush=True)
    ps_y = check_payloads([p0, p1], frames, [r0, r1], "preset 4")
    types = [frame_type(p) for p in (p0, p1)]
    print(f"preset 4: frame types {types}, luma PSNR "
          f"{', '.join(f'{x:.2f}' for x in ps_y)} dB", flush=True)
    if types != [0, 1] or area <= 0.5:
        raise AssertionError(f"preset 4: types {types}, inter area {area}")
    DECODE["preset-4 I+P 1920x1088 (phase 27)"] = ([p0, p1], [r0, r1],
                                                    False, None)


def phase_deltas_card_vs_cpu():
    """Phase 28: angle deltas at 256x128, q60, on the card and on the CPU:
    preset 4 low-delay I, P, P (``moving_stripes``) at 8 bits and I, P at
    10 bits; a preset-4 compound pyramid, gop 2, TF (the card's filtered
    anchors fed to the CPU encoder, as phase 23 does; its checks at the
    end of the script); the flat path with preset 0's deltas, I, P; one
    preset-1 partition key frame.  Per coded unit the agreement of every
    map (the flat path's modes by phase 2's bar), and byte-identical
    payloads with equal recons whenever every map agrees."""
    w, h, q = 256, 128, 60        # q60: P frames pick intra deltas too
    p4 = lambda bd=8: presets.apply_preset(
        ie.EncoderConfig(w, h, qindex=q, bit_depth=bd), 4)
    for label in ("preset 4 I,P,P", "10-bit preset 4 I,P",
                  "flat preset-0 I,P"):
        fut, _, (cfg, clip, flat) = cpu_half(f"deltas {label}")
        cands = expand_candidates(ie.CAND_MODES, cfg.angle_deltas)
        picked = []

        def count(enc, key_dev):
            """The card's coded blocks with a non-zero delta, a frame."""
            if len(picked) == 0:
                picked.append(delta_blocks(cands, key_dev[0]["y_mi"][0].cpu()
                                           .numpy()) if flat
                              else key_deltas(key_dev[0], cands))
            else:
                picked.append(delta_blocks(cands, enc.last_p["y_mi"]) if flat
                              else p_deltas(enc.last_p, cands))
        runs = {"cuda": low_delay_units("cuda", cfg, clip, flat, count),
                "cpu": fut.result()}
        print(f"card vs CPU, {label} {w}x{h} (card {runs['cuda'][1]:.1f} s, "
              f"CPU {runs['cpu'][1]:.1f} s): coded blocks with a non-zero "
              f"delta a frame (card) {picked}", flush=True)
        if not any(picked):
            raise AssertionError(f"{label}: no block picked a delta")
        frames_agree(label, runs["cuda"][0], runs["cpu"][0],
                     modes_bar=flat, tag="deltas")

    # the compound pyramid at preset 4, gop 2, TF
    clip = moving_stripes(w, h, 3)
    card_tf = []
    card = run_part_pyramid(p4(), clip, "cuda", None,
                            lambda x: card_tf.append(x) or x, 2)
    fut = cpu_submit(pyramid_side, p4(), clip, None, card_tf, 2, True)

    def check(fut=fut, card=card, card_tf=card_tf):
        cpu, diffs = fut.result()
        print(f"card vs CPU, preset-4 partition pyramid {w}x{h} gop 2 TF "
              f"(card {card[3]:.1f} s, CPU {cpu[3]:.1f} s): {len(card_tf)} "
              f"TF calls, pixels the card's TF planes differ by from the "
              f"CPU's {[[n for n, _ in f] for f in diffs]}; {len(card[1])} "
              f"TUs", flush=True)
        frames_agree("preset-4 partition pyramid", card[0], cpu[0],
                     tag="deltas")
        if all(all(np.array_equal(mc[n], mp[n]) for n in mc)
               for (_, _, mc), (_, _, mp) in zip(card[0], cpu[0])):
            same = card[1] == cpu[1] and all(
                np.array_equal(a, b) for x, y in zip(card[2], cpu[2])
                for a, b in zip(x, y))
            print(f"card vs CPU, preset-4 partition pyramid: every map "
                  f"agrees; payloads and recons identical {same}",
                  flush=True)
            if not same:
                raise AssertionError("preset-4 pyramid: maps agree but "
                                     "payloads or recons differ")
    DEFERRED.append(("preset-4 partition pyramid", check))

    # one preset-1 partition key frame (61 luma candidates)
    fut, _, (cfg, f) = cpu_half("deltas preset-1 key frame")
    enc = ie.IntraEncoder(cfg, device="cuda")
    t0 = time.perf_counter()
    dev = enc.device_encode(f)
    payloads, recons = enc.host_finish(dev)
    card = ([(payloads, recons, part_maps(dev))], time.perf_counter() - t0)
    cpu = fut.result()
    n = key_deltas(dev, expand_candidates(ie.CAND_MODES, cfg.angle_deltas))
    print(f"card vs CPU, preset-1 key frame {w}x{h} (card {card[1]:.1f} s, "
          f"CPU {cpu[3]:.1f} s): {n} coded blocks with a non-zero delta",
          flush=True)
    if not n:
        raise AssertionError("preset-1 key frame: no block picked a delta")
    frames_agree("preset-1 key frame", card[0], [(cpu[1], cpu[2], cpu[0])],
                 tag="deltas")


# ---- tile columns, the multi-device module and the CLI's last flags ---------

TILES = 2            # phase 29's tile columns: two 960-px tiles at 1080p


def phase_tiles():
    """Phase 29: tile columns at 1920x1080: VideoEncoder(qindex=100,
    tile_cols=2, keyint=64) with the default partition config on I+P of
    ``moving_frames``.  Stage times of each frame after a synchronize
    (the tile coder's summed over the tiles), e2e fps, the scans' four new
    shapes (key and P, luma and U+V, the tiles on the batch axis: step
    graphs, nodes, capture and instantiate seconds, host RSS), each
    shape's first call and a replay of it on the same inputs (equal
    outputs), the inter shares.  Checks: KEY then INTER, payloads parse,
    luma PSNR > 30 dB, each replay equal to its first call, the P frame's
    luma area more than half inter; the stream goes to phase 16, which
    decodes it on the card."""
    frames = moving_frames(W, H, 2)
    cfg = ie.EncoderConfig(W, H, qindex=100, tile_cols=TILES)
    presets.verify_settings(cfg)
    enc = ve.VideoEncoder(cfg, keyint=64, device="cuda")
    n_log = len(wf2.GRAPHS["log"])
    g0 = graph_snapshot()
    t0 = time.perf_counter()
    with StageClock(StageClock.KEY) as kclock:
        p0, r0 = enc.encode_frame(*frames[0])
    t1 = time.perf_counter()
    key_graphs = graph_delta(g0)
    g0 = graph_snapshot()
    with StageClock(StageClock.P_FRAME) as pclock:
        p1, r1 = enc.encode_frame(*frames[1])
    t2 = time.perf_counter()
    p_graphs = graph_delta(g0)
    fmt = lambda ms: ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
    print(f"tiles: {W}x{H} q100 keyint 64, {TILES} tile columns of "
          f"{W // TILES} px: key frame (q70) {1e3 * (t1 - t0):.1f} ms "
          f"({fmt(kclock.ms)}; {key_graphs}); P frame {1e3 * (t2 - t1):.1f} "
          f"ms ({fmt(pclock.ms)}; {p_graphs}); e2e {2 / (t2 - t0):.4f} fps "
          f"over the 2 frames [{CARD}]", flush=True)
    print_captures("tiles", wf2.GRAPHS["log"][n_log:])
    for frame, clock in (("key frame", kclock), ("P frame", pclock)):
        for kind in ("luma wavefront", "chroma wavefront"):
            a, kw = clock.args[kind][0]
            first = next(ms for key, ms in clock.calls if key == kind)
            torch.cuda.synchronize()
            t = time.perf_counter()
            again = wf2.encode_plane_wavefront_part(*a, **kw)
            torch.cuda.synchronize()
            rep = time.perf_counter() - t
            same = all(torch.equal(x, y) for x, y in
                       zip(again, clock.out[kind][0]))
            print(f"tiles: {frame} {kind.split()[0]} scan "
                  f"{tuple(a[0].shape)}: first call {first / 1e3:.2f} s, "
                  f"replay {rep:.3f} s, outputs equal {same} [{CARD}]",
                  flush=True)
            if not same:
                raise AssertionError(f"tiles {frame} {kind}: the replay "
                                     "differs from the first call")
    m = enc.last_p
    (sb_i, sb_n), (t_i, t_n), (l_i, l_n), area = inter_shares(m, H)
    ps_y = check_payloads([p0, p1], frames, [r0, r1], "tiles")
    types = [frame_type(p) for p in (p0, p1)]
    print(f"tiles: key frame {len(p0)} bytes, P frame {len(p1)} bytes "
          f"(inter blocks 64x64 {sb_i} of {sb_n}, 32x32 {t_i} of {t_n}, "
          f"16x16 {l_i} of {l_n}, luma area inter {100 * area:.1f}%); "
          f"frame types {types}, luma PSNR "
          f"{', '.join(f'{x:.2f}' for x in ps_y)} dB; host RSS "
          f"{wf2._host_rss() / 2 ** 30:.2f} GiB", flush=True)
    if types != [0, 1] or area <= 0.5:
        raise AssertionError(f"tiles: types {types}, inter area {area}")
    DECODE[f"{TILES} tile columns I+P (phase 29)"] = ([p0, p1], [r0, r1],
                                                      False, None)


def phase_tiles_card_vs_cpu():
    """Phase 30: tile columns at 256x128 on the card and on the CPU: key
    frames at 2 and 4 tile columns; preset 4 with LR and CCSO, I, P, P at
    2 (``moving_frames``); 10-bit I, P at 2; a compound pyramid (gop 2, TF;
    the card's filtered anchors fed to the CPU encoder, its checks at the
    end of the script) at 2.  Per coded unit the agreement of every map,
    and byte-identical payloads with equal recons whenever every map
    agrees."""
    w, h = 256, 128
    for T in (2, 4):
        runs = {d: ([(r[1], r[2], r[0])], r[3]) for d, r in
                both_halves(f"tiles key frames T={T}").items()}
        print(f"card vs CPU, key frames {w}x{h} x2 at {T} tile columns "
              f"(card {runs['cuda'][1]:.1f} s, CPU {runs['cpu'][1]:.1f} s)",
              flush=True)
        frames_agree(f"key frames, {T} tiles", runs["cuda"][0],
                     runs["cpu"][0], tag="tiles")
    for label in ("preset 4 + LR + CCSO I,P,P", "10-bit I,P"):
        runs = both_halves(f"tiles {label}")
        n = len(runs["cuda"][0])
        types = [frame_type(x[0][0]) for x in runs["cuda"][0]]
        print(f"card vs CPU, {label} {w}x{h} at 2 tile columns (card "
              f"{runs['cuda'][1]:.1f} s, CPU {runs['cpu'][1]:.1f} s): frame "
              f"types {types}", flush=True)
        if types != [0] + [1] * (n - 1):
            raise AssertionError(f"tiles {label}: frame types {types}")
        frames_agree(label, runs["cuda"][0], runs["cpu"][0], tag="tiles")
    cfg = ie.EncoderConfig(w, h, qindex=100, tile_cols=2)
    clip = moving_frames(w, h, 3)
    card_tf = []
    card = run_part_pyramid(cfg, clip, "cuda", None,
                            lambda x: card_tf.append(x) or x, 2)
    fut = cpu_submit(pyramid_side, cfg, clip, None, card_tf, 2, True)

    def check(fut=fut, card=card, card_tf=card_tf):
        cpu, diffs = fut.result()
        print(f"card vs CPU, compound pyramid {w}x{h} gop 2 TF at 2 tile "
              f"columns (card {card[3]:.1f} s, CPU {cpu[3]:.1f} s): "
              f"{len(card_tf)} TF calls, pixels the card's TF planes differ "
              f"by from the CPU's {[[n for n, _ in f] for f in diffs]}; "
              f"{len(card[1])} TUs", flush=True)
        frames_agree("compound pyramid", card[0], cpu[0], tag="tiles")
        if all(all(np.array_equal(mc[n], mp[n]) for n in mc)
               for (_, _, mc), (_, _, mp) in zip(card[0], cpu[0])):
            same = card[1] == cpu[1] and all(
                np.array_equal(a, b) for x, y in zip(card[2], cpu[2])
                for a, b in zip(x, y))
            print(f"card vs CPU, tiled compound pyramid: every map agrees; "
                  f"payloads and recons identical {same}", flush=True)
            if not same:
                raise AssertionError("tiled pyramid: maps agree but "
                                     "payloads or recons differ")
    DEFERRED.append(("tiled compound pyramid", check))


def phase_mesh():
    """Phase 31: ``parallel.mesh`` on every card (two entries on cuda:0
    when the machine has one): GOP-parallel flat encodes on host threads
    (their key frames run the wavefront kernel) and a key frame's tile
    columns scanned on the mesh's devices (a host thread each, sharing
    one scan shape's graphs on one card), each against its serial encode
    byte for byte; the encode step (the kernel on each device) and the
    pipeline step against their one-call runs.  The partition path's
    GOP-parallel encode is held on the CPU (``tests/test_torch_tiles.py``)."""
    from svtav1_tpu_torch.parallel import mesh
    n = torch.cuda.device_count()
    devs = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 2
    print(f"mesh: torch.cuda.device_count() {n}, mesh {devs}", flush=True)
    t0 = time.perf_counter()
    got = mesh.sharded_video_encode_bytes(devs)
    t1 = time.perf_counter()
    want = mesh.sharded_video_encode_bytes(devs, shard=False)
    t2 = time.perf_counter()
    print(f"mesh: GOP-parallel flat encode (2 GOPs of 3 frames, 64x64): "
          f"{len(got)} bytes, equal to the serial encode {got == want} "
          f"(sharded {t1 - t0:.2f} s, serial {t2 - t1:.2f} s) [{CARD}]",
          flush=True)
    if got != want:
        raise AssertionError("mesh: GOP-parallel bytes differ")
    for n_tiles in sorted({len(devs), 4}):
        t0 = time.perf_counter()
        got = mesh.sharded_tile_encode_bytes(devs, n_tiles=n_tiles)
        t1 = time.perf_counter()
        want = mesh.sharded_tile_encode_bytes(devs, n_tiles=n_tiles,
                                              shard=False)
        print(f"mesh: key frame of {n_tiles} tile columns over {len(devs)} "
              f"devices (a host thread each): {len(got)} bytes, equal to "
              f"the one-device encode {got == want} (sharded {t1 - t0:.2f} "
              f"s, one device {time.perf_counter() - t1:.2f} s)", flush=True)
        if got != want:
            raise AssertionError("mesh: tile-parallel bytes differ")
    n0 = wk.LAUNCHES
    rec, total = mesh.sharded_encode_step(devs)
    launched = wk.LAUNCHES - n0
    rec1, total1 = mesh.sharded_encode_step(devs, shard=False)
    rec_p, bits = mesh.sharded_pipeline_step(devs)
    rec_p1, bits1 = mesh.sharded_pipeline_step(devs, shard=False)
    same = torch.equal(rec, rec1) and torch.equal(rec_p, rec_p1) and \
        bits == bits1 and abs(total - total1) <= 1e-5 * abs(total1)
    print(f"mesh: encode step recon {tuple(rec.shape)} ({launched} kernel "
          f"launches), analysis total {total:.1f} (one call {total1:.1f}); "
          f"pipeline step recon {tuple(rec_p.shape)}, bits {bits} (one "
          f"call {bits1}); equal {same}", flush=True)
    if not same or launched != len(devs):
        raise AssertionError("mesh: the steps differ from their one-call "
                             f"runs ({launched} launches)")


def cli_flags():
    """Phase 32: the CLI on the card, inside main(): ``--keyint 1 --mbr``
    on the flat path (``--preset 12``) and the default partition path,
    and ``--stat-report``, on a 256x128 Y4M of ``moving_frames`` (2
    frames, written under the git-ignored ``svtav1_tpu_torch/build/``).
    Each run exits 0 with two payloads; the capped runs' payloads fit the
    cap and are smaller than the uncapped ones; --stat-report prints the
    PSNR and SSIM lines."""
    import contextlib
    import io
    from svtav1_tpu_torch import app
    from svtav1_tpu_torch.utils.ivf import read_ivf
    from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "svtav1_tpu_torch", "build", "cli_flags")
    os.makedirs(d, exist_ok=True)
    src, out = os.path.join(d, "in.y4m"), os.path.join(d, "out.ivf")
    with open(src, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(256, 128, 30, 1))
        for fr in moving_frames(256, 128, 2):
            wtr.write_frame(*fr)

    def run(args):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = app.main(["-i", src, "-b", out, "--keyint", "1"] + args)
        with open(out, "rb") as f:
            sizes = [len(p) for p, _ in read_ivf(f)[1]]
        print(f"CLI --keyint 1 {' '.join(args)}: exit {rc}, payload bytes "
              f"{sizes}, {time.perf_counter() - t0:.1f} s; "
              f"{' | '.join(buf.getvalue().splitlines())} [{CARD}]",
              flush=True)
        if rc != 0 or len(sizes) != 2:
            raise AssertionError(f"CLI {args}: exit {rc}, {sizes}")
        return sizes, buf.getvalue()

    for preset in (["--preset", "12"], []):
        plain, _ = run(preset)
        mbr = int(0.7 * max(plain) * 8 * 30 / 1000)
        capped, text = run(preset + ["--mbr", str(mbr), "--stat-report"])
        cap = mbr * 1000 // 30
        if any(8 * s > cap for s in capped) or capped == plain:
            raise AssertionError(f"CLI --mbr {mbr}: payload bytes {capped} "
                                 f"(cap {cap} bits, uncapped {plain})")
        if "PSNR Y" not in text or "SSIM Y" not in text:
            raise AssertionError("CLI --stat-report: no PSNR or SSIM line")


def cli_presets():
    """The encoder CLI at every preset 0-13 on the card (not part of
    main()): a 256x128 Y4M of ``moving_stripes`` (2 frames, written under
    the git-ignored ``svtav1_tpu_torch/build/``), I+P at the default
    --keyint; each run exits 0 with two payloads."""
    from svtav1_tpu_torch import app
    from svtav1_tpu_torch.utils.ivf import read_ivf
    from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "svtav1_tpu_torch", "build", "cli_presets")
    os.makedirs(d, exist_ok=True)
    src, out = os.path.join(d, "in.y4m"), os.path.join(d, "out.ivf")
    with open(src, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(256, 128, 30, 1))
        for fr in moving_stripes(256, 128, 2):
            wtr.write_frame(*fr)
    for preset in range(14):
        t0 = time.perf_counter()
        rc = app.main(["-i", src, "-b", out, "--preset", str(preset)])
        with open(out, "rb") as f:
            n = len(list(read_ivf(f)[1]))
        print(f"CLI --preset {preset}: exit {rc}, {n} payloads, "
              f"{time.perf_counter() - t0:.1f} s [{CARD}]", flush=True)
        if rc != 0 or n != 2:
            raise AssertionError(f"CLI --preset {preset}: exit {rc}, {n} "
                                 "payloads")


W4, H4 = 3840, 2160     # the CTC's 4K class: m = 12, the edge strip


def edge_frames4k(bd, n=BATCH, seed=0):
    return (synth_frames(W4, H4, n, seed=seed) if bd == 8
            else synth_frames10(W4, H4, n, seed=seed))


def decode_to_recons(label, payloads, recons):
    """The port's Decoder on the card: each payload decodes to its recon,
    every pixel."""
    from svtav1_tpu_torch.decoder.decoder import Decoder
    dec = Decoder(device="cuda")
    t0 = time.perf_counter()
    for k, (pay, rec) in enumerate(zip(payloads, recons)):
        if not same_planes(dec.decode_frame_obus(pay), rec):
            raise AssertionError(f"{label}: frame {k} decodes to other "
                                 "pixels than its recon")
    print(f"{label}: {len(payloads)} frames decode on the card to the "
          f"recon, every pixel, {time.perf_counter() - t0:.1f} s [{CARD}]",
          flush=True)


def phase_edge():
    """Phase 33: the flat path at an m = 12 height, 3840x2160 (the edge
    strip, ``encoder/edge.py``), at 8 and 10 bits: a batch of 4 through
    ``device_encode`` queued without a host sync, with the chain kernel's
    launch count set to 0 before and read after (2: luma, U+V), its
    payloads equal to the warm-up batch's and its first two frames
    decoded on the card to the recon; then the chain kernel on that run's
    own plane outputs (the plane kernel's, before the chain) against the
    plain chain ``_edge_body`` on the CPU: 0 differing elements in the
    plane outputs and the strip's, and the strip's modes and levels equal
    to those of the main path's run.  Kernel ms by CUDA events (three
    runs, the least), the plain chain's from its one run, the bound from
    ``edge_work``.  Returns {name: (err, ms, plain ms, bound ms,
    launches)}."""
    from svtav1_tpu_torch.cuda import edge_kernel as ek
    from svtav1_tpu_torch.encoder.edge import _edge_body
    rows = {}
    for bd in (8, 10):
        frames = edge_frames4k(bd)
        cfg = presets.apply_preset(ie.EncoderConfig(W4, H4, qindex=110,
                                                    bit_depth=bd), 12)
        enc = ie.IntraEncoder(cfg, device="cuda")
        name = "edge strip" if bd == 8 else "edge strip 10-bit"
        # warm-up: tables, the first payload's sequence header
        first, _ = enc.host_finish(enc.device_encode(frames))
        ek.LAUNCHES = 0
        hold = hold_copies()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dev = enc.device_encode(frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            hold.set()
        launches = ek.LAUNCHES
        strip = {k: dev[k].clone() for k in ie._D2H_EDGE}
        plane = {k: dev[k].clone() for k in ("y_mi", "y_lev", "uv_mi",
                                             "uv_lev")}
        payloads, recons = enc.host_finish(dev)
        wk.raise_on_error(DEV)
        print(f"{name} {W4}x{H4}: device_encode queued without a host sync, "
              f"chain launches {launches} (expected 2), payload bytes "
              f"{[len(x) for x in payloads]}", flush=True)
        if launches != 2:
            raise AssertionError(f"{name}: chain launches {launches} != 2")
        if payloads[1:] != first[1:]:
            raise AssertionError(f"{name}: the batch's payloads differ from "
                                 "the warm-up's (the same frames)")
        decode_to_recons(f"{name} {W4}x{H4}", first[:2], recons[:2])

        cands = expand_candidates(ie.CAND_MODES)
        k_ms, p_ms, b_ms = 0.0, 0.0, 0.0
        for big, paired, keys in ((32, False, ("y_mi", "y_lev", "y_emi",
                                               "y_elev")),
                                  (16, True, ("uv_mi", "uv_lev", "uv_emi",
                                              "uv_elev"))):
            if paired:
                planes = np.concatenate([np.stack([f[k] for f in frames])
                                         for k in (1, 2)])
                vh, h = H4 // 2, enc.ph // 2
            else:
                planes = np.stack([f[0] for f in frames])
                vh, h = H4, enc.ph
            src = enc._upload(ie.pad_plane_bottom(planes, h))
            tx = TX_32X32 if big == 32 else TX_16X16
            # the plane kernel's outputs, the SB rows above the strip's
            base = ie.encode_plane_wavefront(
                src, big, tx, cfg.qindex, ie.CAND_MODES, bd, valid_h=vh,
                paired=paired, kf="uv" if paired else True, uv_tx=paired)
            rd = rd_params(cfg.qindex, bd, cands,
                           kf="uv" if paired else True)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            ms = []
            for _ in range(3):
                got = [t.clone() for t in base]
                start.record()
                e_mi, e_lev = ek.edge_cuda(src, rd, *got, big, cands, bd, vh,
                                           paired, paired)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            wk.raise_on_error(DEV)
            want = [t.cpu() for t in base]
            t0 = time.perf_counter()
            we_mi, we_lev = _edge_body(src.cpu(), rd, *want, big, cands, bd,
                                       vh, paired, paired)
            plain = 1e3 * (time.perf_counter() - t0)
            diff = [int((a.cpu() != b).sum()) for a, b in
                    zip(got + [e_mi, e_lev], want + [we_mi, we_lev])]
            main = [int((a != b).sum()) for a, b in zip(
                (got[0], got[1], e_mi, e_lev),
                (plane[keys[0]], plane[keys[1]], strip[keys[2]],
                 strip[keys[3]]))]
            bound = ek.bound_ms(big, src.shape[0], src.shape[2],
                                ie.CAND_MODES, paired, bd)
            label = "luma" if big == 32 else "U+V"
            print(f"{name} {label} chain on the run's plane outputs: kernel "
                  f"{min(ms):.3f} ms ({', '.join(f'{m:.3f}' for m in ms)}), "
                  f"plain {plain:.1f} ms (CPU, one run), bound {bound:.4f} "
                  f"ms ({100 * bound / min(ms):.2f}% of it); differing "
                  f"elements against the plain chain (modes, levels, recon, "
                  f"strip modes, strip levels) {diff}, against the main "
                  f"path's run (modes, levels, strip modes, strip levels) "
                  f"{main} [{CARD}]", flush=True)
            if any(diff) or any(main):
                raise AssertionError(f"{name} {label}: the chain kernel "
                                     "differs from the plain chain or from "
                                     "the main path's run")
            k_ms, p_ms, b_ms = k_ms + min(ms), p_ms + plain, b_ms + bound
        rows[name] = (0, k_ms, p_ms, b_ms, launches)
    return rows


def cli_edge():
    """Phase 34: the CLI at ``--preset 12 --keyint 1`` on a 3840x2160 Y4M
    of 4 frames (written under the git-ignored ``svtav1_tpu_torch/build/``)
    at 8 and 10 bits: exit 0, four payloads, and the first two decoded on
    the card by the port's Decoder equal the recon Y4M (``-o``)."""
    import contextlib
    import io
    from svtav1_tpu_torch import app
    from svtav1_tpu_torch.utils.ivf import read_ivf
    from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mReader, Y4mWriter
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "svtav1_tpu_torch", "build", "cli_edge")
    os.makedirs(d, exist_ok=True)
    src, out, rec = (os.path.join(d, f) for f in ("in.y4m", "out.ivf",
                                                   "rec.y4m"))
    for bd in (8, 10):
        with open(src, "wb") as f:
            wtr = Y4mWriter(f, Y4mInfo(W4, H4, 30, 1, bit_depth=bd))
            for fr in edge_frames4k(bd, seed=7):
                wtr.write_frame(*fr)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = app.main(["-i", src, "-b", out, "-o", rec, "-q", "110",
                           "--preset", "12", "--keyint", "1"])
        dt = time.perf_counter() - t0
        with open(out, "rb") as f:
            payloads = [x for x, _ in read_ivf(f)[1]]
        with open(rec, "rb") as f:
            recons = list(Y4mReader(f).frames())
        print(f"CLI {W4}x{H4} {bd}-bit --preset 12 --keyint 1: exit {rc}, "
              f"{len(payloads)} payloads, {sum(map(len, payloads))} bytes, "
              f"{len(recons)} recon frames, {dt:.1f} s [{CARD}]", flush=True)
        if rc != 0 or len(payloads) != 4 or len(recons) != 4:
            raise AssertionError(f"CLI {W4}x{H4} {bd}-bit: exit {rc}, "
                                 f"{len(payloads)} payloads, {len(recons)} "
                                 "recon frames")
        decode_to_recons(f"CLI {W4}x{H4} {bd}-bit", payloads[:2],
                         recons[:2])


CARD = ""


def phase_build():
    """Phase 1: build the kernels from the sources (one nvcc for the CUDA
    file, gcc for the native coders); ptxas' registers and spills, and
    wf_info of each form (8-bit uint8_t, 10-bit uint16_t): registers,
    spills, CTAs an SM, shared bytes, clusters that fit at once, and the
    cluster width and warps a CTA, which must be each form's."""
    t0 = time.perf_counter()
    so, log = build.build()
    native._load()
    native._load_reader()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}, "
          f"{native.library_path().name} and "
          f"{native.library_path(native._READER_SRC, 'libcoeffreader').name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    C = len(expand_candidates(ie.CAND_MODES))
    C0 = len(expand_candidates(ie.CAND_MODES, P0_DELTAS))
    C4 = len(expand_candidates(ie.CAND_MODES, P4_DELTAS))
    # (CTAs a cluster, warps a CTA) of each form: the 13-16-candidate
    # forms keep 4-CTA clusters; the delta forms run one candidate a warp
    # on clusters of 8 (29 candidates) or 16 (61-63)
    forms = {(32, C): (4, 4), (16, C): (4, 4), (32, C + 2): (4, 4),
             (16, 2): (4, 1), (32, C4): (8, 4), (32, C0): (16, 4),
             (32, C0 + 2): (16, 4)}
    for bd, pix in ((8, "uint8_t"), (10, "uint16_t")):
        for (bs, c), want in forms.items():
            info = wk.kernel_info(bs, c, bd)
            print(f"wf_plane_kernel<{bs}, {pix}>, {c} candidates: {info}",
                  flush=True)
            if info["ctas_per_sm"] < 1 or info["clusters"] < 1:
                raise AssertionError(f"wf_plane_kernel<{bs}, {pix}>: no "
                                     "CTA or cluster fits")
            if (info["cluster"], info["warps_per_cta"]) != want or \
                    info["local_bytes"]:
                raise AssertionError(f"wf_plane_kernel<{bs}, {pix}>, {c} "
                                     f"candidates: {info}, not clusters of "
                                     f"{want[0]} CTAs of {want[1]} warps "
                                     "without spills")
    from svtav1_tpu_torch.cuda import edge_kernel as ek
    for bd, pix in ((8, "uint8_t"), (10, "uint16_t")):
        info = ek.kernel_info(bd)
        print(f"wf_edge_kernel<{pix}>: {info}", flush=True)
        if info["local_bytes"]:
            raise AssertionError(f"wf_edge_kernel<{pix}> spills: {info}")


def main():
    global CARD
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda is not available - this needs a "
                 "CUDA card")
    CARD = card()
    print(CARD)                     # nvidia-smi's name, power.limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    spawn_workers()
    phase_build()
    # the CPU halves that need nothing from the card, queued for the
    # workers, which run them through the untimed phases
    start_cpu_halves()
    clock = [time.perf_counter()]
    # the timed phases: the workers are stopped through them
    quiet = {phase_compare, phase_compare_lanes, phase_compare_10bit,
             phase_compare_deltas, phase_main_path, phase_profile,
             phase_partition, phase_part_launches, phase_filters,
             phase_video, phase_flat_video, phase_flat_pyramid,
             phase_part_pyramid, phase_flat_deltas, phase_preset4,
             phase_tiles, phase_decode, phase_edge}

    def phase(fn, *args):
        pause_workers(fn in quiet)
        clock.append(time.perf_counter())
        out = fn(*args)
        clock.append(time.perf_counter())
        print(f"phase {fn.__name__}: {clock[-1] - clock[-2]:.1f} s"
              f"{' (CPU workers stopped)' if fn in quiet else ''}, host RSS "
              f"{wf2._host_rss() / 2 ** 30:.2f} GiB", flush=True)
        return out

    def drop(label, pred):
        """Forget the 1080p scan shapes that no later phase uses."""
        n = wf2.drop_scans(pred)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"after {label}: dropped {n} scan shapes, host RSS "
              f"{wf2._host_rss() / 2 ** 30:.2f} GiB", flush=True)

    # scan keys: (device, B, h, w, bs, chroma, bd, tx_search, valid_h,
    # n_extra, angle deltas); the 1080p shapes have h >= 544
    big = lambda k: k[2] >= 544
    try:
        max_err, ms, plain_ms, bound, basis = phase(phase_compare)
        lanes = phase(phase_compare_lanes)
        main10, lanes10 = phase(phase_compare_10bit)
        deltas = phase(phase_compare_deltas)
        launches, enc, batch = phase(phase_main_path)
        phase(phase_profile, enc, batch)
        phase(phase_partition)
        phase(phase_card_vs_cpu)
        phase(phase_part_launches)
        phase(phase_graph_vs_eager)
        phase(phase_filters)
        # phase 8's key-frame luma shape (1088 rows, no deltas): phase 27
        # keeps only its U+V shape
        drop("phase 8", lambda k: big(k) and not k[5] and k[8] is None and
             k[9] is None)
        phase(phase_filters_card_vs_cpu)
        phase(phase_video)
        phase(phase_video_card_vs_cpu)
        p_launches = phase(phase_flat_video)
        phase(phase_flat_video_card_vs_cpu)
        pyr_launches = phase(phase_flat_pyramid)
        phase(phase_flat_pyramid_card_vs_cpu)
        phase(phase_part_pyramid)
        # the 1080-row shapes of phases 5, 10 and 22
        drop("phase 22", lambda k: big(k) and k[8] is not None)
        phase(phase_part_pyramid_card_vs_cpu)
        delta_launches = phase(phase_flat_deltas)
        phase(phase_preset4)
        drop("phase 27", big)
        phase(phase_deltas_card_vs_cpu)
        phase(phase_tiles)
        drop("phase 29", big)
        phase(phase_tiles_card_vs_cpu)
        phase(phase_decode)
        phase(phase_decode_card_vs_cpu)
        launches10 = phase(phase_main_path, 10)[0]
        p10_launches = phase(phase_flat_video, 10)
        phase(phase_decode, DECODE10)
        phase(phase_10bit_card_vs_cpu)
        phase(phase_mesh)
        phase(cli_flags)
        edge_rows = phase(phase_edge)
        phase(cli_edge)
        phase(finish_deferred)
    finally:
        stop_workers()
    print(f"chip_smoke: total {time.perf_counter() - t0:.1f} s", flush=True)
    kernel = dict(route="cuda", source="svtav1_tpu_torch/csrc/wavefront.cu",
                  replaces="svtav1_tpu/pallas/wavefront_kernel.py:550")
    rows = [dict(name="wavefront", **kernel, launches=launches,
                 max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound, bound_by=basis, library_ms=None)]
    for kind, (err, k, p, b, by) in lanes.items():
        rows.append(dict(name=LANE_KERNELS[kind], **kernel,
                         launches=p_launches[kind] + pyr_launches[kind],
                         max_abs_err=err, ms=k,
                         plain_ms=p, bound_ms=b, bound_by=by,
                         library_ms=None))
    err, ms, plain_ms, bound, basis = main10
    rows.append(dict(name="wavefront 10-bit", **kernel, launches=launches10,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by=basis, library_ms=None))
    for kind, (err, k, p, b, by) in lanes10.items():
        rows.append(dict(name=LANE_KERNELS[kind].replace(
            "wavefront", "wavefront 10-bit"), **kernel,
            launches=p10_launches[kind], max_abs_err=err, ms=k, plain_ms=p,
            bound_ms=b, bound_by=by, library_ms=None))
    for name, (err, k, p, b, by) in deltas.items():
        rows.append(dict(name=name, **kernel, launches=delta_launches[name],
                         max_abs_err=err, ms=k, plain_ms=p, bound_ms=b,
                         bound_by=by, library_ms=None))
    edge_kernel = dict(route="cuda", source="svtav1_tpu_torch/csrc/wf_edge.cu",
                       replaces=None)
    for name, (err, k, p, b, n) in edge_rows.items():
        rows.append(dict(name=name, **edge_kernel, launches=n,
                         max_abs_err=err, ms=k, plain_ms=p, bound_ms=b,
                         bound_by="operations", library_ms=None))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
