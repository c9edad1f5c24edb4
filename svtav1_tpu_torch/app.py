"""Y4M in -> AV1 IVF out with the PyTorch port.

Usage:
  python -m svtav1_tpu_torch.app -i in.y4m -b out.ivf [-q 100 | --crf N] \
      [--keyint N] [--preset 0..13] [--no-part-search] [--cdef] [--lr] \
      [--ccso] [--no-cdf-update] [--pyramid [--tf]] \
      [--rc cq|crf|cbr|vbr] [--tbr KBPS] [--mbr KBPS] \
      [-n N] [--batch N] [--stat-report] [-o recon.y4m] \
      [--film-grain N] [--mastering-display MD] [--content-light CLL,FALL] \
      [--device cuda|cpu]

8-bit (C420) and 10-bit (C420p10) 4:2:0 input take every path below; a
10-bit stream codes uint16 planes (high_bitdepth in its sequence header).

--keyint N > 1 (the default 64) is the low-delay I/P path of
``svtav1_tpu/app.py``: a key frame every N frames (or at a scene cut) and
P frames that each reference the previous frame, encoded one frame at a
time by ``VideoEncoder``.  --keyint 1 is all-intra: reading, the device
stage of batch k+1 and the entropy coding of batch k overlap as in
``svtav1_tpu/app.py``.  With no preset and no --no-part-search it runs the
partition path (the default of EncoderConfig).  Presets 0..5 are the
partition path with CDEF that also searches angle deltas on the luma
whole-block and SB candidates (0..1: -3..3; 2: -3, -1, 0, 1, 3; 3..5: -2,
0, 2), presets 6..8 the same without angle deltas, 9 without the tx-type
search, 10 without CDEF, and --no-part-search and presets 11..13 the flat
path (32x32 blocks; its P frames at --keyint > 1 too, preset 13 without
CDF update).  --cdef, --lr, --ccso, --no-part-search and --no-cdf-update
apply over the preset as in ``svtav1_tpu/app.py``, and the settings are
then checked by ``verify_settings`` with its messages (exit status 2);
the in-loop filters ride the partition path at heights a multiple of 64
(presets 0..9 turn CDEF on, so they need such a height); CCSO streams are
the fork's nonstandard AV1.  --rc (with --tbr for cbr and
vbr) sets each frame's base qindex on the low-delay paths; --crf N is
qindex 4N in crf mode.  --pyramid at --keyint > 1 codes hierarchical
mini-GoPs (--tf filters their anchors), reading 16 frames at a time as
``svtav1_tpu/app.py`` does: on the partition path their interior frames
are compound (LAST + ALTREF), on the flat path single-reference; its
payloads include show_existing overlay TUs.  --mbr KBPS caps each frame
of the all-intra path (--keyint 1 only, as in ``svtav1_tpu/app.py``) at
KBPS over the input's frame rate: a frame over the cap is coded again at
qindex + 24, + 48, + 88 until it fits (capped CRF).
--mastering-display and --content-light write HDR metadata OBUs into
the first temporal unit, and --film-grain N (0..50) film grain
parameters (8-bit only, as in the JAX package: a 10-bit stream carries
none), as ``svtav1_tpu/app.py`` does.  --stat-report prints the mean
PSNR and SSIM (``ops.metrics.ssim_plane``) of each plane, at the peak
(1 << bit depth) - 1; -o writes the reconstruction as a Y4M of the
input's bit depth.  The settings are logged on stderr at SVT_LOG's level
(``utils.log``), as the JAX CLI logs them.  At ``SVT_LOG=debug`` the run
is also traced (``utils.trace``): at the end, one debug line a span (its
count and mean ms: the flat stage's ``enc.*`` and ``fin.*`` parts, the
coder's frames, the builds) and one of the counters (D2H bytes, coded
symbols, compilations).
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from contextlib import nullcontext
from dataclasses import replace

import numpy as np

from .ops.metrics import ssim_plane
from .utils import log, trace


def psnr(a: np.ndarray, b: np.ndarray, peak: int = 255) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(peak * peak / mse)


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="svtav1_tpu_torch")
    p.add_argument("-i", "--input", required=True, help="input .y4m")
    p.add_argument("-b", "--output", required=True, help="output .ivf")
    p.add_argument("-q", "--qp", type=int, default=100,
                   help="base qindex 0-255")
    p.add_argument("--crf", type=int, default=None,
                   help="CRF 0-63 (qindex = 4*crf, overrides -q; selects "
                        "--rc crf)")
    p.add_argument("--keyint", type=int, default=64,
                   help="key frame interval (1 = all-intra)")
    p.add_argument("--no-part-search", action="store_true",
                   help="flat 32x32 blocks instead of the partition search")
    p.add_argument("--preset", type=int, default=None, metavar="M",
                   help="speed preset 0 (slow)..13 (fast); explicit flags "
                        "override it")
    p.add_argument("--cdef", action="store_true",
                   help="enable the CDEF in-loop filter (search + signal)")
    p.add_argument("--lr", action="store_true",
                   help="enable loop restoration (SGR/Wiener search + "
                        "signal)")
    p.add_argument("--ccso", action="store_true",
                   help="enable the fork's grafted CCSO filter (search + "
                        "signal); CCSO streams are not standard AV1")
    p.add_argument("--pyramid", action="store_true",
                   help="hierarchical mini-GoPs with show_existing overlays "
                        "(flat path)")
    p.add_argument("--tf", action="store_true",
                   help="temporal filtering of the pyramid's anchors")
    p.add_argument("--no-cdf-update", action="store_true",
                   help="code every symbol with the default CDFs")
    p.add_argument("--rc", choices=("cq", "crf", "cbr", "vbr"), default=None,
                   help="rate control (default: cq, or crf with --crf)")
    p.add_argument("--tbr", type=int, default=0, metavar="KBPS",
                   help="target bitrate of --rc cbr/vbr")
    p.add_argument("--mbr", type=int, default=0, metavar="KBPS",
                   help="max bitrate cap for capped CRF/CQ (all-intra "
                        "--keyint 1): over-cap frames re-encode at "
                        "higher q (EbRateControlProcess.c capped_crf)")
    p.add_argument("-n", "--frames", type=int, default=0,
                   help="max frames (0 = all)")
    p.add_argument("--batch", type=int, default=4,
                   help="frames per device batch (all-intra)")
    p.add_argument("--stat-report", action="store_true",
                   help="print the mean PSNR and SSIM of the "
                        "reconstruction")
    p.add_argument("-o", "--recon", default=None,
                   help="write the reconstruction (display order) as .y4m")
    p.add_argument("--film-grain", type=int, default=0, metavar="N",
                   help="film grain synthesis strength 0 (off)..50 (8-bit)")
    p.add_argument("--mastering-display", default=None, metavar="MD",
                   help="HDR mastering display metadata OBU, "
                        "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)")
    p.add_argument("--content-light", default=None, metavar="CLL,FALL",
                   help="HDR content light level metadata OBU")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)
    if args.crf is not None:
        if not 0 <= args.crf <= 63:
            return _error(f"--crf must be 0..63 (got {args.crf})")
        args.qp = min(255, args.crf * 4)
    if not 0 <= args.qp <= 255:
        return _error(f"-q/--qp must be 0..255 (got {args.qp})")
    if args.keyint < 1:
        return _error(f"--keyint must be >= 1 (got {args.keyint})")
    if args.batch < 1:
        return _error("--batch must be >= 1")

    from .encoder.intra_encoder import EncoderConfig, IntraEncoder
    from .encoder.presets import apply_preset, verify_settings
    from .encoder.rate_control import RateControl
    from .encoder.video_encoder import VideoEncoder
    from .utils.ivf import IvfWriter
    from .utils.metadata import build_metadata_obus
    from .utils.y4m import Y4mReader, Y4mWriter

    with open(args.input, "rb") as fin:
        rdr = Y4mReader(fin)
        info = rdr.info
        if info.subsampling != "420":
            return _error("4:2:0 input only")
        cfg = EncoderConfig(info.width, info.height, qindex=args.qp,
                            bit_depth=info.bit_depth,
                            cdf_update=not args.no_cdf_update,
                            part_search=not args.no_part_search,
                            enable_cdef=args.cdef, enable_lr=args.lr,
                            enable_ccso=args.ccso,
                            film_grain=max(0, min(50, args.film_grain)))
        if args.mastering_display or args.content_light:
            try:
                cfg = replace(cfg, metadata=build_metadata_obus(
                    args.mastering_display, args.content_light))
            except ValueError as e:
                return _error(str(e))
        if args.preset is not None:
            try:
                cfg = apply_preset(cfg, args.preset)
            except ValueError as e:
                return _error(str(e))
            # explicit flags over the preset
            if args.no_part_search:
                cfg = replace(cfg, part_search=False)
            if args.cdef:
                cfg = replace(cfg, enable_cdef=True)
            if args.lr:
                cfg = replace(cfg, enable_lr=True)
            if args.no_cdf_update:
                cfg = replace(cfg, cdf_update=False)
        try:
            verify_settings(cfg, keyint=args.keyint)
        except ValueError as e:
            return _error(str(e))
        log.info("app", "%dx%d bd=%d q=%d keyint=%d preset=%s",
                 info.width, info.height, info.bit_depth, cfg.qindex,
                 args.keyint, args.preset)
        # rate control as svtav1_tpu/app.py builds it (also at --keyint 1,
        # where the all-intra encoder ignores it)
        rc = None
        rc_mode = args.rc or ("crf" if args.crf is not None else "cq")
        if rc_mode in ("cbr", "vbr") or args.rc in ("cq", "crf"):
            try:
                rc = RateControl(rc_mode, qindex=cfg.qindex,
                                 target_kbps=args.tbr,
                                 fps=info.fps_num / max(info.fps_den, 1))
            except ValueError as e:
                return _error(str(e))
        if args.mbr and args.keyint != 1:
            return _error("--mbr (capped CRF) is supported for the "
                          "all-intra path (--keyint 1)")
        try:
            if args.keyint == 1:
                enc = IntraEncoder(cfg, device=args.device)
                if args.mbr:
                    enc.cap_bits = int(args.mbr * 1000 * info.fps_den /
                                       max(info.fps_num, 1))
            elif args.pyramid:
                # hierarchical mini-GoPs: compound interior frames on the
                # partition path, single-reference ones on the flat path
                enc = VideoEncoder(cfg, keyint=args.keyint, pyramid=True,
                                   tf=args.tf, rc=rc, device=args.device)
                # the mini-GoP lookahead: the frames buffered when a GoP
                # is coded decide what TF sees, so the groups are JAX's
                args.batch = 16
            else:
                # as in svtav1_tpu/app.py, --tf acts through --pyramid only
                enc = VideoEncoder(cfg, keyint=args.keyint, rc=rc,
                                   device=args.device)
                args.batch = 1          # low-delay P is reference-serial
        except (NotImplementedError, ValueError) as e:
            return _error(str(e))

        traced = log.get_level() <= log.DEBUG
        if traced:
            trace.enable()
        t0 = time.perf_counter()
        n = n_tu = total_bytes = 0
        psnrs, ssims = [], []
        peak = (1 << info.bit_depth) - 1
        frame_iter = itertools.islice(rdr.frames(), args.frames or None)
        with open(args.output, "wb") as fout, \
                (open(args.recon, "wb") if args.recon else nullcontext()) \
                as frec:
            ivf = IvfWriter(fout, info.width, info.height, info.fps_den,
                            info.fps_num)
            recw = Y4mWriter(frec, info) if frec else None
            src_fifo = []           # display-order sources awaiting recon

            def write(payloads, recons):
                """Payloads in decode order (the pyramid's include overlay
                TUs), recons in display order against the sources."""
                nonlocal n_tu, total_bytes
                for payload in payloads:
                    ivf.write_frame(payload, n_tu)
                    n_tu += 1
                    total_bytes += len(payload)
                for rec in recons:
                    src = src_fifo.pop(0)
                    if recw is not None:
                        recw.write_frame(*(np.asarray(r, src[0].dtype)
                                           for r in rec))
                    if args.stat_report:
                        psnrs.append([psnr(a, r, peak)
                                      for a, r in zip(src, rec)])
                        ssims.append([ssim_plane(a, r, peak)
                                      for a, r in zip(src, rec)])

            pending = None          # device outputs of the batch in flight
            while True:
                batch = [f for _, f in zip(range(args.batch), frame_iter)]
                if not batch:
                    break
                n += len(batch)
                src_fifo.extend(batch)
                if args.keyint > 1:
                    write(*enc.encode_frames(batch))
                    continue
                # queue this batch's device stage, then entropy-code the
                # previous batch while it runs
                dev = enc.device_encode(batch)
                if pending is not None:
                    write(*enc.host_finish(pending))
                pending = dev
            if pending is not None:
                write(*enc.host_finish(pending))
            if args.keyint > 1:
                write(*enc.flush())
            ivf.finalize()
    dt = time.perf_counter() - t0
    kbps = total_bytes * 8 * info.fps_num / info.fps_den / max(n, 1) / 1000
    print(f"encoded {n} frames in {dt:.2f}s ({n / dt if dt else 0:.2f} fps)"
          f", {kbps:.1f} kbps")
    if psnrs:
        m = np.mean(psnrs, axis=0)
        print(f"PSNR Y {m[0]:.2f} U {m[1]:.2f} V {m[2]:.2f}")
        s = np.mean(ssims, axis=0)
        print(f"SSIM Y {s[0]:.4f} U {s[1]:.4f} V {s[2]:.4f}")
    if traced:
        trace.enable(False)
        for name, (count, mean_ms) in sorted(trace.summary().items()):
            log.debug("trace", "%s: %d spans, mean %.3f ms", name, count,
                      mean_ms)
        log.debug("trace", "counters: %s; %d records dropped", ", ".join(
            f"{k} {v}" for k, v in sorted(trace.counters().items())),
            trace.dropped())
    return 0


if __name__ == "__main__":
    sys.exit(main())
