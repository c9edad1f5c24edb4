"""Drive the PyTorch port's flat all-intra 1080p encode once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero and never prints
its last line):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the wavefront kernel from svtav1_tpu_torch/csrc;
  2. the kernel against its plain PyTorch version on the card, under the
     agreement bar of the wavefront tests (>= 99% equal modes, levels
     equal where the mode agrees, recon equal when every mode agrees), at
     the test shapes and at the 1080p shapes of the main path; kernel and
     plain times at 1080p;
  3. the main path: IntraEncoder(1920, 1080, qindex=100,
     part_search=False) on 12 synthetic frames, batch 4, device stage of
     batch k+1 overlapped with the entropy coding of batch k.  Checks the
     kernel launch count, that every payload parses as OBUs, luma PSNR >
     30 dB, and byte-identical payloads against the plain version on the
     card when every mode agrees; prints e2e and device-only fps.
Then one JSON line of kernel results and, last, one JSON line naming the
device.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda is not available - this needs a CUDA "
             "card")

from bench import synth_frames  # noqa: E402
from svtav1_tpu.utils.obu import OBU_FRAME, parse_obus  # noqa: E402
from svtav1_tpu.spec.txfm import TX_16X16, TX_32X32  # noqa: E402
from svtav1_tpu_torch.cuda import build  # noqa: E402
from svtav1_tpu_torch.cuda import wavefront_kernel as wk  # noqa: E402
from svtav1_tpu_torch.encoder import intra_encoder as ie  # noqa: E402
from svtav1_tpu_torch.encoder.wavefront import (  # noqa: E402
    _wavefront_body, expand_candidates, rd_params)

DEV = torch.device("cuda")
W, H = 1920, 1080
BATCH = 4


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def plane_src(seed, B, h, w):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = [np.clip(120 + 60 * np.sin((xx + 7 * b) / 17.0) +
                   40 * np.cos((yy + 3 * b) / 11.0) +
                   rng.randint(-6, 7, (h, w)), 0, 255) for b in range(B)]
    return np.stack(out).astype(np.uint8)


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


def wf_args(bs, q, chroma, valid_h=None):
    cands = expand_candidates(ie.CAND_MODES)
    rd = rd_params(q, 8, cands, kf="uv" if chroma else True)
    kw = dict(valid_h=valid_h, paired=chroma, uv_tx=chroma)
    return rd, (bs, TX_16X16 if chroma else TX_32X32, ie.CAND_MODES, 8,
                (0,)), kw


def cuda_ms(fn, n):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_compare():
    """Kernel vs plain on the card.  Returns (max_abs_err, kernel ms,
    plain ms) of one batch's luma + chroma wavefronts at 1080p."""
    cases = [  # label, seed, B, h, w, bs, q, chroma, valid_h, timed
        ("luma 2x128x192 q100", 0, 2, 128, 192, 32, 100, False, None, 0),
        ("luma 1x128x128 q120 valid_h=100", 1, 1, 128, 128, 32, 120, False,
         100, 0),
        ("chroma paired 4x64x96 q100", 2, 4, 64, 96, 16, 100, True, None, 0),
        ("luma 1x1088x1920 q100", 3, 1, 1088, 1920, 32, 100, False, 1080, 1),
        ("chroma paired 2x544x960 q100", 4, 2, 544, 960, 16, 100, True, 540,
         1),
        ("luma 4x1088x1920 q100 (main path)", 5, 4, 1088, 1920, 32, 100,
         False, 1080, 2),
        ("chroma paired 8x544x960 q100 (main path)", 6, 8, 544, 960, 16, 100,
         True, 540, 2),
    ]
    max_err, ms, plain_ms = 0, 0.0, 0.0
    for label, seed, B, h, w, bs, q, chroma, vh, timed in cases:
        src = torch.from_numpy(plane_src(seed, B, h, w)).to(DEV)
        rd, pos, kw = wf_args(bs, q, chroma, vh)
        kern = lambda: wk.wavefront_cuda(src, rd, *pos, **kw)
        plain = lambda: _wavefront_body(src, rd, *pos, **kw)
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        frac, err = agree(ref, got, label)
        max_err = max(max_err, err)
        line = f"compare {label}: modes agree {frac:.4f}, max_abs_err {err}"
        if timed:
            # plain, kernel, kernel, plain on one card
            p1 = cuda_ms(plain, 1)
            k1 = cuda_ms(kern, 5)
            k2 = cuda_ms(kern, 5)
            p2 = cuda_ms(plain, 1)
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            line += (f"; kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
                     f"{p:.3f} ms ({p1:.3f}, {p2:.3f}) [{CARD}]")
            if timed == 2:
                ms += k
                plain_ms += p
        print(line, flush=True)
    return max_err, ms, plain_ms


def plain_wavefront(src, bs, tx_size, qindex, modes, bd=8, angle_deltas=(0,),
                    valid_h=None, paired=False, kf=True, uv_tx=False):
    """The plain PyTorch wavefront with encode_plane_wavefront's
    signature, on whatever device src lies on."""
    rd = rd_params(qindex, bd, expand_candidates(modes, angle_deltas), kf)
    return _wavefront_body(src, rd, bs, tx_size, modes, bd, angle_deltas,
                           valid_h, paired, uv_tx)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def phase_main_path():
    cfg = ie.EncoderConfig(W, H, qindex=100, part_search=False)
    frames = synth_frames(W, H, 12)
    enc = ie.IntraEncoder(cfg, device="cuda")

    def queue(batch):
        # device_encode must not synchronise: host coding of the previous
        # batch overlaps it (set_sync_debug_mode raises on a sync)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return enc.device_encode(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    wk.LAUNCHES = 0
    payloads, recons, first_dev = [], [], None
    marks = [time.perf_counter()]
    pending = None
    for i in range(0, len(frames), BATCH):
        dev = queue(frames[i:i + BATCH])
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
    want = 2 * 248 * 2 * (len(frames) // BATCH)
    print(f"main path: {len(payloads)} frames, {sum(map(len, payloads))} "
          f"bytes, kernel launches {launches} (expected {want}), "
          "device_encode queued without a host sync", flush=True)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for k, p in enumerate(payloads):
        obus = list(parse_obus(p))
        if not p or not any(t == OBU_FRAME and len(d) for t, _, _, d in obus):
            raise AssertionError(f"frame {k}: no OBU_FRAME in the payload")
    ps_y = [psnr(f[0], r[0]) for f, r in zip(frames, recons)]
    print(f"main path: luma PSNR min {min(ps_y):.2f} dB, mean "
          f"{np.mean(ps_y):.2f} dB", flush=True)
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
    print(f"main path: first batch modes agree with the plain version: "
          f"{same}", flush=True)
    if same and ps_p != payloads[:BATCH]:
        raise AssertionError("payloads differ from the plain version's")
    if same:
        print("main path: first batch payloads byte-identical to the plain "
              "version's", flush=True)

    def device_only():
        d = enc.device_encode(frames[:BATCH])
        torch.cuda.synchronize()
        return d
    device_only()
    t0 = time.perf_counter()
    for _ in range(3):
        device_only()
    dev_fps = 3 * BATCH / (time.perf_counter() - t0)
    print(f"main path: e2e {e2e_fps:.3f} fps steady (batches 2-3, batch "
          f"{BATCH}), device-only {dev_fps:.3f} fps [{CARD}]", flush=True)
    return launches


CARD = ""


def main():
    global CARD
    CARD = card()
    print(CARD)                     # nvidia-smi's name, power.limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    so, log = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    wk._lib()
    max_err, ms, plain_ms = phase_compare()
    launches = phase_main_path()
    print(json.dumps({"kernels": [{
        "name": "wavefront", "route": "cuda",
        "source": "svtav1_tpu_torch/csrc/wavefront.cu",
        "replaces": "svtav1_tpu/pallas/wavefront_kernel.py:550",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
