"""The port's main path in two checkouts of the repo, in turn, on one card.

    python3 svtav1_tpu_torch/cuda/compare_trees.py ROOT_A ROOT_B [--rounds 3]

Runs the flat all-intra encoder of each checkout (``IntraEncoder(1920,
1080, qindex=100, part_search=False)`` on the 12 frames of
``inputs.synth_frames``, batch 4, the device stage of batch k+1 queued
before the host stage of batch k, as ``chip_smoke.py`` drives it) in a
process of its own, in the order A B, B A, A B, ... (--rounds pairs).
Each process makes one warm-up pass and three timed passes and prints,
per pass, the steady e2e fps (batches 2-3), the host time of every
``device_encode`` call (enqueue, no sync) and ``host_finish`` call, then
the device-only fps (``device_encode`` + synchronize, 3 batches) and,
for one batch, cProfile's functions by own host time in ``device_encode``
and in ``host_finish``.  Last, a summary per checkout over all its passes.

Each process imports ``svtav1_tpu_torch`` from its checkout (PYTHONPATH)
and the frames from ``inputs.py`` beside this file, so a checkout of an
earlier version of the port can be measured as it was.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time
from pathlib import Path

W, H, N_FRAMES, BATCH = 1920, 1080, 12, 4


def _profile(fn, top=12):
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    return [ln for ln in out.getvalue().splitlines()
            if ln.strip() and not ln.lstrip().startswith(("Ordered", "List"))]


def worker():
    """One checkout's measurements (run in a process of its own)."""
    import torch
    from inputs import card, synth_frames   # beside this file
    from svtav1_tpu_torch.encoder import intra_encoder as ie

    import svtav1_tpu_torch
    pkg = Path(svtav1_tpu_torch.__file__).resolve().parent
    print(f"package {pkg} [{card()}]", flush=True)
    frames = synth_frames(W, H, N_FRAMES)
    enc = ie.IntraEncoder(ie.EncoderConfig(W, H, qindex=100,
                                           part_search=False), device="cuda")

    def finish(dev, fin, marks):
        t0 = time.perf_counter()
        enc.host_finish(dev)
        marks.append(time.perf_counter())
        fin.append(marks[-1] - t0)

    def one_pass():
        # e2e as chip_smoke.py counts it: the frames of batches 2-3 over
        # the time from the end of batch 1's host stage to the last one's
        enq, fin, marks, pending = [], [], [], None
        for i in range(0, N_FRAMES, BATCH):
            t0 = time.perf_counter()
            dev = enc.device_encode(frames[i:i + BATCH])
            enq.append(time.perf_counter() - t0)
            if pending is not None:
                finish(pending, fin, marks)
            pending = dev
        finish(pending, fin, marks)
        return (N_FRAMES - BATCH) / (marks[-1] - marks[0]), enq, fin

    one_pass()                                   # warm-up
    res = {"e2e_fps": [], "enqueue_ms": [], "host_finish_ms": []}
    for k in range(3):
        fps, enq, fin = one_pass()
        res["e2e_fps"].append(fps)
        res["enqueue_ms"] += [1e3 * t for t in enq]
        res["host_finish_ms"] += [1e3 * t for t in fin]
        print(f"pass {k + 1}: e2e {fps:.3f} fps; device_encode enqueue "
              + ", ".join(f"{1e3 * t:.3f}" for t in enq) + " ms; host_finish "
              + ", ".join(f"{1e3 * t:.3f}" for t in fin) + " ms", flush=True)
    batch = frames[:BATCH]
    t0 = time.perf_counter()
    for _ in range(3):
        enc.device_encode(batch)
        torch.cuda.synchronize()
    res["device_fps"] = 3 * BATCH / (time.perf_counter() - t0)
    print(f"device-only {res['device_fps']:.3f} fps", flush=True)
    dev = []
    lines = _profile(lambda: (dev.append(enc.device_encode(batch)),
                              torch.cuda.synchronize()))
    print("cProfile device_encode + synchronize, by own time:\n  "
          + "\n  ".join(lines), flush=True)
    lines = _profile(lambda: enc.host_finish(dev[0]))
    print("cProfile host_finish, by own time:\n  " + "\n  ".join(lines),
          flush=True)
    print("RESULT " + json.dumps(res), flush=True)


def run(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--worker"], cwd=root, env=env, check=True,
                         capture_output=True, text=True).stdout
    for line in out.splitlines():
        if not line.startswith("RESULT "):
            print(f"[{root.name}] {line}", flush=True)
    return json.loads(out.splitlines()[-1][len("RESULT "):])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return worker()
    if len(args.roots) != 2:
        ap.error("give two checkouts")
    roots = [r.resolve() for r in args.roots]
    got = {r: [] for r in roots}
    for k in range(args.rounds):
        for r in (roots if k % 2 == 0 else roots[::-1]):
            got[r].append(run(r))
    for r in roots:
        runs = got[r]
        e2e = [v for g in runs for v in g["e2e_fps"]]
        enq = [v for g in runs for v in g["enqueue_ms"]]
        fin = [v for g in runs for v in g["host_finish_ms"]]
        dev = [g["device_fps"] for g in runs]
        print(f"summary {r.name}: e2e fps " + ", ".join(f"{v:.3f}" for v in e2e)
              + f" (mean {sum(e2e) / len(e2e):.3f}); device-only fps "
              + ", ".join(f"{v:.3f}" for v in dev)
              + f"; device_encode enqueue mean {sum(enq) / len(enq):.3f} ms"
              f" (min {min(enq):.3f}, max {max(enq):.3f}); host_finish mean "
              f"{sum(fin) / len(fin):.3f} ms (min {min(fin):.3f}, max "
              f"{max(fin):.3f})", flush=True)


if __name__ == "__main__":
    main()
