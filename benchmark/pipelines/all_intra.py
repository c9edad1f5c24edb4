"""The all-intra encode as the CLI runs it at ``--keyint 1`` on the flat
presets (``svtav1_tpu_torch/app.py``): ``IntraEncoder.device_encode`` of
batch k+1 is queued, then ``host_finish`` codes batch k, in a closed loop
(the next batch is queued as soon as the previous ``host_finish``
returns).  The source is a pool of distinct frames made from the seed and
cycled; all-intra frames carry no state from frame to frame, so every
encode of a pool frame is the same work and gives the same bytes.

The window keeps, for the check afterwards, every payload (by pool frame),
the newest recon of every pool frame, and the device outputs of the
newest batch that holds each pool frame.  ``check`` holds them against
the plain reference in ``benchmark/reference``: the device stage (mode
maps, levels, deblocked recons) of every pool frame the window coded,
the recons as ``host_finish`` returned them, the payload bytes of a
sample of pool frames drawn from the seed, and every window payload
against the newest one of its pool frame.
"""

from __future__ import annotations

import pickle
import random
import subprocess
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch

from ..reference import encoder as ref_encoder
from ..yardstick import clips, stats


@dataclass
class Window:
    """What one measured window saw, for the metric readers and the check.
    Times are host perf_counter seconds; the traced-run fields stay empty
    without --trace."""
    t0: float = 0.0
    t_end: float = 0.0
    frames: int = 0
    batch_done: list = field(default_factory=list)      # host_finish returns
    payload_bytes: int = 0
    spans: dict = field(default_factory=dict)           # name -> [(t0, t1)]
    coder_s: list = field(default_factory=list)         # one a coded frame
    plane_calls: list = field(default_factory=list)     # (bs, B, h, w, chroma)
    payloads: dict = field(default_factory=dict)        # pool index -> [bytes]
    recons: dict = field(default_factory=dict)          # pool index -> planes
    dev: dict = field(default_factory=dict)             # pool index -> (dev, b)


class Cell:
    """One configuration under one traffic mix, on one device: the pool of
    frames, the payloads the check samples and, with program=True, the
    encoder."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program: bool = True):
        self.device = torch.device(device)
        self.width, self.height = config["width"], config["height"]
        self.bd = config["bit_depth"]
        self.cdf_update = config["cdf_update"]
        self.qindex = traffic["qindex"]
        self.batch = traffic["batch"]
        self.pool_n = traffic["pool"]
        self.pool = clips.make_pool(traffic["content"], self.width,
                                    self.height, self.bd, self.pool_n, seed,
                                    self.device)
        self.coded = sorted(random.Random(seed).sample(
            range(self.pool_n), traffic["check_payloads"]))
        self._next = 0
        self.enc = self._encoder(config) if program else None

    def _encoder(self, config: dict):
        from svtav1_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                            IntraEncoder)
        from svtav1_tpu_torch.encoder.presets import apply_preset
        cfg = apply_preset(EncoderConfig(self.width, self.height,
                                         qindex=self.qindex,
                                         bit_depth=self.bd),
                           config["preset"])
        cfg = replace(cfg, lf_level=config["lf_level"],
                      tile_cols=config["tile_cols"],
                      film_grain=config["film_grain"])
        if cfg.part_search or cfg.angle_deltas != (0,) or \
                cfg.cdf_update != self.cdf_update:
            raise ValueError(f"preset {config['preset']} is not the flat "
                             "path that the configuration states")
        return IntraEncoder(cfg, device=self.device)

    def _batch(self):
        """The next batch's pool indices (consecutive, cycling)."""
        idx = [(self._next + k) % self.pool_n for k in range(self.batch)]
        self._next = (self._next + self.batch) % self.pool_n
        return idx

    def warm_up(self) -> None:
        """Every shape the window uses: two overlapped batches of the
        cell's size (the kernels, their tables, the coder threads)."""
        b0, b1 = self._batch(), self._batch()
        d0 = self.enc.device_encode([self.pool[i] for i in b0])
        d1 = self.enc.device_encode([self.pool[i] for i in b1])
        self.enc.host_finish(d0)
        self.enc.host_finish(d1)
        self._next = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace: bool = False) -> Window:
        """The closed loop for `seconds`: from the first batch queued to
        the first host_finish that returns at or after the end; every
        frame returned in between counts.  The batch still in flight is
        finished after the window."""
        enc, w = self.enc, Window()
        rf = _annotate if trace else (lambda name: nullcontext())
        span = w.spans.setdefault

        def device_encode(idx):
            t = time.perf_counter()
            with rf("bench.device_encode"):
                dev = enc.device_encode([self.pool[i] for i in idx])
            span("device_encode", []).append((t, time.perf_counter()))
            if trace:
                h, wd = dev["y_rec"].shape[1:]
                w.plane_calls += [(32, len(idx), h, wd, False),
                                  (16, 2 * len(idx), h // 2, wd // 2, True)]
            return dev

        def host_finish(dev):
            t = time.perf_counter()
            with rf("bench.host_finish"):
                out = enc.host_finish(dev)
            span("host_finish", []).append((t, time.perf_counter()))
            return out

        with rf("bench.window"), \
                (_timed_coder(w) if trace else nullcontext()):
            w.t0 = time.perf_counter()
            end = w.t0 + seconds
            idx = self._batch()
            pending = (idx, device_encode(idx))
            while True:
                idx = self._batch()
                dev = device_encode(idx)
                pidx, pdev = pending
                payloads, recons = host_finish(pdev)
                t = time.perf_counter()
                w.batch_done.append(t)
                w.frames += len(pidx)
                for b, (i, p, r) in enumerate(zip(pidx, payloads, recons)):
                    w.payloads.setdefault(i, []).append(p)
                    w.payload_bytes += len(p)
                    w.recons[i] = r
                    w.dev[i] = (pdev, b)
                pending = (idx, dev)
                if t >= end:
                    break
            w.t_end = t
        enc.host_finish(pending[1])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return w

    def psnr_y(self, w: Window) -> float:
        """Mean luma PSNR of the pool frames against their recons."""
        return float(np.mean([stats.psnr(self.pool[i][0], w.recons[i][0],
                                         self.bd) for i in sorted(w.recons)]))

    def program_outputs(self, w: Window) -> dict:
        """The device outputs of every pool frame the window coded, on the
        host, as _frame gives the reference's."""
        out = {}
        for i, (dev, b) in w.dev.items():
            n = dev["n"]
            out[i] = {k: (torch.stack([dev[k][b], dev[k][n + b]])
                          if k.startswith("uv") else dev[k][b])
                      .to(torch.int32).cpu().numpy() for k in _KEYS}
        return out

    def free_program(self) -> None:
        self.enc = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, cost_dtype=torch.float32) -> dict:
        """The reference's device stage of every pool frame, {pool index:
        frame outputs}."""
        out = ref_encoder.device_stage(self.pool, self.qindex, self.bd,
                                       self.height, self.device, cost_dtype)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return {i: _frame(out, i) for i in range(self.pool_n)}

    def recon(self, f: dict) -> tuple:
        """A frame's deblocked planes at the frame's true height."""
        H = self.height
        return f["y_rec"][:H], f["uv_rec"][0][:H // 2], f["uv_rec"][1][:H // 2]

    def payloads(self, frames: dict) -> dict:
        """The reference coder's payload of each frame in self.coded, from
        its device outputs frames[i]."""
        lf = ref_encoder.lf_levels(self.qindex)
        jobs = [(f["y_mi"], f["uv_mi"][0], f["y_lev"], f["uv_lev"][0],
                 f["uv_lev"][1], self.width, self.height, self.qindex, lf,
                 self.cdf_update) for f in (frames[i] for i in self.coded)]
        return dict(zip(self.coded, _in_workers(jobs)))

    def check(self, w: Window, prog: dict, ref: dict) -> dict:
        """Each number compared, with its limit: {name: (value, limit)}.
        prog: program_outputs; ref: reference()."""
        missing = [i for i in range(self.pool_n) if i not in w.payloads]
        dev_diff = recon_diff = 0
        for i, got in prog.items():
            dev_diff += sum(int(np.count_nonzero(got[k] != ref[i][k]))
                            for k in _KEYS)
            recon_diff += sum(int(np.count_nonzero(
                np.asarray(a, np.int32) != b))
                for a, b in zip(w.recons[i], self.recon(ref[i])))
        coded = self.payloads(ref)
        payload_diff = sum(int(i not in w.payloads or w.payloads[i][-1] != p)
                           for i, p in coded.items())
        repeat_diff = sum(int(p != ps[-1]) for ps in w.payloads.values()
                          for p in ps)
        return {"missing_frames": (len(missing), 0),
                "device_mismatch": (dev_diff, 0),
                "recon_mismatch": (recon_diff, 0),
                "payload_mismatch": (payload_diff, 0),
                "repeat_mismatch": (repeat_diff, 0)}

    def failed(self, w: Window, checks: dict) -> int:
        """Window frames whose answer is judged wrong: every frame of the
        window when the sampled check fails (the samples stand for the
        rest), else the payloads that differ from their pool frame's."""
        if any(v > lim for k, (v, lim) in checks.items()
               if k != "repeat_mismatch"):
            return w.frames
        return checks["repeat_mismatch"][0]


_KEYS = ("y_mi", "uv_mi", "y_lev", "uv_lev", "y_rec", "uv_rec")


def _frame(out: dict, i: int) -> dict:
    """Frame i of a stacked device-stage result (luma [n, ...], U then V
    [2n, ...]): each key's array, the chroma ones [2, ...] (U, V)."""
    n = len(out["y_mi"])
    return {k: v[[i, n + i]] if k.startswith("uv") else v[i]
            for k, v in out.items()}


_WORKER = ("import pickle, sys; sys.path.insert(0, sys.argv[1]); "
           "from benchmark.reference.coder import host_stage; "
           "sys.stdout.buffer.write(host_stage(*pickle.load(sys.stdin.buffer)))")


def _in_workers(jobs: list, width: int = 8) -> list:
    """host_stage(*job) of each job, in worker processes (the Python
    coder takes seconds a busy 1080p frame), at most `width` at once;
    each worker has ended when this returns."""
    root = str(Path(__file__).resolve().parents[2])
    out = []
    for k in range(0, len(jobs), width):
        procs = [subprocess.Popen([sys.executable, "-c", _WORKER, root],
                                  stdin=subprocess.PIPE,
                                  stdout=subprocess.PIPE)
                 for _ in jobs[k:k + width]]
        for proc, job in zip(procs, jobs[k:k + width]):
            proc.stdin.write(pickle.dumps(job))
            proc.stdin.close()
        for proc in procs:
            data = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError("a reference coder worker failed")
            out.append(data)
    return out


@contextmanager
def _timed_coder(w: Window):
    """Time every call of the native tile coder (one a frame, on the
    encoder's coder threads) through the module attribute that
    host_finish calls."""
    from svtav1_tpu_torch.ec import native
    inner = native.encode_tile_intra
    lock = threading.Lock()

    def timed(*a, **k):
        t = time.perf_counter()
        out = inner(*a, **k)
        dt = time.perf_counter() - t
        with lock:
            w.coder_s.append(dt)
        return out

    native.encode_tile_intra = timed
    try:
        yield
    finally:
        native.encode_tile_intra = inner


def _annotate(name: str):
    return torch.profiler.record_function(name)


def control(config: dict, traffic: dict, seed: int, device) -> dict:
    """The control: the reference with its RD cost in bfloat16 put in the
    program's place, held to the float32 reference by the same numbers
    (its payloads coded from its own device outputs)."""
    cell = Cell(config, traffic, seed, device, program=False)
    low = cell.reference(torch.bfloat16)
    w = Window(payloads={i: [p] for i, p in cell.payloads(low).items()},
               recons={i: cell.recon(f) for i, f in low.items()})
    for i in range(cell.pool_n):
        w.payloads.setdefault(i, [b""])
    return cell.check(w, low, cell.reference())
