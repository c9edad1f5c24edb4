"""The all-intra encode of a frame whose height leaves m = 12 valid mi rows
in its bottom SB row (height % 64 == 48, e.g. 2160): ``all_intra``'s
closed loop, whose frames the program codes with the edge strip (its
bottom SB row one chain per frame, the bottom 32-row in 16x16 blocks).

The window and the metrics are all_intra's; the window also lists the
chain launches (``edge_calls``: big block size, planes, width, chroma),
and its plane calls cover the SB rows the plane kernel codes (all but
the bottom one).  The check holds the strip's modes and levels to the
plain reference (``reference/edge.py``) beside all_intra's outputs, the
recons with the strip in them, and the payloads with the strip's syntax.
"""

from __future__ import annotations

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..reference import edge as ref_edge
from ..reference import encoder as ref_encoder
from . import all_intra
from .all_intra import Window, _frame

STRIP = ("y_emi", "y_elev", "uv_emi", "uv_elev")


class Cell(all_intra.Cell):
    """all_intra.Cell at an m = 12 height."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program: bool = True):
        if config["height"] % 64 != 48:
            raise ValueError(f"height {config['height']}: the edge strip "
                             "pipeline needs height % 64 == 48")
        super().__init__(config, traffic, seed, device, program)

    def window(self, seconds: float, trace: bool = False) -> Window:
        w = super().window(seconds, trace)
        # the plane kernel codes every SB row but the bottom one, which
        # the chain launch of each plane call codes
        w.edge_calls = [(bs, B, wd, chroma)
                        for bs, B, h, wd, chroma in w.plane_calls]
        w.plane_calls = [(bs, B, h - 2 * bs, wd, chroma)
                         for bs, B, h, wd, chroma in w.plane_calls]
        return w

    def program_outputs(self, w: Window) -> dict:
        out = super().program_outputs(w)
        for i, (dev, b) in w.dev.items():
            n = dev["n"]
            out[i].update({k: (torch.stack([dev[k][b], dev[k][n + b]])
                               if k.startswith("uv") else dev[k][b])
                           .to(torch.int32).cpu().numpy() for k in STRIP})
        return out

    def reference(self, cost_dtype=torch.float32) -> dict:
        out = ref_edge.device_stage(self.pool, self.qindex, self.bd,
                                    self.height, self.device, cost_dtype)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return {i: _frame(out, i) for i in range(self.pool_n)}

    def payloads(self, frames: dict) -> dict:
        lf = ref_encoder.lf_levels(self.qindex)
        jobs = [(f["y_mi"], f["uv_mi"][0], f["y_lev"], f["uv_lev"][0],
                 f["uv_lev"][1], (f["y_emi"], f["uv_emi"][0], f["y_elev"],
                                  f["uv_elev"][0], f["uv_elev"][1]),
                 self.width, self.height, self.qindex, lf, self.cdf_update)
                for f in (frames[i] for i in self.coded)]
        return dict(zip(self.coded, _in_workers(jobs)))

    def check(self, w: Window, prog: dict, ref: dict) -> dict:
        checks = super().check(w, prog, ref)
        strip = sum(int(np.count_nonzero(got[k] != ref[i][k]))
                    for i, got in prog.items() for k in STRIP)
        v, lim = checks["device_mismatch"]
        checks["device_mismatch"] = (v + strip, lim)
        return checks


_WORKER = ("import pickle, sys; sys.path.insert(0, sys.argv[1]); "
           "from benchmark.reference.edge import host_stage; "
           "sys.stdout.buffer.write("
           "host_stage(*pickle.load(sys.stdin.buffer)))")


def _in_workers(jobs: list, width: int = 8) -> list:
    """all_intra._in_workers over reference/edge.py's host_stage."""
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


def control(config: dict, traffic: dict, seed: int, device) -> dict:
    """all_intra.control of this pipeline: the reference with its RD cost
    in bfloat16 in the program's place, strip included."""
    cell = Cell(config, traffic, seed, device, program=False)
    low = cell.reference(torch.bfloat16)
    w = Window(payloads={i: [p] for i, p in cell.payloads(low).items()},
               recons={i: cell.recon(f) for i, f in low.items()})
    for i in range(cell.pool_n):
        w.payloads.setdefault(i, [b""])
    return cell.check(w, low, cell.reference())
