"""Where the wavefront kernel's time goes, on one CUDA card.

    python3 -m svtav1_tpu_torch.cuda.probe_wavefront

Prints the card (nvidia-smi name and power limit), the SASS instruction
count of each kernel instantiation, and for each 1080p shape of the main
path (luma 1x and 4x 1088x1920, paired chroma 2x and 8x 544x960, q100):
  * the kernel time without and with its per-ticket timestamps (CUDA
    events over rounds of 10 calls in turn), so the second is what the
    stamps cost; a traced call must give the untraced call's outputs;
  * from the stamps: the span, the mean time a CTA waits for its
    neighbours, computes (edges to chosen costs) and writes out (to the
    published flag), the flag latency (a block's ready time minus its
    last neighbour's publish time), and the chain that set the span:
    walking back from the last block published to the neighbour it
    waited for last, its length in blocks and mean link.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..encoder.intra_encoder import CAND_MODES
from ..encoder.wavefront import expand_candidates, rd_params
from ..spec.txfm import TX_16X16, TX_32X32
from . import build
from . import wavefront_kernel as wk
from .inputs import SHAPES_1080P, card, plane_src


def sass_counts(so: Path) -> dict:
    """Instructions per kernel function in the library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(so)], check=True,
                         capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    return counts


def chain_stats(trace: np.ndarray, sched: np.ndarray, NU: int, bw: int):
    """Phase means (us) and the realised critical chain of one traced
    call: trace [NU * nblk, 16] ns in ticket order (k * NU + u), and
    one warp's phase means (us) from columns 4-10."""
    t = trace.astype(np.float64)
    t[:, :11] -= t[:, 0].min()
    nblk = len(sched)
    k_of = {int(r) * bw + int(c): k for k, (r, c) in
            enumerate(sched[:, :2])}
    pub = t[:, 3].reshape(nblk, NU)
    lat, prev = [], np.full(len(t), -1)
    for k, row in enumerate(sched):
        deps = [k_of[d] for d in row[4:] if d >= 0]
        if not deps:
            continue
        for u in range(NU):
            last = max(deps, key=lambda d: pub[d, u])
            prev[k * NU + u] = last * NU + u
            lat.append(t[k * NU + u, 1] - pub[last, u])
    node, chain = int(np.argmax(t[:, 3])), 0
    while prev[node] >= 0:
        node, chain = int(prev[node]), chain + 1
    span = t[:, 3].max()
    ws = np.diff(t[:, 4:11], axis=1).mean(0) / 1e3
    phases = dict(zip(("pred_us", "fwd_us", "quant_us", "inv_us", "recon_us",
                       "cost_us"), ws))
    return dict(span_us=span / 1e3,
                wait_us=np.mean(t[:, 1] - t[:, 0]) / 1e3,
                compute_us=np.mean(t[:, 2] - t[:, 1]) / 1e3,
                out_us=np.mean(t[:, 3] - t[:, 2]) / 1e3,
                flag_latency_us=np.mean(lat) / 1e3,
                chain_blocks=chain + 1,
                us_per_link=span / 1e3 / (chain + 1), **phases)


def main():
    name = card()
    print(name, flush=True)
    so, _ = build.build()
    for fn, n in sass_counts(so).items():
        print(f"sass: {n} instructions in {fn}", flush=True)
    cands = expand_candidates(CAND_MODES)
    for bs in (32, 16):
        print(f"bs {bs}: {wk.kernel_info(bs, len(cands))}", flush=True)
    for label, seed, B, h, w, bs, chroma, vh, _ in SHAPES_1080P:
        src = torch.from_numpy(plane_src(seed, B, h, w)).cuda()
        rd = rd_params(100, 8, cands, kf="uv" if chroma else True)
        args = (src, rd, bs, TX_16X16 if chroma else TX_32X32, CAND_MODES,
                8, (0,), vh, chroma, chroma)
        ref = wk.launch(*args)[:3]
        got = wk.launch(*args, trace=True)[:3]
        torch.cuda.synchronize()
        wk.raise_on_error("cuda")
        if not all(torch.equal(a, b) for a, b in zip(ref, got)):
            raise AssertionError(f"{label}: the trace changes the output")
        times = {False: [], True: []}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for rnd in range(4):
            for trace in ((False, True) if rnd % 2 == 0 else (True, False)):
                ev[0].record()
                for _ in range(10):
                    wk.launch(*args, trace=trace)
                ev[1].record()
                torch.cuda.synchronize()
                times[trace].append(ev[0].elapsed_time(ev[1]) / 10)
        wk.raise_on_error("cuda")
        plain_ms, traced_ms = np.mean(times[False]), np.mean(times[True])
        print(f"{label}: kernel {plain_ms:.3f} ms, traced {traced_ms:.3f} ms "
              f"[{name}]", flush=True)
        tr = wk.launch(*args, trace=True)[3]
        torch.cuda.synchronize()
        st = chain_stats(tr.cpu().numpy(), wk.schedule(bs, h, w, vh),
                         B // 2 if chroma else B, w // bs)
        print(f"{label} trace: " + ", ".join(
            f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()) + f" [{name}]", flush=True)


if __name__ == "__main__":
    main()
