"""Where the wavefront kernel's time goes, on one CUDA card.

    python3 -m svtav1_tpu_torch.cuda.probe_wavefront [--deltas]
        [--geometry KxW ...]

Prints the card (nvidia-smi name and power limit), the SASS instruction
count of each kernel instantiation, and for each 1080p shape of the main
path (luma 1x and 4x 1088x1920, paired chroma 2x and 8x 544x960, q100),
or with ``--deltas`` for each shape of the delta form (luma 1x1088x1920,
valid_h 1080, q100: preset 0's 61 candidates and preset 4's 29 at 8 and
10 bits, and 61 + 2 seeded inter lanes at 8 bits):
  * the kernel's resources (``kernel_info``) and time without and with
    its per-ticket timestamps (CUDA events, the median of 4 rounds of 10
    calls each, in turn), so the second is what the stamps cost; a traced
    call must give the untraced call's outputs;
  * from the stamps: the span, the mean time a CTA waits for its
    neighbours, computes (edges to chosen costs) and writes out (to the
    published flag), the flag latency (a block's ready time minus its
    last neighbour's publish time), and the chain that set the span:
    walking back from the last block published to the neighbour it
    waited for last, its length in blocks and mean link; where the kernel
    stamps them, the ticket's cluster barrier (ticket asked for to ticket
    taken) and the cost exchange (the lead warp's cost to costs chosen:
    the slowest warp, the cluster barrier and the gather).
``--geometry 16x2 4x4`` adds a run of each shape on clusters of K CTAs of
W warps (W up to 4) that hold its candidates, besides the kernel's own
choice (``launch_geometry``), each held bit for bit to the kernel's own
outputs.
"""

from __future__ import annotations

import argparse
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
from .inputs import SHAPES_1080P, card, lane_arrays, plane_src, plane_src10

P0_DELTAS = (-3, -2, -1, 0, 1, 2, 3)    # preset 0: 61 luma candidates
P4_DELTAS = (-2, 0, 2)                  # preset 4: 29


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
    one warp's phase means (us) from columns 4-10; columns 11-12 (the
    cluster barriers) where the kernel wrote them."""
    t = trace.astype(np.float64)
    t[:, :13] -= np.where(t[:, :13] > 0, t[:, 0].min(), 0)
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
    if trace[:, 11:13].all():
        phases.update(ticket_us=np.mean(t[:, 0] - t[:, 12]) / 1e3,
                      exchange_us=np.mean(t[:, 2] - t[:, 11]) / 1e3)
    return dict(span_us=span / 1e3,
                wait_us=np.mean(t[:, 1] - t[:, 0]) / 1e3,
                compute_us=np.mean(t[:, 2] - t[:, 1]) / 1e3,
                out_us=np.mean(t[:, 3] - t[:, 2]) / 1e3,
                flag_latency_us=np.mean(lat) / 1e3,
                chain_blocks=chain + 1,
                us_per_link=span / 1e3 / (chain + 1), **phases)


def main_shapes():
    """(label, launch args, launch kwargs, C, NU) of the main path's
    1080p shapes."""
    cands = expand_candidates(CAND_MODES)
    for label, seed, B, h, w, bs, chroma, vh, _ in SHAPES_1080P:
        src = torch.from_numpy(plane_src(seed, B, h, w)).cuda()
        rd = rd_params(100, 8, cands, kf="uv" if chroma else True)
        yield (label, (src, rd, bs, TX_16X16 if chroma else TX_32X32,
                       CAND_MODES, 8, (0,), vh, chroma, chroma), {},
               len(cands), B // 2 if chroma else B)


def delta_shapes():
    """The same for the delta form's five shapes at 1x1088x1920."""
    for bd, deltas, lanes in ((8, P0_DELTAS, 0), (8, P4_DELTAS, 0),
                              (10, P0_DELTAS, 0), (10, P4_DELTAS, 0),
                              (8, P0_DELTAS, 2)):
        src = plane_src(3, 1, 1088, 1920) if bd == 8 else \
            plane_src10(3, 1, 1088, 1920).astype(np.int16)
        cands = expand_candidates(CAND_MODES, deltas)
        kw = {}
        if lanes:
            a = lane_arrays(src[0], lanes, np.random.RandomState(7))
            kw["extra"] = tuple(torch.from_numpy(x).cuda()
                                for x in (a[0], a[1], a[2], a[9]))
        rd = rd_params(100, bd, cands, kf=not lanes)
        label = (f"{'' if bd == 8 else '10-bit '}luma 1x1088x1920, "
                 f"{len(cands)} candidates" +
                 (f" + {lanes} lanes" if lanes else ""))
        yield (label, (torch.from_numpy(src).cuda(), rd, 32, TX_32X32,
                       CAND_MODES, bd, deltas, 1080), kw,
               len(cands) + lanes, 1)


def probe(name, label, args, kw, C, NU, geometry=None):
    """Resources, times and trace statistics of one shape at one
    geometry (None: the kernel's own); returns the untraced outputs."""
    bd, bs, (B, h, w) = args[5], args[2], args[0].shape
    # the geometry keyword only when given, so that the probe also runs
    # on a tree whose kernel takes none (a parent commit, for comparison)
    gk = {"geometry": geometry} if geometry else {}
    if geometry:
        kw = dict(kw, **gk)
        label += f" on {geometry[0]}x{geometry[1]}"
    info = wk.kernel_info(bs, C, bd, **gk)
    ref = wk.launch(*args, **kw)[:3]
    got = wk.launch(*args, trace=True, **kw)[:3]
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
                wk.launch(*args, trace=trace, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            times[trace].append(ev[0].elapsed_time(ev[1]) / 10)
    wk.raise_on_error("cuda")
    plain_ms, traced_ms = np.median(times[False]), np.median(times[True])
    print(f"{label}: kernel {plain_ms:.3f} ms, traced {traced_ms:.3f} ms; "
          f"{info} [{name}]", flush=True)
    tr = wk.launch(*args, trace=True, **kw)[3]
    torch.cuda.synchronize()
    st = chain_stats(tr.cpu().numpy(), wk.schedule(bs, h, w, args[7]), NU,
                     w // bs)
    print(f"{label} trace: " + ", ".join(
        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in st.items()) + f" [{name}]", flush=True)
    return ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deltas", action="store_true",
                    help="the delta form's five shapes, not the main path's")
    ap.add_argument("--geometry", nargs="*", default=[],
                    help="clusters of K CTAs of W warps to run besides the "
                         "kernel's own, as KxW")
    a = ap.parse_args(argv)
    geometries = [tuple(int(x) for x in g.split("x")) for g in a.geometry]
    name = card()
    print(name, flush=True)
    so, _ = build.build()
    for fn, n in sass_counts(so).items():
        print(f"sass: {n} instructions in {fn}", flush=True)
    for label, args, kw, C, NU in (delta_shapes() if a.deltas
                                   else main_shapes()):
        ref = probe(name, label, args, kw, C, NU)
        for g in geometries:
            if g[0] * g[1] < C:
                continue
            got = probe(name, label, args, kw, C, NU, g)
            if not all(torch.equal(x, y) for x, y in zip(ref, got)):
                raise AssertionError(f"{label} on {g}: outputs differ from "
                                     "the kernel's own geometry")


if __name__ == "__main__":
    main()
