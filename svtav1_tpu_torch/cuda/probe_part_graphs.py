"""The partition scan's CUDA graphs at the 1080p shapes, against its eager
steps on one card.

    python3 -m svtav1_tpu_torch.cuda.probe_part_graphs

For each shape (a 512x128 luma crop in the key-frame form and with 5
seeded lanes; 1080p luma 1x1088x1920 in the key-frame form and with 5
seeded lanes; paired U+V 2x544x960 in the key-frame form) it runs
``encode_plane_wavefront_part`` at q100 (weight 1.0, no map), q70 and
q140 (weight 1.15, a seeded lambda map): the first call captures the
shape's step graphs, the later ones replay them.  Printed per call: the
wall time between two synchronizes and, where the eager steps run too,
their time and whether all ten outputs are equal; per shape: the step
graphs, their nodes, capture and instantiate seconds, the device memory
reserved and the host RSS after the last capture; the card's name and
power limit first.  Raises if an output differs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..encoder import wavefront2 as wf2
from ..encoder.geometry import bottom_force_masks
from .inputs import card, lane_arrays, plane_src

# label, B, h, w, bs, chroma, valid_h, lanes, the calls that also run the
# eager steps
SHAPES = [
    ("luma crop", 1, 128, 512, 32, False, None, None, (0, 2)),
    ("luma crop, 5 lanes", 1, 128, 512, 32, False, None, 5, (0, 2)),
    ("luma 1080p", 1, 1088, 1920, 32, False, 1080, None, (0, 2)),
    ("U+V 1080p", 2, 544, 960, 16, True, 540, None, (0,)),
    ("luma 1080p, 5 lanes", 1, 1088, 1920, 32, False, 1080, 5, (0, 2)),
]
CALLS = ((100, 1.0, False), (70, 1.0, False), (140, 1.15, True))


def shape_line(key) -> str:
    log = [c for c in wf2.GRAPHS["log"] if c["key"] == key]
    nodes = [c["nodes"] for c in log]
    return (f"{len(log)} step graphs, "
            f"{'not read' if None in nodes else sum(nodes)} nodes, capture "
            f"{sum(c['capture_s'] for c in log):.1f} s, instantiate "
            f"{sum(c['instantiate_s'] for c in log):.1f} s, device memory "
            f"reserved {log[-1]['reserved_bytes'] / 2 ** 20:.0f} MiB, host RSS "
            f"{log[-1]['rss_bytes'] / 2 ** 30:.2f} GiB")


def main():
    dev = torch.device("cuda")
    name = card()
    print(name, flush=True)
    for label, B, h, w, bs, chroma, vh, n, eager_at in SHAPES:
        rng = np.random.RandomState(5)
        src_np = plane_src(3, B, h, w)
        src = torch.from_numpy(src_np).to(dev)
        if chroma:
            fp_np = rng.randint(0, 2, (B, h // bs, w // bs))
            fsb_np = rng.randint(0, 2, (B, h // bs // 2, w // bs // 2))
        else:
            fp_np, fsb_np = (a[None] for a in bottom_force_masks(
                h // 32, w // 32, h // 64, w // 64, (vh or h) // 4))
        fp, fsb = (torch.from_numpy(a.astype(np.int32)).to(dev)
                   for a in (fp_np, fsb_np))
        inter = None if n is None else wf2.InterLanes(*(
            torch.from_numpy(a).to(dev)
            for a in lane_arrays(src_np[0], n, rng)))
        for i, (q, scale, with_map) in enumerate(CALLS):
            lam_map = torch.from_numpy(rng.uniform(
                0.68, 1.18, (B, h // bs, w // bs)).astype(np.float32)).to(
                    dev) if with_map else None
            kw = dict(chroma=chroma, tx_search=not chroma, valid_h=vh,
                      inter=inter, lam_scale=scale, lam_map=lam_map)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = wf2.encode_plane_wavefront_part(src, bs, q, fp, fsb, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            line = (f"{label} {B}x{h}x{w}, q{q}, weight {scale}, "
                    f"{'a seeded' if with_map else 'no'} lambda map: graph "
                    f"call {t1 - t0:.3f} s")
            if i in eager_at:
                want = wf2.encode_plane_wavefront_part(src, bs, q, fp, fsb,
                                                       eager=True, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                line += (f", eager steps {time.perf_counter() - t1:.3f} s, "
                         f"outputs equal {same}")
                if not same:
                    raise AssertionError(line)
            print(f"{line} [{name}]", flush=True)
        key = (str(src.device), B, h, w, bs, chroma, 8, not chroma, vh, n,
               (0,))
        print(f"{label}: {shape_line(key)} [{name}]", flush=True)


if __name__ == "__main__":
    main()
