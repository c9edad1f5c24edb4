"""The benchmark's clip generator: one function for every traffic mix.

A mix's ``content`` block (its data file under ``traffic/``) gives, at
8-bit scale, a moving sine/cosine luma pattern, an optional busy texture (a
fine sine plus uniform noise) and smooth chroma; this module makes frames
of any size and bit depth from it and a seed.  At 10 bits the amplitudes
are four times larger and the noise is drawn at 10-bit resolution (not an
8-bit draw scaled).  Frames are made on the given device with a
``torch.Generator`` seeded by ``--seed`` and come back as numpy planes
(uint8, or uint16 at 10 bits).  The seed draws the noise and the
pattern's starting phase; the sizes, amplitudes and motion are the mix's,
so every seed gives the same kind of content.

Written for the benchmark from the port's ``cuda/inputs.py``
(``synth_frames``, ``banded_frames``), which it replaces as the
benchmark's source of inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def _noise(gen, amp: int, shape, device):
    """Uniform integers in [-amp, amp] (0 when amp is 0)."""
    if not amp:
        return torch.zeros(shape, device=device)
    return torch.randint(-amp, amp + 1, shape, generator=gen,
                         device=device).float()


def make_pool(content: dict, width: int, height: int, bd: int, n: int,
              seed: int, device="cpu") -> list:
    """n distinct (y, u, v) frames of the mix's content."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    sc = 1 << (bd - 8)
    top = (1 << bd) - 1
    dtype = np.uint8 if bd == 8 else np.uint16
    L = content["luma"]
    yy, xx = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                            torch.arange(width, device=dev, dtype=torch.float32),
                            indexing="ij")
    cy, cx = yy[::2, ::2], xx[::2, ::2]
    phase = int(torch.randint(0, 64, (1,), generator=gen, device=dev))
    tex = L.get("texture_amp", 0) * torch.sin(xx / 2.0 + yy / 3.0)
    frames = []
    for k in range(n):
        t = float(phase + k)
        y = (L["mean"] + L["amp_x"] * torch.sin((xx + L["speed_x"] * t) /
                                                L["period_x"]) +
             L["amp_y"] * torch.cos((yy + L["speed_y"] * t) / L["period_y"]) +
             tex) * sc
        y = y + _noise(gen, L["noise"] * sc, y.shape, dev) + \
            _noise(gen, L.get("texture_noise", 0) * sc, y.shape, dev)
        planes = [y]
        for key in ("u", "v"):
            C = content[key]
            axis = cx if C["axis"] == "x" else cy
            p = (C["mean"] + C["amp"] * torch.sin(
                (axis + C["speed"] * t) / C["period"] + C.get("shift", 0.0))
                 ) * sc
            planes.append(p + _noise(gen, C.get("noise", 0) * sc, p.shape,
                                     dev))
        frames.append(tuple(p.clamp(0, top).floor().to(torch.int32).cpu()
                            .numpy().astype(dtype) for p in planes))
    return frames
