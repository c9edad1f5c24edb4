"""Inputs and the card query shared by the scripts that run the port on a
CUDA card (``chip_smoke.py``, ``cuda/probe_wavefront.py``,
``cuda/compare_trees.py``).

numpy and the standard library only, so a script can load it beside a
checkout of another version of the port.
"""

from __future__ import annotations

import subprocess

import numpy as np

# the wavefront's 1080p shapes: one frame and the main path's batch of 4
# (luma 32x32 blocks, valid_h 1080; paired chroma 16x16, valid_h 540):
# label, seed, B, h, w, bs, chroma, valid_h, on the main path
SHAPES_1080P = [
    ("luma 1x1088x1920", 3, 1, 1088, 1920, 32, False, 1080, False),
    ("chroma paired 2x544x960", 4, 2, 544, 960, 16, True, 540, False),
    ("luma 4x1088x1920", 5, 4, 1088, 1920, 32, False, 1080, True),
    ("chroma paired 8x544x960", 6, 8, 544, 960, 16, True, 540, True),
]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def plane_src(seed, B, h, w):
    """[B, h, w] uint8 planes: a sine/cosine pattern plus uniform noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = [np.clip(120 + 60 * np.sin((xx + 7 * b) / 17.0) +
                   40 * np.cos((yy + 3 * b) / 11.0) +
                   rng.randint(-6, 7, (h, w)), 0, 255) for b in range(B)]
    return np.stack(out).astype(np.uint8)


def plane_src10(seed, B, h, w):
    """[B, h, w] uint16 10-bit planes: plane_src's pattern at 10 bits with
    its own noise (not 8-bit values scaled by 4)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = [np.clip(480 + 240 * np.sin((xx + 7 * b) / 17.0) +
                   160 * np.cos((yy + 3 * b) / 11.0) +
                   rng.randint(-24, 25, (h, w)), 0, 1023) for b in range(B)]
    return np.stack(out).astype(np.uint16)


def synth_frames10(width, height, n, seed=0):
    """A 10-bit clip (uint16): a moving sine/cosine luma pattern with
    uniform noise of +-20 and smooth chroma, as the JAX package's 10-bit
    video test makes it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for t in range(n):
        y = np.clip(400 + 200 * np.sin((xx + 4 * t) / 17.0) +
                    160 * np.cos(yy / 23.0) +
                    rng.randint(-20, 21, (height, width)), 0, 1023)
        u = np.clip(480 + 120 * np.sin((xx[::2, ::2] + 2 * t) / 31.0), 0,
                    1023)
        v = np.clip(520 + 100 * np.cos(yy[::2, ::2] / 29.0), 0, 1023)
        out.append(tuple(p.astype(np.uint16) for p in (y, u, v)))
    return out


def synth_frames(width, height, n, seed=0):
    """The JAX benchmark's synthetic 1080p clip (bench.py), frame for
    frame: a moving sine/cosine pattern plus uniform noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    frames = []
    for t in range(n):
        y = np.clip(110 + 70 * np.sin((xx + 5 * t) / 19.0) +
                    50 * np.cos((yy + 3 * t) / 13.0) +
                    rng.randint(-4, 5, (height, width)), 0,
                    255).astype(np.uint8)
        u = np.clip(120 + 40 * np.sin((xx[::2, ::2] + 2 * t) / 23.0), 0,
                    255).astype(np.uint8)
        v = np.clip(135 + 35 * np.cos((yy[::2, ::2] + t) / 27.0), 0,
                    255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def banded_frames(width, height, n, seed=0):
    """synth_frames with a busy texture (a fine sine plus uniform noise)
    added to the luma of every other of six vertical bands.  The synthetic
    clip alone is smooth at the 64x64 scale and the partition path codes it
    as 64x64 blocks at q100; the busy bands split to 32x32 and 16x16 blocks
    with non-DCT tx types, so a run takes every decision of the path."""
    rng = np.random.RandomState(seed + 1)
    yy, xx = np.mgrid[0:height, 0:width]
    band = (xx // (width // 6)) % 2 == 1
    out = []
    for y, u, v in synth_frames(width, height, n, seed):
        busy = (y + 20 * np.sin(xx / 2.0 + yy / 3.0) +
                rng.randint(-16, 17, (height, width)))
        out.append((np.clip(np.where(band, busy, y), 0,
                            255).astype(np.uint8), u, v))
    return out


def edge_frames(width, height, n, seed=0):
    """Sharp diagonal luma edges with noise in every other 64-column band
    and uniform noise between them; chroma with co-located edges.  CCSO,
    which corrects chroma and luma from the deblocked luma's edge classes,
    turns on for such content where the smooth synthetic clip leaves it
    off."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    cy, cx = yy[::2, ::2], xx[::2, ::2]
    out = []
    for b in range(n):
        edges = 128 + 70 * np.sign(np.sin((xx + 2 * yy) / 6.0 + b)) + \
            rng.randint(-12, 13, (height, width))
        noise = 128 + rng.randint(-40, 41, (height, width))
        y = np.where((xx // 64) % 2 == 0, edges, noise)
        u = 120 + 30 * np.sign(np.sin((cx + 2 * cy) / 3.0 + b)) + \
            rng.randint(-6, 7, cy.shape)
        v = 130 + 25 * np.cos(cy / 4.0) + rng.randint(-8, 9, cy.shape)
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (y, u, v)))
    return out


def edge_frames10(width, height, n, seed=0):
    """edge_frames at 10 bits (uint16): the same layout of sharp diagonal
    edges and noise bands, drawn at 10-bit amplitudes with 10-bit noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    cy, cx = yy[::2, ::2], xx[::2, ::2]
    out = []
    for b in range(n):
        edges = 512 + 280 * np.sign(np.sin((xx + 2 * yy) / 6.0 + b)) + \
            rng.randint(-48, 49, (height, width))
        noise = 512 + rng.randint(-160, 161, (height, width))
        y = np.where((xx // 64) % 2 == 0, edges, noise)
        u = 480 + 120 * np.sign(np.sin((cx + 2 * cy) / 3.0 + b)) + \
            rng.randint(-24, 25, cy.shape)
        v = 520 + 100 * np.cos(cy / 4.0) + rng.randint(-32, 33, cy.shape)
        out.append(tuple(np.clip(p, 0, 1023).astype(np.uint16)
                         for p in (y, u, v)))
    return out


def moving_frames(width, height, n, seed=0):
    """A panned clip for the inter path: one texture drawn once from the
    seed, larger than the frame (the synthetic pattern with
    ``banded_frames``' busy bands, its noise fixed in the texture), and
    each frame a crop of it moved by (2, 3) px a frame, so the global
    motion fit has a pan to find.  A centred patch (256 px square, or half
    the frame's smaller side) moves at another velocity, (-1, -2.5) px a
    frame: at a half-pel position it is the mean of two crops 1 px apart,
    so NEWMV, subpel mvs and the filter pick have work.  Every frame gets
    +-2 of fresh noise, so that residuals are not all zero.  Chroma is the
    2x2 mean of full-size chroma textures moved the same way."""
    rng = np.random.RandomState(seed)
    m = 4 * n + 32
    th, tw = height + 2 * m, width + 2 * m
    yy, xx = np.mgrid[0:th, 0:tw]
    flat = (110 + 70 * np.sin(xx / 19.0) + 50 * np.cos(yy / 13.0) +
            rng.randint(-4, 5, (th, tw)))
    busy = (flat + 20 * np.sin(xx / 2.0 + yy / 3.0) +
            rng.randint(-16, 17, (th, tw)))
    band = (xx // max(width // 6, 1)) % 2 == 1
    tex = [np.where(band, busy, flat),
           120 + 40 * np.sin(xx / 23.0) + rng.randint(-3, 4, (th, tw)),
           135 + 35 * np.cos(yy / 27.0) + rng.randint(-3, 4, (th, tw))]
    tex = [np.clip(t, 0, 255).astype(np.int32) for t in tex]
    ps = min(256, height // 2, width // 2)
    py, px = (height - ps) // 2, (width - ps) // 2
    frames = []
    for t in range(n):
        planes = []
        for k, tx in enumerate(tex):
            p = tx[m - 2 * t:m - 2 * t + height, m - 3 * t:m - 3 * t + width]
            p = p.copy()
            # the patch: (-1, -2.5) px a frame, half-pel columns averaged
            r0, c0 = m + py + t, m + px + (5 * t) // 2
            a = tx[r0:r0 + ps, c0:c0 + ps]
            b = tx[r0:r0 + ps, c0 + (5 * t) % 2:c0 + (5 * t) % 2 + ps]
            p[py:py + ps, px:px + ps] = (a + b + 1) >> 1
            if k:
                p = (p[::2, ::2] + p[::2, 1::2] + p[1::2, ::2] +
                     p[1::2, 1::2] + 2) >> 2
            p = p + rng.randint(-2, 3, p.shape)
            planes.append(np.clip(p, 0, 255).astype(np.uint8))
        frames.append(tuple(planes))
    return frames


def moving_frames10(width, height, n, seed=0):
    """A panned 10-bit clip (uint16) for the inter paths, built as
    moving_frames is: one texture drawn from the seed (a 10-bit sine
    pattern with fixed noise, busy in every other of six vertical bands),
    each frame a crop moved (2, 3) px a frame, a centred patch moved (-1,
    -1.5) px a frame (half-pel columns averaged), +-3 of fresh noise a
    frame, chroma the 2x2 mean of its own textures.  The decimated luma
    SAD between frames (about 18) stays below the scene-cut threshold of
    26, which the encoders apply to 10-bit values unscaled."""
    rng = np.random.RandomState(seed)
    m = 4 * n + 32
    th, tw = height + 2 * m, width + 2 * m
    yy, xx = np.mgrid[0:th, 0:tw]
    flat = (512 + 150 * np.sin(xx / 23.0) + 120 * np.cos(yy / 19.0) +
            rng.randint(-6, 7, (th, tw)))
    busy = flat + 16 * np.sin(xx / 2.0 + yy / 3.0) + \
        rng.randint(-6, 7, (th, tw))
    band = (xx // max(width // 6, 1)) % 2 == 1
    tex = [np.where(band, busy, flat),
           480 + 100 * np.sin(xx / 29.0) + rng.randint(-2, 3, (th, tw)),
           540 + 90 * np.cos(yy / 31.0) + rng.randint(-2, 3, (th, tw))]
    tex = [np.clip(t, 0, 1023).astype(np.int32) for t in tex]
    ps = min(256, height // 2, width // 2)
    py, px = (height - ps) // 2, (width - ps) // 2
    frames = []
    for t in range(n):
        planes = []
        for k, tx in enumerate(tex):
            p = tx[m - 2 * t:m - 2 * t + height,
                   m - 3 * t:m - 3 * t + width].copy()
            r0, c0 = m + py + t, m + px + (3 * t) // 2
            a = tx[r0:r0 + ps, c0:c0 + ps]
            b = tx[r0:r0 + ps, c0 + (3 * t) % 2:c0 + (3 * t) % 2 + ps]
            p[py:py + ps, px:px + ps] = (a + b + 1) >> 1
            if k:
                p = (p[::2, ::2] + p[::2, 1::2] + p[1::2, ::2] +
                     p[1::2, 1::2] + 2) >> 2
            p = p + rng.randint(-3, 4, p.shape)
            planes.append(np.clip(p, 0, 1023).astype(np.uint16))
        frames.append(tuple(planes))
    return frames


def stripes(width, height, deg, seed=0, bd=8):
    """One frame of luma stripes constant along the direction deg (degrees
    from the x axis, y up), period 9 px, with +-3 of noise (scaled to the
    bit depth bd, 8 or 10), and flat chroma: a directional mode with an
    angle delta fits it better than the base angles when deg lies between
    them.  uint8 planes at 8 bits, uint16 at 10."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    t = np.deg2rad(deg)
    phase = (xx * np.sin(t) + yy * np.cos(t)) * 2 * np.pi / 9.0
    k = 1 << (bd - 8)
    dt = np.uint8 if bd == 8 else np.uint16
    y = np.clip(k * (128 + 90 * np.sin(phase)) +
                k * rng.randint(-3, 4, (height, width)), 0,
                (1 << bd) - 1).astype(dt)
    u = np.full((height // 2, width // 2), 120 * k, dt)
    v = np.full((height // 2, width // 2), 136 * k, dt)
    return y, u, v


def moving_stripes(width, height, n, seed=0, bd=8):
    """A clip for the inter paths with angle deltas: stripes at 51 degrees
    (period 12 px, amplitude 60) panned 1 px a frame, and a patch near the
    centre (a third of the smaller side, its corner on the 32x32 block
    grid; ``stripes``' period 9 px, amplitude 90)
    whose stripes turn to another angle every frame (80, 20, 129, 39
    degrees, ...), so that P frames code it intra, with deltas; +-3 of
    fresh noise a frame, flat chroma.  The decimated luma SAD between
    frames (about 17) stays below the scene-cut threshold of 26; at 10
    bits the same amplitudes sit about 512, since the encoders apply that
    threshold to 10-bit values unscaled (uint8 planes at 8 bits, uint16
    at 10)."""
    rng = np.random.RandomState(seed)
    off = (1 << (bd - 1)) - 128
    dt = np.uint8 if bd == 8 else np.uint16
    yy, xx = np.mgrid[0:height, 0:width]
    ps = min(height, width) // 3
    py, px = ((height - ps) // 2) // 32 * 32, ((width - ps) // 2) // 32 * 32
    patch_degs = (80, 20, 129, 39, 141, 62)

    def pattern(deg, dx, amp, period):
        t = np.deg2rad(deg)
        return 128 + amp * np.sin(((xx + dx) * np.sin(t) + yy * np.cos(t)) *
                                  2 * np.pi / period)
    frames = []
    for t in range(n):
        y = pattern(51, t, 60, 12.0)
        y[py:py + ps, px:px + ps] = pattern(
            patch_degs[t % len(patch_degs)], 0, 90,
            9.0)[py:py + ps, px:px + ps]
        y = np.clip(off + y + rng.randint(-3, 4, y.shape), 0,
                    (1 << bd) - 1).astype(dt)
        frames.append((y, np.full((height // 2, width // 2), off + 120, dt),
                       np.full((height // 2, width // 2), off + 136, dt)))
    return frames


def lane_arrays(plane, n, rng):
    """n seeded inter lanes of a luma partition scan over `plane` [h, w]
    (h, w multiples of 64), as numpy in ``wavefront2.InterLanes``' order:
    the plane's 32x32, z-order 16x16 and 64x64 blocks plus noise (int32),
    rates in [3, 24) bits (float32), lane and intra masks open nine times
    in ten (bool), each with a leading batch axis of 1."""
    h, w = plane.shape
    p = plane.astype(np.int32)

    def pred(bs):
        b = p.reshape(h // bs, bs, w // bs, bs).transpose(0, 2, 1, 3)
        noise = rng.randint(-12, 13, (1, n) + b.shape)
        return np.clip(b[None, None] + noise, 0, 255).astype(np.int32)
    g32, g64 = (h // 32, w // 32), (h // 64, w // 64)
    sub = pred(16).reshape((1, n, g32[0], 2, g32[1], 2, 16, 16)).transpose(
        0, 1, 2, 4, 3, 5, 6, 7).reshape((1, n) + g32 + (4, 16, 16))
    rate = lambda *s: rng.uniform(3, 24, (1, n) + s).astype(np.float32)
    ok = lambda *s: rng.rand(*s) < 0.9
    return (pred(32), rate(*g32), ok(1, n, *g32), sub, rate(*g32, 4),
            ok(1, n, *g32, 4), pred(64), rate(*g64), ok(1, n, *g64),
            ok(1, *g32), ok(1, *g32, 4), ok(1, *g64))
