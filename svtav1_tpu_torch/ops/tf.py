"""Motion-compensated temporal filtering (MCTF) of anchor pictures, plain
PyTorch on the planes' device.

Counterpart of ``svtav1_tpu/ops/tf.py`` (the reference's alt-ref /
key-frame temporal filter, EbTemporalFiltering.c:250-277: block ME against
each neighbour source picture, per-pixel squared-difference window
statistics, exponential decay weights, weighted average into the filtered
anchor):
  1. one motion search over the K neighbours at once, the centre tiled on
     the batch axis (``encoder/me.py``, 32x32 blocks);
  2. motion compensation of each neighbour's luma and chroma at those mvs
     (``ops/mc.py``, REGULAR filter);
  3. a per-pixel weight for each neighbour, 16 exp(-d / decay), where d is
     the 5x5 windowed mean of the squared error against the centre (edge
     pixels replicated) and the decay is q-scaled; the centre weighs 16;
  4. the weighted mean, rounded half to even and clipped.
Encoder-side only: the output replaces the anchor's source before it is
coded, so conformance is unaffected.

Float32 as in the JAX package, in its order of operations.  The squared
errors and their 25-term window sums are integers below 2^24, so they are
summed exactly in int32 here; the divisions are correctly rounded (by a
tensor on the planes' device: CUDA multiplies by the reciprocal of a host
scalar divisor); the neighbour sums run in neighbour order.  ``exp`` is
not correctly rounded in XLA, torch's CPU or CUDA, so a filtered pixel
can differ by one where the weighted mean sits at a rounding tie.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import upload
from ..encoder.geometry import pad_plane_bottom
from .mc import pad_plane, predict_inter_blocks

TF_WEIGHT_SCALE = 16.0       # centre (self) weight; neighbour max weight
TF_WINDOW = 5                # squared-error smoothing window


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on like's device."""
    return torch.tensor(np.float32(x), device=like.device)


def _box5(x):
    """5x5 box mean with edge replication of [..., H, W] int32 values whose
    window sums stay below 2^24 -> float32 (sums exact, one rounded
    division)."""
    pad = TF_WINDOW // 2
    H, W = x.shape[-2:]
    dev = x.device
    rows = torch.arange(-pad, H + pad, device=dev).clamp(0, H - 1)
    cols = torch.arange(-pad, W + pad, device=dev).clamp(0, W - 1)
    xp = x[..., rows, :][..., cols]
    s = sum(xp[..., :, j:j + W] for j in range(TF_WINDOW))
    s = sum(s[..., i:i + H, :] for i in range(TF_WINDOW))
    s = s.to(torch.float32)
    return s / _f32(TF_WINDOW * TF_WINDOW, s)


def _blocks_to_plane(blocks, bh: int, bw: int, bs: int):
    """[K, N, bs, bs] raster blocks -> [K, bh*bs, bw*bs]."""
    K = blocks.shape[0]
    return (blocks.reshape(K, bh, bw, bs, bs).permute(0, 1, 3, 2, 4)
            .reshape(K, bh * bs, bw * bs))


def _tf_blend(center, aligned, decay: float):
    """center [H, W] and aligned [K, H, W] int32 pixels -> the filtered
    plane [H, W] float32: per-pixel neighbour weights from the 5x5
    windowed MSE with exponential decay."""
    d = _box5((aligned - center[None]) ** 2)
    w = TF_WEIGHT_SCALE * torch.exp(-d / _f32(decay, d))
    a = aligned.to(torch.float32)
    num, den = w[0] * a[0], w[0]
    for k in range(1, a.shape[0]):
        num = num + w[k] * a[k]
        den = den + w[k]
    return (TF_WEIGHT_SCALE * center.to(torch.float32) + num) / \
        (TF_WEIGHT_SCALE + den)


def temporal_filter_plane(center, neighbors, mv8, bs: int, ss: int,
                          frame_h: int, frame_w: int, decay: float,
                          bd: int = 8):
    """center [H, W]; neighbors [K, H, W] (plane resolution); mv8 [K, N, 2]
    luma 1/8-pel mvs of the 32x32 luma blocks.  Returns the filtered plane,
    float32."""
    K = neighbors.shape[0]
    H, W = center.shape
    pbs = bs >> ss
    bh, bw = H // pbs, W // pbs
    N = bh * bw
    ar = torch.arange(N, device=center.device)
    y0 = (ar // bw * pbs)[None].expand(K, N)
    x0 = (ar % bw * pbs)[None].expand(K, N)
    pred = predict_inter_blocks(pad_plane(neighbors.to(torch.int32)), y0, x0,
                                mv8, frame_h, frame_w, pbs, ss, bd)
    return _tf_blend(center.to(torch.int32), _blocks_to_plane(pred, bh, bw,
                                                              pbs), decay)


def tf_decay(qindex: int, n_neighbors: int) -> float:
    """q-scaled squared-error decay (reference: adjust_filter_strength):
    stronger filtering at a higher q, each of more neighbours a little
    weaker."""
    q = max(1.0, qindex / 4.0)
    base = 2.0 * q
    return float(base * (1.0 + 0.1 * max(0, n_neighbors - 2)))


def temporal_filter_frame(center, neighbors, qindex: int, bd: int = 8,
                          device="cpu"):
    """center (y, u, v) uint8 (or uint16) arrays; neighbors a list of such
    tuples.  Filters on `device`; returns the filtered (y, u, v) arrays of
    center's dtype, or center unchanged when no neighbours are given."""
    if not neighbors:
        return center
    from ..encoder.me import motion_estimate

    cy, cu, cv = (np.asarray(p) for p in center)
    th, W = cy.shape
    # SB-pad an odd height (the filter reads the source; crop back after)
    ph = -(-th // 64) * 64
    planes = [(cy, cu, cv)] + [tuple(np.asarray(p) for p in n)
                                for n in neighbors]
    planes = [tuple(pad_plane_bottom(p, ph >> s) for p, s in zip(f, (0, 1, 1)))
              for f in planes]
    K = len(neighbors)
    c = [upload(p, device) for p in planes[0]]
    nb = [upload(np.stack([f[i] for f in planes[1:]]), device)
          for i in range(3)]
    # one motion search over all neighbours (the centre tiled on batch)
    mv8, _ = motion_estimate(c[0][None].expand(K, ph, W), nb[0], 32)
    mv8 = mv8.reshape(K, -1, 2)
    decay = tf_decay(qindex, K)
    filt = [temporal_filter_plane(c[i], nb[i], mv8, 32, int(i > 0), ph, W,
                                  decay * (0.5 if i else 1.0), bd)
            for i in range(3)]
    peak = (1 << bd) - 1
    out = tuple(p.round().clamp(0, peak).to(torch.int32).cpu().numpy()
                .astype(cy.dtype) for p in filt)
    return out[0][:th], out[1][:th // 2], out[2][:th // 2]
