"""Multi-device encode: the counterpart of ``svtav1_tpu/parallel/mesh.py``
over a list of torch devices in place of a JAX ``Mesh``.

The reference scales with threads over pictures, segments and tiles; here
  - GOPs (key-aligned chunks) encode on their own devices, each on a host
    thread (``sharded_video_encode_bytes``);
  - tile columns encode their scans on their own devices
    (``sharded_tile_encode_bytes``, through ``IntraEncoder.tile_devices``);
  - the toy steps (``sharded_encode_step``, ``sharded_pipeline_step``)
    split frames over the "data" axis and superblock rows over the "tile"
    axis.
A device list of n entries with ``tile_parallel`` t reads as the JAX
mesh's (n / t) x t grid, row-major.  Where the JAX module sums over the
mesh with ``psum``, these functions sum the per-device partial values on
the host.  A list may repeat a device (two chunks on one card).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from .. import resolve_device


def make_mesh(n_devices: int | None = None, tile_parallel: int = 1) -> list:
    """The first n_devices (default all) CUDA devices, as a list; raises
    if more are requested than exist, or tile_parallel does not divide
    them."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_devices or len(devs)
    if n > len(devs) or n < 1:
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % tile_parallel:
        raise ValueError(f"tile_parallel {tile_parallel} does not divide "
                         f"{n} devices")
    return devs[:n]


def _grid(mesh, tile_parallel: int):
    """The mesh's devices as a (data, tile) grid of rows."""
    devs = [resolve_device(d) for d in mesh]
    if len(devs) % tile_parallel:
        raise ValueError(f"tile_parallel {tile_parallel} does not divide "
                         f"{len(devs)} devices")
    return [devs[i:i + tile_parallel]
            for i in range(0, len(devs), tile_parallel)]


def _on(dev):
    """Make dev the thread's current device (a CUDA one)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def sharded_encode_step(mesh, tile_parallel: int = 1, shard: bool = True):
    """One step of the encode pipeline over the mesh: frame d of a seeded
    [data, 64 * tile, 128] batch encodes (the flat luma wavefront, 32x32
    blocks, q100; on a CUDA device the hand-written kernel) on row d's
    first device, and each device takes its superblock rows of its row's
    frame for a picture analysis (the 64x64 blocks' variances), whose
    per-device sums the host adds up (the JAX module's psum, the stand-in
    for the per-GOP rate-control reduction).  shard=False runs the same
    batch in one call on the mesh's first device.  Returns (recon [data,
    H, W] on the mesh's first device, the total)."""
    from ..encoder.wavefront import encode_plane_wavefront
    from ..spec.txfm import TX_32X32

    grid = _grid(mesh, tile_parallel)
    ndata, ntile = len(grid), tile_parallel
    B, H, W = ndata, 64 * ntile, 128
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (B, H, W)).astype(np.uint8)

    if not shard:
        dev = grid[0][0]
        with _on(dev):
            _, _, recon = encode_plane_wavefront(
                torch.from_numpy(src).to(dev), 32, TX_32X32, 100)
            var = torch.var(torch.from_numpy(src).to(dev).to(
                torch.float32).reshape(B, H // 64, 64, W // 64, 64),
                dim=(2, 4), correction=0)
        return recon, float(var.sum())

    # picture-parallel intra encode (no cross-device dependency)
    recons = []
    for d, row in enumerate(grid):
        with _on(row[0]):
            _, _, rec = encode_plane_wavefront(
                torch.from_numpy(src[d:d + 1]).to(row[0]), 32, TX_32X32, 100)
        recons.append(rec)
    recon = torch.cat([r.to(grid[0][0]) for r in recons])

    # superblock-row analysis: each device's shard, summed on the host
    blocks = src.reshape(B, H // 64, 64, W // 64, 64).transpose(0, 1, 3, 2, 4)
    partial = []
    for d, row in enumerate(grid):
        for t, dev in enumerate(row):
            part = torch.from_numpy(np.ascontiguousarray(
                blocks[d, t:t + 1])).to(dev)
            var = torch.var(part.to(torch.float32), dim=(-1, -2),
                            correction=0)
            partial.append(float(var.sum()))
    return recon, float(np.sum(partial, dtype=np.float64))


def sharded_pipeline_step(mesh, tile_parallel: int = 1,
                          shard: bool = True):
    """The transform, quantizer and reconstruction stage over the mesh:
    seeded [data, 2 * tile, 2, 32, 32] residual blocks, frames split over
    the data axis and block rows over the tile axis; each device runs the
    forward DCT, quantization at q100, dequantization and the inverse DCT
    of its shard, and the host adds up the shards' sum |levels| (the JAX
    module's psum).  shard=False runs every block in one call on the
    mesh's first device.  Returns (recon on the mesh's first device,
    bits)."""
    from ..ops.quant import dequantize_dq, quantize_dq
    from ..ops.transforms import fwd_txfm2d, inv_txfm2d
    from ..spec import tables as tbl
    from ..spec.txfm import DCT_DCT, TX_32X32

    grid = _grid(mesh, tile_parallel)
    n_frames, rows, cols = len(grid), 2 * tile_parallel, 2
    rng = np.random.RandomState(0)
    blocks = rng.randint(-255, 256,
                         (n_frames, rows, cols, 32, 32)).astype(np.int32)
    dc, ac = tbl.qindex_to_dq(100, 8)

    def step(x):
        q = quantize_dq(fwd_txfm2d(x, TX_32X32, DCT_DCT), TX_32X32, dc, ac)
        return (inv_txfm2d(dequantize_dq(q, TX_32X32, dc, ac), TX_32X32,
                           DCT_DCT), int(q.abs().sum()))

    if not shard:
        return step(torch.from_numpy(blocks).to(grid[0][0]))
    out = [[None] * tile_parallel for _ in grid]
    bits = 0
    for d, row in enumerate(grid):
        for t, dev in enumerate(row):
            out[d][t], b = step(torch.from_numpy(np.ascontiguousarray(
                blocks[d, 2 * t:2 * t + 2])).to(dev))
            bits += b
    first = grid[0][0]
    recon = torch.stack([torch.cat([r.to(first) for r in row])
                         for row in out])
    return recon, bits


def _cert_clip(w, h, n, seed=0):
    """The JAX module's clip: a moving sine pattern with noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = np.clip(110 + 70 * np.sin((xx + 2.5 * t) / 19.0) +
                    50 * np.cos((yy + 1.5 * t) / 13.0) +
                    rng.randint(-3, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(120 + 40 * np.sin((xx[::2, ::2] + t) / 23.0),
                    0, 255).astype(np.uint8)
        v = np.clip(135 + 35 * np.cos((yy[::2, ::2] + 0.5 * t) / 27.0),
                    0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _preload(devs):
    """Load what loads lazily and not thread-safely before the threads:
    the native coders (gcc at first use) and, for a card, the kernel's
    library (nvcc at first use)."""
    from ..ec import native
    native._load()
    if any(d.type == "cuda" for d in devs):
        from ..cuda import wavefront_kernel
        wavefront_kernel._lib()


def sharded_video_encode_bytes(mesh, shard: bool = True, w: int = 64,
                               h: int = 64, keyint: int = 3,
                               n_gops: int = 2, pyramid: bool = False,
                               part_search: bool = False) -> bytes:
    """GOP-parallel encode: key-aligned chunks of a keyint * n_gops clip
    are independent (a key frame resets the CDF chain and the DPB), so
    chunk g encodes on mesh[g % n] on its own host thread, every chunk
    after the first without a sequence header.  (The JAX module's psum of
    the chunks' bits, its rate-control aggregation, only checks itself
    against the host's sum, so nothing stands in for it here.)  The
    chunks' concatenation must equal, byte for byte, what one encoder
    writes for the whole clip on the mesh's first device (shard=False
    returns that)."""
    from ..encoder.intra_encoder import EncoderConfig
    from ..encoder.video_encoder import VideoEncoder

    devs = [resolve_device(d) for d in mesh]
    frames = _cert_clip(w, h, keyint * n_gops)
    cfg = EncoderConfig(w, h, qindex=110, part_search=part_search)
    _preload(devs)

    def encode(enc, chunk):
        ps, _ = enc.encode_frames(chunk)
        p2, _ = enc.flush()
        return b"".join(ps) + b"".join(p2)

    if not shard:
        return encode(VideoEncoder(cfg, keyint=keyint, pyramid=pyramid,
                                   gop=keyint, device=devs[0]), frames)

    chunks = [frames[i * keyint:(i + 1) * keyint] for i in range(n_gops)]
    assign = [devs[i % len(devs)] for i in range(n_gops)]
    encs = []
    for gi, dev in enumerate(assign):
        enc = VideoEncoder(cfg, keyint=keyint, pyramid=pyramid, gop=keyint,
                           device=dev)
        if gi > 0:
            enc.mark_continuation()      # one sequence header, the first
        encs.append(enc)

    def run(gi):
        with _on(assign[gi]):
            return encode(encs[gi], chunks[gi])

    with ThreadPoolExecutor(max_workers=n_gops) as ex:
        outs = list(ex.map(run, range(n_gops)))
    return b"".join(outs)


def sharded_tile_encode_bytes(mesh, n_tiles: int = None,
                              shard: bool = True) -> bytes:
    """One key frame of n_tiles (default the mesh's size) 64-px tile
    columns, 64 rows, its tile t's scans on mesh[t % n] (shard; each
    device's on a host thread) or all on the mesh's first device: the
    frame's payload, which must not change by a bit between the two (tile
    columns code independently)."""
    from ..encoder.intra_encoder import EncoderConfig, IntraEncoder

    devs = [resolve_device(d) for d in mesh]
    n_tiles = n_tiles or len(devs)
    w, h = 64 * n_tiles, 64
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(120 + 70 * np.sin((xx + yy) / 9.0) +
                rng.randint(-25, 26, (h, w)), 0, 255).astype(np.uint8)
    u = np.clip(120 + 30 * np.sin(xx[::2, ::2] / 30.0), 0,
                255).astype(np.uint8)
    v = np.clip(130 + 30 * np.cos(yy[::2, ::2] / 20.0), 0,
                255).astype(np.uint8)
    enc = IntraEncoder(EncoderConfig(w, h, qindex=100, tile_cols=n_tiles),
                       device=devs[0])
    if shard:
        enc.tile_devices = devs
    with _on(devs[0]):
        payloads, _ = enc.encode_frames([(y, u, v)])
    return payloads[0]
