"""svtav1_tpu_torch — the PyTorch + CUDA port of the AV1 engine in ``svtav1_tpu``.

It runs the encode (8-bit 4:2:0) end to end on an NVIDIA Hopper card: the
low-delay I/P path that is the CLI's default (``VideoEncoder``: key frames,
then P frames with motion estimation, motion compensation and inter
candidates in the partition scan; rate control; on the flat path also the
hierarchical mini-GoP pyramid with temporal filtering), and both intra
paths: the partition
path (64x64 / 32x32 / 16x16 blocks, tx-type search, partition-aware
deblocking with a DLF level search, the in-loop filters CDEF, CCSO and
loop restoration when enabled, the Python tile coder) and the flat path of
presets M11-M13 (32x32 luma / 16x16 chroma blocks, uniform deblocking,
the native tile coder):

- ``ops``     — plain PyTorch counterparts of the normative integer ops
                (intra predictors, transforms, quantizer, deblocking,
                CDEF, CCSO, Wiener and self-guided restoration, motion
                compensation) and the temporal filter.
- ``encoder`` — the two wavefront mode decisions, motion estimation, the
                in-loop filter searches, the tile coder, rate control,
                ``IntraEncoder`` and ``VideoEncoder``.
- ``csrc``    — the hand-written CUDA kernel of the intra wavefront, built
                at first use by ``cuda.build`` and bound by ctypes in
                ``cuda.wavefront_kernel``.
- ``spec``, ``ec``, ``utils``, ``native`` — the host side: normative
                tables and their data files, the native C tile coder
                (built by gcc at first use into ``build/``), OBU and
                container writers.
- ``app``     — the Y4M -> IVF command line.

The JAX package ``svtav1_tpu`` stays the reference: the tests feed the
same inputs to both and compare.  This package imports nothing of it, not
even its JAX-free host modules: it keeps its own copies of those, cut to
what the port's paths use, and imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if a CUDA device is asked for and
    no card is present (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda is not "
                           "available")
    return dev


def upload(a, device) -> torch.Tensor:
    """numpy array -> tensor on `device`.  A CUDA copy goes through pinned
    memory without blocking, so it never synchronises the stream."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:           # e.g. planes read from a file
        a = a.copy()
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
