"""svtav1_tpu_torch — the PyTorch + CUDA port of the AV1 engine in ``svtav1_tpu``.

It runs the encode (8- and 10-bit 4:2:0) and the decode end to end on an
NVIDIA Hopper card.  The encode: the low-delay I/P path that is the CLI's
default (``VideoEncoder``: key frames, then P frames with motion estimation,
motion compensation and inter candidates in the partition scan; rate
control; on the flat path also the hierarchical mini-GoP pyramid with
temporal filtering), and both intra paths: the partition path (64x64 /
32x32 / 16x16 blocks, tx-type search, partition-aware deblocking with a
DLF level search, the in-loop filters CDEF, CCSO and loop restoration when
enabled, the Python tile coder) and the flat path of presets M11-M13
(32x32 luma / 16x16 chroma blocks, uniform deblocking, the native tile
coder); tile columns on every partition path.  The decode (``Decoder``,
``dec_app``): every
stream the JAX package's decoder reads (key and inter frames, compound
LAST+ALTREF, tile columns, 8- and 10-bit, the in-loop filters,
show_existing overlays, film grain on the output, metadata OBUs), parsed
on the host and reconstructed and filtered on the card:

- ``ops``     — plain PyTorch counterparts of the normative integer ops
                (intra predictors, transforms, quantizer, deblocking,
                CDEF, CCSO, Wiener and self-guided restoration, motion
                compensation) and the temporal filter.
- ``encoder`` — the two wavefront mode decisions, motion estimation, the
                in-loop filter searches, the tile coder, rate control,
                ``IntraEncoder`` and ``VideoEncoder``.
- ``decoder`` — ``Decoder``: OBU and tile parse on the host, batched
                residuals and motion compensation, the serial intra
                pass and the frame filters on the device.
- ``csrc``    — the hand-written CUDA kernel of the intra wavefront, built
                at first use by ``cuda.build`` and bound by ctypes in
                ``cuda.wavefront_kernel``.
- ``spec``, ``ec``, ``utils``, ``native`` — the host side: normative
                tables and their data files, the symbol writers and
                readers, the native C tile coder and coefficient reader
                (built by gcc at first use into ``build/``), OBU,
                metadata and container writers and readers.
- ``parallel``— ``mesh``: GOPs and tile columns spread over a list of
                devices, the counterpart of the JAX package's mesh.
- ``app``     — the Y4M -> IVF command line; ``dec_app`` IVF -> Y4M.

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
    memory without blocking, so it never synchronises the stream.  uint16
    (10-bit planes) arrives as int32: torch has no arithmetic on uint16."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    if not a.flags.writeable:           # e.g. planes read from a file
        a = a.copy()
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def pix_dtype(bd: int) -> torch.dtype:
    """The tensor dtype of bd-bit pixels: uint8 at 8 bits, int16 at 10
    (torch has no arithmetic on uint16; the values are the same)."""
    return torch.uint8 if bd == 8 else torch.int16


def host_pixels(t: torch.Tensor, bd: int) -> np.ndarray:
    """A pixel tensor (any integer dtype) on the host as numpy uint8
    (8-bit) or uint16 (10-bit), the JAX package's recon dtypes."""
    a = t.to(pix_dtype(bd)).cpu().numpy()
    return a if bd == 8 else a.view(np.uint16)


def __getattr__(name):
    """``Decoder`` and ``DecodeError`` of ``decoder.decoder``, imported on
    first use (the encoder's imports do not load the decoder)."""
    if name in ("Decoder", "DecodeError"):
        from .decoder import decoder
        return getattr(decoder, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
