"""CCSO (Cross-Component Sample Offset), the fork's grafted AV2/AVM tool.

Counterpart of ``svtav1_tpu/ops/ccso.py``; reference EbCcso.c:204-296.
Each filtered pixel takes its co-located luma sample, classifies the two
filter-support neighbour differences into edge classes, buckets the luma
into a band and adds the signalled LUT offset: strided slices of the
extended luma, compares and one table read over the whole plane.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import upload

# (dy, dx) neighbour pair per ext_filter_support (EbCcso.c:204-234)
SAMPLE_POS = [
    ((-1, 0), (1, 0)), ((-1, -1), (1, 1)), ((0, -1), (0, 1)),
    ((1, -1), (-1, 1)), ((0, -3), (0, 3)), ((0, -5), (0, 5)),
]

CCSO_PAD = 5  # luma border needed for the widest support

# quantizer step per signalled quant_idx (EbCcso.c ccso_frame quant_sz)
CCSO_QUANT_SZ = (16, 8, 32, 64)

# signalable per-class offsets (EbEntropyCoding.c:2366 ccso_offset)
CCSO_OFFSETS = (0, 1, -1, 3, -3, 7, -7, -10)

CCSO_UNIT_LOG2 = 8  # 256x256 luma px per on/off flag


def ccso_filter_plane(dst, src_y_ext, offset_lut, *, filter_support: int,
                      quant_step: int, max_band_log2: int, edge_clf: int = 0,
                      bo_only: bool = False, y_uv_scale: int = 0,
                      bit_depth: int = 8):
    """Apply CCSO to a plane.

    dst        [..., h, w] int32 - the plane being corrected (post-CDEF).
    src_y_ext  [..., H+2*PAD, W+2*PAD] int32 - extended luma where
               (H, W) = (h, w) << y_uv_scale.
    offset_lut [128] - (band << 4) + (c0 << 2) + c1 indexed offsets.
    """
    h, w = dst.shape[-2], dst.shape[-1]
    st = 1 << y_uv_scale

    def luma_at(dy, dx):
        r, c = CCSO_PAD + dy, CCSO_PAD + dx
        return src_y_ext[..., r:r + h * st:st, c:c + w * st:st]

    center = luma_at(0, 0)
    if bo_only:
        c0 = c1 = torch.zeros_like(center)
    else:
        cls = []
        for dy, dx in SAMPLE_POS[filter_support]:
            d = luma_at(dy, dx) - center
            if edge_clf == 0:
                c = torch.where(d > quant_step, 2,
                                torch.where(d < -quant_step, 0, 1))
            else:
                c = torch.where(d < -quant_step, 0, 1)
            cls.append(c)
        c0, c1 = cls
    band = torch.zeros_like(center) if max_band_log2 == 0 else \
        center >> (bit_depth - max_band_log2)
    lut = upload(np.asarray(offset_lut, np.int32), dst.device)
    off = lut[(band << 4) + (c0 << 2) + c1]
    return torch.clamp(dst + off, 0, (1 << bit_depth) - 1)


def edge_pad(plane: torch.Tensor, n: int) -> torch.Tensor:
    """[..., H, W] -> [..., H+2n, W+2n] with the edge rows and columns
    replicated (numpy's mode="edge"), by one gather."""
    H, W = plane.shape[-2], plane.shape[-1]
    dev = plane.device
    rows = torch.arange(-n, H + n, device=dev).clamp(0, H - 1)
    cols = torch.arange(-n, W + n, device=dev).clamp(0, W - 1)
    return plane[..., rows[:, None], cols[None, :]]


def ccso_apply_frame(planes, pre_cdef_y, info, bit_depth: int = 8):
    """Whole-frame CCSO apply with per-256x256-luma-unit on/off flags.

    planes      (y, u, v) post-CDEF tensors on one device.
    pre_cdef_y  the post-deblock (pre-CDEF) luma - the classifier input.
    info        {'planes': [None | {'quant_idx', 'support', 'edge_clf',
                 'max_band_log2', 'bo_only', 'lut'[128], 'flags'[uh,uw]}]}.
    """
    ext = edge_pad(pre_cdef_y.to(torch.int32), CCSO_PAD)
    out = []
    for p, plane in enumerate(planes):
        pi = info["planes"][p] if info else None
        if pi is None:
            out.append(plane)
            continue
        sc = 0 if p == 0 else 1
        filt = ccso_filter_plane(
            plane.to(torch.int32), ext, pi["lut"],
            filter_support=int(pi["support"]),
            quant_step=CCSO_QUANT_SZ[int(pi["quant_idx"])],
            max_band_log2=int(pi["max_band_log2"]),
            edge_clf=int(pi["edge_clf"]),
            bo_only=bool(pi.get("bo_only", 0)),
            y_uv_scale=sc, bit_depth=bit_depth)
        u = 1 << (CCSO_UNIT_LOG2 - sc)
        h, w = plane.shape
        m = np.repeat(np.repeat(np.asarray(pi["flags"], bool), u, 0),
                      u, 1)[:h, :w]
        out.append(torch.where(upload(m, plane.device), filt,
                               plane.to(torch.int32)).to(plane.dtype))
    return tuple(out)
