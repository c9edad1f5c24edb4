"""Picture-analysis helpers.

Counterpart of ``downsample2x`` of ``svtav1_tpu/ops/metrics.py`` (the
motion search's pyramid); SSIM is not ported yet.
"""

from __future__ import annotations

import torch


def downsample2x(plane):
    """2x decimation by rounded averaging of 2x2 pixels ([..., H, W] ->
    [..., H/2, W/2] int32; EbPictureAnalysisProcess.c:1825)."""
    x = plane.to(torch.int32)
    return (x[..., ::2, ::2] + x[..., ::2, 1::2] + x[..., 1::2, ::2] +
            x[..., 1::2, 1::2] + 2) >> 2
