"""Picture-analysis helpers.

Counterparts of ``svtav1_tpu/ops/metrics.py``: ``downsample2x`` (the
motion search's pyramid, on the device) and ``ssim_plane`` (the CLI's
``--stat-report`` SSIM, numpy on the host).
"""

from __future__ import annotations

import numpy as np
import torch


def downsample2x(plane):
    """2x decimation by rounded averaging of 2x2 pixels ([..., H, W] ->
    [..., H/2, W/2] int32; EbPictureAnalysisProcess.c:1825)."""
    x = plane.to(torch.int32)
    return (x[..., ::2, ::2] + x[..., ::2, 1::2] + x[..., 1::2, ::2] +
            x[..., 1::2, 1::2] + 2) >> 2


def ssim_plane(a, b, peak: int = 255) -> float:
    """Mean SSIM over 8x8 windows stepped by 4 (the reference's aom_ssim2
    grid: EbPsnr.c / aom_dsp ssim.c, k1 = 0.01 and k2 = 0.03 scaled to
    the bit depth's peak); 1.0 for a plane smaller than a window."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    h, w = a.shape
    if h < 8 or w < 8:
        return 1.0
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2

    def win_sums(x):
        # [nh, nw] sums of the 8x8 windows at stride 4, from an integral
        # image
        ii = np.zeros((h + 1, w + 1))
        ii[1:, 1:] = x.cumsum(0).cumsum(1)
        r = np.arange(0, h - 7, 4)
        c = np.arange(0, w - 7, 4)
        return (ii[np.ix_(r + 8, c + 8)] - ii[np.ix_(r, c + 8)] -
                ii[np.ix_(r + 8, c)] + ii[np.ix_(r, c)])

    n = 64.0
    sa, sb = win_sums(a), win_sums(b)
    saa, sbb = win_sums(a * a), win_sums(b * b)
    sab = win_sums(a * b)
    ma, mb = sa / n, sb / n
    va = saa / n - ma * ma
    vb = sbb / n - mb * mb
    cov = sab / n - ma * mb
    ssim = ((2 * ma * mb + c1) * (2 * cov + c2) /
            ((ma * ma + mb * mb + c1) * (va + vb + c2)))
    return float(ssim.mean())
