"""Batched inter prediction (motion compensation), spec §7.11.3.

Counterpart of the batched predictors of ``svtav1_tpu/ops/mc.py``, single
reference and COMPOUND_AVERAGE (reference: svt_make_inter_predictor,
EbDecInterPrediction.c:418-520): the
mv is scaled to 1/16-plane-pel (q4) and clamped to the UMV border
(dec_clamp_mv_to_umv_border_sb), its integer part selects the reference
window and its 4-bit phase the 8-tap kernel, per block.  Out-of-frame
reads replicate edge pixels: windows are gathered from an edge-padded
plane, their indices clamped to it, so an mv of any size reads inside
the plane.

Integer semantics follow XLA's int32: ``>> 4`` on a negative q4 is an
arithmetic shift and ``& 15`` a two's-complement mask (torch's int64 ops
give the same values), and every filter sum fits in int32.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import upload
from .convolve import FILTER_BITS, ROUND0, ROUND1, kernels

MV_PRED_PAD = 48      # padded-plane margin covering the UMV clamp range


def pad_plane(plane, pad: int = MV_PRED_PAD):
    """Edge-replicate padding ([..., H, W] -> [..., H+2p, W+2p]), the
    normative out-of-frame extension."""
    H, W = plane.shape[-2:]
    dev = plane.device
    rows = (torch.arange(-pad, H + pad, device=dev)).clamp(0, H - 1)
    cols = (torch.arange(-pad, W + pad, device=dev)).clamp(0, W - 1)
    return plane[..., rows[:, None], cols[None, :]]


@lru_cache(maxsize=None)
def _kern_t(filt: int, device: str) -> torch.Tensor:
    return upload(kernels(filt), device)


def kernel_table(filt: int, like: torch.Tensor) -> torch.Tensor:
    """[16, 8] int32 kernels of filter type filt on like's device (one
    upload per device)."""
    return _kern_t(filt, str(like.device))


def _dyn_tap(x, kern, axis: int):
    """8-tap filter along axis (-1 or -2) with per-item kernels kern
    [..., 8] broadcast over the two trailing spatial dims of x."""
    n = x.shape[axis] - 7
    out = None
    for k in range(8):
        xs = x[..., k:k + n] if axis == -1 else x[..., k:k + n, :]
        term = kern[..., k, None, None] * xs
        out = term if out is None else out + term
    return out


def interp_block_dyn(windows, kx, ky, bd: int = 8):
    """Normative 2D subpel filter with per-block kernels: windows [...,
    bs+7, bs+7] int32, kx/ky [..., 8] -> [..., bs, bs] int32."""
    x = windows.to(torch.int32)
    hsum = _dyn_tap(x, kx, -1) + (1 << (bd + FILTER_BITS - 1))
    im = (hsum + (1 << (ROUND0 - 1))) >> ROUND0
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    vsum = _dyn_tap(im, ky, -2) + (1 << offset_bits)
    res = ((vsum + (1 << (ROUND1 - 1))) >> ROUND1) - \
        ((1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1)))
    return res.clamp(0, (1 << bd) - 1)


def _mc_window(ref_padded, y0, x0, mv8, frame_h: int, frame_w: int,
               bs: int, ss: int, kern):
    """The UMV clamp and window gather of predict_inter_blocks: (win [B, N,
    bs+7, bs+7], kx, ky)."""
    y0, x0 = y0.long(), x0.long()
    mv8 = mv8.long()
    bs_l = bs << ss                                      # luma-scale size
    ly0, lx0 = y0 << ss, x0 << ss
    q4r = mv8[..., 0] * (1 << (1 - ss))                  # 1/16-plane-pel
    q4c = mv8[..., 1] * (1 << (1 - ss))
    spel = (4 + bs) << 4
    mb_to_left = -(lx0 * 8) * (1 << (1 - ss))
    mb_to_right = ((frame_w - bs_l - lx0) * 8) * (1 << (1 - ss))
    mb_to_top = -(ly0 * 8) * (1 << (1 - ss))
    mb_to_bottom = ((frame_h - bs_l - ly0) * 8) * (1 << (1 - ss))
    q4c = torch.minimum(torch.maximum(q4c, mb_to_left - spel),
                        mb_to_right + spel - 16)
    q4r = torch.minimum(torch.maximum(q4r, mb_to_top - spel),
                        mb_to_bottom + spel - 16)

    iy = y0 + (q4r >> 4)                                 # window start - 3
    ix = x0 + (q4c >> 4)
    ky = kern[q4r & 15]                                  # [B, N, 8]
    kx = kern[q4c & 15]
    B = ref_padded.shape[0]
    ar = torch.arange(bs + 7, device=ref_padded.device)
    rows = (iy[..., None] + (MV_PRED_PAD - 3) + ar).clamp(
        0, ref_padded.shape[-2] - 1)
    cols = (ix[..., None] + (MV_PRED_PAD - 3) + ar).clamp(
        0, ref_padded.shape[-1] - 1)
    bi = torch.arange(B, device=ref_padded.device)[:, None, None, None]
    win = ref_padded[bi, rows[:, :, :, None], cols[:, :, None, :]]
    return win, kx, ky


COMPOUND_ROUND1 = 7     # convolve.h COMPOUND_ROUND1_BITS


def interp_block_dyn_mid(windows, kx, ky, bd: int = 8):
    """Compound intermediate: the 2D filter result before the final
    compound rounding (ConvBufType res of svt_av1_jnt_convolve_2d_c,
    EbInterPrediction.c:503; round_0 = 3, round_1 = COMPOUND_ROUND1)."""
    x = windows.to(torch.int32)
    hsum = _dyn_tap(x, kx, -1) + (1 << (bd + FILTER_BITS - 1))
    im = (hsum + (1 << (ROUND0 - 1))) >> ROUND0
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    vsum = _dyn_tap(im, ky, -2) + (1 << offset_bits)
    return (vsum + (1 << (COMPOUND_ROUND1 - 1))) >> COMPOUND_ROUND1


def compound_average(res0, res1, bd: int = 8):
    """COMPOUND_AVERAGE combine of two intermediates (the do_average path
    of svt_av1_jnt_convolve_2d_c without jnt weights)."""
    offset_bits = bd + 2 * FILTER_BITS - ROUND0
    round_offset = ((1 << (offset_bits - COMPOUND_ROUND1)) +
                    (1 << (offset_bits - COMPOUND_ROUND1 - 1)))
    round_bits = 2 * FILTER_BITS - ROUND0 - COMPOUND_ROUND1
    tmp = ((res0 + res1) >> 1) - round_offset
    out = (tmp + (1 << (round_bits - 1))) >> round_bits
    return out.clamp(0, (1 << bd) - 1)


def predict_inter_blocks(ref_padded, y0, x0, mv8, frame_h: int, frame_w: int,
                         bs: int, ss: int = 0, bd: int = 8, filt: int = 0):
    """Motion-compensated prediction of a batch of blocks.

    ref_padded [B, H/2^ss + 2*MV_PRED_PAD, W/2^ss + 2*MV_PRED_PAD] int32,
    the edge-padded reference plane; y0/x0 [B, N] plane-coordinate block
    origins; mv8 [B, N, 2] luma 1/8-pel mvs; frame_h/frame_w the true
    luma dims (the UMV clamp's).  Returns [B, N, bs, bs] int32."""
    win, kx, ky = _mc_window(ref_padded, y0, x0, mv8, frame_h, frame_w, bs,
                             ss, kernel_table(filt, ref_padded))
    return interp_block_dyn(win, kx, ky, bd)


def predict_inter_blocks_compound(ref0p, ref1p, y0, x0, mv8a, mv8b,
                                  frame_h: int, frame_w: int, bs: int,
                                  ss: int = 0, bd: int = 8, filt: int = 0):
    """COMPOUND_AVERAGE prediction of a batch of blocks from two padded
    references (normative intermediate precision, the jnt convolve path
    of EbInterPrediction.c); arguments as predict_inter_blocks, mv8a
    into ref0p and mv8b into ref1p."""
    kern = kernel_table(filt, ref0p)
    w0, kx0, ky0 = _mc_window(ref0p, y0, x0, mv8a, frame_h, frame_w, bs,
                              ss, kern)
    w1, kx1, ky1 = _mc_window(ref1p, y0, x0, mv8b, frame_h, frame_w, bs,
                              ss, kern)
    return compound_average(interp_block_dyn_mid(w0, kx0, ky0, bd),
                            interp_block_dyn_mid(w1, kx1, ky1, bd), bd)
