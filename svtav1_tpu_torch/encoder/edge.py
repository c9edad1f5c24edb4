"""The flat path's edge strip: the bottom SB row of a frame whose height
leaves m = 12 valid mi rows there (height % 64 == 48, e.g. 2160).

There the spec lets no 32x32 block of the bottom 32-row be coded whole
(§5.11.4: hasRows is false at +8 mi), so that row is coded as SPLIT into
16x16 luma blocks (TX_16X16, DCT_DCT) with 8x8 chroma (TX_8X8, the
uv_mode's implied tx type), of which only the top two of each 32x32 lie
in the frame; the +12 mi children start below it and are not coded.  The
top-left 32x32 block of every SB of that row reads its below-left edge
from the strip of the SB to its left, so the whole bottom SB row is one
chain in coding order: per SB the top-left and top-right 32x32 (16x16
chroma) blocks, then the four in-frame strip blocks left to right.  The
plane wavefront codes every SB row above it (``wavefront_cuda`` at this
valid_h; the plain body codes the whole plane and this chain overwrites
its bottom SB row), and ``encode_edge`` codes the chain: the plain
PyTorch body below for a tensor on the CPU, the hand-written kernel
``wf_edge_kernel`` (``csrc/wf_edge.cu``) on a CUDA device.  The
candidates, the RD cost and the first-minimum rule are the plane
wavefront's.

In the plane outputs the chain writes the bottom SB row whole: the top
32x32 blocks' modes, levels and recon, the strip's recon, zeros for the
split blocks' mode and levels and for the recon rows below the frame.  The
strip's own modes and levels come back as two more arrays.
"""

from __future__ import annotations

import torch

from ..spec.txfm import TX_8X8, TX_16X16, TX_32X32
from .wavefront import (_resid_bits, _tx_types, chain, expand_candidates,
                        intra_preds, rd_params)

SB = 64
_TX_OF = {32: TX_32X32, 16: TX_16X16, 8: TX_8X8}


def edge_blocks(w: int, big: int) -> list:
    """The bottom SB row's chain in coding order for a plane of width w
    whose SB is 2 * big wide (big = 32 luma, 16 chroma): (dy, x, n,
    has_tr, has_bl, out), dy from the SB row's top, out the block column
    of a top big block or -1 - k for strip block k.  §7.11.2 edges, where
    the above (left) edge exists: the above-right of every strip block but
    the SB's last lies in the 32-row above it, and no strip block has its
    below-left coded."""
    s = big // 2
    out = []
    for k in range(w // (2 * big)):
        x = 2 * big * k
        out += [(0, x, big, True, x > 0, 2 * k),
                (0, x + big, big, x + 2 * big < w, False, 2 * k + 1)]
        out += [(big, x + j * s, s, j < 3, False, -1 - (4 * k + j))
                for j in range(4)]
    return out


def strip_count(w: int, big: int) -> int:
    """Strip blocks of a plane of width w: two per big block."""
    return 2 * (w // big)


def encode_edge(src, mode_idx, levels, recon, big: int, qindex: int,
                modes, bd: int = 8, angle_deltas=(0,), valid_h: int = None,
                paired: bool = False, uv_tx: bool = False):
    """Code the bottom SB row of src [B, h, w] (h a multiple of 2 * big)
    into the plane wavefront's outputs (mode_idx [B, bh, bw], levels [B,
    bh, bw, big, big], recon [B, h, w], written in place) after every SB
    row above it; valid_h leaves m = 12.  Returns the strip's (mode_idx
    [B, n], levels [B, n, big/2, big/2]) int32, n = strip_count(w, big).
    paired / uv_tx as encode_plane_wavefront's (the chroma call)."""
    cands = expand_candidates(modes, angle_deltas)
    rd = rd_params(qindex, bd, cands, kf="uv" if paired else True)
    if src.device.type == "cpu":
        return _edge_body(src, rd, mode_idx, levels, recon, big, cands, bd,
                          valid_h, paired, uv_tx)
    from ..cuda.edge_kernel import edge_cuda
    return edge_cuda(src, rd, mode_idx, levels, recon, big, cands, bd,
                     valid_h, paired, uv_tx)


def _edge(recon, y: int, x: int, n: int, has_tr: bool, has_bl: bool,
          vh: int, base: int):
    """§7.11.2 edges of the block (y, x) of size n of every plane of recon
    [B, h, w], read from the recon itself: above, left [B, n], corner
    [B], above_ext, left_ext [B, 2n]; left rows clamp at vh - 1."""
    B, h, w = recon.shape
    dev = recon.device
    ar = torch.arange(n, device=dev)
    ha, hl = y > 0, x > 0
    ym1, xm1 = max(y - 1, 0), max(x - 1, 0)
    above_r = recon[:, ym1, x:x + n]
    left_r = recon[:, (y + ar).clamp(max=vh - 1), xm1]
    if ha:
        above = above_r
    else:
        above = (left_r[:, :1] if hl else torch.full_like(above_r, base - 1)
                 ).expand(B, n)
    if hl:
        left = left_r
    else:
        left = (above_r[:, :1] if ha else torch.full_like(left_r, base + 1)
                ).expand(B, n)
    corner = (recon[:, ym1, xm1] if ha and hl else above_r[:, 0] if ha
              else left_r[:, 0] if hl else torch.full_like(above_r[:, 0],
                                                           base))
    xt = min(x + n, w - n)
    tr = (recon[:, ym1, xt:xt + n] if has_tr and ha
          else above[:, -1:].expand(B, n))
    yb = min(y + n, h - n)
    bl = (recon[:, (yb + ar).clamp(max=vh - 1), xm1] if has_bl and hl
          else left[:, -1:].expand(B, n))
    return (above, left, corner, torch.cat([above, tr], -1),
            torch.cat([left, bl], -1))


def _edge_body(src, rd, mode_idx, levels, recon, big: int, cands, bd: int,
               valid_h, paired: bool, uv_tx: bool):
    """Plain PyTorch chain; the contract of encode_edge (rd: rd_params)."""
    dqdc, dqac, lam, mode_rate = rd
    B, h, w = src.shape
    vh = h if valid_h is None else valid_h
    dev = src.device
    base = 1 << (bd - 1)
    s = big // 2
    y0 = h - 2 * big
    bh = h // big
    n_strip = strip_count(w, big)
    e_mi = torch.zeros((B, n_strip), dtype=torch.int32, device=dev)
    e_lev = torch.zeros((B, n_strip, s, s), dtype=torch.int32, device=dev)
    rate = mode_rate.to(dev)[:, None].expand(-1, B)
    lam = float(lam)
    types = {n: _tx_types(cands, _TX_OF[n], uv_tx) for n in (big, s)}
    srci = src.to(torch.int32)
    mode_idx[:, bh - 1] = 0
    levels[:, bh - 1] = 0
    recon[:, y0:] = 0
    one = torch.ones((B, 1, 1), dtype=torch.bool, device=dev)
    for dy, x, n, has_tr, has_bl, out in edge_blocks(w, big):
        y = y0 + dy
        above, left, corner, above_ext, left_ext = _edge(
            recon, y, x, n, has_tr, has_bl, vh, base)
        preds = intra_preds(cands, above, left, corner, above_ext, left_ext,
                            one & (y > 0), one & (x > 0), n, bd)
        lev, recb, sse = chain(srci[:, y:y + n, x:x + n], torch.stack(preds),
                               types[n], _TX_OF[n], dqdc, dqac, bd)
        cost = sse + lam * (rate + _resid_bits(lev, n))      # [C, B]
        if paired:
            best = torch.argmin(cost.reshape(len(cands), 2, B // 2).sum(1),
                                0).repeat(2)
        else:
            best = torch.argmin(cost, 0)                      # first minimum
        lanes = torch.arange(B, device=dev)
        best_lev, best_rec = lev[best, lanes], recb[best, lanes]
        recon[:, y:y + n, x:x + n] = best_rec
        if out >= 0:
            mode_idx[:, bh - 2, out] = best.to(torch.int32)
            levels[:, bh - 2, out] = best_lev
        else:
            e_mi[:, -1 - out] = best.to(torch.int32)
            e_lev[:, -1 - out] = best_lev
    recon[:, vh:] = 0
    return e_mi, e_lev

