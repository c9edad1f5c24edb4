"""Tile entropy coder of the flat P frame: every 64x64 SB split into four
32x32 blocks, each PARTITION_NONE, one TX_32X32 luma and two TX_16X16
chroma transform blocks.

Counterpart of ``svtav1_tpu/encoder/tile_inter.py`` (``encode_inter_tile``).
That flat walk is the partition coder's walk with every SB split and every
32x32 block left whole, so this drives ``tile_codec.TileCoder``'s inter
branch (is_inter, the LAST reference, the mode against the block's MV
stack, the DRL index and mv residual, the inter frame's y_mode CDF, DC
chroma, the coefficient writer) with those maps: one coder for both paths.
Pure Python over numpy: it runs on the host.
"""

from __future__ import annotations

import numpy as np

from .tile_codec import TileCoder


def encode_inter_tile(width: int, height: int, qindex: int, cdf_update: bool,
                      y_cand, y_lev, u_lev, v_lev, mv8, cands, n_intra: int,
                      cdf_init=None, true_h: int = None, gm_mv=(0, 0),
                      mode_counts: dict = None):
    """y_cand [bh, bw] candidate indices: < n_intra the intra candidate
    cands[idx] (chroma DC), n_intra NEWMV at mv8 [bh, bw, 2] (1/8 pel),
    past it GLOBALMV at gm_mv; each inter mv is coded against the block's
    MV stack (NEARESTMV / NEARMV / GLOBALMV when it equals that
    predictor).  y_lev [bh, bw, 32, 32], u_lev / v_lev [bh, bw, 16, 16].
    cdf_init: the primary reference frame's CDF snapshot (None: the
    default tables at qindex); true_h: the signalled height when `height`
    is the SB-padded plane height.  mode_counts, when given, gains the
    inter modes coded.  Returns (tile bytes, the frame-end CdfContext)."""
    if len(cands) != n_intra:
        raise ValueError(f"{len(cands)} intra candidates, n_intra {n_intra}")
    y_cand = np.asarray(y_cand)
    bh, bw = y_cand.shape
    sbh, sbw = -(-bh // 2), bw // 2
    mv = np.where((y_cand == n_intra)[..., None], np.asarray(mv8),
                  np.asarray(gm_mv, np.int32))
    tc = TileCoder(width, height, qindex, cdf_update, true_h=true_h,
                   kf=False, cdf_init=cdf_init, gm_mv=gm_mv)
    # the flat grid as a partition tree: SBs split, 32x32 blocks NONE; the
    # 16x16 and 64x64 maps are never read
    none = np.zeros((bh, bw), np.int32)
    sub = np.zeros((bh, bw, 4), np.int32)
    sb = np.zeros((sbh, sbw), np.int32)
    tile, cdf = tc.encode(none, y_cand, y_lev, u_lev, v_lev, sub, None, None,
                          None, tuple(cands), (), sub, np.ones_like(sb), sb,
                          None, None, None, none, sub, sb, mv_top=mv)
    if mode_counts is not None:
        for k, v in tc.mode_counts.items():
            mode_counts[k] = mode_counts.get(k, 0) + v
    return tile, cdf
