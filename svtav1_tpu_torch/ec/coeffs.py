"""Coefficient (transform block) entropy coding, spec §5.11.39/§8.3.2.

Copy of ``svtav1_tpu/ec/coeffs.py`` (reference writer
EbEntropyCoding.c:485-617 av1_write_coeffs_txb_1d, reader
EbDecParseBlock.c parse_coeffs, contexts
EbCoefficients.h:2860-2955, EbCommonUtils.h:126-160).  Context maps are
computed with numpy over the whole block; only the symbol emission is
serial.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..spec import tables as tbl
from . import native

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2

# tx_type → class (EbCabacContextModel.h:459)
TX_TYPE_TO_CLASS = [TX_CLASS_2D] * 10 + [
    TX_CLASS_VERT, TX_CLASS_HORIZ,   # V_DCT, H_DCT
    TX_CLASS_VERT, TX_CLASS_HORIZ,   # V_ADST, H_ADST
    TX_CLASS_VERT, TX_CLASS_HORIZ,   # V_FLIPADST, H_FLIPADST
]

NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = (1 << COEFF_CONTEXT_BITS) - 1

K_EOB_GROUP_START = [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513]
K_EOB_OFFSET_BITS = [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]

# SIG_COEF_CONTEXTS_2D = 26; 1D offsets {26, 31, 36} (EbCoefficients.h:46)
_NZ_CTX_1D = np.array([26, 31] + [36] * 30, np.int32)

# tx-type ↔ coded-symbol maps per ext-tx *set type*
# (EbCabacContextModel.h:687-704 av1_ext_tx_ind / av1_ext_tx_inv)
EXT_TX_IND = [
    [0] * 16,
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 3, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6],
]
EXT_TX_INV = [
    [0] * 16,
    [9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 10, 11, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8, 0, 0, 0, 0],
    [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8],
]
# which tx types each set type admits (first nsyms entries of INV)
EXT_TX_MEMBERS = [set(inv[:n]) for inv, n in
                  zip(EXT_TX_INV, (1, 2, 5, 7, 12, 16))]


def eob_pos_token(eob: int):
    """(eob_pt, eob_extra) — EbEntropyCoding.c:299-312."""
    if eob <= 0:
        raise ValueError
    t = 0
    while t < 11 and eob >= K_EOB_GROUP_START[t + 1]:
        t += 1
    return t, eob - K_EOB_GROUP_START[t]


def _padded_levels(levels2d: np.ndarray) -> np.ndarray:
    """uint8 |level| clamped to 127, padded 4 right + 4 below with zeros."""
    h, w = levels2d.shape
    out = np.zeros((h + 4, w + 4), np.uint8)
    out[:h, :w] = np.minimum(np.abs(levels2d), 127).astype(np.uint8)
    return out


def base_ctx_map(levels2d, tx_size: int, tx_class: int) -> np.ndarray:
    """coeff_base context for every position [h, w] (get_nz_map_ctx)."""
    h, w = levels2d.shape
    pad = _padded_levels(levels2d)
    c3 = np.minimum(pad.astype(np.int32), 3)
    lv = pad.astype(np.int32)

    # neighbor magnitude sums for every position, vectorized
    if tx_class == TX_CLASS_2D:
        mag = (c3[0:h, 1:w + 1] + c3[1:h + 1, 0:w] + c3[1:h + 1, 1:w + 1] +
               c3[0:h, 2:w + 2] + c3[2:h + 2, 0:w])
    elif tx_class == TX_CLASS_VERT:
        mag = (c3[0:h, 1:w + 1] + c3[1:h + 1, 0:w] + c3[2:h + 2, 0:w] +
               c3[3:h + 3, 0:w] + c3[4:h + 4, 0:w])
    else:
        mag = (c3[0:h, 1:w + 1] + c3[1:h + 1, 0:w] + c3[0:h, 2:w + 2] +
               c3[0:h, 3:w + 3] + c3[0:h, 4:w + 4])
    ctx = np.minimum((mag + 1) >> 1, 4)

    rows, cols = np.mgrid[0:h, 0:w]
    if tx_class == TX_CLASS_2D:
        off = np.full((h, w), 21, np.int32)
        off[rows + cols < 4] = 6
        off[rows + cols < 2] = 1
        if w < h:
            off[rows < 2] = 11
        elif w > h:
            off[:, :2] = 16
        base_ctx = ctx + off
        base_ctx[0, 0] = 0
    elif tx_class == TX_CLASS_VERT:
        base_ctx = ctx + _NZ_CTX_1D[rows]
    else:
        base_ctx = ctx + _NZ_CTX_1D[cols]

    return base_ctx


def eob_pos_ctx(scan_idx: int, n_pels: int) -> int:
    """coeff_base_eob context for the eob-1 scan index {0..3}."""
    if scan_idx == 0:
        return 0
    if scan_idx <= n_pels // 8:
        return 1
    if scan_idx <= n_pels // 4:
        return 2
    return 3


def nz_map_contexts(levels2d, scan, tx_size: int, tx_class: int,
                    eob: int) -> np.ndarray:
    """Per-scan-index base context for 0..eob-1; index eob-1 gets the
    coeff_base_eob context."""
    h, w = levels2d.shape
    flat = base_ctx_map(levels2d, tx_size, tx_class).reshape(-1)
    out = flat[scan[:eob]].copy()
    out[eob - 1] = eob_pos_ctx(eob - 1, h * w)
    return out


def br_contexts(levels2d, tx_class: int) -> np.ndarray:
    """Level-above-2 (coeff_br) context for every position [h, w]."""
    h, w = levels2d.shape
    pad = _padded_levels(levels2d).astype(np.int32)
    mag = pad[0:h, 1:w + 1] + pad[1:h + 1, 0:w]
    if tx_class == TX_CLASS_2D:
        mag = mag + pad[1:h + 1, 1:w + 1]
    elif tx_class == TX_CLASS_HORIZ:
        mag = mag + pad[0:h, 2:w + 2]
    else:
        mag = mag + pad[2:h + 2, 0:w]
    mag = np.minimum((mag + 1) >> 1, 6)

    rows, cols = np.mgrid[0:h, 0:w]
    if tx_class == TX_CLASS_2D:
        region = ((rows < 2) & (cols < 2)).astype(np.int32) * 7
    elif tx_class == TX_CLASS_HORIZ:
        region = (cols == 0).astype(np.int32) * 7
    else:
        region = (rows == 0).astype(np.int32) * 7
    out = np.where(region > 0, mag + 7, mag + 14)
    out[0, 0] = mag[0, 0]
    return out


def tx_set_params(tx_size: int, is_inter: bool, reduced_tx_set: bool = True):
    """(nsyms, cdf_set_index, set_type) for the luma tx-type signal — spec
    get_tx_set (EbDefinitions.h:1804-1845).  nsyms == 1 → no symbol coded.
    cdf_set_index indexes intra_ext_tx_cdf/inter_ext_tx_cdf; set_type
    indexes EXT_TX_IND/EXT_TX_INV."""
    squp = tbl.txsize_sqr_up(tx_size)
    if squp > 3:                       # 64-dim: DCT only
        return 1, 0, 0
    if is_inter:
        # 32x32 or reduced set → EXT_TX_SET_DCT_IDTX {IDTX, DCT}
        if squp == 3 or reduced_tx_set:
            return 2, 3, 1             # inter cdf set 3; set type 1
        raise NotImplementedError("full inter tx sets (reduced_tx_set=0)")
    if squp == 3:                      # intra 32x32: DCT only
        return 1, 0, 0
    if reduced_tx_set:
        # EXT_TX_SET_DTT4_IDTX (5 types): intra cdf set 2, set type 2
        return 5, 2, 2
    raise NotImplementedError("full intra tx sets (reduced_tx_set=0)")


def write_golomb(enc, level: int) -> None:
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        enc.encode_bool(0, 0x4000)
    for i in range(length - 1, -1, -1):
        enc.encode_bool((x >> i) & 1, 0x4000)


def write_coeffs_txb(enc, cdf, levels2d: np.ndarray, tx_size: int,
                     tx_type: int, plane_type: int, txb_skip_ctx: int,
                     dc_sign_ctx: int, is_inter: bool = False,
                     reduced_tx_set: bool = True,
                     intra_mode: int = 0) -> int:
    """Write one transform block's quantized levels; returns cul_level
    (bottom 6 bits = clamped level sum, bits 6+ = dc sign code).

    levels2d: [h, w] int array over the *adjusted* coded area (≤32x32),
    row-major; caller guarantees zeros outside.
    """
    h, w = levels2d.shape
    scan = tbl.scan(tx_size, tx_type).astype(np.int64)
    flat = levels2d.reshape(-1).astype(np.int64)
    sc_vals = flat[scan]
    nz = np.nonzero(sc_vals)[0]
    eob = int(nz[-1]) + 1 if len(nz) else 0
    txs = tbl.txs_ctx(tx_size)
    tx_class = TX_TYPE_TO_CLASS[tx_type]

    sym = int(eob == 0)
    c_skip = cdf.txb_skip_cdf[txs][txb_skip_ctx]
    enc.encode_symbol(sym, c_skip)
    cdf.update(c_skip, sym)
    if eob == 0:
        return 0

    # transform_type (spec §5.11.47): luma TXBs with a >1-entry tx set
    # code the type right after all_zero
    if plane_type == 0:
        nsyms, eset, styp = tx_set_params(tx_size, is_inter, reduced_tx_set)
        if nsyms > 1:
            if tx_type not in EXT_TX_MEMBERS[styp]:
                raise ValueError(f"tx_type {tx_type} not in tx set {styp}")
            sym2 = EXT_TX_IND[styp][tx_type]
            sq = tbl.txsize_sqr(tx_size)
            if is_inter:
                t = cdf.inter_ext_tx_cdf[eset][sq]
            else:
                t = cdf.intra_ext_tx_cdf[eset][sq][intra_mode]
            enc.encode_symbol(sym2, t, nsyms)
            cdf.update(t, sym2, nsyms)
        elif tx_type != 0:
            raise ValueError("tx set admits DCT only")

    # eob token
    eob_pt, eob_extra = eob_pos_token(eob)
    # log2(adjusted coded area) - 4  (== txsize_log2_minus4[tx_size])
    eob_multi_size = (w * h).bit_length() - 1 - 4
    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    eob_cdf = getattr(cdf, f"eob_flag_cdf{16 << eob_multi_size}")[
        plane_type][eob_multi_ctx]
    enc.encode_symbol(eob_pt - 1, eob_cdf)
    cdf.update(eob_cdf, eob_pt - 1)

    offset_bits = K_EOB_OFFSET_BITS[eob_pt]
    if offset_bits > 0:
        bit = (eob_extra >> (offset_bits - 1)) & 1
        ec = cdf.eob_extra_cdf[txs][plane_type][eob_pt]
        enc.encode_symbol(bit, ec)
        cdf.update(ec, bit)
        for i in range(1, offset_bits):
            enc.encode_bool((eob_extra >> (offset_bits - 1 - i)) & 1, 0x4000)

    # base + br levels, reverse scan order
    ctxs = nz_map_contexts(levels2d, scan, tx_size, tx_class, eob)
    brc = br_contexts(levels2d, tx_class).reshape(-1)
    abs_vals = np.abs(sc_vals)
    for c in range(eob - 1, -1, -1):
        level = int(abs_vals[c])
        ctx = int(ctxs[c])
        if c == eob - 1:
            s = min(level, 3) - 1
            t = cdf.coeff_base_eob_cdf[txs][plane_type][ctx]
            enc.encode_symbol(s, t)
            cdf.update(t, s)
        else:
            s = min(level, 3)
            t = cdf.coeff_base_cdf[txs][plane_type][ctx]
            enc.encode_symbol(s, t)
            cdf.update(t, s)
        if level > NUM_BASE_LEVELS:
            base_range = level - 1 - NUM_BASE_LEVELS
            br_ctx = int(brc[scan[c]])
            t = cdf.coeff_br_cdf[min(txs, 3)][plane_type][br_ctx]
            idx = 0
            while idx < COEFF_BASE_RANGE:
                k = min(base_range - idx, BR_CDF_SIZE - 1)
                enc.encode_symbol(k, t)
                cdf.update(t, k)
                if k < BR_CDF_SIZE - 1:
                    break
                idx += BR_CDF_SIZE - 1

    # signs (forward scan), golomb tails
    cul_level = 0
    for c in range(eob):
        v = int(sc_vals[c])
        level = abs(v)
        cul_level += level
        if level:
            sign = 1 if v < 0 else 0
            if c == 0:
                t = cdf.dc_sign_cdf[plane_type][dc_sign_ctx]
                enc.encode_symbol(sign, t)
                cdf.update(t, sign)
            else:
                enc.encode_bool(sign, 0x4000)
            if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                write_golomb(enc, level - COEFF_BASE_RANGE - 1 -
                             NUM_BASE_LEVELS)

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    dc_val = int(flat[0])
    if dc_val < 0:
        cul_level |= 1 << COEFF_CONTEXT_BITS
    elif dc_val > 0:
        cul_level += 2 << COEFF_CONTEXT_BITS
    return cul_level


@lru_cache(maxsize=None)
def _scan16(tx_size: int, tx_type: int) -> np.ndarray:
    return np.ascontiguousarray(tbl.scan(tx_size, tx_type), np.int16)


def read_coeffs_txb(dec, cdf, h: int, w: int, tx_size: int, tx_type: int,
                    plane_type: int, txb_skip_ctx: int,
                    dc_sign_ctx: int, is_inter: bool = False,
                    reduced_tx_set: bool = True,
                    intra_mode: int = 0) -> np.ndarray:
    """Parse one transform block (decoder mirror of write_coeffs_txb,
    reference: EbDecParseBlock.c parse_coeffs).  Returns (levels [h, w],
    tx_type): for luma with a >1-entry tx set the returned tx_type is the
    parsed one (the passed value is ignored); otherwise it echoes the
    caller's (chroma derives its type from luma, never coded).

    The skip flag, tx type and eob are read here; the coefficient loop
    runs in C (``ec/native.read_coeffs``): JAX's reader recomputes
    base_ctx_map / br_contexts over the whole block for every coefficient,
    the C loop reads the same contexts at the coefficient's position (the
    same symbols, the same result)."""
    txs = tbl.txs_ctx(tx_size)
    c_skip = cdf.txb_skip_cdf[txs][txb_skip_ctx]
    all_zero = dec.decode_symbol(c_skip)
    cdf.update(c_skip, all_zero)
    if all_zero:
        return np.zeros((h, w), np.int32), tx_type

    if plane_type == 0:
        nsyms, eset, styp = tx_set_params(tx_size, is_inter, reduced_tx_set)
        if nsyms > 1:
            sq = tbl.txsize_sqr(tx_size)
            if is_inter:
                t = cdf.inter_ext_tx_cdf[eset][sq]
            else:
                t = cdf.intra_ext_tx_cdf[eset][sq][intra_mode]
            sym = dec.decode_symbol(t, nsyms)
            cdf.update(t, sym, nsyms)
            tx_type = EXT_TX_INV[styp][sym]
        else:
            tx_type = 0
    tx_class = TX_TYPE_TO_CLASS[tx_type]

    eob_multi_size = (w * h).bit_length() - 1 - 4
    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    eob_cdf = getattr(cdf, f"eob_flag_cdf{16 << eob_multi_size}")[
        plane_type][eob_multi_ctx]
    eob_pt = dec.decode_symbol(eob_cdf) + 1
    cdf.update(eob_cdf, eob_pt - 1)
    eob = K_EOB_GROUP_START[eob_pt]
    offset_bits = K_EOB_OFFSET_BITS[eob_pt]
    if offset_bits > 0:
        ec = cdf.eob_extra_cdf[txs][plane_type][eob_pt]
        bit = dec.decode_symbol(ec)
        cdf.update(ec, bit)
        extra = bit << (offset_bits - 1)
        for i in range(1, offset_bits):
            extra |= dec.decode_bool(0x4000) << (offset_bits - 1 - i)
        eob += extra

    # the levels, their signs and Golomb tails: native/coeff_reader.c
    # (per coefficient, the contexts of base_ctx_map / br_contexts at its
    # position)
    levels = native.read_coeffs(
        dec, h, w, eob, tx_class, _scan16(tx_size, tx_type),
        cdf.coeff_base_cdf[txs][plane_type],
        cdf.coeff_br_cdf[min(txs, 3)][plane_type],
        cdf.coeff_base_eob_cdf[txs][plane_type],
        cdf.dc_sign_cdf[plane_type][dc_sign_ctx], cdf.update_enabled)
    return levels, tx_type
