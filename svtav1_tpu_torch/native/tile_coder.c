/* Native tile entropy coder for the TPU-native AV1 encoder.
 *
 * Entropy coding is inherently serial per tile (SURVEY.md §7 "hard parts"),
 * so it runs as native host code over the device-produced mode/level tensors
 * — the role the reference gives its EC process thread
 * (EbEntropyCodingProcess.c).  The algorithm mirrors svtav1_tpu/ec/*.py
 * (which is conformance-proven against dav1d); Python remains the reference
 * implementation and the two are tested byte-identical.
 *
 * Build: gcc -O3 -fPIC -shared -o libtilecoder.so tile_coder.c
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Daala/AV1 range encoder (spec §8.2)                                  */
/* ------------------------------------------------------------------ */

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define CDF_PROB_TOP 32768

typedef struct {
    uint32_t low;
    uint16_t rng;
    int cnt;
    uint16_t *precarry;
    size_t n, cap;
    uint8_t *out;
    size_t out_n;
    long nsym;       /* symbols coded: each enc_q15 and enc_bool */
    int update;      /* CDF adaptation enabled (per call: threads code
                      * frames of different settings at once) */
} RangeEnc;

static void enc_init(RangeEnc *e, size_t cap) {
    e->low = 0;
    e->rng = 0x8000;
    e->cnt = -9;
    e->n = 0;
    e->cap = cap;
    e->precarry = malloc(cap * sizeof(uint16_t));
    e->out = NULL;
    e->out_n = 0;
    e->nsym = 0;
}

static void enc_push(RangeEnc *e, uint16_t v) {
    if (e->n >= e->cap) {
        e->cap = e->cap * 2 + 16;
        e->precarry = realloc(e->precarry, e->cap * sizeof(uint16_t));
    }
    e->precarry[e->n++] = v;
}

static int ilog_nz(uint32_t x) {
    return 32 - __builtin_clz(x);
}

static void enc_normalize(RangeEnc *e, uint32_t low, uint32_t rng) {
    int d = 16 - ilog_nz(rng);
    int c = e->cnt;
    int s = c + d;
    if (s >= 0) {
        c += 16;
        uint32_t m = (1u << c) - 1;
        if (s >= 8) {
            enc_push(e, (low >> c) & 0xFFFF);
            low &= m;
            c -= 8;
            m >>= 8;
        }
        enc_push(e, (low >> c) & 0xFFFF);
        s = c + d - 24;
        low &= m;
    }
    e->low = low << d;
    e->rng = rng << d;
    e->cnt = s;
}

static void enc_q15(RangeEnc *e, unsigned fl, unsigned fh, int s, int nsyms) {
    e->nsym++;
    uint32_t l = e->low;
    uint32_t r = e->rng;
    const int n = nsyms - 1;
    if (fl < CDF_PROB_TOP) {
        unsigned u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                     + EC_MIN_PROB * (n - (s - 1));
        unsigned v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                     + EC_MIN_PROB * (n - s);
        l += r - u;
        r = u - v;
    } else {
        r -= ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
             + EC_MIN_PROB * (n - s);
    }
    enc_normalize(e, l, r);
}

static void enc_bool(RangeEnc *e, int val, unsigned f) {
    e->nsym++;
    uint32_t l = e->low;
    uint32_t r = e->rng;
    unsigned v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                 + EC_MIN_PROB;
    if (val) {
        l += r - v;
        r = v;
    } else {
        r -= v;
    }
    enc_normalize(e, l, r);
}

static void enc_literal(RangeEnc *e, unsigned v, int bits) {
    for (int i = bits - 1; i >= 0; i--) enc_bool(e, (v >> i) & 1, 0x4000);
}

/* CDF slice layout: nsyms icdf entries (icdf[nsyms-1]==0) + counter. */
#define NSYMBS2SPEED(n) ((n) < 2 ? 0 : ((n) < 4 ? 1 : 2))

static void update_cdf(uint16_t *cdf, int val, int nsyms) {
    int count = cdf[nsyms];
    int rate = 3 + (count > 15) + (count > 31) + NSYMBS2SPEED(nsyms);
    int tmp = 32768;
    for (int i = 0; i < nsyms - 1; i++) {
        if (i == val) tmp = 0;
        int c = cdf[i];
        if (tmp < c)
            cdf[i] = c - ((c - tmp) >> rate);
        else
            cdf[i] = c + ((tmp - c) >> rate);
    }
    if (count < 32) cdf[nsyms] = count + 1;
}

static void enc_symbol(RangeEnc *e, int s, uint16_t *icdf, int nsyms) {
    enc_q15(e, s > 0 ? icdf[s - 1] : CDF_PROB_TOP, icdf[s], s, nsyms);
    if (e->update) update_cdf(icdf, s, nsyms);
}

static void enc_symbol_noupd(RangeEnc *e, int s, const uint16_t *icdf,
                             int nsyms) {
    enc_q15(e, s > 0 ? icdf[s - 1] : CDF_PROB_TOP, icdf[s], s, nsyms);
}

static size_t enc_done(RangeEnc *e, uint8_t *dst, size_t dst_cap) {
    uint32_t l = e->low;
    int c = e->cnt;
    int s = 10;
    uint32_t m = 0x3FFF;
    uint32_t ee = ((l + m) & ~m) | (m + 1);
    s += c;
    if (s > 0) {
        uint32_t n = (1u << (c + 16)) - 1;
        do {
            enc_push(e, (ee >> (c + 16)) & 0xFFFF);
            ee &= n;
            s -= 8;
            c -= 8;
            n >>= 8;
        } while (s > 0);
    }
    size_t nb = e->n;
    if (nb > dst_cap) return 0;
    uint32_t carry = 0;
    for (ssize_t i = nb - 1; i >= 0; i--) {
        carry += e->precarry[i];
        dst[i] = carry & 0xFF;
        carry >>= 8;
    }
    free(e->precarry);
    return nb;
}

/* ------------------------------------------------------------------ */
/* CDF context (tables passed from Python, mutated in place)            */
/* ------------------------------------------------------------------ */

typedef struct {
    /* coefficient tables (already sliced to the frame's qindex class) */
    uint16_t *txb_skip;        /* [5][13][3] */
    uint16_t *eob_flag16;      /* [2][2][6] */
    uint16_t *eob_flag32;      /* [2][2][7] */
    uint16_t *eob_flag64;      /* [2][2][8] */
    uint16_t *eob_flag128;     /* [2][2][9] */
    uint16_t *eob_flag256;     /* [2][2][10] */
    uint16_t *eob_flag512;     /* [2][2][11] */
    uint16_t *eob_flag1024;    /* [2][2][12] */
    uint16_t *eob_extra;       /* [5][2][22][3] */
    uint16_t *coeff_base_eob;  /* [5][2][4][4] */
    uint16_t *coeff_base;      /* [5][2][42][5] */
    uint16_t *coeff_br;        /* [4][2][21][5] */
    uint16_t *dc_sign;         /* [2][3][3] */
    /* mode tables */
    uint16_t *partition;       /* [20][11] */
    uint16_t *skip;            /* [3][3] */
    uint16_t *kf_y;            /* [5][5][14] */
    uint16_t *uv_mode;         /* [2][13][15] */
    uint16_t *angle_delta;     /* [8][8] */
    /* scans */
    int16_t *scan32;           /* [1024] */
    int16_t *scan16;           /* [256] */
} Tables;

/* ------------------------------------------------------------------ */
/* Coefficient coding (mirrors svtav1_tpu/ec/coeffs.py)                 */
/* ------------------------------------------------------------------ */

static const int16_t K_EOB_GROUP_START[12] = {0, 1, 2,  3,  5,   9,
                                              17, 33, 65, 129, 257, 513};
static const int16_t K_EOB_OFFSET_BITS[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7,
                                              8, 9};

static int clip3(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

/* base-level ctx for position (r,c), levels is [h][w] int32 of |levels|
 * capped at 127 conceptually (we cap inline). tx_class 0 only (2D). */
static int base_ctx(const int32_t *lv, int h, int w, int r, int c,
                    int wlth) {
    (void)wlth;
    int mag = 0;
#define L(rr, cc) \
    (((rr) < h && (cc) < w) ? clip3(abs((int)lv[(rr) * w + (cc)]), 0, 3) : 0)
    mag = L(r, c + 1) + L(r + 1, c) + L(r + 1, c + 1) + L(r, c + 2) +
          L(r + 2, c);
#undef L
    int ctx = (mag + 1) >> 1;
    if (ctx > 4) ctx = 4;
    if (r == 0 && c == 0) return 0;
    int off;
    if (r + c < 2)
        off = 1;
    else if (r + c < 4)
        off = 6;
    else
        off = 21;
    /* square blocks only in this path (32x32 / 16x16) */
    return ctx + off;
}

static int br_ctx(const int32_t *lv, int h, int w, int r, int c) {
    int mag = 0;
#define L(rr, cc) \
    (((rr) < h && (cc) < w) ? clip3(abs((int)lv[(rr) * w + (cc)]), 0, 127) : 0)
    mag = L(r, c + 1) + L(r + 1, c) + L(r + 1, c + 1);
#undef L
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (r == 0 && c == 0) return mag;
    if (r < 2 && c < 2) return mag + 7;
    return mag + 14;
}

static void write_golomb(RangeEnc *e, int level) {
    int x = level + 1;
    int length = ilog_nz(x);
    for (int i = 0; i < length - 1; i++) enc_bool(e, 0, 0x4000);
    for (int i = length - 1; i >= 0; i--)
        enc_bool(e, (x >> i) & 1, 0x4000);
}

/* returns cul_level (6-bit sum + dc-sign code in bits 6+) */
static int write_coeffs(RangeEnc *e, Tables *t, const int32_t *lv, int n,
                        int tx_size_is_32, int plane_type, int txb_skip_ctx,
                        int dc_sign_ctx) {
    int w = n, h = n;
    const int16_t *scan = tx_size_is_32 ? t->scan32 : t->scan16;
    int npix = w * h;
    int txs = tx_size_is_32 ? 3 : 2;

    int eob = 0;
    for (int i = 0; i < npix; i++)
        if (lv[scan[i]]) eob = i + 1;

    uint16_t *cskip = t->txb_skip + (txs * 13 + txb_skip_ctx) * 3;
    enc_symbol(e, eob == 0, cskip, 2);
    if (eob == 0) return 0;

    /* eob token */
    int eob_pt = 0;
    while (eob_pt < 11 && eob >= K_EOB_GROUP_START[eob_pt + 1]) eob_pt++;
    int eob_extra = eob - K_EOB_GROUP_START[eob_pt];
    /* eob_multi_size = log2(npix) - 4: 16x16→4, 32x32→6 */
    uint16_t *ecdf;
    int ecdf_n;
    if (tx_size_is_32) {
        ecdf = t->eob_flag1024 + (plane_type * 2 + 0) * 12;
        ecdf_n = 11;
    } else {
        ecdf = t->eob_flag256 + (plane_type * 2 + 0) * 10;
        ecdf_n = 9;
    }
    enc_symbol(e, eob_pt - 1, ecdf, ecdf_n);

    int offset_bits = K_EOB_OFFSET_BITS[eob_pt];
    if (offset_bits > 0) {
        int bit = (eob_extra >> (offset_bits - 1)) & 1;
        uint16_t *xc = t->eob_extra + ((txs * 2 + plane_type) * 22 + eob_pt) * 3;
        enc_symbol(e, bit, xc, 2);
        for (int i = 1; i < offset_bits; i++)
            enc_bool(e, (eob_extra >> (offset_bits - 1 - i)) & 1, 0x4000);
    }

    for (int ci = eob - 1; ci >= 0; ci--) {
        int pos = scan[ci];
        int r = pos / w, c = pos % w;
        int v = lv[pos];
        int level = abs(v);
        if (ci == eob - 1) {
            int ctx;
            if (ci == 0)
                ctx = 0;
            else if (ci <= npix / 8)
                ctx = 1;
            else if (ci <= npix / 4)
                ctx = 2;
            else
                ctx = 3;
            uint16_t *tb = t->coeff_base_eob +
                           ((txs * 2 + plane_type) * 4 + ctx) * 4;
            int s = (level < 3 ? level : 3) - 1;
            enc_symbol(e, s, tb, 3);
        } else {
            int ctx = base_ctx(lv, h, w, r, c, 0);
            uint16_t *tb = t->coeff_base +
                           ((txs * 2 + plane_type) * 42 + ctx) * 5;
            int s = level < 3 ? level : 3;
            enc_symbol(e, s, tb, 4);
        }
        if (level > 2) {
            int base_range = level - 3;
            int bctx = br_ctx(lv, h, w, r, c);
            int txs_br = txs < 3 ? txs : 3;
            uint16_t *tb = t->coeff_br +
                           ((txs_br * 2 + plane_type) * 21 + bctx) * 5;
            for (int idx = 0; idx < 12; idx += 3) {
                int k = base_range - idx;
                if (k > 3) k = 3;
                enc_symbol(e, k, tb, 4);
                if (k < 3) break;
            }
        }
    }

    int cul = 0;
    for (int ci = 0; ci < eob; ci++) {
        int pos = scan[ci];
        int v = lv[pos];
        int level = abs(v);
        cul += level;
        if (level) {
            int sign = v < 0;
            if (ci == 0) {
                uint16_t *tb = t->dc_sign +
                               (plane_type * 3 + dc_sign_ctx) * 3;
                enc_symbol(e, sign, tb, 2);
            } else {
                enc_bool(e, sign, 0x4000);
            }
            if (level > 14) write_golomb(e, level - 15);
        }
    }
    if (cul > 63) cul = 63;
    int dc = lv[0];
    if (dc < 0)
        cul |= 1 << 6;
    else if (dc > 0)
        cul += 2 << 6;
    return cul;
}

/* ------------------------------------------------------------------ */
/* Tile coding for the fixed-32x32 intra frame                          */
/* ------------------------------------------------------------------ */

static const int INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3,
                                           0, 1, 2, 0};

/* split_or_horz bool for blocks crossing the frame bottom (spec §5.11.4;
 * partition_gather_vert_alike, EbCabacContextModel.h:735): P(SPLIT) is
 * gathered from the partition CDF, no adaptation. */
static void enc_partition_edge_split(RangeEnc *e, const uint16_t *icdf,
                                     int nsyms) {
    static const int elems[6] = {2 /*VERT*/, 3 /*SPLIT*/, 4 /*HORZ_A*/,
                                 6 /*VERT_A*/, 7 /*VERT_B*/, 9 /*VERT_4*/};
    unsigned psum = 0;
    for (int i = 0; i < 6; i++) {
        int s = elems[i];
        if (s >= nsyms) continue;
        unsigned hi = s == 0 ? CDF_PROB_TOP : icdf[s - 1];
        unsigned lo = s < nsyms - 1 ? icdf[s] : 0;
        psum += hi - lo;
    }
    uint16_t scratch[3] = {(uint16_t)psum, 0, 0};
    enc_symbol_noupd(e, 1 /*split*/, scratch, 2);
}

/* Returns tile size, writes into dst.
 * true_h: signaled frame height (<= height, the SB-padded plane height);
 * bottom-row geometry follows encoder/geometry.py FLAT_OK_M.
 * n_symbols (NULL: not asked): the symbols coded, literal and Golomb bits
 * included. */
long encode_tile_intra(
    uint8_t *dst, long dst_cap, int width, int height, int update_cdf,
    const int32_t *y_modes,  /* [bh][bw] */
    const int32_t *y_lev,    /* [bh][bw][32][32] */
    const int32_t *u_lev,    /* [ch][cw][16][16] */
    const int32_t *v_lev,
    Tables *t, int true_h,
    const int32_t *uv_modes, /* [bh][bw] (NULL -> DC) */
    const int32_t *y_deltas, /* [bh][bw] luma angle deltas -3..3 (NULL
                              * -> 0) */
    long *n_symbols) {
    if (true_h <= 0) true_h = height;
    int mi_cols = width / 4;
    int mi_rows = true_h / 4;
    int sb_cols = width / 64;
    int sb_rows = height / 64;
    int bw = width / 32;

    RangeEnc e;
    enc_init(&e, 1 << 16);
    e.update = update_cdf;

    uint8_t *above_part = calloc(mi_cols, 1);
    uint8_t *skip_grid = calloc(mi_rows * mi_cols, 1);
    uint8_t *mode_grid = calloc(mi_rows * mi_cols, 1);
    /* per-plane above ctx: value + avail */
    int aw[3] = {width / 4, width / 8, width / 8};
    uint8_t *above_cul[3], *above_av[3];
    for (int p = 0; p < 3; p++) {
        above_cul[p] = calloc(aw[p], 1);
        above_av[p] = calloc(aw[p], 1);
    }
    uint8_t left_cul[3][16];
    uint8_t left_av[3][16];

    for (int sb_r = 0; sb_r < sb_rows; sb_r++) {
        uint8_t left_part[16];
        memset(left_part, 0, sizeof(left_part));
        memset(left_cul, 0, sizeof(left_cul));
        memset(left_av, 0, sizeof(left_av));
        for (int sb_c = 0; sb_c < sb_cols; sb_c++) {
            int mi_c0 = sb_c * 16;
            /* partition SPLIT at 64 (split_or_horz bool when the SB
             * crosses the true frame bottom) */
            {
                int bsl = 3;
                int a = (above_part[mi_c0] >> bsl) & 1;
                int l = (left_part[0] >> bsl) & 1;
                int ctx = (l * 2 + a) + bsl * 4;
                if (sb_r * 16 + 8 < mi_rows)
                    enc_symbol(&e, 3 /*SPLIT*/, t->partition + ctx * 11, 10);
                else
                    enc_partition_edge_split(&e, t->partition + ctx * 11,
                                             10);
            }
            static const int qoff[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
            for (int q = 0; q < 4; q++) {
                int qr = qoff[q][0], qc = qoff[q][1];
                int br = sb_r * 2 + qr, bc = sb_c * 2 + qc;
                int mi_r = br * 8, mi_c = bc * 8;
                if (mi_r >= mi_rows)
                    continue;   /* quad below the frame bottom */
                /* partition NONE at 32 */
                {
                    int bsl = 2;
                    int a = (above_part[mi_c] >> bsl) & 1;
                    int l = (left_part[qr * 8] >> bsl) & 1;
                    int ctx = (l * 2 + a) + bsl * 4;
                    enc_symbol(&e, 0 /*NONE*/, t->partition + ctx * 11, 10);
                }

                int have_above = mi_r > 0;
                int have_left = mi_c > 0;
                int y_mode = y_modes[br * bw + bc];
                const int32_t *ylv = y_lev + ((long)(br * bw + bc)) * 32 * 32;
                const int32_t *ulv = u_lev + ((long)(br * bw + bc)) * 16 * 16;
                const int32_t *vlv = v_lev + ((long)(br * bw + bc)) * 16 * 16;
                int any = 0;
                for (int i = 0; i < 32 * 32 && !any; i++) any |= ylv[i] != 0;
                for (int i = 0; i < 16 * 16 && !any; i++)
                    any |= (ulv[i] != 0) | (vlv[i] != 0);
                int skip = !any;

                int a_skip = have_above ? skip_grid[(mi_r - 1) * mi_cols + mi_c]
                                        : 0;
                int l_skip = have_left ? skip_grid[mi_r * mi_cols + mi_c - 1]
                                       : 0;
                enc_symbol(&e, skip, t->skip + (a_skip + l_skip) * 3, 2);

                int a_mode = have_above
                                 ? mode_grid[(mi_r - 1) * mi_cols + mi_c] : 0;
                int l_mode = have_left ? mode_grid[mi_r * mi_cols + mi_c - 1]
                                       : 0;
                enc_symbol(&e, y_mode,
                           t->kf_y + (INTRA_MODE_CONTEXT[a_mode] * 5 +
                                      INTRA_MODE_CONTEXT[l_mode]) * 14, 13);
                if (y_mode >= 1 && y_mode <= 8)
                    enc_symbol(&e, 3 + (y_deltas ? y_deltas[br * bw + bc]
                                                 : 0),
                               t->angle_delta + (y_mode - 1) * 8, 7);
                /* uv mode (searched; cfl-allowed 14-symbol CDF) */
                int uv_mode = uv_modes ? uv_modes[br * bw + bc] : 0;
                enc_symbol(&e, uv_mode,
                           t->uv_mode + (1 * 13 + y_mode) * 15, 14);
                if (uv_mode >= 1 && uv_mode <= 8)
                    enc_symbol(&e, 3 /*delta 0*/,
                               t->angle_delta + (uv_mode - 1) * 8, 7);

                if (!skip) {
                    for (int plane = 0; plane < 3; plane++) {
                        const int32_t *lv = plane == 0 ? ylv
                                            : (plane == 1 ? ulv : vlv);
                        int n = plane == 0 ? 32 : 16;
                        int shift = plane == 0 ? 0 : 1;
                        int units = (32 >> shift) / 4;
                        /* frame-bottom overhang: contexts read over
                         * in-frame units only; beyond-edge left entries
                         * reset to 0 after coding (EbDecParseBlock.c
                         * :2117-2133, update_coeff_ctx :1644-1654) */
                        int row_px = (mi_r * 4) >> shift;
                        int valid_px = (mi_rows * 4) >> shift;
                        int units_v = (valid_px - row_px) / 4;
                        if (units_v > units) units_v = units;
                        if (units_v < 0) units_v = 0;
                        int au0 = ((bc * 32) >> shift) / 4;
                        int lu0 = (((br * 32) >> shift) / 4) % (16 >> shift);
                        int ptype = plane == 0 ? 0 : 1;
                        int tctx, dctx;
                        if (plane == 0) {
                            tctx = 0;
                        } else {
                            int a_nz = 0, l_nz = 0;
                            for (int k = 0; k < units; k++)
                                if (above_av[plane][au0 + k] &&
                                    (above_cul[plane][au0 + k] & 0x3F))
                                    a_nz = 1;
                            for (int k = 0; k < units_v; k++)
                                if (left_av[plane][lu0 + k] &&
                                    (left_cul[plane][lu0 + k] & 0x3F))
                                    l_nz = 1;
                            tctx = 7 + a_nz + l_nz;
                        }
                        {
                            int signs = 0;
                            for (int k = 0; k < units; k++)
                                if (above_av[plane][au0 + k]) {
                                    int s = above_cul[plane][au0 + k] >> 6;
                                    signs += s == 2 ? 1 : (s == 1 ? -1 : 0);
                                }
                            for (int k = 0; k < units_v; k++)
                                if (left_av[plane][lu0 + k]) {
                                    int s = left_cul[plane][lu0 + k] >> 6;
                                    signs += s == 2 ? 1 : (s == 1 ? -1 : 0);
                                }
                            dctx = signs > 0 ? 2 : (signs < 0 ? 1 : 0);
                        }
                        int cul = write_coeffs(&e, t, lv, n, plane == 0,
                                               ptype, tctx, dctx);
                        for (int k = 0; k < units; k++) {
                            above_cul[plane][au0 + k] = cul;
                            above_av[plane][au0 + k] = 1;
                            left_cul[plane][lu0 + k] = k < units_v ? cul : 0;
                            left_av[plane][lu0 + k] = 1;
                        }
                    }
                } else {
                    for (int plane = 0; plane < 3; plane++) {
                        int shift = plane == 0 ? 0 : 1;
                        int units = (32 >> shift) / 4;
                        int au0 = ((bc * 32) >> shift) / 4;
                        int lu0 = (((br * 32) >> shift) / 4) % (16 >> shift);
                        for (int k = 0; k < units; k++) {
                            above_cul[plane][au0 + k] = 0;
                            above_av[plane][au0 + k] = 1;
                            left_cul[plane][lu0 + k] = 0;
                            left_av[plane][lu0 + k] = 1;
                        }
                    }
                }

                int rows8 = mi_rows - mi_r < 8 ? mi_rows - mi_r : 8;
                for (int i = 0; i < rows8; i++) {
                    for (int j = 0; j < 8; j++) {
                        skip_grid[(mi_r + i) * mi_cols + mi_c + j] = skip;
                        mode_grid[(mi_r + i) * mi_cols + mi_c + j] = y_mode;
                    }
                }
                /* partition ctx leaf update: 32x32 → value 24 */
                memset(above_part + mi_c, 24, 8);
                memset(left_part + qr * 8, 24, 8);
            }
        }
    }

    long nb = (long)enc_done(&e, dst, dst_cap);
    if (n_symbols) *n_symbols = e.nsym;
    free(above_part);
    free(skip_grid);
    free(mode_grid);
    for (int p = 0; p < 3; p++) {
        free(above_cul[p]);
        free(above_av[p]);
    }
    return nb;
}
