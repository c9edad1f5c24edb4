/* The coefficient loop of the decoder's transform-block reader: the same
 * symbols as ec/coeffs.py::read_coeffs_txb reads after the block's skip
 * flag, tx type and eob (spec 5.11.39 coeffs(); reference
 * EbDecParseBlock.c parse_coeffs), on the same range decoder state and
 * the same CDF tables, adapted in place.
 *
 * Levels in reverse scan order (coeff_base_eob, coeff_base, coeff_br with
 * the contexts of base_ctx_map / br_contexts at the coefficient's
 * position), then signs and Golomb tails in scan order.  Built by gcc at
 * first use (ec/native.py) and called through ctypes.
 */
#include <stdint.h>
#include <string.h>

typedef struct {
    const uint8_t *data;
    long len, bptr;
    uint64_t dif;
    uint32_t rng;
    long cnt;
} Dec;

static const int SPEED[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                              2, 2};

static void refill(Dec *d) {
    long s = 32 - 9 - (d->cnt + 15);
    while (s >= 0 && d->bptr < d->len) {
        d->dif ^= (uint64_t)d->data[d->bptr] << s;
        d->cnt += 8;
        d->bptr++;
        s -= 8;
    }
    if (d->bptr >= d->len)
        d->cnt = 1 << 14;      /* "lots of bits" of zeros */
}

static void normalize(Dec *d, uint64_t dif, uint32_t r) {
    int n = 16 - (32 - __builtin_clz(r));
    d->cnt -= n;
    d->dif = (((dif + 1) << n) - 1) & 0xFFFFFFFFull;
    d->rng = (r << n) & 0xFFFF;
    if (d->cnt < 0)
        refill(d);
}

static int symbol(Dec *d, uint16_t *icdf, int nsyms, int adapt) {
    uint32_t c = (uint32_t)(d->dif >> 16), r8 = d->rng >> 8;
    uint32_t u, v = d->rng;
    int ret = -1;
    do {
        ret++;
        u = v;
        v = ((r8 * (uint32_t)(icdf[ret] >> 6)) >> 1) +
            4u * (uint32_t)(nsyms - 1 - ret);
    } while (c < v);
    normalize(d, d->dif - ((uint64_t)v << 16), u - v);
    if (adapt) {
        int count = icdf[nsyms];
        int rate = 3 + (count > 15) + (count > 31) + SPEED[nsyms];
        for (int i = 0; i < nsyms - 1; i++) {
            if (i < ret)
                icdf[i] += (32768 - icdf[i]) >> rate;
            else
                icdf[i] -= icdf[i] >> rate;
        }
        if (count < 32)
            icdf[nsyms] = count + 1;
    }
    return ret;
}

static int bool_half(Dec *d) {
    uint32_t v = (((d->rng >> 8) * (0x4000 >> 6)) >> 1) + 4;
    uint64_t vw = (uint64_t)v << 16;
    if (d->dif >= vw) {
        normalize(d, d->dif - vw, d->rng - v);
        return 0;
    }
    normalize(d, d->dif, v);
    return 1;
}

static int min_i(int a, int b) { return a < b ? a : b; }

/* TX_CLASS_2D 0, TX_CLASS_HORIZ 1, TX_CLASS_VERT 2 (ec/coeffs.py) */
static int base_ctx(const int *m3, int p, int r, int c, int stride, int h,
                    int w, int cls) {
    static const int nz1d[3] = {26, 31, 36};
    int s, ctx;
    if (cls == 0) {
        if (r == 0 && c == 0)
            return 0;
        s = m3[p + 1] + m3[p + stride] + m3[p + stride + 1] + m3[p + 2] +
            m3[p + 2 * stride];
        ctx = min_i((s + 1) >> 1, 4);
        if (w < h && r < 2)
            return ctx + 11;
        if (w > h && c < 2)
            return ctx + 16;
        return ctx + (r + c < 2 ? 1 : r + c < 4 ? 6 : 21);
    }
    if (cls == 2) {
        s = m3[p + 1] + m3[p + stride] + m3[p + 2 * stride] +
            m3[p + 3 * stride] + m3[p + 4 * stride];
        return min_i((s + 1) >> 1, 4) + nz1d[min_i(r, 2)];
    }
    s = m3[p + 1] + m3[p + stride] + m3[p + 2] + m3[p + 3] + m3[p + 4];
    return min_i((s + 1) >> 1, 4) + nz1d[min_i(c, 2)];
}

static int br_ctx(const int *mag, int p, int r, int c, int stride, int cls) {
    int s = mag[p + 1] + mag[p + stride], near;
    if (cls == 0) {
        s += mag[p + stride + 1];
        near = r < 2 && c < 2;
    } else if (cls == 1) {
        s += mag[p + 2];
        near = c == 0;
    } else {
        s += mag[p + 2 * stride];
        near = r == 0;
    }
    s = min_i((s + 1) >> 1, 6);
    if (r == 0 && c == 0)
        return s;
    return s + (near ? 7 : 14);
}

static int eob_pos_ctx(int c, int n) {
    if (c == 0)
        return 0;
    if (c <= n / 8)
        return 1;
    if (c <= n / 4)
        return 2;
    return 3;
}

/* state: [bptr, dif, rng, cnt] in and out.  base [42][5], br [21][5],
 * eob_base [4][4], dc_sign [3]: CDF rows (icdf values, counter).  out:
 * h*w int32 levels, zero on entry.  Returns 0, or -1 when a Golomb tail
 * is longer than 32 bits or a level leaves int32 (a corrupt stream). */
int read_coeffs(const uint8_t *data, long len, int64_t *state, int h, int w,
                int eob, int cls, const int16_t *scan, uint16_t *base,
                uint16_t *br, uint16_t *eob_base, uint16_t *dc_sign,
                int adapt, int32_t *out) {
    Dec d = {data, len, (long)state[0], (uint64_t)state[1],
             (uint32_t)state[2], (long)state[3]};
    int stride = w + 4;
    int mag[36 * 36], m3[36 * 36];     /* h, w <= 32, padded by 4 */
    memset(mag, 0, sizeof(int) * (h + 4) * stride);
    memset(m3, 0, sizeof(int) * (h + 4) * stride);
    for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c], r = pos / w, col = pos % w;
        int p = r * stride + col, level;
        if (c == eob - 1)
            level = symbol(&d, eob_base + 4 * eob_pos_ctx(c, h * w), 3,
                           adapt) + 1;
        else
            level = symbol(&d, base + 5 * base_ctx(m3, p, r, col, stride, h,
                                                   w, cls), 4, adapt);
        if (level > 2) {
            uint16_t *t = br + 5 * br_ctx(mag, p, r, col, stride, cls);
            for (int idx = 0; idx < 12; idx += 3) {
                int k = symbol(&d, t, 4, adapt);
                level += k;
                if (k < 3)
                    break;
            }
        }
        mag[p] = min_i(level, 127);
        m3[p] = min_i(level, 3);
        out[pos] = level;
    }
    int err = 0;
    for (int c = 0; c < eob && !err; c++) {
        int pos = scan[c];
        int64_t level = out[pos];
        if (!level)
            continue;
        int sign = c == 0 ? symbol(&d, dc_sign, 2, adapt) : bool_half(&d);
        if (level > 14) {
            int length = 0;
            while (!bool_half(&d))
                if (++length > 32) {
                    err = -1;
                    break;
                }
            if (err)
                break;
            int64_t x = 1;
            for (int i = 0; i < length; i++)
                x = (x << 1) | bool_half(&d);
            level = x - 1 + 15;
            if (level > 0x7FFFFFFF) {
                err = -1;
                break;
            }
        }
        out[pos] = (int32_t)(sign ? -level : level);
    }
    state[0] = d.bptr;
    state[1] = (int64_t)d.dif;
    state[2] = d.rng;
    state[3] = d.cnt;
    return err;
}
