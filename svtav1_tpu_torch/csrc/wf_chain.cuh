// One candidate of one block on one warp: the mode-decision chain that the
// plane kernel (csrc/wavefront.cu, wf_plane_kernel) and the edge strip's
// chain kernel (csrc/wf_edge.cu, wf_edge_kernel) share, so the normative
// integer chain and the RD cost's float32 order live in one place.
//
// A block of S x S (32, 16 or 8) pixels takes S lanes: 32 / S blocks ride
// a warp, block hf = lane / S in lanes hf * S .. hf * S + S - 1, and lane
// j = lane % S owns column j of its block, then row j after the
// transpose.  Per block the caller gives, in shared memory: the source
// [hf][S][S] pixels, the §7.11.2 edge arrays [hf][4S + 1] ints (edge_of
// below), and the warp's slot: a transpose tile [hf][S][S + 1] ints,
// levels [hf][S][S + 2] int16 and a prediction / recon tile [hf][S][S]
// pixels.  warp_chain predicts (DC, the directional modes through the
// host's (i0, i1, shift) maps, PAETH, SMOOTH*, or an inter lane's given
// prediction), runs forward transform -> deadzone quantizer -> normative
// dequantizer -> inverse transform -> reconstruction with the 1D networks
// of csrc/txfm_nets.cuh in registers, and returns the block's sse and
// residual bits summed over its lanes; its levels and recon stay in the
// slot.  The per-pixel phases are loops (unrolled, the code outgrows the
// instruction cache); the floating-point steps use the _rn intrinsics so
// no multiply-add is contracted.
#pragma once

#include <cstdint>

#include "txfm_nets.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Round2 for s > 0, multiply by 2^-s for s < 0 (round_shift_array).
__device__ __forceinline__ int rshift_signed(int x, int s) {
  if (s > 0) return (x + (1 << (s - 1))) >> s;
  if (s < 0) return x * (1 << (-s));
  return x;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Forward network of pass 0 (columns) or 1 (rows); 32x32 has one, its
// column and row cos bits being equal.
template <int S>
__device__ __forceinline__ void fwd_net(int* v, int pass, int kind) {
  if constexpr (S == 32) {
    net_fwd_dct32(v);
  } else if constexpr (S == 16) {
    if (pass) {
      if (kind) net_fwd_row_adst16(v);
      else net_fwd_row_dct16(v);
    } else {
      if (kind) net_fwd_col_adst16(v);
      else net_fwd_col_dct16(v);
    }
  } else {
    if (pass) {
      if (kind) net_fwd_row_adst8(v);
      else net_fwd_row_dct8(v);
    } else {
      if (kind) net_fwd_col_adst8(v);
      else net_fwd_col_dct8(v);
    }
  }
}

template <int S>
__device__ __forceinline__ void inv_net(int* v, int kind, int lo, int hi) {
  if constexpr (S == 32) {
    net_inv_dct32(v, lo, hi);
  } else if constexpr (S == 16) {
    if (kind) net_inv_adst16(v, lo, hi);
    else net_inv_dct16(v, lo, hi);
  } else {
    if (kind) net_inv_adst8(v, lo, hi);
    else net_inv_dct8(v, lo, hi);
  }
}

// Value q of the edge array E = [corner, above(S), above-right(S),
// left(S), below-left(S)] of a block of size S (§7.11.2), from two
// readers of the coded pixels around it: above(k) the row above at
// column k of the block (k = -1 the corner), above(S + k) its k-th
// above-right pixel; left(k) the column left at row k, left(S + k) its
// k-th below-left pixel; each reader applies its own clamps.  ha / hl:
// the row above / column left exist; tr / bl: the above-right /
// below-left are coded (and their row or column exists).
template <int S, typename Above, typename Left>
__device__ __forceinline__ int edge_of(int q, bool ha, bool hl, bool tr,
                                       bool bl, int base, Above above,
                                       Left left) {
  auto above_at = [&](int k) {
    return ha ? above(k) : (hl ? left(0) : base - 1);
  };
  auto left_at = [&](int k) {
    return hl ? left(k) : (ha ? above(0) : base + 1);
  };
  if (q == 0)
    return (ha && hl) ? above(-1)
                      : (ha ? above(0) : (hl ? left(0) : base));
  if (q < 2 * S + 1) {
    const int k = q - 1;
    if (k < S) return above_at(k);
    return tr ? above(k) : above_at(S - 1);
  }
  const int k = q - (2 * S + 1);
  if (k < S) return left_at(k);
  return bl ? left(k) : left_at(S - 1);
}

// The per-size shifts of the chain (tx_params in cuda/wavefront_kernel.py).
struct ChainShifts {
  int qshift, fwd_s0, fwd_s1, fwd_s2, inv_s0, inv_s1;
};

// A candidate's sse and residual bits, each summed over its block's lanes.
struct ChainOut {
  int sse;
  float rbits;
};

// One candidate (mode, row kind rk, column kind ck; mode < 0 an inter
// lane whose prediction of this lane's block is X [S][S], in global
// memory) of the blocks held in sSrc / sE, on the warp whose slot is
// Tw0 / Lw0 / Rw0.  dm: the candidate's predictor map [S][S]; smw: the
// smooth weights [S].  P is the kernel's parameter
// struct (base, pix_max, the quantizer's steps, reciprocals and clamps).
// ws: the warp's phase stamps, or null.
template <int S, typename Pix, typename P>
__device__ __forceinline__ ChainOut warp_chain(
    const P& p, const ChainShifts sh, int mode, int rk, int ck, bool ha,
    bool hl, const Pix* sSrc, const int* sE, int* Tw0, int16_t* Lw0,
    Pix* Rw0, const int* dm, const int* smw, const Pix* X,
    unsigned long long* ws) {
  constexpr int NE = 4 * S + 1, N = S * S, TP = S + 1, LSTR = S + 2;
  constexpr int A = 1, L = 2 * S + 1;
  const int lane = threadIdx.x & 31;
  const int hf = lane / S, j = lane % S;
  const int* E = sE + hf * NE;
  const Pix* Sb = sSrc + hf * N;
  int* Tw = Tw0 + hf * S * TP;
  Pix* Rw = Rw0 + hf * N;
  int dcv = p.base;
  if (mode == 0) {                                     // DC: one tree
    int sa = E[A + j], sl = E[L + j];
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(FULL, sa, o);
      sl += __shfl_xor_sync(FULL, sl, o);
    }
    dcv = (ha && hl) ? (sa + sl + S) / (2 * S)
                     : ha ? (sa + S / 2) / S
                          : hl ? (sl + S / 2) / S : p.base;
  }
  // Column j of the prediction (kept in Rw until the reconstruction) and
  // of the residual (in Tw), one loop per predictor family so each is a
  // straight loop.
  __syncwarp();
  auto put = [&](int i, int pr) {
    Rw[i * S + j] = (Pix)pr;
    Tw[i * TP + j] = rshift_signed((int)Sb[i * S + j] - pr, sh.fwd_s0);
  };
  if (mode < 0) {                                      // inter lane
    const Pix* Xj = X + j;
#pragma unroll 8
    for (int i = 0; i < S; ++i) put(i, __ldg(Xj + i * S));
  } else if (mode == 0) {                              // DC
#pragma unroll 8
    for (int i = 0; i < S; ++i) put(i, dcv);
  } else if (mode <= 8) {                              // V, H, directional
    const int* dmj = dm + j;
#pragma unroll 8
    for (int i = 0; i < S; ++i) {
      const int m = dmj[i * S];
      const int i0 = m & 0xFF, i1 = (m >> 8) & 0xFF;
      const int shf = (m >> 16) & 0x3F;
      put(i, clampi((E[i0] * (32 - shf) + E[i1] * shf + 16) >> 5, 0,
                    p.pix_max));
    }
  } else if (mode == 12) {                             // PAETH
    const int top = E[A + j], tl = E[0];
#pragma unroll 8
    for (int i = 0; i < S; ++i) {
      const int left = E[L + i];
      const int pb = top + left - tl;
      const int p_t = abs(pb - top), p_l = abs(pb - left);
      const int p_tl = abs(pb - tl);
      put(i, (p_l <= p_t && p_l <= p_tl) ? left : (p_t <= p_tl ? top : tl));
    }
  } else {                                             // SMOOTH, _V, _H
    const int wj = smw[j], top = E[A + j];
    const int below = E[L + S - 1], right = E[A + S - 1];
#pragma unroll 8
    for (int i = 0; i < S; ++i) {
      const int wi = smw[i], left = E[L + i];
      const int v = (wi * top + (256 - wi) * below + 128) >> 8;
      const int hz = (wj * left + (256 - wj) * right + 128) >> 8;
      put(i, mode == 9 ? (wi * top + (256 - wi) * below + wj * left +
                          (256 - wj) * right + 256) >> 9
                       : mode == 10 ? v : hz);
    }
  }

  if (ws) ws[1] = gtime();
  // forward transform in place in Tw: pass 0 column j, pass 1 row j,
  // each network in registers
  int v[S];
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int base = pass ? j * TP : j, step = pass ? 1 : TP;
    const int s = pass ? sh.fwd_s2 : sh.fwd_s1;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = Tw[base + i * step];
    fwd_net<S>(v, pass, pass ? rk : ck);
#pragma unroll
    for (int i = 0; i < S; ++i) Tw[base + i * step] = rshift_signed(v[i], s);
  }

  // deadzone quantizer and normative dequantizer of row j, in place
  if (ws) ws[2] = gtime();
  int nnz = 0;
  float lbits = 0.f;
  int16_t* Lw = Lw0 + (hf * S + j) * LSTR;
  int* Trow = Tw + j * TP;
#pragma unroll 8
  for (int i = 0; i < S; ++i) {
    const int co = Trow[i];
    const bool dc = (j == 0 && i == 0);
    const int dqv = dc ? p.dqdc : p.dqac;
    const unsigned n = ((unsigned)abs(co) << sh.qshift) +
                       (unsigned)((dqv * 48) >> 7);
    const int lv = min((int)(((unsigned long long)n * (dc ? p.mdc : p.mac))
                             >> (dc ? p.sdc : p.sac)), (1 << 15) - 1);
    Lw[i] = (int16_t)(co < 0 ? -lv : lv);
    int dq = ((lv * dqv) & 0xFFFFFF) >> sh.qshift;
    dq = co < 0 ? -dq : dq;
    Trow[i] = clampi(dq, p.dq_lo, p.dq_hi);             // ±2^(bd+7)
    nnz += lv != 0;
    lbits = __fadd_rn(lbits, log2f(1.0f + (float)lv));
  }

  if (ws) ws[3] = gtime();
  // inverse transform in place: pass 0 row j (row network clamp, then the
  // row output clamp), pass 1 column j (column network clamp, then the
  // residual clamp); reconstruction
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int base = pass ? j : j * TP, step = pass ? TP : 1;
    const int s = pass ? sh.inv_s1 : sh.inv_s0;
    const int lo = pass ? p.res_lo : p.mid_lo;
    const int hi = pass ? p.res_hi : p.mid_hi;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = Tw[base + i * step];
    inv_net<S>(v, pass ? ck : rk, pass ? p.col_lo : p.row_lo,
               pass ? p.col_hi : p.row_hi);
#pragma unroll
    for (int i = 0; i < S; ++i)
      Tw[base + i * step] = clampi(rshift_signed(v[i], s), lo, hi);
  }
  if (ws) ws[4] = gtime();
  int sse = 0;
#pragma unroll 4
  for (int i = 0; i < S; ++i) {
    const int rec = clampi((int)Rw[i * S + j] + Tw[i * TP + j], 0,
                           p.pix_max);
    Rw[i * S + j] = (Pix)rec;
    const int d = (int)Sb[i * S + j] - rec;
    sse += d * d;
  }

  if (ws) ws[5] = gtime();
  // the block's sums, then its bit estimate
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) {
    sse += __shfl_xor_sync(FULL, sse, o);
    nnz += __shfl_xor_sync(FULL, nnz, o);
    lbits = __fadd_rn(lbits, __shfl_xor_sync(FULL, lbits, o));
  }
  const float fn = (float)nnz;
  float est;
  if (S >= 32)
    est = __fadd_rn(__fadd_rn(25.7f, __fmul_rn(2.43f, fn)),
                    __fmul_rn(1.83f, lbits));
  else
    est = __fadd_rn(__fadd_rn(16.2f, __fmul_rn(2.47f, fn)),
                    __fmul_rn(1.58f, lbits));
  return ChainOut{sse, nnz > 0 ? est : 1.0f};
}

// sse + lambda * (rate + residual bits), in this order.
__device__ __forceinline__ float rd_cost(ChainOut o, float lam, float rate) {
  return __fadd_rn((float)o.sse, __fmul_rn(lam, __fadd_rn(rate, o.rbits)));
}

}  // namespace
