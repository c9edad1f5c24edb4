// Flat intra wavefront: mode decision + reconstruction of a whole plane.
//
// Replaces the Pallas TPU kernel svtav1_tpu/pallas/wavefront_kernel.py
// (_make_kernel(...).kernel, launched by pl.pallas_call in
// _wavefront_pl_impl) and its XLA twin _wavefront_body in
// svtav1_tpu/encoder/wavefront.py.  Same function: for every block of the
// quad z-order wavefront, build the §7.11.2 edges from the boundary
// buffers (left rows clamped at valid_h), predict every candidate mode,
// run forward transform -> quantize -> dequantize -> inverse transform ->
// reconstruct, cost sse + lambda * (mode_rate + resid_bits), keep the
// first minimum (joint over each U/V pair when paired), update the
// boundary buffers.
//
// What bounds it on an H100: the schedule is 4 * nsteps dependent
// sub-steps (248 per 1080p plane), each with only B * D * C blocks of work
// (780 CTAs for luma at B = 4: 60 lanes x 13 candidates).  It is launch-
// and latency-bound, not FLOP- or byte-bound: a 32x32 block's whole chain
// is ~40 dependent shared-memory stages.
//
// What the design does about it: the TPU grid ran (step, candidate) in
// order with the boundary state and the running best in VMEM; here the
// step axis is a host loop and each sub-step is two launches on the
// caller's stream, with no host synchronisation in between:
//   wf_eval   grid (B*D lanes, C candidates), one CTA = one candidate of
//             one block, one thread per pixel, the whole integer chain in
//             shared memory; writes cost/levels/recon of every candidate
//             to scratch.
//   wf_select grid (B*D lanes): first-minimum over the candidates, writes
//             the winner into the final outputs and the boundary buffers.
// Every candidate of a sub-step runs in parallel (the TPU ran them in
// sequence), and invalid schedule lanes exit at once.  A persistent
// kernel or a CUDA graph of the launches is later work.
//
// Predictors are integer arithmetic: DC, SMOOTH* and PAETH directly, V, H
// and the six directional modes through per-(candidate, pixel) tables of
// (i0, i1, shift) into the edge array [corner, above_ext, left_ext].  The
// butterfly networks are the stage tables of
// svtav1_tpu.spec.txfm.compiled_stages; products are taken in 64 bits and
// narrowed, which equals the reference's int32 results (they never
// overflow for 8-bit input).  Floating-point steps of the RD cost use the
// _rn intrinsics so no multiply-add is contracted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXC = 16;     // candidates
constexpr int MAXST = 12;    // butterfly stages of one 1D network
constexpr int NNET = 6;      // fwd col DCT/ADST, fwd row DCT/ADST, inv DCT/ADST
constexpr int MODE_ADD_CLAMP = 0;
constexpr int MODE_BTF = 1;

}  // namespace

// Mirrored field by field by _Params in cuda/wavefront_kernel.py.
struct WfParams {
  const uint8_t* src;      // [B, h, w]
  int* rowbuf;             // [B, bh, w]  bottom row of each coded block
  int* colbuf;             // [B, h, bw]  right column of each coded block
  const int* sched;        // [S, D, 5]   r, c, valid, has_tr, has_bl
  const int* dirmap;       // [C, bs*bs]  i0 | i1 << 8 | shift << 16
  const int* smw;          // [bs]        smooth weights
  const int* stages;       // [NNET, MAXST, bs, 5] ia, wa, ib, wb, mode
  float* cost;             // [C, B*D]
  int16_t* lev_scr;        // [C, B*D, bs*bs]
  uint8_t* rec_scr;        // [C, B*D, bs*bs]
  int* mode_idx;           // [B, bh, bw]
  int* levels;             // [B, bh, bw, bs*bs]
  int* recon;              // [B, h, w]
  int s, D, B, h, w, bh, bw, vh, C, paired;
  int dqdc, dqac, qshift;
  int fwd_cos_col, fwd_cos_row, inv_cos, inv_clamp_row, inv_clamp_col;
  int fwd_s0, fwd_s1, fwd_s2, inv_s0, inv_s1;
  float lam;
  int nst[NNET];
  int cand_mode[MAXC];
  int cand_kind[MAXC];     // row kind | col kind << 1 (0 DCT, 1 ADST)
  float rate[MAXC];
};

namespace {

__device__ __forceinline__ int clampi(long long v, int lo, int hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// Round2 for s > 0, multiply by 2^-s for s < 0 (round_shift_array).
__device__ __forceinline__ int rshift_signed(int x, int s) {
  if (s > 0) return (x + (1 << (s - 1))) >> s;
  if (s < 0) return x * (1 << (-s));
  return x;
}

// One 1D network over the block held one value per thread.  COLS: the
// vector runs down a column (index = row), else along a row.  Double
// buffered in shared memory, one barrier per stage.
template <int BS, bool COLS>
__device__ int run_net(int v, int* buf, const int* net, int nst, int cos_bit,
                       int clamp_bit, int t, int pi, int pj) {
  constexpr int N = BS * BS;
  int cur = 0;
  buf[t] = v;
  __syncthreads();
  const int k = COLS ? pi : pj;
  const long long half = 1LL << (cos_bit - 1);
  const int lo = clamp_bit ? -(1 << (clamp_bit - 1)) : 0;
  const int hi = clamp_bit ? (1 << (clamp_bit - 1)) - 1 : 0;
  for (int st = 0; st < nst; ++st) {
    const int* e = net + (st * BS + k) * 5;
    const int ia = __ldg(e), wa = __ldg(e + 1), ib = __ldg(e + 2);
    const int wb = __ldg(e + 3), mode = __ldg(e + 4);
    const int* in = buf + cur * N;
    const int va = COLS ? in[ia * BS + pj] : in[pi * BS + ia];
    const int vb = COLS ? in[ib * BS + pj] : in[pi * BS + ib];
    const long long lin = (long long)wa * va + (long long)wb * vb;
    int o;
    if (mode == MODE_BTF)
      o = (int)((lin + half) >> cos_bit);
    else if (mode == MODE_ADD_CLAMP && clamp_bit)
      o = clampi(lin, lo, hi);
    else
      o = (int)lin;
    cur ^= 1;
    buf[cur * N + t] = o;
    __syncthreads();
  }
  return buf[cur * N + t];
}

// Block-wide sums (int, int, float) in a fixed tree order.
template <int BS>
__device__ void block_sums(int& a, int& b, float& f, int* red_i, float* red_f,
                           int t) {
  constexpr int NW = BS * BS / 32;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
    f = __fadd_rn(f, __shfl_down_sync(0xffffffffu, f, o));
  }
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    red_i[warp] = a;
    red_i[32 + warp] = b;
    red_f[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < NW ? red_i[lane] : 0;
    b = lane < NW ? red_i[32 + lane] : 0;
    f = lane < NW ? red_f[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
      f = __fadd_rn(f, __shfl_down_sync(0xffffffffu, f, o));
    }
  }
}

template <int BS>
__global__ void __launch_bounds__(BS * BS)
wf_eval_kernel(const WfParams p) {
  constexpr int N = BS * BS;
  constexpr int A = 1, L = 2 * BS + 1;   // above_ext[0], left_ext[0] in E
  const int l = blockIdx.x, c = blockIdx.y;
  const int b = l / p.D, i = l % p.D;
  const int* sc = p.sched + (p.s * p.D + i) * 5;
  if (!sc[2]) return;                    // invalid lane: no block
  const int r = sc[0], cb = sc[1], has_tr = sc[3], has_bl = sc[4];
  const int t = threadIdx.x, pi = t / BS, pj = t % BS;
  const int y = r * BS, x = cb * BS;

  __shared__ int E[4 * BS + 1];
  __shared__ int buf[2 * N];
  __shared__ int red_i[64];
  __shared__ float red_f[32];

  // ---- edges: E = [corner, above(BS), above-right(BS), left(BS),
  //      below-left(BS)] from the boundary buffers (§7.11.2)
  const int* rb = p.rowbuf + (size_t)b * p.bh * p.w;
  const int* cbf = p.colbuf + (size_t)b * p.h * p.bw;
  const bool ha = r > 0, hl = cb > 0;
  const int rm1 = max(r - 1, 0), cm1 = max(cb - 1, 0);
  const int base = 128;
  if (t < 4 * BS + 1) {
    auto above_real = [&](int j) { return rb[rm1 * p.w + x + j]; };
    auto left_real = [&](int j) {
      return cbf[min(y + j, p.vh - 1) * p.bw + cm1];
    };
    auto above_at = [&](int j) {
      return ha ? above_real(j) : (hl ? left_real(0) : base - 1);
    };
    auto left_at = [&](int j) {
      return hl ? left_real(j) : (ha ? above_real(0) : base + 1);
    };
    int v;
    if (t == 0) {
      v = (ha && hl) ? rb[rm1 * p.w + max(x - 1, 0)]
                     : (ha ? above_real(0) : (hl ? left_real(0) : base));
    } else if (t < L) {
      const int k = t - A;
      if (k < BS)
        v = above_at(k);
      else
        v = has_tr ? rb[rm1 * p.w + min(x + BS, p.w - BS) + (k - BS)]
                   : above_at(BS - 1);
    } else {
      const int k = t - L;
      if (k < BS)
        v = left_at(k);
      else
        v = has_bl ? cbf[min(min(y + BS, p.h - BS) + (k - BS), p.vh - 1) *
                             p.bw + cm1]
                   : left_at(BS - 1);
    }
    E[t] = v;
  }
  __syncthreads();

  // ---- prediction of candidate c at pixel (pi, pj)
  const int mode = p.cand_mode[c];
  int pred;
  if (mode == 0) {                                  // DC
    int sa = 0, sl = 0;
    for (int k = 0; k < BS; ++k) {
      sa += E[A + k];
      sl += E[L + k];
    }
    if (ha && hl)
      pred = (sa + sl + BS) / (2 * BS);
    else if (ha)
      pred = (sa + BS / 2) / BS;
    else if (hl)
      pred = (sl + BS / 2) / BS;
    else
      pred = base;
  } else if (mode <= 8) {                           // V, H, directional
    const int m = __ldg(p.dirmap + (size_t)c * N + t);
    const int i0 = m & 0xFF, i1 = (m >> 8) & 0xFF, sh = (m >> 16) & 0x3F;
    pred = min(max((E[i0] * (32 - sh) + E[i1] * sh + 16) >> 5, 0), 255);
  } else if (mode == 12) {                          // PAETH
    const int top = E[A + pj], left = E[L + pi], tl = E[0];
    const int pb = top + left - tl;
    const int p_t = abs(pb - top), p_l = abs(pb - left), p_tl = abs(pb - tl);
    pred = (p_l <= p_t && p_l <= p_tl) ? left : (p_t <= p_tl ? top : tl);
  } else {                                          // SMOOTH, _V, _H
    const int wh = __ldg(p.smw + pi), ww = __ldg(p.smw + pj);
    const int below = E[L + BS - 1], right = E[A + BS - 1];
    if (mode == 9)
      pred = (wh * E[A + pj] + (256 - wh) * below + ww * E[L + pi] +
              (256 - ww) * right + 256) >> 9;
    else if (mode == 10)
      pred = (wh * E[A + pj] + (256 - wh) * below + 128) >> 8;
    else
      pred = (ww * E[L + pi] + (256 - ww) * right + 128) >> 8;
  }

  // ---- forward transform (columns, then rows)
  const int srcpix = p.src[((size_t)b * p.h + y + pi) * p.w + x + pj];
  const int kind = p.cand_kind[c];
  const int rk = kind & 1, ck = (kind >> 1) & 1;
  const int* nets = p.stages;
  const int netsz = MAXST * BS * 5;
  int v = rshift_signed(srcpix - pred, p.fwd_s0);
  v = run_net<BS, true>(v, buf, nets + (0 + ck) * netsz, p.nst[0 + ck],
                        p.fwd_cos_col, 0, t, pi, pj);
  v = rshift_signed(v, p.fwd_s1);
  v = run_net<BS, false>(v, buf, nets + (2 + rk) * netsz, p.nst[2 + rk],
                         p.fwd_cos_row, 0, t, pi, pj);
  v = rshift_signed(v, p.fwd_s2);

  // ---- deadzone quantizer and normative dequantizer
  const int dqv = (t == 0) ? p.dqdc : p.dqac;
  const int scaled = abs(v) << p.qshift;
  const int lv = min((scaled + ((dqv * 48) >> 7)) / dqv, (1 << 15) - 1);
  const int lev = v < 0 ? -lv : lv;
  int dq = ((lv * dqv) & 0xFFFFFF) >> p.qshift;
  dq = v < 0 ? -dq : dq;
  dq = min(max(dq, -(1 << 15)), (1 << 15) - 1);     // ±2^(bd+7), bd = 8

  // ---- inverse transform (rows, then columns) and reconstruction
  int u = min(max(dq, -(1 << 15)), (1 << 15) - 1);  // bd + 8 bits
  u = run_net<BS, false>(u, buf, nets + (4 + rk) * netsz, p.nst[4 + rk],
                         p.inv_cos, p.inv_clamp_row, t, pi, pj);
  u = rshift_signed(u, p.inv_s0);
  u = min(max(u, -(1 << 15)), (1 << 15) - 1);       // max(bd + 6, 16) bits
  u = run_net<BS, true>(u, buf, nets + (4 + ck) * netsz, p.nst[4 + ck],
                        p.inv_cos, p.inv_clamp_col, t, pi, pj);
  u = rshift_signed(u, p.inv_s1);
  const int res_max = (1 << 15) - 1 + (914 << 1);
  u = min(max(u, -res_max - 1), res_max);
  const int rec = min(max(pred + u, 0), 255);

  // ---- RD cost
  const int d = srcpix - rec;
  int sse = d * d, nnz = lev != 0;
  float lbits = log2f(1.0f + (float)lv);
  block_sums<BS>(sse, nnz, lbits, red_i, red_f, t);
  const int BD = p.B * p.D;
  const size_t slot = ((size_t)c * BD + l) * N + t;
  p.lev_scr[slot] = (int16_t)lev;
  p.rec_scr[slot] = (uint8_t)rec;
  if (t == 0) {
    const float fn = (float)nnz;
    float est;
    if (BS >= 32)
      est = __fadd_rn(__fadd_rn(25.7f, __fmul_rn(2.43f, fn)),
                      __fmul_rn(1.83f, lbits));
    else
      est = __fadd_rn(__fadd_rn(16.2f, __fmul_rn(2.47f, fn)),
                      __fmul_rn(1.58f, lbits));
    const float rbits = nnz > 0 ? est : 1.0f;
    p.cost[(size_t)c * BD + l] =
        __fadd_rn((float)sse, __fmul_rn(p.lam, __fadd_rn(p.rate[c], rbits)));
  }
}

template <int BS>
__global__ void __launch_bounds__(BS * BS)
wf_select_kernel(const WfParams p) {
  constexpr int N = BS * BS;
  const int l = blockIdx.x;
  const int b = l / p.D, i = l % p.D;
  const int* sc = p.sched + (p.s * p.D + i) * 5;
  if (!sc[2]) return;
  const int r = sc[0], cb = sc[1];
  const int BD = p.B * p.D;
  int lu = l, lv = l;
  if (p.paired) {                 // U lanes in the first half of the batch
    const int hb = p.B / 2;
    lu = (b % hb) * p.D + i;
    lv = lu + hb * p.D;
  }
  float best = 0.f;
  int bi = 0;
  for (int cc = 0; cc < p.C; ++cc) {
    float v = p.cost[(size_t)cc * BD + lu];
    if (p.paired) v = __fadd_rn(v, p.cost[(size_t)cc * BD + lv]);
    if (cc == 0 || v < best) {    // first minimum
      best = v;
      bi = cc;
    }
  }
  const int t = threadIdx.x, pi = t / BS, pj = t % BS;
  const int y = r * BS, x = cb * BS;
  const size_t slot = ((size_t)bi * BD + l) * N + t;
  const int rec = p.rec_scr[slot];
  const size_t blk = ((size_t)b * p.bh + r) * p.bw + cb;
  if (t == 0) p.mode_idx[blk] = bi;
  p.levels[blk * N + t] = p.lev_scr[slot];
  p.recon[((size_t)b * p.h + y + pi) * p.w + x + pj] = rec;
  if (pi == BS - 1) p.rowbuf[((size_t)b * p.bh + r) * p.w + x + pj] = rec;
  if (pj == BS - 1) p.colbuf[((size_t)b * p.h + y + pi) * p.bw + cb] = rec;
}

}  // namespace

extern "C" {

int wf_params_size() { return (int)sizeof(WfParams); }

int wf_eval(const WfParams* p, int bs, void* stream) {
  const dim3 grid(p->B * p->D, p->C);
  cudaStream_t st = (cudaStream_t)stream;
  if (bs == 32)
    wf_eval_kernel<32><<<grid, 32 * 32, 0, st>>>(*p);
  else if (bs == 16)
    wf_eval_kernel<16><<<grid, 16 * 16, 0, st>>>(*p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int wf_select(const WfParams* p, int bs, void* stream) {
  const dim3 grid(p->B * p->D);
  cudaStream_t st = (cudaStream_t)stream;
  if (bs == 32)
    wf_select_kernel<32><<<grid, 32 * 32, 0, st>>>(*p);
  else if (bs == 16)
    wf_select_kernel<16><<<grid, 16 * 16, 0, st>>>(*p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
