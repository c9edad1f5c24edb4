// The flat path's edge strip: mode decision + reconstruction of the
// bottom SB row of a plane whose height leaves m = 12 valid mi rows there
// (encoder/edge.py has the rules and the plain PyTorch twin).  Per SB the
// chain codes the top-left and top-right big blocks (32x32 luma, 16x16
// chroma), then the four in-frame small blocks of the strip (16x16 luma,
// 8x8 chroma) left to right; the top-left block of each SB reads its
// below-left edge from the previous SB's strip, so the row is one
// dependent chain per frame (or U/V pair), with no parallelism across it.
//
// What bounds it.  A 3840-wide luma row is a chain of 360 blocks (120 big,
// 240 small) and its chroma the same, each a full candidate evaluation;
// the blocks of one frame cannot overlap, so the launch takes about 360
// times one block's latency, whatever the card's width.  The work is
// small (9.6e8 int32 operations a 4K luma batch of 4, 0.058 ms at the
// card's rate: edge_work() in cuda/edge_kernel.py) against 5.7-6.1 ms
// measured (PERF.md), so the kernel is latency-bound like the plane
// kernel, with one CTA per frame.
//
// Design: one CTA per unit (a luma frame, or a U/V pair when paired), one
// candidate a warp (looping when there are more candidates than warps),
// on the plane kernel's per-warp chain (csrc/wf_chain.cuh, which both
// kernels include): a lane owns a column of the block, the 1D networks
// of csrc/txfm_nets.cuh run in registers with one padded shared-memory
// transpose, the quantizer divides by a host reciprocal.  Only the
// chain's schedule is this file's.  Blocks of 16 (8) pixels put 2 (4)
// blocks on a warp's lanes: the U and V blocks of a pair in the first
// two, copies of the first in the rest (never written out).  The edges
// are read from the plane's recon, where the plane kernel left every SB
// row above and this CTA its own blocks (a __syncthreads orders each
// block's writes before the next block's reads).  The RD cost, its
// float32 association and the first-minimum rule are the plane kernel's,
// so the reference in benchmark/reference agrees bit for bit.  The
// winner's levels and recon are written from the slot of the warp that
// ran it; with more candidates than warps (angle deltas), a winner no
// longer in its warp's slot is run again by that warp first.

#include <cstdint>
#include <cuda_runtime.h>

#include "wf_chain.cuh"

namespace {

constexpr int EMAXC = 64;     // candidates: preset 0's 61
constexpr int EMAXW = 13;     // warps a CTA at most (the flat 13 modes)
constexpr int ECOLS = 6;      // block table: dy, x, small, tr, bl, out

}  // namespace

// Mirrored field by field by _EdgeParams in cuda/edge_kernel.py.  Arrays
// of two: [0] the big blocks (32 luma, 16 chroma), [1] the small ones.
struct EdgeParams {
  const void* src;         // [B, h, w] pixels (uint8 or uint16)
  int* recon;              // [B, h, w] the plane's recon, read and written
  int* mode_idx;           // [B, bh, bw] the plane's modes
  int* levels;             // [B, bh, bw, big*big]
  int* e_mode;             // [B, n] the strip's modes
  int* e_lev;              // [B, n, small*small]
  const int* blocks;       // [nblk, ECOLS] the chain in coding order
  const int* dirmap0;      // [C, big*big] i0 | i1 << 8 | shift << 16
  const int* dirmap1;      // [C, small*small]
  const int* smw0;         // [big] smooth weights
  const int* smw1;         // [small]
  unsigned long long mdc, mac;   // reciprocals of the dc/ac steps
  int sdc, sac;                  // and their shifts
  int B, NU, h, w, bh, bw, vh, C, paired, nblk, n, big, nw;
  int dqdc, dqac;
  int qshift[2], fwd_s0[2], fwd_s1[2], fwd_s2[2], inv_s0[2], inv_s1[2];
  int base, pix_max;
  int dq_lo, dq_hi, row_lo, row_hi, mid_lo, mid_hi, col_lo, col_hi;
  int res_lo, res_hi;
  float lam;
  int cand_mode[EMAXC];
  int cand_kind[2 * EMAXC];      // [2][C] row kind | col kind << 1
  float rate[EMAXC];
};

namespace {

// Shared memory, sized for the largest block (32x32, one a warp) and laid
// out per warp: transpose tile [32][33] ints, levels [32][34] int16,
// recon [1024] pixels; then the source [1024] pixels, the edges [4][33]
// ints (4 * (4S + 1) <= 132 for every S), the costs [4][EMAXC] floats.
constexpr int T_INTS = 32 * 33;
constexpr int LEV_ELEMS = 32 * 34;
constexpr int E_INTS = 4 * 33;

template <typename Pix>
size_t edge_smem(int nw) {
  return (size_t)nw * (T_INTS * 4 + LEV_ELEMS * 2 + 1024 * sizeof(Pix)) +
         1024 * sizeof(Pix) + E_INTS * 4 + 4 * EMAXC * 4 + 16;
}

// Frame of half hf of unit u: U (or the luma frame) in half 0, V of a
// pair in half 1, copies of half 0 past those.
__device__ __forceinline__ int half_frame(const EdgeParams& p, int u,
                                          int hf) {
  return (hf == 1 && p.paired) ? u + p.NU : u;
}

// Value q of the edge array of frame f's block (y, x) of size S, from
// the recon (encoder/edge.py _edge).
template <int S>
__device__ int edge_at(const EdgeParams& p, int f, int y, int x,
                       int has_tr, int has_bl, int q) {
  const int* R = p.recon + (size_t)f * p.h * p.w;
  auto above = [&](int k) {
    return R[(size_t)(y - 1) * p.w +
             (k < S ? x + k : min(x + S, p.w - S) + k - S)];
  };
  auto left = [&](int k) {
    return R[(size_t)min(k < S ? y + k : min(y + S, p.h - S) + k - S,
                         p.vh - 1) * p.w + x - 1];
  };
  return edge_of<S>(q, y > 0, x > 0, has_tr && y > 0, has_bl && x > 0,
                    p.base, above, left);
}

// One warp runs candidate c on the block (y, x) of size S held in sSrc
// and sE (32 / S halves on the warp's lanes; csrc/wf_chain.cuh); its
// prediction-then-recon goes to Rw, its levels to Lw.  Returns the lane's
// cost (half 0's lanes: the pair's sum when paired).
template <int S, typename Pix>
__device__ float run_cand(const EdgeParams& p, int c, int sz, int y, int x,
                          const Pix* sSrc, const int* sE, int* Tw,
                          int16_t* Lw, Pix* Rw, const int* dirmap,
                          const int* smw) {
  const int kind = p.cand_kind[sz * EMAXC + c];
  const ChainOut o = warp_chain<S, Pix>(
      p, ChainShifts{p.qshift[sz], p.fwd_s0[sz], p.fwd_s1[sz], p.fwd_s2[sz],
                     p.inv_s0[sz], p.inv_s1[sz]},
      p.cand_mode[c], kind & 1, (kind >> 1) & 1, y > 0, x > 0, sSrc, sE, Tw,
      Lw, Rw, dirmap + (size_t)c * S * S, smw, nullptr, nullptr);
  float cost = rd_cost(o, p.lam, p.rate[c]);
  const float other = __shfl_sync(FULL, cost, S);
  if (p.paired) cost = __fadd_rn(cost, other);
  __syncwarp();
  return cost;
}

// One block of the chain: load, edges, every candidate, first minimum,
// write-out.  sz: 0 big, 1 small.
template <int S, typename Pix>
__device__ void run_block(const EdgeParams& p, int u, int sz, int y, int x,
                          int has_tr, int has_bl, int out,
                          unsigned char* smem) {
  constexpr int H = 32 / S, NE = 4 * S + 1, N = S * S, LSTR = S + 2;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = p.nw;
  int* sT = reinterpret_cast<int*>(smem);
  int16_t* sLev = reinterpret_cast<int16_t*>(sT + nw * T_INTS);
  Pix* sRec = reinterpret_cast<Pix*>(sLev + nw * LEV_ELEMS);
  Pix* sSrc = sRec + nw * 1024;
  int* sE = reinterpret_cast<int*>(sSrc + 1024);
  float* sCost = reinterpret_cast<float*>(sE + E_INTS);    // [4][EMAXC]
  const Pix* src = static_cast<const Pix*>(p.src);
  const int* dirmap = sz ? p.dirmap1 : p.dirmap0;
  const int* smw = sz ? p.smw1 : p.smw0;

  for (int e = tid; e < H * N; e += nthr) {
    const int f = half_frame(p, u, e / N), q = e % N;
    sSrc[e] = src[((size_t)f * p.h + y + q / S) * p.w + x + q % S];
  }
  for (int e = tid; e < H * NE; e += nthr)
    sE[e] = edge_at<S>(p, half_frame(p, u, e / NE), y, x, has_tr, has_bl,
                       e % NE);
  __syncthreads();

  int mine = -1;                  // the candidate in this warp's slot
  int* Tw = sT + warp * T_INTS;
  int16_t* Lw = sLev + warp * LEV_ELEMS;
  Pix* Rw = sRec + warp * 1024;
  for (int c = warp; c < p.C; c += nw) {
    const float cost = run_cand<S, Pix>(p, c, sz, y, x, sSrc, sE, Tw, Lw, Rw,
                                        dirmap, smw);
    if (lane % S == 0) sCost[(lane / S) * EMAXC + c] = cost;
    mine = c;
  }
  __syncthreads();

  // the first minimum of half 0's costs (a pair's sum when paired)
  int best = 0;
  float bv = sCost[0];
  for (int cc = 1; cc < p.C; ++cc)
    if (sCost[cc] < bv) {
      bv = sCost[cc];
      best = cc;
    }
  // the real halves: U and V of a pair, else the frame alone
  const int real = p.paired ? 2 : 1;
  // the warp that ran the winner writes it out, from its slot, running
  // it again first where a later candidate took the slot
  const int home = best % nw;
  if (warp == home && mine != best)
    run_cand<S, Pix>(p, best, sz, y, x, sSrc, sE, Tw, Lw, Rw, dirmap, smw);
  __syncthreads();
  const int16_t* Lh = sLev + home * LEV_ELEMS;
  const Pix* Rh = sRec + home * 1024;
  const int bh = p.bh;
  for (int e = tid; e < real * N; e += nthr) {
    const int hh = e / N, q = e % N, i = q / S, jj = q % S;
    const int f = half_frame(p, u, hh);
    p.recon[((size_t)f * p.h + y + i) * p.w + x + jj] = Rh[hh * N + q];
    const int lv = Lh[(hh * S + i) * LSTR + jj];
    if (out >= 0) {
      const size_t blk = ((size_t)f * bh + bh - 2) * p.bw + out;
      p.levels[blk * N + q] = lv;
      if (q == 0) p.mode_idx[blk] = best;
    } else {
      const size_t k = (size_t)f * p.n + (-1 - out);
      p.e_lev[k * N + q] = lv;
      if (q == 0) p.e_mode[k] = best;
    }
  }
  __syncthreads();
}

template <typename Pix>
__global__ void __launch_bounds__(32 * EMAXW, 1)
wf_edge_kernel(const EdgeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int u = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int big = p.big, bh = p.bh, bw = p.bw;
  const int nf = p.paired ? 2 : 1;
  // what lies below the frame and the split blocks' plane outputs: zeros
  for (int hh = 0; hh < nf; ++hh) {
    const int f = half_frame(p, u, hh);
    for (int e = tid; e < (p.h - p.vh) * p.w; e += nthr)
      p.recon[((size_t)f * p.h + p.vh) * p.w + e] = 0;
    for (int e = tid; e < bw; e += nthr)
      p.mode_idx[((size_t)f * bh + bh - 1) * bw + e] = 0;
    for (int e = tid; e < bw * big * big; e += nthr)
      p.levels[((size_t)f * bh + bh - 1) * bw * big * big + e] = 0;
  }
  __syncthreads();
  const int y0 = p.h - 2 * big;
  for (int k = 0; k < p.nblk; ++k) {
    const int* bl = p.blocks + k * ECOLS;
    const int y = y0 + bl[0], x = bl[1], small = bl[2];
    const int S = small ? big / 2 : big;
    if (S == 32)
      run_block<32, Pix>(p, u, small, y, x, bl[3], bl[4], bl[5], smem);
    else if (S == 16)
      run_block<16, Pix>(p, u, small, y, x, bl[3], bl[4], bl[5], smem);
    else
      run_block<8, Pix>(p, u, small, y, x, bl[3], bl[4], bl[5], smem);
  }
}

template <typename Pix>
int edge_launch(const EdgeParams* p, cudaStream_t st) {
  const size_t smem = edge_smem<Pix>(p->nw);
  cudaError_t e = cudaFuncSetAttribute(
      wf_edge_kernel<Pix>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wf_edge_kernel<Pix><<<p->NU, 32 * p->nw, smem, st>>>(*p);
  return (int)cudaGetLastError();
}

template <typename Pix>
int edge_info(int nw, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, wf_edge_kernel<Pix>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)edge_smem<Pix>(nw);
  return 0;
}

}  // namespace

extern "C" {

int wf_edge_params_size() { return (int)sizeof(EdgeParams); }

// One chain launch (one CTA a unit) of bd-bit pixels on the caller's
// stream.
int wf_edge(const EdgeParams* p, int bd, void* stream) {
  if (p->C < 1 || p->C > EMAXC || p->nw < 1 || p->nw > EMAXW ||
      (p->big != 32 && p->big != 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bd == 8) return edge_launch<uint8_t>(p, st);
  if (bd == 10) return edge_launch<uint16_t>(p, st);
  return (int)cudaErrorInvalidValue;
}

// Registers per thread, local (spill) bytes per thread and dynamic
// shared bytes per CTA of the bd form with nw warps.
int wf_edge_info(int bd, int nw, int* out) {
  if (bd == 8) return edge_info<uint8_t>(nw, out);
  if (bd == 10) return edge_info<uint16_t>(nw, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
