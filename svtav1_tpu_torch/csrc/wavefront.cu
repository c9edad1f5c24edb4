// Flat wavefront: mode decision + reconstruction of a whole plane, as one
// persistent dataflow launch per plane call.
//
// Replaces the Pallas TPU kernel svtav1_tpu/pallas/wavefront_kernel.py
// (_make_kernel(...).kernel, launched by pl.pallas_call in
// _wavefront_pl_impl) and its XLA twin _wavefront_body in
// svtav1_tpu/encoder/wavefront.py, with that twin's n_extra inter lanes.
// Same function: for every block of the quad z-order wavefront, build the
// §7.11.2 edges from the boundary buffers (left rows clamped at valid_h),
// predict every intra candidate, run forward transform -> quantize ->
// dequantize -> inverse transform -> reconstruct, cost sse + lambda *
// (mode_rate + resid_bits), keep the first minimum (joint over each U/V
// pair when paired), update the boundary buffers.
//
// Bit depth: one form per pixel type, uint8_t for 8-bit planes and
// uint16_t for 10-bit ones (the source, the inter lanes' predictions and
// the shared prediction / reconstruction tiles).  Every bd-dependent
// constant (mid-grey edge base, pixel maximum, dequantizer clamp, the
// inverse transform's row and column network clamps, its row-output and
// residual clamps) comes from the host in WfParams, computed there from
// the port's ops/transforms.py at bd (tx_params in cuda/wavefront_kernel.py).
//
// Inter lanes (the flat P frame): candidates NI..C-1 run the same chain
// with DCT_DCT on a prediction the caller made (motion compensation): the
// kernel reads it per ticket from global memory as pixels (MC output is
// clipped to [0, 2^bd - 1], so the plain version's int32 holds the same
// values) and never predicts or clips it again.  Each lane's rate is its
// own a block (xrate), not the candidate table's; a candidate whose mask
// (xok for a lane, iok for the intra candidates) is false costs 3e38.
// Unpaired 16x16 calls put two frames in one warp, independent of each
// other: frame u in lanes 0-15 and frame u + NU in lanes 16-31, each half
// with its own first minimum (U and V of a P frame in one launch).
//
// What bounds it on an H100.  The operations: ~106 int32 operations per
// pixel and candidate (the four 1D networks counted from their stage
// tables, plus prediction, quantizer and reconstruction; work() in
// cuda/wavefront_kernel.py): 1.15e10 for a 1080p luma batch of 4 (13
// candidates), 0.69 ms at the card's 16.7 Tops/s of int32 (64 lanes x
// 132 SMs x 1.98 GHz).  The bytes (source in, levels and recon out,
// 75 MB) take 0.02 ms.  But a plane is a chain of ~200 dependent blocks
// (the wavefront's sub-steps), so what one block takes from its last
// neighbour's flag to its own flag, times ~200, is what the plane takes:
// the kernel is bound by that latency, not by the ALUs.
//
// What the design does about it:
//   * One persistent launch per plane call, no host step loop.  The host
//     lists the blocks once, in the wavefront's sub-step order (a
//     topological order of the dependencies), with the raster ids of the
//     blocks whose boundary pixels each one reads.  A ticket (block k of
//     unit u = frame or U/V pair) is taken with atomicAdd; the source
//     block is loaded, then the CTA waits with acquire loads on the ready
//     flags of exactly those neighbours, computes the block and publishes
//     its own flag with a release store.  Tickets go out in topological
//     order and only running CTAs take them, so every flag waited on
//     belongs to a running CTA or a finished block: no deadlock.  Frames
//     of a batch and lanes of a diagonal run ahead on their own.  The
//     boundary buffers are write-once per cell, so there is no
//     write-after-read hazard; they are read with ld.global.cg (L2, never
//     a stale L1 line).  A wait longer than SPIN_CAP polls sets the sticky
//     error word; the launch then runs to its end without waiting and the
//     host raises.
//   * All candidates of a block at once, one candidate a warp, on one
//     thread block cluster, select fused.  The host decides the geometry
//     (launch_geometry and warp_map in cuda/wavefront_kernel.py) and
//     passes it in WfParams: clusters of K CTAs of wpc warps, the
//     candidate warp w of CTA rank runs (cand, w * K + rank) and the
//     rank and warp that ran each candidate (home).  K is 4 up to 16
//     candidates (13 intra, 13 + 2 inter lanes, a P frame's 2 chroma
//     candidates on 1 warp a CTA; 4 measured faster than clusters of 1
//     or 2 at every 1080p shape, PERF.md), 8 up to 32 and 16 up to 64
//     (a non-portable cluster size); for 16x16 chroma lanes 0-15 hold the
//     U block and lanes 16-31 the V block of a pair, so the paired cost is
//     one shuffle.  Costs meet through distributed shared memory after
//     one cluster barrier; every CTA takes the first minimum in candidate
//     order (strict <; half 0's cost, the pair's sum, for a U/V pair),
//     and the CTA that ran the winner writes its boundary row and column
//     from the slot of the warp that ran it, publishes the flag, then
//     writes levels and recon from shared memory.  No global candidate
//     scratch.
//   * Angle deltas (presets 0-5; the flat path with deltas, which the JAX
//     package runs on the XLA twin, not the Pallas kernel): 29 candidates
//     (preset 4) on 8 CTAs of 4 warps, 61-64 (preset 0, with a flat P
//     frame's 2 inter lanes) on 16.  A block's latency is then one
//     candidate chain and two cluster barriers, as with 13 candidates.
//     Measured at 1x1088x1920 (probe_wavefront --deltas, PERF.md): 61
//     candidates 4.44 ms on 16x4 against 4.92 ms on 8 CTAs of 8 warps
//     (with MAXW = 8, a 256-thread launch bound: two busy warps a
//     scheduler slow the chain by 10%) and 12.4 ms for
//     the earlier layout, which looped each of 16 warps over up to 4
//     candidates with a best-so-far slot; 29 candidates 3.90 ms on 8x4,
//     3.85 on 8x8 (within noise, twice the shared memory and half the
//     resident clusters), 4.22 on 16x2 and 4.52 on 4x8.  The 16-wide
//     barriers cost ~1.0 us (the ticket) and ~2.5 us (the cost exchange,
//     the slowest warp included) of a ~23 us link; 4 CTAs of 16 warps
//     would cap every form at 128 registers and was not tried.
//   * Transforms in registers: a lane owns one column of 32 (16) values,
//     runs the 1D network as straight-line code (csrc/txfm_nets.cuh,
//     generated from spec.txfm.compiled_stages), goes through one
//     transpose in padded shared memory ([n][n+1] ints, __syncwarp only,
//     conflict-free) and then owns one row.  The per-pixel phases
//     (prediction, quantizer, reconstruction) are loops, and each network
//     is inlined once for both passes: fully unrolled, the code did not
//     fit the instruction cache (10.3k SASS instructions, a warp at ~5
//     cycles per instruction).  The deadzone division is a multiply by a
//     host-computed reciprocal (exact for every dividend below 2^31).  DC
//     sums its edges once per block with a shuffle tree.  The predictor
//     maps live in shared memory: an acquire load invalidates L1, so read
//     from global they came from L2 for every block.
//   * Not used: wgmma (the transforms round after every butterfly stage,
//     so they are not a matrix product, and a tensor-core product would
//     not be bit-exact); TMA (a block's source is 1 KB; it is loaded
//     before the flag wait instead, with plain loads, and a cp.async
//     prefetch of the next ticket's source was not tried).
//   * Resources (wf_info and -Xptxas -v, printed by chip_smoke.py; H100):
//     128 registers a thread at 32x32, 142 (8-bit) and 158 (10-bit) at
//     16x16, no spills; 4 warps a CTA (1 for the P frame's 2 chroma
//     candidates), one level / recon slot, transpose tile and predictor
//     map a warp: 47.6 KB of shared memory a luma CTA at 8 bits, 52.6 KB
//     at 10 (4 CTAs an SM whatever the candidate count), 21.1 KB for 13
//     chroma candidates (3 an SM).  Clusters resident at once: 124 of 4
//     luma CTAs, 62 of 8, 28 of 16 (a diagonal holds 10-17 ready blocks).
//
// Predictors are integer arithmetic: DC, SMOOTH* and PAETH directly, V, H
// and the six directional modes through per-(candidate, pixel) tables of
// (i0, i1, shift) into the edge array [corner, above_ext, left_ext].
// Floating-point steps of the RD cost use the _rn intrinsics so no
// multiply-add is contracted.

#include <algorithm>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "txfm_nets.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAXC = 64;      // candidates: preset 0's 61 + 2 inter lanes
constexpr int MAXK = 16;      // CTAs a cluster at most (non-portable > 8)
constexpr int MAXW = 4;       // warps a CTA at most
constexpr int MAXDEP = 8;     // neighbours one block waits on
constexpr int BLKCOLS = 4 + MAXDEP;
constexpr int SPIN_CAP = 1 << 22;
constexpr int ERR_SPIN = 1;
constexpr int TRACE_COLS = 16;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field by field by _Params in cuda/wavefront_kernel.py.
struct WfParams {
  const void* src;         // [B, h, w] pixels (uint8 or uint16)
  int* rowbuf;             // [B, bh, w]  bottom row of each coded block
  int* colbuf;             // [B, h, bw]  right column of each coded block
  const int* blocks;       // [nblk, BLKCOLS] ticket order: r, c, has_tr,
                           //   has_bl, raster ids of the deps (-1 pad)
  const int* dirmap;       // [C, bs*bs]  i0 | i1 << 8 | shift << 16
  const int* smw;          // [bs]        smooth weights
  int* sync;               // [1 + NU*nblk] ticket counter, ready flags
  int* err;                // [1] sticky error word
  int* mode_idx;           // [B, bh, bw]
  int* levels;             // [B, bh, bw, bs*bs]
  int* recon;              // [B, h, w]
  unsigned long long* trace;     // [NU*nblk, 16] or null: see launch()
  const void* xpred;       // [B, nE, bh, bw, bs*bs] inter lanes (pixels),
                           //   or null
  const float* xrate;      // [B, nE, bh, bw] their rates (bits)
  const uint8_t* xok;      // [B, nE, bh, bw] their masks
  const uint8_t* iok;      // [B, bh, bw] intra mask, or null (all allowed)
  unsigned long long mdc, mac;   // reciprocals of the dc/ac steps
  int sdc, sac;                  // and their shifts
  int B, NU, h, w, bh, bw, vh, C, paired, nblk;
  int NI, nE;              // intra candidates, inter lanes (C = NI + nE)
  int dqdc, dqac, qshift;
  int fwd_s0, fwd_s1, fwd_s2, inv_s0, inv_s1;
  int base, pix_max;       // 1 << (bd - 1), (1 << bd) - 1
  int dq_lo, dq_hi;        // dequantizer = inverse input clamp
  int row_lo, row_hi;      // row (pass 0) network clamp
  int mid_lo, mid_hi;      // row output clamp
  int col_lo, col_hi;      // column (pass 1) network clamp
  int res_lo, res_hi;      // residual clamp
  float lam;
  int K, wpc;              // launch: clusters of K CTAs of wpc warps
  int cand[MAXK * MAXW];   // [rank][warp] the candidate it runs, or -1
  int home[MAXC];          // candidate c's rank | warp << 8
  int cand_mode[MAXC];     // intra mode, or -1 for an inter lane
  int cand_kind[MAXC];     // row kind | col kind << 1 (0 DCT, 1 ADST)
  float rate[MAXC];
};

namespace {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
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

#define WF_HD __host__ __device__ constexpr
template <int BS> WF_HD int halves() { return 32 / BS; }
template <int BS> WF_HD int n_edge() { return 4 * BS + 1; }
template <int BS> WF_HD int t_ints() { return halves<BS>() * BS * (BS + 1); }
// int16 row stride of a candidate's levels: conflict-free row writes
template <int BS> WF_HD int lev_stride() { return BS + 2; }
template <int BS> WF_HD int lev_elems() {
  return halves<BS>() * BS * lev_stride<BS>();
}
template <int BS> WF_HD int rec_elems() { return halves<BS>() * BS * BS; }
#undef WF_HD

// Shared bytes of a CTA of `wpc` candidate warps: one transpose tile,
// level and recon slot and predictor map a warp.
template <int BS, typename Pix>
size_t smem_bytes(int wpc) {
  constexpr size_t rec_bytes = rec_elems<BS>() * sizeof(Pix);
  return (size_t)wpc * (t_ints<BS>() * 4 + lev_elems<BS>() * 2 + rec_bytes +
                        BS * BS * 4) +
         rec_bytes + halves<BS>() * n_edge<BS>() * 4 + 4 * MAXC * 4 + 8 +
         BS * 4;
}

// One value of the edge array E = [corner, above(BS), above-right(BS),
// left(BS), below-left(BS)] of frame f's block (r, cb) (§7.11.2).
template <int BS>
__device__ int edge_value(const WfParams& p, int f, int r, int cb,
                          int has_tr, int has_bl, int q) {
  constexpr int A = 1, L = 2 * BS + 1;
  const int* rb = p.rowbuf + (size_t)f * p.bh * p.w;
  const int* cbf = p.colbuf + (size_t)f * p.h * p.bw;
  const bool ha = r > 0, hl = cb > 0;
  const int rm1 = max(r - 1, 0), cm1 = max(cb - 1, 0);
  const int y = r * BS, x = cb * BS;
  const int base = p.base;
  auto above_real = [&](int j) { return __ldcg(rb + rm1 * p.w + x + j); };
  auto left_real = [&](int j) {
    return __ldcg(cbf + min(y + j, p.vh - 1) * p.bw + cm1);
  };
  auto above_at = [&](int j) {
    return ha ? above_real(j) : (hl ? left_real(0) : base - 1);
  };
  auto left_at = [&](int j) {
    return hl ? left_real(j) : (ha ? above_real(0) : base + 1);
  };
  if (q == 0)
    return (ha && hl) ? __ldcg(rb + rm1 * p.w + max(x - 1, 0))
                      : (ha ? above_real(0) : (hl ? left_real(0) : base));
  if (q < L) {
    const int k = q - A;
    if (k < BS) return above_at(k);
    return has_tr ? __ldcg(rb + rm1 * p.w + min(x + BS, p.w - BS) + (k - BS))
                  : above_at(BS - 1);
  }
  const int k = q - L;
  if (k < BS) return left_at(k);
  return has_bl ? __ldcg(cbf + min(min(y + BS, p.h - BS) + (k - BS),
                                   p.vh - 1) * p.bw + cm1)
                : left_at(BS - 1);
}

// Forward network of pass 0 (columns) or 1 (rows); 32x32 has one, its
// column and row cos bits being equal.
template <int BS>
__device__ __forceinline__ void fwd_net(int* v, int pass, int kind) {
  if constexpr (BS == 32) net_fwd_dct32(v);
  else if (pass) {
    if (kind) net_fwd_row_adst16(v);
    else net_fwd_row_dct16(v);
  } else {
    if (kind) net_fwd_col_adst16(v);
    else net_fwd_col_dct16(v);
  }
}

template <int BS>
__device__ __forceinline__ void inv_net(int* v, int kind, int lo, int hi) {
  if constexpr (BS == 32) net_inv_dct32(v, lo, hi);
  else if (kind) net_inv_adst16(v, lo, hi);
  else net_inv_dct16(v, lo, hi);
}

template <int BS, typename Pix>
__global__ void __launch_bounds__(32 * MAXW, 1)
wf_plane_kernel(const WfParams p) {
  constexpr int H = halves<BS>(), NE = n_edge<BS>(), N = BS * BS;
  constexpr int A = 1, L = 2 * BS + 1, TP = BS + 1, LSTR = lev_stride<BS>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x, wpc = nthr >> 5;
  int* sT = reinterpret_cast<int*>(smem);                // [wpc][H][BS][TP]
  // [wpc] levels and recons, one slot a warp
  int16_t* sLev = reinterpret_cast<int16_t*>(sT + wpc * t_ints<BS>());
  constexpr int RE = rec_elems<BS>();
  Pix* sRec = reinterpret_cast<Pix*>(sLev + wpc * lev_elems<BS>());
  Pix* sSrc = sRec + wpc * RE;                              // [H][BS][BS]
  int* sE = reinterpret_cast<int*>(sSrc + RE);              // [H][NE]
  const Pix* src = static_cast<const Pix*>(p.src);
  float* sCost = reinterpret_cast<float*>(sE + H * NE);  // [2][C], own
  float* sAll = sCost + 2 * MAXC;                    // [2][C], gathered
  int* sMisc = reinterpret_cast<int*>(sAll + 2 * MAXC);  // ticket, pad
  int* sDir = sMisc + 2;                 // [wpc][N] the warps' pred maps
  int* sSmw = sDir + wpc * N;            // [BS] smooth weights

  // the cluster's CTAs share each ticket: warp `warp` of CTA `rank` runs
  // candidate p.cand[rank][warp] (or none), so every candidate of a block
  // runs at once; rank 0 takes the tickets
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int warp = tid >> 5, lane = tid & 31;
  const int c = p.cand[rank * MAXW + warp];  // this warp's candidate, or -1
  const int hf = lane / BS, j = lane % BS;   // this lane's block and column
  const int ntick = p.NU * p.nblk;
  volatile int* verr = p.err;
  int* counter = p.sync;
  int* flags = p.sync + 1;

  // The predictor tables go to shared memory once: every acquire load of
  // a ready flag invalidates L1, so read from global they would come
  // from L2 for every block.
  for (int e = tid; e < wpc * N; e += nthr) {
    const int cc = p.cand[rank * MAXW + e / N];
    sDir[e] = cc >= 0 ? __ldg(p.dirmap + (size_t)cc * N + e % N) : 0;
  }
  for (int e = tid; e < BS; e += nthr) sSmw[e] = __ldg(p.smw + e);
  __syncthreads();

  const bool lead = tid == 0 && rank == 0;
  for (;;) {
    const unsigned long long top = p.trace && lead ? gtime() : 0;
    if (lead) {
      const int t = atomicAdd(counter, 1);
      sMisc[0] = *verr ? ntick : t;
    }
    cl.sync();
    const int t = *cl.map_shared_rank(sMisc, 0);
    if (t >= ntick) break;
    unsigned long long* tr =
        p.trace ? p.trace + (size_t)t * TRACE_COLS : nullptr;
    if (tr && lead) {
      tr[0] = gtime();
      tr[12] = top;
    }
    const int k = t / p.NU, u = t % p.NU;
    const int* bl = p.blocks + k * BLKCOLS;
    const int r = bl[0], cb = bl[1], has_tr = bl[2], has_bl = bl[3];
    const int y = r * BS, x = cb * BS;
    // 16x16: unit u holds frames u (lanes 0-15) and u + NU (lanes 16-31;
    // a paired batch's U and V).  Past the batch, the upper half repeats
    // frame u and is never written out.
    const int fr1 = (H == 2 && u + p.NU < p.B) ? u + p.NU : u;
    const bool real1 = fr1 != u;
    const int need = 1 + real1;     // halves that publish a block's flag

    // the source block(s), loaded before the wait, in 4-byte words
    constexpr int WPR = BS * (int)sizeof(Pix) / 4;     // words a row
    for (int e = tid; e < H * BS * WPR; e += nthr) {
      const int hh = e / (BS * WPR), q = e % (BS * WPR);
      const int f = hh ? fr1 : u;
      const uint32_t* s = reinterpret_cast<const uint32_t*>(
          src + ((size_t)f * p.h + y + q / WPR) * p.w + x) + q % WPR;
      reinterpret_cast<uint32_t*>(sSrc)[e] = __ldg(s);
    }
    // wait for the blocks whose boundary pixels this one reads.  Past
    // the cap (or once another CTA has set the error word) it stops
    // waiting and runs on with whatever the buffers hold, so every CTA of
    // the cluster reaches the same barriers and the launch ends; the
    // next ticket it takes ends the loop.
    if (tid < MAXDEP) {
      const int d = bl[4 + tid];
      if (d >= 0) {
        const int* fl = flags + (size_t)u * p.nblk + d;
        int it = 0;
        while (ld_acquire(fl) < need && !*verr) {
          if (++it > SPIN_CAP) {
            atomicOr(p.err, ERR_SPIN);
            break;
          }
          __nanosleep(64);
        }
      }
    }
    __syncthreads();
    if (tr && lead) tr[1] = gtime();
    for (int e = tid; e < H * NE; e += nthr)
      sE[e] = edge_value<BS>(p, e < NE ? u : fr1, r, cb, has_tr, has_bl,
                             e % NE);
    __syncthreads();

    // ---- warp `warp`: candidate c of the block(s), its levels and recon
    // in the warp's slot; per-phase stamps of one warp (warp 1 of rank 0)
    // in trace[4..10]
    unsigned long long* ws = (tr && rank == 0 && warp == 1 && lane == 0)
                                 ? tr + 4 : nullptr;
    if (ws) ws[0] = gtime();
    if (c >= 0) {
      const int mode = p.cand_mode[c], kind = p.cand_kind[c];
      const int rk = kind & 1, ck = (kind >> 1) & 1;
      const int* E = sE + hf * NE;
      const Pix* S = sSrc + hf * N;
      const int fr = hf ? fr1 : u;                     // this lane's frame
      const size_t bix = ((size_t)fr * p.bh + r) * p.bw + cb;
      const size_t xix = (((size_t)fr * p.nE + (c - p.NI)) * p.bh + r) *
                         p.bw + cb;                    // inter lanes only
      const bool ha = r > 0, hl = cb > 0;
      int dcv = p.base;
      if (mode == 0) {                                 // DC: one tree
        int sa = E[A + j], sl = E[L + j];
#pragma unroll
        for (int o = BS / 2; o > 0; o >>= 1) {
          sa += __shfl_xor_sync(FULL, sa, o);
          sl += __shfl_xor_sync(FULL, sl, o);
        }
        dcv = (ha && hl) ? (sa + sl + BS) / (2 * BS)
                         : ha ? (sa + BS / 2) / BS
                              : hl ? (sl + BS / 2) / BS : p.base;
      }
      // Column j of the prediction (kept in Rw until the reconstruction)
      // and of the residual (in Tw), one loop per predictor family so
      // each is a straight loop.  The per-pixel loops stay loops:
      // unrolled 32 times, the predictors, quantizer and reconstruction
      // would be code the instruction cache cannot hold.
      int* Tw = sT + warp * t_ints<BS>() + hf * BS * TP;
      Pix* Rw = sRec + warp * RE + hf * N;
      __syncwarp();
      auto put = [&](int i, int pr) {
        Rw[i * BS + j] = (Pix)pr;
        Tw[i * TP + j] = rshift_signed((int)S[i * BS + j] - pr, p.fwd_s0);
      };
      if (mode < 0) {                                  // inter lane
        const Pix* X = static_cast<const Pix*>(p.xpred) + xix * N + j;
#pragma unroll 8
        for (int i = 0; i < BS; ++i) put(i, __ldg(X + i * BS));
      } else if (mode == 0) {                          // DC
#pragma unroll 8
        for (int i = 0; i < BS; ++i) put(i, dcv);
      } else if (mode <= 8) {                          // V, H, directional
        const int* dm = sDir + warp * N + j;
#pragma unroll 8
        for (int i = 0; i < BS; ++i) {
          const int m = dm[i * BS];
          const int i0 = m & 0xFF, i1 = (m >> 8) & 0xFF;
          const int sh = (m >> 16) & 0x3F;
          put(i, clampi((E[i0] * (32 - sh) + E[i1] * sh + 16) >> 5, 0,
                        p.pix_max));
        }
      } else if (mode == 12) {                         // PAETH
        const int top = E[A + j], tl = E[0];
#pragma unroll 8
        for (int i = 0; i < BS; ++i) {
          const int left = E[L + i];
          const int pb = top + left - tl;
          const int p_t = abs(pb - top), p_l = abs(pb - left);
          const int p_tl = abs(pb - tl);
          put(i, (p_l <= p_t && p_l <= p_tl) ? left
                                             : (p_t <= p_tl ? top : tl));
        }
      } else {                                         // SMOOTH, _V, _H
        const int wj = sSmw[j], top = E[A + j];
        const int below = E[L + BS - 1], right = E[A + BS - 1];
#pragma unroll 8
        for (int i = 0; i < BS; ++i) {
          const int wi = sSmw[i], left = E[L + i];
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
      int v[BS];
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        const int base = pass ? j * TP : j, step = pass ? 1 : TP;
        const int s = pass ? p.fwd_s2 : p.fwd_s1;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < BS; ++i) v[i] = Tw[base + i * step];
        fwd_net<BS>(v, pass, pass ? rk : ck);
#pragma unroll
        for (int i = 0; i < BS; ++i) Tw[base + i * step] = rshift_signed(v[i],
                                                                         s);
      }

      // deadzone quantizer and normative dequantizer of row j, in place
      if (ws) ws[2] = gtime();
      int nnz = 0;
      float lbits = 0.f;
      int16_t* Lw = sLev + warp * lev_elems<BS>() + (hf * BS + j) * LSTR;
      int* Trow = Tw + j * TP;
#pragma unroll 8
      for (int i = 0; i < BS; ++i) {
        const int co = Trow[i];
        const bool dc = (j == 0 && i == 0);
        const int dqv = dc ? p.dqdc : p.dqac;
        const unsigned n = ((unsigned)abs(co) << p.qshift) +
                           (unsigned)((dqv * 48) >> 7);
        const int lv = min((int)(((unsigned long long)n * (dc ? p.mdc : p.mac))
                                 >> (dc ? p.sdc : p.sac)), (1 << 15) - 1);
        Lw[i] = (int16_t)(co < 0 ? -lv : lv);
        int dq = ((lv * dqv) & 0xFFFFFF) >> p.qshift;
        dq = co < 0 ? -dq : dq;
        Trow[i] = clampi(dq, p.dq_lo, p.dq_hi);             // ±2^(bd+7)
        nnz += lv != 0;
        lbits = __fadd_rn(lbits, log2f(1.0f + (float)lv));
      }

      if (ws) ws[3] = gtime();
      // inverse transform in place: pass 0 row j (row network clamp, then
      // the row output clamp), pass 1 column j (column network clamp, then
      // the residual clamp); reconstruction
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        const int base = pass ? j : j * TP, step = pass ? TP : 1;
        const int s = pass ? p.inv_s1 : p.inv_s0;
        const int lo = pass ? p.res_lo : p.mid_lo;
        const int hi = pass ? p.res_hi : p.mid_hi;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < BS; ++i) v[i] = Tw[base + i * step];
        inv_net<BS>(v, pass ? ck : rk, pass ? p.col_lo : p.row_lo,
                    pass ? p.col_hi : p.row_hi);
#pragma unroll
        for (int i = 0; i < BS; ++i)
          Tw[base + i * step] = clampi(rshift_signed(v[i], s), lo, hi);
      }
      if (ws) ws[4] = gtime();
      int sse = 0;
#pragma unroll 4
      for (int i = 0; i < BS; ++i) {
        const int rec = clampi((int)Rw[i * BS + j] + Tw[i * TP + j], 0,
                               p.pix_max);
        Rw[i * BS + j] = (Pix)rec;
        const int d = (int)S[i * BS + j] - rec;
        sse += d * d;
      }

      if (ws) ws[5] = gtime();
      // RD cost of each block, paired sum, first minimum below
#pragma unroll
      for (int o = BS / 2; o > 0; o >>= 1) {
        sse += __shfl_xor_sync(FULL, sse, o);
        nnz += __shfl_xor_sync(FULL, nnz, o);
        lbits = __fadd_rn(lbits, __shfl_xor_sync(FULL, lbits, o));
      }
      const float fn = (float)nnz;
      float est;
      if (BS >= 32)
        est = __fadd_rn(__fadd_rn(25.7f, __fmul_rn(2.43f, fn)),
                        __fmul_rn(1.83f, lbits));
      else
        est = __fadd_rn(__fadd_rn(16.2f, __fmul_rn(2.47f, fn)),
                        __fmul_rn(1.58f, lbits));
      const float rbits = nnz > 0 ? est : 1.0f;
      const bool xl = c >= p.NI;
      const float rate = xl ? __ldg(p.xrate + xix) : p.rate[c];
      const bool ok = xl ? __ldg(p.xok + xix) != 0
                         : (p.iok == nullptr || __ldg(p.iok + bix) != 0);
      float cost = __fadd_rn((float)sse,
                             __fmul_rn(p.lam, __fadd_rn(rate, rbits)));
      if (!ok) cost = 3e38f;
      if constexpr (H == 2) {
        const float cv = __shfl_sync(FULL, cost, BS);
        if (p.paired) cost = __fadd_rn(cost, cv);
      }
      if (j == 0) sCost[hf * MAXC + c] = cost;
      if (ws) ws[6] = gtime();
    }
    if (tr && lead) tr[11] = gtime();
    cl.sync();
    for (int e = tid; e < H * p.C; e += nthr) {
      const int hh = e / p.C, cc = e % p.C;
      sAll[hh * MAXC + cc] =
          cl.map_shared_rank(sCost, p.home[cc] & 0xFF)[hh * MAXC + cc];
    }
    __syncthreads();
    if (tr && lead) tr[2] = gtime();

    // ---- first minimum of each half (one for a pair: half 0's cost is
    // the pair's sum); the CTA that ran a half's winner writes that half
    // out from the slot of the warp that ran it: the boundary row and
    // column, its share of the flag, then levels and recon, which no other
    // block reads
    int best0 = 0, best1 = 0;
    float bv0 = sAll[0], bv1 = sAll[MAXC];
    for (int cc = 1; cc < p.C; ++cc) {
      if (sAll[cc] < bv0) {
        bv0 = sAll[cc];
        best0 = cc;
      }
      if (sAll[MAXC + cc] < bv1) {
        bv1 = sAll[MAXC + cc];
        best1 = cc;
      }
    }
    if (H == 1 || p.paired) best1 = best0;
    const int home0 = p.home[best0], home1 = p.home[best1];
    const bool mine0 = (home0 & 0xFF) == rank;
    const bool mine1 = real1 && (home1 & 0xFF) == rank;
    if (!mine0 && !mine1) continue;
    // the slot of half hh's winner: the warp of this CTA that ran it
    auto win_slot = [&](int hh) { return (hh ? home1 : home0) >> 8; };
    for (int e = tid; e < H * 2 * BS; e += nthr) {
      const int hh = e / (2 * BS), q = e % (2 * BS);
      if (!(hh ? mine1 : mine0)) continue;
      const int f = hh ? fr1 : u;
      const Pix* R = sRec + win_slot(hh) * RE + hh * N;
      if (q < BS)
        p.rowbuf[((size_t)f * p.bh + r) * p.w + x + q] = R[(BS - 1) * BS + q];
      else
        p.colbuf[((size_t)f * p.h + y + q - BS) * p.bw + cb] =
            R[(q - BS) * BS + BS - 1];
    }
    // the barrier orders the CTA's boundary stores before thread 0's
    // release add (release is cumulative), so no fence is needed; the flag
    // is ready when every real half has added its share
    __syncthreads();
    if (tid == 0) {
      add_release(flags + (size_t)u * p.nblk + r * p.bw + cb,
                  (int)mine0 + (int)mine1);
      if (tr) tr[3] = gtime();
    }
    for (int e = tid; e < H * N; e += nthr) {
      const int hh = e / N, q = e % N, i = q / BS, jj = q % BS;
      if (!(hh ? mine1 : mine0)) continue;
      const int bh_ = hh ? best1 : best0;
      const int f = hh ? fr1 : u;
      const size_t blk = ((size_t)f * p.bh + r) * p.bw + cb;
      const int sl = win_slot(hh);
      p.levels[blk * N + q] =
          sLev[sl * lev_elems<BS>() + (hh * BS + i) * LSTR + jj];
      p.recon[((size_t)f * p.h + y + i) * p.w + x + jj] =
          sRec[sl * RE + hh * N + q];
      if (q == 0) p.mode_idx[blk] = bh_;
    }
  }
  cl.sync();   // no CTA leaves while another may read its shared memory
}

// Launch geometry: clusters of K CTAs of wpc warps.  Sets the kernel's
// shared bytes and (K > 8 is a non-portable cluster size) allows K, then
// gives the shared bytes per CTA, CTAs per SM and the clusters that fit on
// the card at once; an error if not one cluster fits.
template <int BS, typename Pix>
int configure(int K, int wpc, size_t* smem, int* per_sm, int* clusters) {
  *smem = smem_bytes<BS, Pix>(wpc);
  cudaError_t e = cudaFuncSetAttribute(
      wf_plane_kernel<BS, Pix>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wf_plane_kernel<BS, Pix>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             K > 8);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, wf_plane_kernel<BS, Pix>, 32 * wpc, *smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(32 * wpc);
  cfg.dynamicSmemBytes = *smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, wf_plane_kernel<BS, Pix>,
                                     &cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int BS, typename Pix>
int launch(const WfParams* p, cudaStream_t st) {
  int per_sm, clusters;
  size_t smem;
  int e = configure<BS, Pix>(p->K, p->wpc, &smem, &per_sm, &clusters);
  if (e) return e;
  const int ntick = p->NU * p->nblk;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p->K * std::min(ntick, clusters));
  cfg.blockDim = dim3(32 * p->wpc);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, wf_plane_kernel<BS, Pix>, *p);
  return e ? e : (int)cudaGetLastError();
}

template <int BS, typename Pix>
int info(int K, int wpc, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, wf_plane_kernel<BS, Pix>);
  if (e != cudaSuccess) return (int)e;
  int per_sm, clusters;
  size_t smem;
  const int r = configure<BS, Pix>(K, wpc, &smem, &per_sm, &clusters);
  if (r) return r;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  out[3] = (int)smem;
  out[4] = sm_count();
  out[5] = clusters;
  out[6] = wpc;
  out[7] = K;
  return 0;
}

bool geometry_ok(int K, int wpc) {
  return K >= 1 && K <= MAXK && wpc >= 1 && wpc <= MAXW;
}

// Every candidate runs on one warp of the launch, and that warp runs it.
bool map_ok(const WfParams* p) {
  if (!geometry_ok(p->K, p->wpc)) return false;
  for (int c = 0; c < p->C; ++c) {
    const int rank = p->home[c] & 0xFF, warp = p->home[c] >> 8;
    if (rank >= p->K || warp >= p->wpc || p->cand[rank * MAXW + warp] != c)
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

int wf_params_size() { return (int)sizeof(WfParams); }

// One plane call: the persistent kernel of bs x bs blocks and bd-bit
// pixels (8: uint8, 10: uint16) on the caller's stream.
int wf_plane(const WfParams* p, int bs, int bd, void* stream) {
  if (p->C < 1 || p->C > MAXC || !map_ok(p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bd == 8 && bs == 32) return launch<32, uint8_t>(p, st);
  if (bd == 8 && bs == 16) return launch<16, uint8_t>(p, st);
  if (bd == 10 && bs == 32) return launch<32, uint16_t>(p, st);
  if (bd == 10 && bs == 16) return launch<16, uint16_t>(p, st);
  return (int)cudaErrorInvalidValue;
}

// Registers per thread, local (spill) bytes per thread, CTAs per SM,
// shared bytes per CTA, the SM count, clusters resident at once, warps per
// CTA and CTAs per cluster, of the bs, bd form in clusters of K CTAs of
// wpc warps.
int wf_info(int bs, int bd, int K, int wpc, int* out) {
  if (!geometry_ok(K, wpc)) return (int)cudaErrorInvalidValue;
  if (bd == 8 && bs == 32) return info<32, uint8_t>(K, wpc, out);
  if (bd == 8 && bs == 16) return info<16, uint8_t>(K, wpc, out);
  if (bd == 10 && bs == 32) return info<32, uint16_t>(K, wpc, out);
  if (bd == 10 && bs == 16) return info<16, uint16_t>(K, wpc, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
