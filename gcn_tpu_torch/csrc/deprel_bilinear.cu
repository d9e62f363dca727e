// The deprel-conditioned bilinear transform over flattened tokens, f32 or
// bf16.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/deprel_bilinear.py:
//   _kernel_v2  (launched by _core_v2_forward, reached through
//                deprel_bilinear_v2 and deprel_bilinear_batched, the
//                non-factored full_deprel on the fused path)
//                                          -> deprel_bilinear_v2_{f32,bf16}
//   _kernel     (launched by _core_forward, reached through the public
//                deprel_bilinear)          -> deprel_bilinear_v1_{f32,bf16}
// Same contract, x, e, W and out of one type (the TPU kernels' out_shape
// takes x's dtype):
//   x [M, T], e [M, D], W [D, T, H]  ->  out [M, H]
//   out[m, h] = sum_d e[m, d] * sum_t x[m, t] * W[d, t, h]
// (the bias term e @ b stays outside the kernels, as in JAX).
//
// What bounds it on the H100 (SXM, 700 W).  At the C-GCN layer's shapes
// (M = 4800, T = 400 or 200, D = 50, H = 200) it is 2 M D T H = 38.4
// (19.2) GFLOP against 28.5 MB moved in f32 (14.3 MB in bf16): bound by
// operations.  The TPU's v2 packs W into one [T, D*Hp] operand (H padded
// to 128 lanes) for one wide MXU product per row tile and then gates lane
// slices by e; v1 streams W[d] through VMEM along a sequential grid axis
// and accumulates e[:, d] * (x W[d]) in the resident output block.
// Neither padding nor the sequential grid carries over.  No kernel here
// writes the [M, D*T] intermediate.
//
// Both types share the grid: a block owns 128 rows and all H = 200
// columns (one 208-wide tile), 4800 rows make only 38 row tiles for 132
// SMs, so K is split over d into S slices (S = SMs / row tiles, 3 here:
// 114 blocks of 16-17 values of d), each writing an f32 [M, H] partial that
// a second kernel, launched by the same entry point, sums in slice order.
// Each output element sums in one fixed order and there are no float
// atomics, so two calls give the same bits.
//
// f32 (deprel_bilinear_kernel): an implicit GEMM over K = D*T on the
// 3xTF32 tensor-core mainloop of tf32x3_tile.cuh (f32 error, three TF32
// products a k-step): bound at an effective 165 TFLOP/s, 0.233 (0.116)
// ms, against 0.573 (0.287) ms at the f32 FMA rate.  v2 and v1 differ only
// in where e enters:
//   v2 forms A = e[m, d] * x[m, t] on the fly (e read from device memory
//      one d ahead) and adds each chunk's product into the sum;
//   v1 takes A = x[m, t] as it is and folds each chunk's product c of
//      (t chunk, d) in as acc = e[m, d] * c + acc (one fmaf), the
//      d-streamed form of the TPU's v1, which spares the per-d forming of
//      A that is much of v2's work beside the MMAs.
// The k-loop puts t outside d: an x tile of 128 rows x 32 t arrives once
// (cp.async, a three-deep ring) and serves every d of the block's slice,
// each warp reading its A fragments from it and splitting them in
// registers; W [D, T, H] is already the [D*T, H] operand, whose 32-row
// chunk (d, t chunk) streams through a three-stage cp.async ring and is
// read from L2 once per row tile (0.6 GB a call at T = 400; twice that at
// 64 rows, which is why the tile is 128 rows tall).  Each output sums t
// chunks, then d, then the slices.
//
// bf16 (deprel_bilinear_bf16_kernel, both versions): the TPU's _kernel_v2
// order, y_d = x W_d with bf16 operands and f32 sums, then
// acc = e[m, d] * y_d + acc in f32, and out rounded to bf16 once (at its
// store or in the slice sum).  A bf16 x bf16 product is exact in the f32
// accumulator, so the products run on the bf16 tensor cores as they are
// (wgmma.mma_async.m64n208k16, 989 TFLOP/s peak: bound at 0.039 (0.019)
// ms) with no split and no A formed on the CUDA cores; e enters only at
// the fold, so v1 and v2 are one arithmetic in bf16.  (The TPU's v1 adds
// each d's term into a bf16 output block, rounding at every d; the port's
// v1 rounds once, as its v2.)  A block is three warpgroups: two consumers
// of 64 rows each, which hold two f32 fragments of 64 x 208 (the fresh
// y_d and the running acc: 104 + 104 registers a thread, 232 by
// setmaxnreg), and one producer (40 registers) that copies.  The operands
// sit in shared memory in the 128-byte-swizzled layouts that wgmma reads
// through its descriptors:
//   x: the row tile's [128, T] resident, K-major, in blocks of 64 t
//      (16 KB each, 8 at most: T <= 512 stays resident), each block with
//      a barrier of its own, so the products start on the first;
//   W: chunks of 32 t rows x 208 columns of W[d] (MN-major: W's own
//      row-major [T, H] layout, four blocks of 64 columns, 16 KB a chunk)
//      through a six-stage ring (full and empty mbarriers).
// The producer is one thread issuing TMA copies (tensor maps from the
// driver's cuTensorMapEncodeTiled; zeros outside the matrices).  The two
// blocks of a cluster take neighbouring row tiles of one slice, and each
// copies two of a W chunk's four column blocks into both (multicast): W
// is read from L2 once a pair of row tiles (19 x W's 8 MB a call at
// T = 400; read once a row tile, the copies bound the kernel).  Operands
// that TMA cannot take (T or H not a multiple of 8, a base not 16-byte
// aligned: T = 37, an x at an odd element offset) go through the
// producer's 128 threads instead: cp.async of 16 bytes where the rows
// allow, element by element where not, each block its own W.  The order:
//   T <= 512:  for d: y = x W_d over all of T (fresh, 13 chunks at
//              T = 400), acc += e_d y;  -- the TPU's v2 order exactly
//   T > 512:   for each 512-wide pass of t (x reloaded): for d: y over
//              the pass, acc += e_d y  -- a fold per (pass, d)
// and then the slices in order.  A consumer keeps two chunks' products in
// flight while it issues the next (wgmma.wait_group 2), hands each slot
// back to both blocks' producers when its products are done, and waits
// for all of them (wait_group 0) before each fold.  The output goes out
// two columns a store.  The swizzle, descriptors, wgmma, mbarriers, TMA
// and cp.async copies, and the tensor-map encoder are hopper_tile.cuh's,
// shared with the grouped matmul forward's bf16 kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"
#include "tf32x3_tile.cuh"

namespace {

using tf32x3::kStages;

// ---------------------------------------------------------------- f32
// 4 x 2 warps, each 32 rows x 104 columns: 128 x 208 a block
using BTile = tf32x3::Tile<4, 2, 2, 13>;
constexpr int kGroup = 7;  // n-tiles per fresh accumulator (registers)
// x tile row stride, in floats: conflict-free fragment reads
constexpr int kLdx = tf32x3::kBK + 4;
constexpr int kXVals = BTile::kBM * kLdx;
constexpr size_t kSmem =  // the W ring, then a ring of as many x tiles
    BTile::kRingBytes + sizeof(float) * kStages * kXVals;

__device__ __forceinline__ float from_f32(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// Block (row tile, column tile, slice s): rows m0.., columns n0.., d in
// [s D / S, (s + 1) D / S).  Writes out (S == 1) or the slice's [M, H]
// partial at part + s M H.  kV1: e enters at the fold (v1), else in A
// (v2).
template <bool kV1>
__global__ void __launch_bounds__(BTile::kThreads, 1)
deprel_bilinear_kernel(const float* __restrict__ x,
                       const float* __restrict__ e,
                       const float* __restrict__ w, float* __restrict__ out,
                       float* __restrict__ part, int m, int t, int d_dim,
                       int h, int slices, bool vec_x, bool vec_w) {
  using Tl = BTile;
  constexpr int kBK = tf32x3::kBK;
  extern __shared__ __align__(16) float smem_f[];
  float* wring = smem_f;
  float* xring = smem_f + Tl::kRingBytes / sizeof(float);
  const int m0 = blockIdx.x * Tl::kBM, n0 = blockIdx.y * Tl::kBN;
  const int d0 = (int)((long long)blockIdx.z * d_dim / slices);
  const int ds = (int)((long long)(blockIdx.z + 1) * d_dim / slices) - d0;
  const int chunks = (t + kBK - 1) / kBK * ds;  // (t chunk, d), d inner
  auto issue = [&](int c) {
    if (c < chunks) {
      const int tc = c / ds, d = d0 + c % ds;
      tf32x3::copy_tile<kBK, Tl::kBN, Tl::kLdw, Tl::kThreads>(
          wring + (c % kStages) * Tl::kStageFloats,
          w + ((size_t)d * t + (size_t)tc * kBK) * h, h,
          min(kBK, t - tc * kBK), n0, h, vec_w);
      if (c % ds == 0)  // the x tile rides with its t chunk's first d
        tf32x3::copy_tile<Tl::kBM, kBK, kLdx, Tl::kThreads>(
            xring + (tc % kStages) * kXVals, x + (size_t)m0 * t, t,
            m - m0, tc * kBK, t, vec_x);
    }
    tf32x3::cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  // this lane's A rows: m-tile mt, half hf -> m0 + wm*32 + mt*16 + hf*8 + g
  const float* erow[Tl::kMT][2];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 16 * Tl::kMT + mt * 16 + hf * 8 + g;
      erow[mt][hf] = row < m ? e + (size_t)row * d_dim : nullptr;
    }
  auto e_at = [&](float (&ev)[Tl::kMT][2], int d) {
#pragma unroll
    for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        ev[mt][hf] = erow[mt][hf] ? erow[mt][hf][d] : 0.0f;
  };
  float ev[Tl::kMT][2], ev_next[Tl::kMT][2];
  e_at(ev, d0);

  float acc[Tl::kMT][Tl::kNT][4];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) e_at(ev_next, d0 + (c + 1) % ds);
    tf32x3::ring_wait();
    issue(c + kStages - 1);
    const float* xs = xring + (c / ds % kStages) * kXVals +
                      (wm * 16 * Tl::kMT + g) * kLdx + q;
    const float* ws =
        wring + (c % kStages) * Tl::kStageFloats + wn * Tl::kNT * 8;
    if constexpr (kV1) {
      tf32x3::mma_chunk<Tl::kMT, Tl::kNT, kGroup, Tl::kLdw>(
          acc, ws,
          [&](int mt, int ks, float (&a)[4]) {
            const float* p = xs + mt * 16 * kLdx + ks * 8;
            a[0] = p[0];
            a[1] = p[8 * kLdx];
            a[2] = p[4];
            a[3] = p[8 * kLdx + 4];
          },
          [&](int mt, int i, float sum, float chunk) {
            return fmaf(ev[mt][i / 2], chunk, sum);
          });
    } else {
      tf32x3::mma_chunk<Tl::kMT, Tl::kNT, kGroup, Tl::kLdw>(
          acc, ws, [&](int mt, int ks, float (&a)[4]) {
            const float* p = xs + mt * 16 * kLdx + ks * 8;
            a[0] = __fmul_rn(ev[mt][0], p[0]);
            a[1] = __fmul_rn(ev[mt][1], p[8 * kLdx]);
            a[2] = __fmul_rn(ev[mt][0], p[4]);
            a[3] = __fmul_rn(ev[mt][1], p[8 * kLdx + 4]);
          });
    }
#pragma unroll
    for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) ev[mt][hf] = ev_next[mt][hf];
  }

  float* dst = slices > 1 ? part + (size_t)blockIdx.z * m * h : out;
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 16 * Tl::kMT + mt * 16 + hf * 8 + g;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = n0 + wn * Tl::kNT * 8 + j * 8 + 2 * q + i;
          if (col < h) dst[(size_t)row * h + col] = acc[mt][j][hf * 2 + i];
        }
    }
}

// --------------------------------------------------------------- bf16
namespace wg {

using namespace hopper;  // hopper_tile.cuh's helpers

constexpr int kBM = 128, kBN = 208;  // the f32 tile's: one slice count
constexpr int kThreads = 384;        // two consumer warpgroups of 64 rows,
                                     // then one producer warpgroup
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // setmaxnreg
constexpr int kNVals = kBN / 2;      // f32 values of a 64 x 208 fragment
                                     // a thread: 104
constexpr int kKC = 32;              // t rows a W chunk: two k-steps of 16
constexpr int kStages = 6;           // W chunks in the ring
constexpr int kPending = 2;          // chunks' products a consumer keeps in
                                     // flight past the one it issued
constexpr int kLag = 4;              // chunks a copying thread has in
                                     // flight before it reports the oldest
static_assert(kLag <= kStages - kPending, "the ring would deadlock");
constexpr int kXBlocks = 8;          // x blocks of 64 t resident: a pass
constexpr int kPass = 64 * kXBlocks;  // t values a pass
constexpr int kXBlockBytes = kBM * 128;   // [128 rows, 64 t], 16 KB
constexpr int kWBlockBytes = kKC * 128;   // [32 t, 64 columns], 4 KB
constexpr int kStageBytes = (kBN + 63) / 64 * kWBlockBytes;  // 16 KB
constexpr int kBarBytes = 1024;      // the mbarriers, ahead of the ring
static_assert(kBM == BTile::kBM && kBN == BTile::kBN,
              "deprel_bilinear_slices serves both types");
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register file");
static_assert(kNVals == kN208Vals, "one m64n208k16 fragment");

// Block (row tile, column tile, slice s) as the f32 kernel's; writes out
// (S == 1, rounded to bf16) or the slice's f32 partial at part + s M H.
// Warpgroups 0-1 multiply and fold, warpgroup 2 copies.  Barriers: full[i]
// (ring slot i has landed: its bytes, or the copying threads' reports,
// whose first chunk of a pass also brings the pass's x), x_full[b] (with
// TMA: x block b of the pass has landed), empty[i] (the consumers' warps
// are done reading slot i), x_free (they are done with a pass's x).  The
// two CTAs of a cluster take neighbouring row tiles of one slice: with
// TMA each copies half of every W chunk into both (W is read from L2 once
// a pair of row tiles) and so waits until both CTAs' 8 warps are done
// with the slot; without, each copies its own (128 threads, cp.async).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
deprel_bilinear_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w,
                            const bf16* __restrict__ x,
                            const bf16* __restrict__ e,
                            const bf16* __restrict__ w,
                            bf16* __restrict__ out, float* __restrict__ part,
                            int m, int t, int d_dim, int h, int slices,
                            bool tma, bool vec_x, bool vec_w) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: blocks start on multiples of it
  const uint32_t raw = tf32x3::smem_u32(smem_raw);
  const uint32_t bars = (raw + 1023u) & ~1023u;
  const uint32_t ring_s = bars + kBarBytes;
  const uint32_t x_s = ring_s + kStages * kStageBytes;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };
  const uint32_t x_free = bars + 16 * kStages;
  auto x_full = [&](int i) { return x_free + 8 + 8 * i; };

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int d0 = (int)((long long)blockIdx.z * d_dim / slices);
  const int ds = (int)((long long)(blockIdx.z + 1) * d_dim / slices) - d0;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(full(i), tma ? 1 : 128);
      bar_init(empty(i), tma ? 16 : 8);
    }
    bar_init(x_free, 8);
    for (int i = 0; i < kXBlocks; ++i) bar_init(x_full(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peer's barriers are initialised before anything reaches them
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  uint32_t rank;  // in the cluster
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));

  if (group == 2) {  // ------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tma) {  // one thread issues every copy
      if (threadIdx.x != 256) return;
      int slot = 0, phase = 0, issued = 0;
      constexpr int kHalf = kStageBytes / kWBlockBytes / 2;  // W blocks
      for (int tp0 = 0, pass = 0; tp0 < t; tp0 += kPass, ++pass) {
        const int tp = min(kPass, t - tp0);
        if (pass > 0) bar_wait(x_free, (pass - 1) & 1);
        for (int d = d0; d < d0 + ds; ++d)
          for (int tc = tp0; tc < tp0 + tp; tc += kKC) {
            // the slot's last chunk has been handed back
            if (issued++ >= kStages) bar_wait(empty(slot), phase ^ 1);
            // the pass's x block by block, each ahead of the first chunk
            // that reads it
            if (d == d0 && (tc - tp0) % 64 == 0) {
              const int kb = (tc - tp0) / 64;
              bar_expect(x_full(kb), kXBlockBytes);
              tma_2d(x_s + kb * kXBlockBytes, &map_x, tc, m0, x_full(kb));
            }
            bar_expect(full(slot), kStageBytes);
            // W[d] rows tc.., this CTA's two of the four blocks of 64
            // columns, into both CTAs (rows past T and columns past H
            // arrive as zeros)
            for (int nb = kHalf * rank; nb < kHalf * (rank + 1); ++nb)
              tma_3d_multicast(
                  ring_s + slot * kStageBytes + nb * kWBlockBytes, &map_w,
                  n0 + 64 * nb, tc, d, full(slot), 0x3);
            slot = slot + 1 == kStages ? 0 : slot + 1;
            phase ^= slot == 0;
          }
      }
      // the last chunks handed back by both CTAs: no arrival from the
      // peer reaches this CTA after it exits
      for (int i = max(0, issued - kStages); i < issued; ++i)
        bar_wait(empty(i % kStages), i / kStages & 1);
      return;
    }
    unsigned char* ring = smem_raw + (ring_s - raw);
    unsigned char* xt = smem_raw + (x_s - raw);
    const int pt = threadIdx.x - 256;
    int it = 0, reported = 0;  // chunks issued, and reported landed
    for (int tp0 = 0, pass = 0; tp0 < t; tp0 += kPass, ++pass) {
      const int tp = min(kPass, t - tp0);
      const int per_d = (tp + kKC - 1) / kKC;
      if (pass > 0) bar_wait(x_free, (pass - 1) & 1);
      for (int c = 0; c < per_d * ds; ++c, ++it) {
        if (it >= kStages) bar_wait(empty(it % kStages),
                                    (it / kStages - 1) & 1);
        const int d = d0 + c / per_d, tc = c % per_d * kKC;
        load_w<kKC, kBN>(ring + it % kStages * kStageBytes,
               w + ((size_t)d * t + tp0 + tc) * h, h, min(kKC, tp - tc),
               n0, vec_w, pt, 128);
        if (c == 0)  // the pass's x rides with its first chunk
          load_x<kBM>(xt, x + (size_t)m0 * t + tp0, t, m - m0, tp, vec_x, pt,
                 128);
        tf32x3::cp_async_commit();
        if (it + 1 - reported == kLag) {  // the oldest chunk has landed
          tf32x3::cp_async_wait<kLag - 1>();
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bar_arrive(full(reported++ % kStages));
        }
      }
      // the pass's last chunks: the consumers' x_free needs them all
      tf32x3::cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      while (reported < it) bar_arrive(full(reported++ % kStages));
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x % 32;
  // this thread's fragment rows: row0 (values 4j, 4j + 1) and row0 + 8
  // (4j + 2, 4j + 3), columns n0 + 8j + 2 (lane % 4) + {0, 1}
  const int row0 = m0 + group * 64 + threadIdx.x % 128 / 32 * 16 + lane / 4;
  auto e_at = [&](int row, int d) {
    return row < m ? __bfloat162float(e[(size_t)row * d_dim + d]) : 0.0f;
  };

  float acc[kNVals], y[kNVals];
#pragma unroll
  for (int i = 0; i < kNVals; ++i) acc[i] = y[i] = 0.0f;

  // the descriptors of the first k-step; a k-step adds its byte offsets,
  // in 16-byte units, to their start-address field
  const uint64_t a0 = desc(x_s + group * 64 * 128, 16, 1024);
  const uint64_t b0 = desc(ring_s, kWBlockBytes, 1024);
  // the ring slot (and its phase) of the next chunk to read, the slot of
  // the next to hand back, and the chunks read but not handed back
  int slot = 0, phase = 0, back = 0, held = 0;
  auto hand_back = [&](int keep) {  // all but the newest `keep`
    for (; held > keep; --held) {
      if (lane == 0) {
        bar_arrive(empty(back));
        if (tma) bar_arrive_remote(empty(back), rank ^ 1);
      }
      back = back + 1 == kStages ? 0 : back + 1;
    }
  };
  for (int tp0 = 0, pass = 0; tp0 < t; tp0 += kPass, ++pass) {
    const int per_d = (min(kPass, t - tp0) + kKC - 1) / kKC;
    for (int d = d0; d < d0 + ds; ++d) {
      const float e_lo = e_at(row0, d), e_hi = e_at(row0 + 8, d);
      for (int k = 0; k < per_d; ++k) {
        // with TMA each x block has a barrier of its own (else x rides
        // with the pass's first chunk)
        if (tma && d == d0 && k * kKC % 64 == 0)
          bar_wait(x_full(k * kKC / 64), pass & 1);
        bar_wait(full(slot), phase);
        mma_fence();
        // every k-step of the chunk, also past T: x and W are zeros there
        // (a product left out would cost ptxas's fence before each wgmma)
#pragma unroll
        for (int s = 0; s < kKC / 16; ++s) {
          const int tt = k * kKC + s * 16;
          // A: rows 64 group.., t in [tt, tt + 16) of block tt / 64 (the
          // k-step's 32 bytes within the swizzled row); B: the chunk's
          // rows 16 s.., 8-row groups 1024 bytes apart, column blocks
          // kWBlockBytes apart
          mma_208(y, a0 + ((tt / 64 * kXBlockBytes + tt % 64 * 2) >> 4),
                  b0 + ((slot * kStageBytes + s * 16 * 128) >> 4),
                  k > 0 || s > 0);
        }
        mma_commit();
        ++held;
        slot = slot + 1 == kStages ? 0 : slot + 1;
        phase ^= slot == 0;
        if (k < per_d - 1) {
          mma_wait<kPending>();
          hand_back(kPending);
        }
      }
      // y = x W_d over the pass: fold it in
      mma_wait<0>();
      fence_regs(y);
      hand_back(0);
#pragma unroll
      for (int i = 0; i < kNVals; ++i)
        acc[i] = fmaf(i & 2 ? e_hi : e_lo, y[i], acc[i]);
      fence_regs(y);
    }
    if (lane == 0) bar_arrive(x_free);
  }

  // two neighbouring columns a store where H is even: half the store
  // instructions, and every block stores at its end, where nothing hides
  // them
  float* dst = part + (size_t)blockIdx.z * m * h;
  const bool pairs = h % 2 == 0;
#pragma unroll
  for (int j = 0; j < kNVals / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int row = row0 + (i & 2 ? 8 : 0);
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const size_t at = (size_t)row * h + col;
      const float v0 = acc[4 * j + i], v1 = acc[4 * j + i + 1];
      if (row >= m || col >= h) continue;
      if (pairs && slices > 1) {
        *reinterpret_cast<float2*>(dst + at) = make_float2(v0, v1);
      } else if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        for (int c = 0; c < 2 && col + c < h; ++c) {
          if (slices > 1)
            dst[at + c] = c ? v1 : v0;
          else
            out[at + c] = __float2bfloat16_rn(c ? v1 : v0);
        }
      }
    }
}

}  // namespace wg

// Launches of deprel_bilinear_sum_kernel this library has made, read by
// deprel_bilinear_sum_launches().
int g_sum_launches = 0;

// out = sum of the slices' f32 partials, in slice order, rounded to T.
template <typename T>
__global__ void deprel_bilinear_sum_kernel(const float* __restrict__ part,
                                           T* __restrict__ out, int slices,
                                           size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < slices; ++s) v += part[s * count + i];
    out[i] = from_f32(v, out);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The grid of either type, or 0 where the shapes do not fit one.
dim3 grid_of(int m, int d_dim, int h, int slices) {
  const long long rows = ((long long)m + BTile::kBM - 1) / BTile::kBM;
  const int cols = (h + BTile::kBN - 1) / BTile::kBN;
  if (rows > 0x7fffffffLL || cols > 65535 || slices < 1 || slices > d_dim ||
      slices > 65535)
    return dim3(0, 0, 0);
  return dim3((unsigned)rows, cols, slices);
}

// After the main kernel's launch: the slice sum where there are slices.
template <typename T>
int finish(cudaError_t err, const void* part, void* out, int m, int h,
           int slices, cudaStream_t st) {
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t count = (size_t)m * h;
  const int threads = 256;
  const size_t blocks = (count + threads - 1) / threads;
  const int grid = (int)(blocks < 4096 ? blocks : 4096);
  deprel_bilinear_sum_kernel<T><<<grid, threads, 0, st>>>(
      static_cast<const float*>(part), static_cast<T*>(out), slices, count);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_sum_launches;
  return (int)err;
}

template <bool kV1>
int launch_f32(const void* x, const void* e, const void* w, void* out,
               void* part, int m, int t, int d_dim, int h, int slices,
               void* stream) {
  const dim3 grid = grid_of(m, d_dim, h, slices);
  if (grid.x == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      deprel_bilinear_kernel<kV1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = t % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_w = h % 4 == 0 && (uintptr_t)w % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  deprel_bilinear_kernel<kV1><<<grid, BTile::kThreads, kSmem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<float*>(part), m, t, d_dim, h, slices, vec_x, vec_w);
  return finish<float>(cudaGetLastError(), part, out, m, h, slices, st);
}

// The tensor maps of x [M, T] (boxes of 128 rows x 64 t) and W [D, T, H]
// (boxes of one d, kKC rows, 64 columns), 128-byte swizzled, zeros
// outside; false where the driver refuses them.
bool tensor_maps(CUtensorMap* map_x, CUtensorMap* map_w, const void* x,
                 const void* w, int m, int t, int d_dim, int h) {
  const cuuint64_t x_dim[2] = {(cuuint64_t)t, (cuuint64_t)m};
  const cuuint64_t x_stride[1] = {(cuuint64_t)t * 2};
  const cuuint32_t x_box[2] = {64, wg::kBM};
  const cuuint64_t w_dim[3] = {(cuuint64_t)h, (cuuint64_t)t,
                               (cuuint64_t)d_dim};
  const cuuint64_t w_stride[2] = {(cuuint64_t)h * 2, (cuuint64_t)t * h * 2};
  const cuuint32_t w_box[3] = {64, wg::kKC, 1};
  return hopper::bf16_tensor_map(map_x, x, 2, x_dim, x_stride, x_box) &&
         hopper::bf16_tensor_map(map_w, w, 3, w_dim, w_stride, w_box);
}

int launch_bf16(const void* x, const void* e, const void* w, void* out,
                void* part, int m, int t, int d_dim, int h, int slices,
                void* stream) {
  dim3 grid = grid_of(m, d_dim, h, slices);
  if (grid.x == 0 || grid.x > 0x7ffffffe) return (int)cudaErrorInvalidValue;
  grid.x += grid.x % 2;  // clusters of two row tiles
  // 1 KB to align, the barriers, the ring and the resident x blocks
  const int x_blocks = min(wg::kXBlocks, (t + 63) / 64);
  const int smem = 1024 + wg::kBarBytes + wg::kStages * wg::kStageBytes +
                   x_blocks * wg::kXBlockBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wg::deprel_bilinear_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // TMA takes 16-byte-aligned bases and row strides; other operands go
  // through the copying warpgroup
  const bool vec_x = t % 8 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_w = h % 8 == 0 && (uintptr_t)w % 16 == 0;
  CUtensorMap map_x{}, map_w{};
  const bool tma = vec_x && vec_w && t > 0 &&
                   tensor_maps(&map_x, &map_w, x, w, m, t, d_dim, h);
  const cudaStream_t st = (cudaStream_t)stream;
  wg::deprel_bilinear_bf16_kernel<<<grid, wg::kThreads, smem, st>>>(
      map_x, map_w, static_cast<const hopper::bf16*>(x),
      static_cast<const hopper::bf16*>(e), static_cast<const hopper::bf16*>(w),
      static_cast<hopper::bf16*>(out), static_cast<float*>(part), m, t, d_dim,
      h, slices, tma, vec_x, vec_w);
  return finish<hopper::bf16>(cudaGetLastError(), part, out, m, h, slices, st);
}

}  // namespace

extern "C" {

// The number of d slices both versions split K into for these shapes:
// enough blocks for one wave on this device's SMs, at most D.  The
// wrapper allocates [slices, M, H] of scratch when it is above 1.
int deprel_bilinear_slices(int m, int d_dim, int h) {
  const long long tiles = ((long long)m + BTile::kBM - 1) / BTile::kBM *
                          ((h + BTile::kBN - 1) / BTile::kBN);
  const long long fit = tiles > 0 ? sm_count() / tiles : 1;
  return (int)(fit < 1 ? 1 : (fit > d_dim ? d_dim : fit));
}

// How many slice sums the launchers below have launched, both versions
// together: a call launches one exactly where it splits K into slices.
int deprel_bilinear_sum_launches() { return g_sum_launches; }

// v2 (e in A) and v1 (e at the fold) into out; with slices > 1 the
// slices' partials go to part [slices, M, H] (f32 in either instance)
// first.  In bf16 both versions run the one bf16 kernel (e at the fold).
int deprel_bilinear_v2_f32(const void* x, const void* e, const void* w,
                           void* out, void* part, int m, int t, int d_dim,
                           int h, int slices, void* stream) {
  return launch_f32<false>(x, e, w, out, part, m, t, d_dim, h, slices,
                           stream);
}

int deprel_bilinear_v1_f32(const void* x, const void* e, const void* w,
                           void* out, void* part, int m, int t, int d_dim,
                           int h, int slices, void* stream) {
  return launch_f32<true>(x, e, w, out, part, m, t, d_dim, h, slices,
                          stream);
}

int deprel_bilinear_v2_bf16(const void* x, const void* e, const void* w,
                            void* out, void* part, int m, int t, int d_dim,
                            int h, int slices, void* stream) {
  return launch_bf16(x, e, w, out, part, m, t, d_dim, h, slices, stream);
}

int deprel_bilinear_v1_bf16(const void* x, const void* e, const void* w,
                            void* out, void* part, int m, int t, int d_dim,
                            int h, int slices, void* stream) {
  return launch_bf16(x, e, w, out, part, m, t, d_dim, h, slices, stream);
}

const char* deprel_bilinear_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
