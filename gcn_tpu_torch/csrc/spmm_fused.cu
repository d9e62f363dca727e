// Regular-mode GCN layer straight from padded edge lists, forward and the
// symmetric pair product of its backward.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/spmm_fused.py:
//   _kernel           (launched by _forward, reached through
//                      fused_gcn_spmm)        -> spmm_fused_forward_{f32,bf16}
//   _sym_pair_kernel  (launched by _sym_pair, the forward's backward)
//                                             -> spmm_fused_sym_pair_{f32,bf16}
// Same contract, in f32 or bf16 (h, W, b and out of one type, x1, x2, o1
// and o2 of one type):
//   parent, child  [B, E] int32, mask [B, E] uint8 (0 = padded slot)
//   S = A_f + A_f^T + diag(incident + 1), A_f[p, c] = count of the edges
//       p -> c whose mask is set and whose ends both lie in [0, N)
//   forward:  out = relu(((S h) W + 2 b) / denom)
//             h [B, N, T], W [T, H], b [H], out [B, N, H]
//             denom = deg_out + deg_in + incident + 1
//   sym pair: (o1, o2) = (S x1, S x2),  x1 [B, N, T1], x2 [B, N, T2]
//
// What bounds it on the H100 (SXM, 700 W).  The forward's product with W
// is 2*B*N*T*H FLOPs (0.69 GFLOP at B = 50, N = 96, T = 360, H = 200, 0.38
// at T = 200) against some 7 MB moved: bound by operations.  It runs in
// 3xTF32 on the tensor cores (tf32x3_tile.cuh: three TF32 products a
// k-step, f32 error) at an effective 165 TFLOP/s: 0.0042 ms at T = 360
// and 0.0024 at T = 200 (0.0104 and 0.0058 at the f32 FMA rate of the
// first, SIMT version), while S h is a gather of fewer than 2E + N rows
// per sentence.  The sym pair is a gather alone, memory bound.  The TPU
// kernel built the N x N bands in VMEM with one-hot MXU contractions and
// multiplied them densely; on the card rows gather their neighbours in a
// fixed order instead: the same bits on every run, with no float atomics.
// Both kernels load the sentence's edge slots into shared memory and find
// each row's neighbours by warp ballots over them (edge_gather.cuh), with
// no list build: its serial scan and rank loop were the longest part of a
// block's start.
//
// The f32 forward does the W product in its own body.  A block owns 48 rows
// of one sentence and all H columns (one 224-wide tile for H <= 224;
// wider H takes more column blocks), so each (S h) element is gathered
// once: 100 blocks of 12 warps at B = 50, N = 96, for 132 SMs.  It
// gathers (S h) 256 columns of T at a time into shared memory, every
// row's next neighbour load in flight together, and runs the 3xTF32
// mainloop over them with W streaming through a three-stage cp.async ring
// of 32-row chunks.  The epilogue adds 2b, divides by denom (the ballots'
// counts) and applies the ReLU.  T, H and N need not be multiples of a
// tile (360 and 200 at the main path's layers): the ragged edges read as
// zero.
//
// The f32 sym pair's block owns 8 rows of one sentence, one a warp, and a
// warp covers a whole row of x1 or of x2, up to 384 columns (128 kV, kV =
// 1-3 chosen from T1 and T2; wider takes more column blocks): x1's tiles
// and x2's lie along the grid, 1200 blocks at B = 50, N = 96.  A lane
// covers 4 columns of each 128 by 16-byte loads, with several neighbour
// rows in flight.  That timed faster than both operands in one warp, which
// shares the ballots but holds twice the registers, and than two or four
// rows a warp in lockstep.
//
// The bf16 sym pair (8b) is a kernel of its own
// (spmm_sym_pair_bf16_kernel).  Its bytes (13.9 MB at T = 360) sit warm
// in L2 and the template's time was the same at T = 360 and 200: a
// warp's chain of serial waits (the edge slots, then one round trip a
// ballot step that found a neighbour) run over 1200 blocks, more than
// one wave.  Here a warp takes one row of both operands, [x1 | x2] as one
// row of chunks (600 blocks at B = 50, N = 96), so that one walk serves
// both; it loads the row's own values before the edge slots' barrier,
// walks all its ballot steps into a queue of kPairBatch neighbours
// (edge_gather.cuh gather_groups), then issues the queued rows' loads
// together and adds them in list order, group of 32 chunks after group,
// each group's loads issued while the one before is added; its lanes
// take 8 columns each, one 16-byte load (90 chunks at T = 360: three
// groups; 50 at T = 200: two), where T1 and T2 are multiples of 8 and
// every base is 16-byte aligned, other shapes chunks of 4 (the template's
// map).  The sums, their order and the epilogue are the template's, and
// so are its bits (tests/edge_order.py).  It gains at T = 200 and where
// a sentence has hundreds of slots, and loses at T = 360 on short
// sentences and on a star's centre, where a row's three groups still
// wait on two round trips one after another against the template's one
// (PERF.md §6-7).
//
// The bf16 instances round where the TPU kernel rounds: the forward sums
// (S h) in f32, rounds it to bf16 once (the TPU kernel casts (S h) to h's
// dtype before the product with W), multiplies by the bf16 W in f32 and
// rounds the output once; the sym pair sums in f32 and rounds each output
// once.  Their rows move as bf16 (edge_gather.cuh's typed loads and
// stores).
//
// The bf16 forward is a kernel of its own (spmm_fused_fwd_bf16_kernel).
// Its bound is 0.0017 (0.0012) ms, the product at the bf16 tensor cores'
// peak.  The f32 template's bf16 instance, which it replaces, spent half
// of a block's cycles waiting for W and multiplying one TF32 pass from f32
// fragments read value by value, a third gathering (S h) in 256-column
// phases behind block barriers, and a sixth in the epilogue
// (tools/spmm_phases.py).  A block owns 48 rows of one sentence and all H
// <= 224 columns (100 blocks at B = 50, N = 96, one an SM), and is twelve
// warps that gather and multiply plus one that copies:
//  * the copying warp streams W from the kernel's start by TMA (one box
//    of 32 rows x 64 columns a lane) into a ring of up to six chunks (full
//    and empty mbarriers), in the 128-byte-swizzled MN-major blocks of
//    hopper_tile.cuh, which ldmatrix .trans reads conflict-free with the
//    same XOR;
//  * warp 0's first lanes stage the sentence's rows of h for the pass by
//    TMA ([3][N][128], zeros past T), so that the gather reads shared
//    memory: read from device memory, its neighbour loads' latency made
//    most of the block's time;
//  * each warp lists its four rows' neighbours in summing order once (two
//    ballot walks), then walks the list eight entries a step into the
//    resident bf16 (S h) tile (rows padded to 392 values);
//  * each warp multiplies 16 rows by 56 columns of it by W chunk by chunk
//    as each chunk lands: mma.sync.m16n8k16 on bf16 fragments from
//    ldmatrix, f32 sums over all of T, then 2b, denom and the ReLU.
// mma.sync, not wgmma: wgmma takes 64-row tiles, a third more rows than
// the block's 48, and each warp here both gathers and multiplies.
// T past the tile's 384 columns (1084 for BERT vectors without the
// BiLSTM) runs in passes; N past 256 rows or what shared memory holds, T
// or H not a multiple of 8 or a base not 16-byte aligned, take the
// gather from device memory or W by every warp's cp.async instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "edge_gather.cuh"
#include "hopper_tile.cuh"
#include "tf32x3_tile.cuh"

namespace {

using edge_gather::add4;
using edge_gather::Chunks;
using edge_gather::EdgeClock;
using edge_gather::edges_bytes;
using edge_gather::gather_groups;
using edge_gather::to_f32;
using edge_gather::vec_bytes;
using edge_gather::gather_row;
using edge_gather::gather_rows;
using edge_gather::load4;
using edge_gather::load_edges;
using edge_gather::load_edges_wide;
using edge_gather::set_smem;
using edge_gather::store4;
using edge_gather::zero4;
using tf32x3::kStages;

// Phase clocks, compiled in only with -DSPMM_PHASES (tools/spmm_phases.py
// builds this source so): thread 0 of each block adds the SM cycles it
// spent in each phase into spmm_phases[slot] and 1 into
// spmm_phases[kPhaseSlots]; the tool reads them back through
// spmm_phases_read.  Without the macro every member is empty and the
// kernels compile as if it were not there.
constexpr int kPhaseSlots = 15;
#ifdef SPMM_PHASES
__device__ unsigned long long spmm_phases[kPhaseSlots + 1];
#endif

struct PhaseClock {
#ifdef SPMM_PHASES
  long long last = 0, spent[kPhaseSlots] = {};
  __device__ __forceinline__ static long long now() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    return t;
  }
  __device__ __forceinline__ void start() { last = now(); }
  // the cycles since the last mark or start go to slot
  __device__ __forceinline__ void mark(int slot) {
    const long long t = now();
    spent[slot] += t - last;
    last = t;
  }
  // adds this thread's phases in, and counts the block
  __device__ __forceinline__ void flush() {
    for (int i = 0; i < kPhaseSlots; ++i)
      if (spent[i] != 0)
        atomicAdd(&spmm_phases[i], (unsigned long long)spent[i]);
    atomicAdd(&spmm_phases[kPhaseSlots], 1ull);
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush() {}
#endif
};

// forward: 3 x 4 warps, each 16 rows x 56 columns: 48 x 224 a block
using FwdTile = tf32x3::Tile<3, 4, 1, 7>;
constexpr int kAK = 256;                   // forward: (S h) columns per gather
constexpr int kLda = kAK + 4;              // conflict-free A fragment reads
// the forward's degrees and tiles: the A tile and the W ring
constexpr size_t kFwdTileBytes =
    sizeof(int) * FwdTile::kBM + sizeof(float) * FwdTile::kBM * kLda +
    sizeof(float) * (size_t)kStages * FwdTile::kStageFloats;
static_assert(kAK % tf32x3::kBK == 0, "a gather covers whole W chunks");
constexpr int kPairThreads = 256;  // sym pair: 8 warps, a row each
constexpr int kPairRows = kPairThreads / 32;

// (S h) rows m0.. (kBM of them) and columns k0..k0 + kAK of one sentence
// (rows start at hb, width t) into a_s [kBM][kLda], zero past n and t; the
// first call (k0 = 0) also writes each row's degree to deg [kBM].
// Warp w takes rows w, w + kWarps, ...; lane l the columns 4l..4l + 3 of
// each 128 (4 columns a load with kVec: t a multiple of 4, hb aligned).
// Each row sums its forward neighbours, its reverse ones
// (edge_gather.cuh), then diag * self, in f32.
template <bool kVec>
__device__ __forceinline__ void gather_tile(const int* __restrict__ ep,
                                            const int* __restrict__ ec,
                                            int* __restrict__ deg,
                                            const float* __restrict__ hb,
                                            float* __restrict__ a_s, int m0,
                                            int n, int e, int t, int k0) {
  constexpr int kWarps = FwdTile::kThreads / 32;
  constexpr int kRows = FwdTile::kBM / kWarps;
  constexpr int kV = kAK / 128;  // 4-column groups a lane takes in a row
  static_assert(kAK % 128 == 0 && FwdTile::kBM % kWarps == 0, "gather");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kc = k0 + lane * 4;
  int row[kRows], nd[kRows];
  float4 v[kRows][kV], self[kRows][kV];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = m0 + warp + j * kWarps;
    row[j] = i < n ? i : -2;
    nd[j] = 0;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      v[j][u] = zero4();
      self[j][u] = i < n ? load4<kVec>(hb, i, kc + 128 * u, t) : zero4();
    }
  }
  gather_rows(ep, ec, e, row,
              [&](int, int r, int u) {
                return load4<kVec>(hb, r, kc + 128 * u, t);
              },
              v, nd);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = warp + j * kWarps;
    if (k0 == 0 && lane == 0) deg[r] = nd[j];
    const float diag = (nd[j] > 0 ? 1.0f : 0.0f) + 1.0f;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const float4 sf = self[j][u];
      float4 out = v[j][u];
      add4(out, make_float4(diag * sf.x, diag * sf.y, diag * sf.z,
                            diag * sf.w));
      *reinterpret_cast<float4*>(a_s + r * kLda + lane * 4 + 128 * u) = out;
    }
  }
}

// The f32 forward (the bf16 one is spmm_fused_fwd_bf16_kernel below).
__global__ void __launch_bounds__(FwdTile::kThreads, 1)
spmm_fused_fwd_kernel(const int* __restrict__ parent,
                      const int* __restrict__ child,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ hin,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int n, int e, int t, int hdim,
                      size_t tiles_at, bool vec_h, bool vec_w) {
  using Tl = FwdTile;
  extern __shared__ __align__(16) int fwd_smem[];
  int* ep = fwd_smem;  // [e] the edge slots, then (16-byte aligned) the rest
  int* ec = ep + e;
  int* deg = reinterpret_cast<int*>(reinterpret_cast<char*>(fwd_smem) +
                                    tiles_at);  // [kBM]
  float* a_s = reinterpret_cast<float*>(deg + Tl::kBM);
  // W chunks, [kBK][kLdw] each
  float* ring = a_s + Tl::kBM * kLda;
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * Tl::kBN;
  const int m0 = blockIdx.z * Tl::kBM;
  const int chunks = (t + tf32x3::kBK - 1) / tf32x3::kBK;
  PhaseClock clk;  // thread 0: edge load, gather, W wait and product,
  clk.start();     // epilogue (slots 0-3)
  auto issue = [&](int c) {  // W rows c*kBK.. into slot c % kStages
    if (c < chunks)
      tf32x3::copy_tile<tf32x3::kBK, Tl::kBN, Tl::kLdw, Tl::kThreads>(
          ring + (c % kStages) * Tl::kStageFloats,
          w + (size_t)c * tf32x3::kBK * hdim, hdim,
          min(tf32x3::kBK, t - c * tf32x3::kBK), n0, hdim, vec_w);
    tf32x3::cp_async_commit();
  };
  load_edges(parent + (size_t)b * e, child + (size_t)b * e,
             mask + (size_t)b * e, n, e, ep, ec);
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  clk.mark(0);
  const float* hb = hin + (size_t)b * n * t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;

  float acc[1][Tl::kNT][4];
#pragma unroll
  for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][j][i] = 0.0f;

  for (int c = 0; c < chunks || c == 0; ++c) {  // T = 0 still needs deg
    const int kk = (c * tf32x3::kBK) % kAK;  // the chunk's column in a_s
    if (kk == 0) {
      __syncthreads();  // every warp is done with the previous gather
      if (vec_h)
        gather_tile<true>(ep, ec, deg, hb, a_s, m0, n, e, t,
                          c * tf32x3::kBK);
      else
        gather_tile<false>(ep, ec, deg, hb, a_s, m0, n, e, t,
                           c * tf32x3::kBK);
      clk.mark(1);
    }
    tf32x3::ring_wait();  // also publishes the gather
    if (c == chunks) break;
    issue(c + kStages - 1);
    const float* as = a_s + (wm * 16 + g) * kLda + kk + q;
    tf32x3::mma_chunk<1, Tl::kNT, Tl::kNT, Tl::kLdw>(
        acc, ring + (c % kStages) * Tl::kStageFloats + wn * Tl::kNT * 8,
        [&](int, int ks, float (&a)[4]) {
          const float* p = as + ks * 8;
          a[0] = p[0];
          a[1] = p[8 * kLda];
          a[2] = p[4];
          a[3] = p[8 * kLda + 4];
        });
    clk.mark(2);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wm * 16 + g + half * 8, row = m0 + r;
    if (row >= n) continue;
    const float denom = (float)deg[r] + (deg[r] > 0 ? 1.0f : 0.0f) + 1.0f;
    float* orow = out + ((size_t)b * n + row) * hdim;
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n0 + wn * Tl::kNT * 8 + j * 8 + 2 * q + i;
        if (col >= hdim) continue;
        const float z = (acc[0][j][half * 2 + i] + 2.0f * bias[col]) / denom;
        orow[col] = fmaxf(z, 0.0f);
      }
    }
  }
  clk.mark(3);
  if (threadIdx.x == 0) clk.flush();
}

// (S x) rows blockIdx.y * kPairRows.. of sentence blockIdx.x, one a warp,
// 128 kV columns from column tile blockIdx.z: x1's tiles first, then
// x2's.  A row sums its forward neighbours, its reverse ones
// (edge_gather.cuh), then diag * self, diag = [deg > 0] + 1.  T: the
// storage, f32 or bf16.
template <typename T, int kV, bool kVec>
__global__ void __launch_bounds__(kPairThreads)
spmm_sym_pair_kernel(const int* __restrict__ parent,
                     const int* __restrict__ child,
                     const unsigned char* __restrict__ mask,
                     const T* __restrict__ x1,
                     const T* __restrict__ x2, T* __restrict__ o1,
                     T* __restrict__ o2, int n, int e, int t1, int t2,
                     int tiles1) {
  extern __shared__ int pair_smem[];
  int* ep = pair_smem;
  int* ec = ep + e;
  const int b = blockIdx.x;
  load_edges(parent + (size_t)b * e, child + (size_t)b * e,
             mask + (size_t)b * e, n, e, ep, ec);
  const int i = blockIdx.y * kPairRows + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp; no barrier follows
  const bool first = (int)blockIdx.z < tiles1;
  const int t = first ? t1 : t2;
  const T* x = (first ? x1 : x2) + (size_t)b * n * t;
  T* o = (first ? o1 : o2) + (size_t)b * n * t;
  const int kc = (first ? blockIdx.z : blockIdx.z - tiles1) * 128 * kV +
                 threadIdx.x % 32 * 4;
  auto src = [&](int, int r, int u) {
    return load4<kVec>(x, r, kc + 128 * u, t);
  };
  float4 v[kV], self[kV];
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    v[u] = zero4();
    self[u] = src(0, i, u);
  }
  const int deg = gather_row(ep, ec, e, i, src, v);
  const float diag = (deg > 0 ? 1.0f : 0.0f) + 1.0f;
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    const float4 sf = self[u];
    float4 out = v[u];
    add4(out, make_float4(diag * sf.x, diag * sf.y, diag * sf.z,
                          diag * sf.w));
    store4<kVec>(o, i, kc + 128 * u, t, out);
  }
}

// ------------------------------------------------- sym pair, bf16 (8b)
constexpr int kPairBatch = 4;  // 8b: listed rows whose loads are in flight
constexpr int kPairBlocksPerSm = 4;  // registers for two groups' loads
                                     // (chunks of 4, off the main path: 3,
                                     // which they fit unspilled)

// Row blockIdx.y * kPairRows + warp of sentence blockIdx.x of both x1 and
// x2, taken as one row of chunks of kW columns (C: Chunks<kW>, kVec its
// 8-byte loads where kW = 4): x1's ceil(t1 / kW), then x2's; lane l takes
// chunks l + 32 u, group u after group u - 1.  A row sums its forward
// neighbours, its reverse ones, in list order, then diag * self, diag =
// [deg > 0] + 1.
template <int kW, bool kVec>
__global__ void __launch_bounds__(kPairThreads,
                                  kW == 8 ? kPairBlocksPerSm
                                          : kPairBlocksPerSm - 1)
spmm_sym_pair_bf16_kernel(const int* __restrict__ parent,
                          const int* __restrict__ child,
                          const unsigned char* __restrict__ mask,
                          const __nv_bfloat16* __restrict__ x1,
                          const __nv_bfloat16* __restrict__ x2,
                          __nv_bfloat16* __restrict__ o1,
                          __nv_bfloat16* __restrict__ o2, int n, int e,
                          int t1, int t2) {
  using C = Chunks<kW>;
  using Raw = typename C::Raw;
  using bf16 = __nv_bfloat16;
  extern __shared__ int pair16_smem[];
  int* ep = pair16_smem;
  int* ec = ep + e;
  EdgeClock clk;
  clk.start();
  const int b = blockIdx.x;
  const int i = blockIdx.y * kPairRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c1 = (t1 + kW - 1) / kW;
  const int chunks = c1 + (t2 + kW - 1) / kW;
  x1 += (size_t)b * n * t1;
  x2 += (size_t)b * n * t2;
  o1 += (size_t)b * n * t1;
  o2 += (size_t)b * n * t2;
  // the lane's chunk in group u, kept inside the row (a lane past its last
  // chunk loads that chunk's columns and stores nothing): its operand's
  // rows, their width and its column there
  struct Chunk {
    const bf16* x;
    bf16* o;
    int t, k;
  };
  auto chunk = [&](int u) {
    const int c = min(lane + 32 * u, chunks - 1);
    return c < c1 ? Chunk{x1, o1, t1, c * kW}
                  : Chunk{x2, o2, t2, (c - c1) * kW};
  };
  auto load = [&](int row, int u) {
    const Chunk w = chunk(u);
    return C::template load<kVec>(w.x + (size_t)row * w.t, w.k, w.t);
  };
  // group 0's own values before the edges' barrier: they need no edge
  Raw self0{};
  if (i < n) self0 = load(i, 0);
  clk.mark(edge_gather::kOwnRow);
  load_edges_wide(parent + (size_t)b * e, child + (size_t)b * e,
                  mask + (size_t)b * e, n, e, ep, ec);
  clk.mark(edge_gather::kEdges);
  if (i >= n) return;  // the whole warp; no barrier follows
  gather_groups<kPairBatch, true, C>(
      ep, ec, e, i, (chunks + 31) / 32, self0,
      [&](int ent, int u) {
        return load(ent & (edge_gather::kReverse - 1), u);
      },
      [&](int u) { return load(i, u); },
      [&](int u, float (&z)[kW], const Raw& self, int deg) {
        if (lane + 32 * u >= chunks) return;
        const float diag = (deg > 0 ? 1.0f : 0.0f) + 1.0f;
        float s[kW];
        C::widen(s, self);
#pragma unroll
        for (int c = 0; c < kW; ++c) z[c] += diag * s[c];
        const Chunk w = chunk(u);
        C::template store<kVec>(w.o + (size_t)i * w.t, w.k, w.t, z);
      },
      clk);
  clk.flush();
}

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

// Launches 8b (occ null), or writes its blocks an SM and its grid's blocks
// to occ[0], occ[1]: blocks of kPairRows rows of one sentence, all of a
// row of [x1 | x2].  Chunks of 8 columns where t1 and t2 are multiples of
// 8 and every base is 16-byte aligned, else of 4 (8-byte loads where both
// are multiples of 4 and the bases 8-byte aligned).
int sym_pair_bf16(const void* parent, const void* child, const void* mask,
                  const void* x1, const void* x2, void* o1, void* o2, int b,
                  int n, int e, int t1, int t2, void* stream, int* occ) {
  auto all_aligned = [&](int bytes) {
    return aligned(x1, bytes) && aligned(x2, bytes) && aligned(o1, bytes) &&
           aligned(o2, bytes);
  };
  const dim3 grid(b, (n + kPairRows - 1) / kPairRows);
  const size_t smem = edges_bytes(e);
  auto run = [&](auto kernel) {
    const cudaError_t err = set_smem(kernel, smem, 0);
    if (err != cudaSuccess) return (int)err;
    if (occ != nullptr) {
      occ[1] = (int)(grid.x * grid.y);
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ[0], kernel, kPairThreads, smem);
    }
    kernel<<<grid, kPairThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const int*>(parent), static_cast<const int*>(child),
        static_cast<const unsigned char*>(mask),
        static_cast<const __nv_bfloat16*>(x1),
        static_cast<const __nv_bfloat16*>(x2),
        static_cast<__nv_bfloat16*>(o1), static_cast<__nv_bfloat16*>(o2), n,
        e, t1, t2);
    return (int)cudaGetLastError();
  };
  if (t1 % 8 == 0 && t2 % 8 == 0 && all_aligned(16))
    return run(spmm_sym_pair_bf16_kernel<8, true>);
  return t1 % 4 == 0 && t2 % 4 == 0 && all_aligned(8)
             ? run(spmm_sym_pair_bf16_kernel<4, true>)
             : run(spmm_sym_pair_bf16_kernel<4, false>);
}

int forward_f32(const void* parent, const void* child, const void* mask,
                const void* h, const void* w, const void* bias, void* out,
                int b, int n, int e, int t, int hdim, void* stream) {
  const size_t tiles_at = edges_bytes(e);  // the tiles follow ep, ec
  const size_t smem = tiles_at + kFwdTileBytes;
  cudaError_t err = set_smem(spmm_fused_fwd_kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  const bool vec_h = t % 4 == 0 && aligned(h, vec_bytes<float>());
  // W chunks stream by 16-byte copies, 4 columns each
  const bool vec_w = hdim % 4 == 0 && aligned(w, 16);
  dim3 grid(b, (hdim + FwdTile::kBN - 1) / FwdTile::kBN,
            (n + FwdTile::kBM - 1) / FwdTile::kBM);
  spmm_fused_fwd_kernel<<<grid, FwdTile::kThreads, smem,
                          (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), n, e, t, hdim, tiles_at, vec_h, vec_w);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- forward, bf16 (7b)
namespace fwd16 {

using bf16 = __nv_bfloat16;
using edge_gather::bf16x4;
constexpr int kBM = 48;                  // rows a block, of one sentence
constexpr int kWarpsM = 3, kWarpsN = 4;  // the product: 16 x 56 a warp
constexpr int kWarps = kWarpsM * kWarpsN;  // gather and multiply
constexpr int kCompute = 32 * kWarps;
constexpr int kThreads = kCompute + 32;  // and a warp that copies W
constexpr int kNT = 7;                   // n-tiles of 8 a warp
constexpr int kBN = 8 * kNT * kWarpsN;   // 224 columns a block
constexpr int kAB = 128;                 // t columns of a staged block, a
                                         // lane's 4 of each 128
constexpr int kABlocks = 3;
constexpr int kPass = kABlocks * kAB;    // t a pass: the resident tile
constexpr int kLda = kPass + 8;          // bf16 row stride: ldmatrix rows
                                         // 16 bytes apart in the banks
constexpr int kKC = 32;                  // W rows a chunk: two k-steps
constexpr int kStages = 6;               // W chunks in the ring at most
constexpr int kWBlock = kKC * 128;       // [32 rows, 64 columns] swizzled
constexpr int kWStage = (kBN + 63) / 64 * kWBlock;  // 16 KB a chunk
constexpr int kRows = kBM / kWarps;      // rows a warp gathers
constexpr int kMaxStageRows = 256;       // a TMA box's rows at most
// the bytes past the edge slots and the lists: barriers (kStages W
// chunks full and empty, the staged rows), list lengths, degrees, the
// (S h) tile, 1 KB
// to align the W ring, the deepest ring; the staged rows of h follow the
// ring
constexpr size_t kTileBytes = 8 * (2 * kStages + 2) + 4 * (kWarps + kBM) +
                              2 * (size_t)kBM * kLda + 1024 +
                              (size_t)kStages * kWStage;
static_assert(kPass % kKC == 0 && kBM == 16 * kWarpsM, "tiles");
static_assert(kBM % kWarps == 0, "rows");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
// c += A B: A 16 x 16 and B 16 x 8 bf16 (fragments as ldmatrix gives
// them), c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the gather-and-multiply warps' own barrier (the copying warp goes on)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCompute) : "memory");
}

__device__ __forceinline__ float4 widen4(const bf16x4& q) {
  return make_float4(__low2float(q.lo), __high2float(q.lo),
                     __low2float(q.hi), __high2float(q.hi));
}

// A warp's list in shared memory: for each of its rows in [0, n) (m0 +
// warp + j kWarps, j < kRows), the row's forward neighbours (its children)
// in edge order, then its reverse ones (its parents), the order
// edge_gather.cuh's walks sum them in, then one entry for the row itself,
// ~(2 row + [deg > 0]).  Built once a block by two ballot walks over the
// edge slots (counts, then places), so that the gather walks no ballot;
// the rows' degrees go to deg.  The warps' lists lie one after the other
// (wtot [kWarps]: their lengths, at most 2E + kBM in all); returns this
// warp's [first, end).
struct Span {
  int first, end;
};

__device__ __forceinline__ Span build_list(const int* __restrict__ ep,
                                           const int* __restrict__ ec,
                                           int* __restrict__ list,
                                           int* __restrict__ wtot,
                                           int* __restrict__ deg, int m0,
                                           int n, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int row[kRows], cnt[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = m0 + warp + j * kWarps;
    row[j] = i < n ? i : -2;  // -2 matches no slot (-1 marks a dropped one)
    cnt[j] = 0;
  }
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const int* key = dir == 0 ? ep : ec;
    for (int q0 = 0; q0 < e; q0 += 32) {
      const int kq = q0 + lane < e ? key[q0 + lane] : -1;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        cnt[j] += __popc(__ballot_sync(0xffffffffu, kq == row[j]));
    }
  }
  int total = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (lane == 0) deg[warp + j * kWarps] = cnt[j];
    total += row[j] >= 0 ? cnt[j] + 1 : 0;
  }
  if (lane == 0) wtot[warp] = total;
  compute_sync();
  int first = 0;
  for (int w = 0; w < warp; ++w) first += wtot[w];
  int run[kRows];  // where each row's next entry goes
  int at = first;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    run[j] = at;
    if (row[j] >= 0) {
      if (lane == 0) list[at + cnt[j]] = ~(2 * row[j] + (cnt[j] > 0));
      at += cnt[j] + 1;
    }
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const int* key = dir == 0 ? ep : ec;
    const int* nbr = dir == 0 ? ec : ep;
    for (int q0 = 0; q0 < e; q0 += 32) {
      const int q = q0 + lane;
      const int kq = q < e ? key[q] : -1;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const unsigned bits = __ballot_sync(0xffffffffu, kq == row[j]);
        if (kq == row[j]) list[run[j] + __popc(bits & below)] = nbr[q];
        run[j] += __popc(bits);
      }
    }
  }
  __syncwarp();
  return {first, at};
}

constexpr int kU = 8;  // list entries whose loads a gather step issues together

// (S h) of the warp's rows, columns k..k + 3 of lane l's at k = k0 + 4l,
// into the tile a_s [kBM][kLda] at column col + 4l, rounded to bf16 once;
// rows past n are not written.  The list is walked kU entries a step, the
// step's loads issued together, then summed in list order: a row's
// neighbours in f32, then diag * self, diag = [deg > 0] + 1, rounded
// into its tile row; row_at(r, k) gives columns k..k + 3 of sentence row r.
template <class Row>
__device__ __forceinline__ void gather_block(const int* __restrict__ list,
                                             Span span,
                                             bf16* __restrict__ a_s, int m0,
                                             int k0, int col, Row&& row_at) {
  const int lane = threadIdx.x % 32;
  const int kc = k0 + lane * 4;
  bf16* dst = a_s + col + lane * 4 - m0 * kLda;
  float4 acc = zero4();
  for (int p = span.first; p < span.end; p += kU) {
    int x[kU];
    float4 u[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i)
      if (p + i < span.end) {
        x[i] = list[p + i];
        u[i] = row_at(x[i] >= 0 ? x[i] : ~x[i] >> 1, kc);
      }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      if (p + i >= span.end) break;
      if (x[i] >= 0) {
        add4(acc, u[i]);
      } else {
        const float diag = (float)((~x[i] & 1) + 1);  // [deg > 0] + 1
        add4(acc, make_float4(diag * u[i].x, diag * u[i].y, diag * u[i].z,
                              diag * u[i].w));
        bf16x4 q;
        q.lo = __floats2bfloat162_rn(acc.x, acc.y);
        q.hi = __floats2bfloat162_rn(acc.z, acc.w);
        *reinterpret_cast<bf16x4*>(dst + (~x[i] >> 1) * kLda) = q;
        acc = zero4();
      }
    }
  }
}

// Block (sentence blockIdx.x, columns blockIdx.y * kBN.., rows
// blockIdx.z * kBM..): twelve warps that gather and multiply, and one that
// copies W.  Warp 0's first lanes put the sentence's rows of h for the
// pass in flight by TMA (where stage_rows > 0: [kABlocks][n][128], zeros
// past T; else the gather reads h from device memory); the copying warp
// streams W's chunks by TMA from the kernel's start into a ring of nst
// slots (full and empty mbarriers), in the 128-byte-swizzled MN-major
// blocks that ldmatrix .trans reads with the same XOR (where TMA cannot
// take W, the twelve warps copy it by cp.async into the same layout).
// The twelve list their rows' neighbours, gather (S h) into the resident
// bf16 tile, then multiply it by W chunk by chunk (ldmatrix,
// mma.sync.m16n8k16, f32 sums), each warp as soon as the chunk has landed
// and handing the slot back when it is done; T past the tile's 384
// columns in passes.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
spmm_fused_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_h,
                           const int* __restrict__ parent,
                           const int* __restrict__ child,
                           const unsigned char* __restrict__ mask,
                           const bf16* __restrict__ hin,
                           const bf16* __restrict__ w,
                           const bf16* __restrict__ bias,
                           bf16* __restrict__ out, int n, int e, int t,
                           int hdim, size_t tiles_at, int nst,
                           int stage_rows, bool tma_w, bool vec_w) {
  extern __shared__ __align__(16) int fwd16_smem[];
  int* ep = fwd16_smem;  // [e] the edge slots, [2e + kBM] the warps'
  int* ec = ep + e;      // lists, then (16-byte aligned) the rest
  int* list = ec + e;
  unsigned char* tiles = reinterpret_cast<unsigned char*>(fwd16_smem) +
                         tiles_at;
  const uint32_t bars = tf32x3::smem_u32(tiles);
  auto full = [&](int i) { return bars + 8 * i; };  // W chunk in slot i
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };  // read
  const uint32_t h_full = bars + 16 * kStages;      // the staged rows
  int* wtot = reinterpret_cast<int*>(tiles + 8 * (2 * kStages + 2));
  int* deg = wtot + kWarps;                         // [kBM]
  bf16* a_s = reinterpret_cast<bf16*>(deg + kBM);   // [kBM][kLda]
  // the W ring and the staged rows start on 1024-byte boundaries (the
  // swizzle repeats every 1024 bytes)
  const uint32_t a_end = tf32x3::smem_u32(a_s + kBM * kLda);
  const uint32_t ring_s = (a_end + 1023u) & ~1023u;
  const uint32_t stage_s = ring_s + nst * kWStage;
  unsigned char* ring = tiles + (ring_s - bars);
  const bf16* stage = reinterpret_cast<const bf16*>(tiles + (stage_s - bars));
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * kBM;
  const int chunks = (t + kKC - 1) / kKC;
  const int passes = t > 0 ? (t + kPass - 1) / kPass : 1;
  const bf16* hb = hin + (size_t)b * n * t;
  PhaseClock clk;  // thread 0, slots 0-7: see tools/spmm_phases.py
  clk.start();

  // W rows c kKC.. into slot c % nst, zeros past T and H, by the
  // gather-and-multiply threads' cp.async (one group a chunk) where TMA
  // cannot take W
  auto issue = [&](int c) {
    if (c < chunks)
      hopper::load_w<kKC, kBN>(ring + c % nst * kWStage,
                               w + (size_t)c * kKC * hdim, hdim,
                               min(kKC, t - c * kKC), n0, vec_w,
                               threadIdx.x, kCompute);
    tf32x3::cp_async_commit();
  };
  // the pass's columns [t0, t0 + kPass) of the sentence's rows, one box
  // of 128 columns by n rows a lane of warp 0
  const int lane0 = threadIdx.x;  // a lane of warp 0 below 32
  auto stage_pass = [&](int t0) {
    if (stage_rows == 0 || lane0 >= kABlocks) return;
    const int blocks = min(kABlocks, (t - t0 + kAB - 1) / kAB);
    if (lane0 == 0) hopper::bar_expect(h_full, blocks * n * kAB * 2);
    __syncwarp((1u << kABlocks) - 1);
    if (lane0 < blocks)
      hopper::tma_2d(stage_s + lane0 * n * kAB * 2, &map_h, t0 + lane0 * kAB,
                     b * n, h_full);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::bar_init(full(i), 1);
      hopper::bar_init(empty(i), kWarps);
    }
    hopper::bar_init(h_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_pass(0);
  if (!tma_w && threadIdx.x < kCompute)
    for (int c = 0; c < nst - 1; ++c) issue(c);
  clk.mark(0);
  load_edges(parent + (size_t)b * e, child + (size_t)b * e,
             mask + (size_t)b * e, n, e, ep, ec);  // ends with a barrier
  if (threadIdx.x >= kCompute) {  // ------------------------ the W copies
    // W chunk c into slot c % nst once the warps are done with the
    // chunk before it there: TMA boxes of 32 rows x 64 columns, one a lane
    // (lane 0 first expects their bytes)
    constexpr int kWBoxes = kWStage / kWBlock;
    const int lane = threadIdx.x % 32;
    if (!tma_w || lane >= kWBoxes) return;
    for (int c = 0; c < chunks; ++c) {
      const int slot = c % nst;
      if (c >= nst) hopper::bar_wait(empty(slot), (c / nst - 1) & 1);
      if (lane == 0) hopper::bar_expect(full(slot), kWStage);
      __syncwarp((1u << kWBoxes) - 1);
      hopper::tma_2d(ring_s + slot * kWStage + lane * kWBlock, &map_w,
                     n0 + 64 * lane, c * kKC, full(slot));
    }
    return;
  }
  clk.mark(1);
  const Span span = build_list(ep, ec, list, wtot, deg, m0, n, e);
  clk.mark(2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  float b2[kNT][2];  // 2b at this thread's columns
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = n0 + wn * 8 * kNT + j * 8 + 2 * q + i;
      b2[j][i] = col < hdim ? 2.0f * to_f32(bias[col]) : 0.0f;
    }
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  // ldmatrix rows: A rows 16 wm + lane % 16 at columns + 8 (lane / 16);
  // B (k) rows lane % 16 of the k-step, at the n-tile pair's columns
  // + 8 (lane / 16), in the swizzled blocks: piece XOR (row mod 8)
  const uint32_t a_lane =
      tf32x3::smem_u32(a_s) +
      2 * ((wm * 16 + lane % 16) * kLda + lane / 16 * 8);
  uint32_t b_col[(kNT + 1) / 2];
#pragma unroll
  for (int jp = 0; jp < (kNT + 1) / 2; ++jp) {
    const int col = wn * 8 * kNT + (2 * jp + lane / 16) * 8;
    b_col[jp] = col / 64 * kWBlock + ((col % 64 / 8 ^ lane % 8) << 4);
  }
  const uint32_t b_lane = ring_s + lane % 16 * 128;

  for (int pass = 0, c = 0; pass < passes; ++pass) {
    const int t0 = pass * kPass;
    if (pass > 0) {  // every warp is done with the last pass's tile
      compute_sync();
      stage_pass(t0);
    }
    if (stage_rows > 0) hopper::bar_wait(h_full, pass & 1);
    clk.mark(3);
    const int blocks = max(1, min(kABlocks, (t - t0 + kAB - 1) / kAB));
    for (int kb = 0; kb < blocks; ++kb) {
      if (stage_rows > 0)  // columns k..k + 3 of the pass, staged
        gather_block(list, span, a_s, m0, kb * kAB, kb * kAB,
                     [&](int r, int k) {
                       return widen4(*reinterpret_cast<const bf16x4*>(
                           stage + ((k / kAB) * stage_rows + r) * kAB +
                           k % kAB));
                     });
      else  // from device memory
        gather_block(list, span, a_s, m0, t0 + kb * kAB, kb * kAB,
                     [&](int r, int k) { return load4<kVec>(hb, r, k, t); });
    }
    compute_sync();  // the tile is written
    clk.mark(4);
    for (const int end = min(chunks, (t0 + kPass) / kKC); c < end; ++c) {
      if (tma_w) {  // chunk c has landed
        hopper::bar_wait(full(c % nst), c / nst & 1);
      } else {  // chunk c (and those after it) landed; c - 1 done with
        tf32x3::cp_async_wait<0>();
        compute_sync();
        issue(c + nst - 1);
      }
      clk.mark(5);
      const int kk = c * kKC - t0;
      const uint32_t ws = b_lane + c % nst * kWStage;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, a_lane + 2 * (kk + ks * 16));
        const uint32_t wk = ws + ks * 16 * 128;
#pragma unroll
        for (int j = 0; j + 1 < kNT; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, wk + b_col[j / 2]);
          mma_bf16(acc[j], a, bf[0], bf[1]);
          mma_bf16(acc[j + 1], a, bf[2], bf[3]);
        }
        if constexpr (kNT % 2 == 1) {
          uint32_t bf[2];
          ldmatrix_x2_trans(bf, wk + b_col[kNT / 2]);
          mma_bf16(acc[kNT - 1], a, bf[0], bf[1]);
        }
      }
      // this warp's reads of the slot are done: the copying warp may
      // refill it
      if (tma_w && lane == 0) hopper::bar_arrive(empty(c % nst));
      clk.mark(6);
    }
  }
  tf32x3::cp_async_wait<0>();  // no copy is left in flight at exit
  compute_sync();  // T = 0: the degrees

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wm * 16 + g + half * 8, row = m0 + r;
    if (row >= n) continue;
    const float denom = (float)deg[r] + (deg[r] > 0 ? 1.0f : 0.0f) + 1.0f;
    bf16* orow = out + ((size_t)b * n + row) * hdim;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn * 8 * kNT + j * 8 + 2 * q;
      float z[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        z[i] = fmaxf((acc[j][half * 2 + i] + b2[j][i]) / denom, 0.0f);
      if (col + 1 < hdim && hdim % 2 == 0)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(z[0], z[1]);
      else
        for (int i = 0; i < 2 && col + i < hdim; ++i)
          orow[col + i] = __float2bfloat16_rn(z[i]);
    }
  }
  clk.mark(7);
  if (threadIdx.x == 0) clk.flush();
}

int forward(const void* parent, const void* child, const void* mask,
            const void* h, const void* w, const void* bias, void* out, int b,
            int n, int e, int t, int hdim, void* stream) {
  // the tiles follow the edge slots and the lists: 4e + kBM ints; the W
  // ring as deep as fits, from kStages down to 2; the sentence's rows of a
  // pass staged by TMA where they fit too (the main path's N = 96, E = 96:
  // 72 KB beside six chunks), else read from device memory
  const size_t tiles_at = (4 * (4 * (size_t)e + kBM) + 15) / 16 * 16;
  const size_t ring_at = tiles_at + kTileBytes - (size_t)kStages * kWStage;
  int nst = kStages;
  while (nst > 2 && ring_at + (size_t)nst * kWStage > edge_gather::kMaxSmem)
    --nst;
  const size_t base = ring_at + (size_t)nst * kWStage;
  const size_t staged = base + (size_t)kABlocks * n * kAB * 2;
  const bool vec_h = t % 8 == 0 && aligned(h, 16);
  const bool vec_w = hdim % 8 == 0 && aligned(w, 16);
  CUtensorMap map_w{}, map_h{};
  const cuuint64_t w_dim[2] = {(cuuint64_t)hdim, (cuuint64_t)t};
  const cuuint64_t w_stride[1] = {(cuuint64_t)hdim * 2};
  const cuuint32_t w_box[2] = {64, kKC};
  const bool tma_w = vec_w && t > 0 &&
                     hopper::bf16_tensor_map(&map_w, w, 2, w_dim, w_stride,
                                             w_box);
  const cuuint64_t h_dim[2] = {(cuuint64_t)t, (cuuint64_t)b * n};
  const cuuint64_t h_stride[1] = {(cuuint64_t)t * 2};
  const cuuint32_t h_box[2] = {kAB, (cuuint32_t)n};
  const bool stage = vec_h && t > 0 && n <= kMaxStageRows &&
                     staged <= edge_gather::kMaxSmem &&
                     hopper::bf16_tensor_map(&map_h, h, 2, h_dim, h_stride,
                                             h_box, false);
  const size_t smem = stage ? staged : base;
  const bool vec4 = t % 4 == 0 && aligned(h, vec_bytes<bf16>());
  const auto kernel = vec4 ? spmm_fused_fwd_bf16_kernel<true>
                           : spmm_fused_fwd_bf16_kernel<false>;
  cudaError_t err = set_smem(kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, (hdim + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      map_w, map_h, static_cast<const int*>(parent),
      static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const bf16*>(h),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), n, e, t, hdim, tiles_at, nst, stage ? n : 0,
      tma_w, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace fwd16

template <typename T>
int sym_pair(const void* parent, const void* child, const void* mask,
             const void* x1, const void* x2, void* o1, void* o2, int b, int n,
             int e, int t1, int t2, void* stream) {
  const int vb = vec_bytes<T>();
  const bool vec = t1 % 4 == 0 && t2 % 4 == 0 && aligned(x1, vb) &&
                   aligned(x2, vb) && aligned(o1, vb) && aligned(o2, vb);
  // 128 kV columns a tile, kV = 1-3 so that one tile covers up to 384
  const int groups = ((t1 > t2 ? t1 : t2) + 127) / 128;
  const int kv = groups <= 1 ? 1 : groups == 2 ? 2 : 3;
  const int tiles1 = (t1 + 128 * kv - 1) / (128 * kv);
  const int tiles2 = (t2 + 128 * kv - 1) / (128 * kv);
  const dim3 grid(b, (n + kPairRows - 1) / kPairRows, tiles1 + tiles2);
  const size_t smem = edges_bytes(e);
  auto launch = [&](auto kernel) {
    cudaError_t err = set_smem(kernel, smem, 0);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kPairThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const int*>(parent), static_cast<const int*>(child),
        static_cast<const unsigned char*>(mask), static_cast<const T*>(x1),
        static_cast<const T*>(x2), static_cast<T*>(o1), static_cast<T*>(o2),
        n, e, t1, t2, tiles1);
    return (int)cudaGetLastError();
  };
  if (vec)
    return kv == 1   ? launch(spmm_sym_pair_kernel<T, 1, true>)
           : kv == 2 ? launch(spmm_sym_pair_kernel<T, 2, true>)
                     : launch(spmm_sym_pair_kernel<T, 3, true>);
  return kv == 1   ? launch(spmm_sym_pair_kernel<T, 1, false>)
         : kv == 2 ? launch(spmm_sym_pair_kernel<T, 2, false>)
                   : launch(spmm_sym_pair_kernel<T, 3, false>);
}

}  // namespace

extern "C" {

#ifdef SPMM_PHASES
int spmm_phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, spmm_phases, sizeof(spmm_phases));
}
int spmm_phases_zero() {
  const unsigned long long zero[kPhaseSlots + 1] = {};
  return (int)cudaMemcpyToSymbol(spmm_phases, zero, sizeof(zero));
}
#endif

int spmm_fused_forward_f32(const void* parent, const void* child,
                           const void* mask, const void* h, const void* w,
                           const void* bias, void* out, int b, int n, int e,
                           int t, int hdim, void* stream) {
  return forward_f32(parent, child, mask, h, w, bias, out, b, n, e, t, hdim,
                     stream);
}

int spmm_fused_forward_bf16(const void* parent, const void* child,
                            const void* mask, const void* h, const void* w,
                            const void* bias, void* out, int b, int n, int e,
                            int t, int hdim, void* stream) {
  return fwd16::forward(parent, child, mask, h, w, bias, out, b, n, e, t,
                        hdim, stream);
}

int spmm_fused_sym_pair_f32(const void* parent, const void* child,
                            const void* mask, const void* x1, const void* x2,
                            void* o1, void* o2, int b, int n, int e, int t1,
                            int t2, void* stream) {
  return sym_pair<float>(parent, child, mask, x1, x2, o1, o2, b, n, e, t1,
                         t2, stream);
}

int spmm_fused_sym_pair_bf16(const void* parent, const void* child,
                             const void* mask, const void* x1, const void* x2,
                             void* o1, void* o2, int b, int n, int e, int t1,
                             int t2, void* stream) {
  return sym_pair_bf16(parent, child, mask, x1, x2, o1, o2, b, n, e, t1, t2,
                       stream, nullptr);
}

// 8b's blocks an SM (occ[0]) and its grid's blocks (occ[1]) for these
// operands: what spmm_fused_sym_pair_bf16 would launch.
int spmm_fused_sym_pair_bf16_occupancy(const void* parent, const void* child,
                                       const void* mask, const void* x1,
                                       const void* x2, void* o1, void* o2,
                                       int b, int n, int e, int t1, int t2,
                                       void* occ) {
  return sym_pair_bf16(parent, child, mask, x1, x2, o1, o2, b, n, e, t1, t2,
                       nullptr, static_cast<int*>(occ));
}

const char* spmm_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
