// Grouped (ragged) matmul, backward: for y[m] = x[m] @ s[gid(m)] over rows
// sorted so that each group is contiguous,
//   dx[m]  = g[m] @ s[gid(m)]ᵀ
//   ds[r]  = Σ_{m in group r} x[m]ᵀ g[m]
//
// Replaces the Pallas TPU kernel gcn_tpu/ops/pallas/grouped_matmul.py::
// _bwd_kernel (launched by _gmm_bwd, the custom VJP of grouped_matmul).
// Same contract:
//   x           [M, T]
//   g           [M, H]      the cotangent, in x's dtype
//   s           [R, T, H]
//   group_ends  [R] int32   cumsum(group_sizes); rows past the last end
//                           belong to the last group
//   dx          [M, T]      in x's dtype, accumulated in f32
//   ds          [R, T, H]   f32; zero for every group with no rows, the last
//                           one included even when rows past the end exist
// and one scratch: part [grouped_matmul_backward_partials(M), T, H] f32.
// Storage is f32 or bf16.
//
// What bounds it on the H100.  At the main path's shapes (M = 9600 stacked
// band rows, T = 400 or 200, H = 200, R = 87) it does 4 M T H = 3.1 (1.5)
// GFLOP.  The f32 instance moves x, g, the used groups' S in and dx, all
// R groups' dS out once, 92 (50) MB: on the 3xTF32 tensor-core mainloop
// (165 TFLOP/s effective) the bytes bound it, 0.028 (0.015) ms, where the
// CUDA cores' f32 FMA rate would set 0.046 (0.023).  The bf16 instance
// moves 60 (32) MB, of which dS's f32 writes are 46 %: 0.018 (0.0096) ms
// at 3.35 TB/s, against 0.0031 (0.0016) ms for its products at the bf16
// tensor cores' 989 TFLOP/s.  Both are bound by bytes.
//
// The TPU kernel fused both products into one pass over the visit schedule
// so that each group's S block was read from HBM once, while dS of that
// group stayed resident in VMEM across its consecutive visits.  On the card
// the two products have different natural tilings, so the entry point
// launches them back to back, each over a work list cut per group
// (grouped_tiles.cuh):
//   * dx takes the forward's list, 128 rows of one group a piece, by 200
//     (f32: 208) columns of T (two tiles at T = 400);
//   * dS cuts each group into chunks of at most 256 rows (gmm::kKC): a
//     piece is one chunk by 128 rows of T by 200 (f32: 208) columns of H.
//     The padding groups hold about 2070 of the 9600 rows each, the next
//     largest 97: where one block walked a whole group, the two padding
//     groups set the tail; at 256 rows a chunk their pieces are 8 k-chunks
//     of 32 (bf16: 4 of 64) deep against 2-4 (1-2) for the others, and the
//     list starts them first.  (Chunks of 128 rows halve that depth for
//     twice the partials, and were slower in f32.)  A group's first chunk
//     writes dS[g], each later one a partial, and a third launch adds the
//     partials into dS[g] in chunk order: no float atomics, so two calls
//     give the same bits, and an empty group's single chunk of no rows
//     writes its zeros.
// g is read by both products and x by the forward and dS; S only by dx.
//
// f32 (grouped_matmul_dx_kernel, grouped_matmul_ds_kernel): one CTA a
// piece on the 3xTF32 mainloop of grouped_tiles.cuh.
//
// bf16 (grouped_matmul_ds_bf16_kernel, grouped_matmul_dx_bf16_kernel,
// then grouped_matmul_ds_sum_bf16_kernel).  A bf16 x bf16 product is
// exact in f32, so both products run on the bf16 tensor cores as they
// are: wgmma.mma_async.m64n200k16 (bf16 in, f32 sums), 200 columns a tile
// (T = 400 in two tiles, H = 200 in one).  Each kernel is persistent: one
// CTA an SM walks the units of its list (a piece by a column tile; dS:
// and by a 128-row tile of T), so the loads of one unit overlap the
// products and stores of the one before.  A warp finds its units' pieces
// with one scan of the group ends for up to 32 units (a scan a unit, as
// the f32 kernels do, cost 1700-3200 SM cycles on the H100), from a copy
// of the ends in shared memory.  A CTA is 11b's and 3b's three warpgroups:
// two consumers of 64 output rows each (a 64 x 200 f32 fragment, 100
// registers a thread) and a producer, one thread of which issues TMA
// copies (tensor maps from the driver's cuTensorMapEncodeTiled, zeros
// outside the matrices) into a ring of 64-deep k-chunks (full and empty
// mbarriers), in the 128-byte-swizzled layouts that wgmma reads
// (hopper_tile.cuh):
//   dx = g S[g]^T, K = H: A = the piece's 128 g rows by 64 of H, K-major
//     (g's own layout, 16 KB); B = S[g]'s 200 rows of T by the same 64 of
//     H, also K-major (S[g] [T][H] read as [K = H, N = T]: 25 KB), so both
//     transpose flags are clear.  H = 200 is four k-chunks, the last with
//     8 real values and TMA's zeros, and the ring holds all four.  dx
//     rows past the group's end are computed and not stored.  Rounded to
//     bf16 once, into a tile in shared memory whose rows the warpgroup
//     then stores 16 bytes a thread (from the fragments, a warp's store
//     wrote half sectors).
//   dS = x^T g, K = the chunk's rows: A = 64 rows of x by the tile's 128
//     of T, MN-major (two [64 rows, 64 of T] blocks, one a consumer); B =
//     the same 64 rows of g by 256 of H (four blocks), MN-major: both
//     transpose flags set, each operand in its row-major layout.  A box
//     that starts at the chunk's rows also brings the next group's: in a
//     chunk's last k-chunk the consumers zero the rows past its end in
//     all six blocks, fence the generic proxy's writes against the async
//     proxy that wgmma reads by, and meet at a named barrier before any
//     product reads the slot.  The f32 sums (k-steps of 16 over the
//     chunk's rows) go to a 64 x 200 tile in shared memory a warpgroup,
//     which one TMA store copies to dS[g] or a partial (rows past T not
//     written) while the consumers go on; the ring is two stages deep to
//     leave room for the two tiles.  The partials' sum is add_partials's,
//     in its order, with each thread's loads of a group's partials issued
//     together before its adds.
// The dS kernel runs first, and the dx kernel and the sum follow it as
// programmatic dependent launches: dx's CTAs take the SMs that dS's leave
// while dS's longest units (the list's first) run, and the sum's launch
// overlaps dx's end.  dx reads nothing dS writes, but waits for the dS
// grid before it ends, and the sum waits for dx's, so what follows in the
// stream finds both written (in this order the call took 0.0477 ms at
// T = 400 against 0.0502 with dx first, in one run on an NVIDIA H100
// 80GB HBM3 at 700 W).
// A consumer warpgroup with no rows of the unit (dx: past the group's
// end; dS: past T) waits and hands back like the other but issues no
// product.  Operands that TMA cannot take (T or H not a multiple of 8, a
// base not 16-byte aligned) go through the producer's 128 threads instead,
// as in 3b: cp.async of 16 bytes where the rows allow, element by element
// where not; dS where H is not a multiple of 4 is stored from the
// fragments.  tools/gmm_phases.py clocks the phases (-DGMM_PHASES).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "grouped_tiles.cuh"
#include "hopper_tile.cuh"

namespace {

__global__ void __launch_bounds__(gmm::Tl::kThreads, gmm::kMinBlocks)
grouped_matmul_dx_kernel(const float* __restrict__ g,
                         const float* __restrict__ s,
                         const int* __restrict__ group_ends,
                         float* __restrict__ dx, int m, int t, int h, int r,
                         bool vec_g, bool vec_s) {
  gmm::tile_product<gmm::kDx>(g, s, group_ends, dx, nullptr, m, t, h, r,
                              vec_g, vec_s);
}

__global__ void __launch_bounds__(gmm::Tl::kThreads, gmm::kMinBlocks)
grouped_matmul_ds_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         const int* __restrict__ group_ends,
                         float* __restrict__ ds, float* __restrict__ part,
                         int m, int t, int h, int r, bool vec_x, bool vec_g) {
  gmm::tile_product<gmm::kDs>(x, g, group_ends, ds, part, m, t, h, r, vec_x,
                              vec_g);
}

template <typename V>
__global__ void grouped_matmul_ds_sum_kernel(const int* __restrict__ ends,
                                             const float* __restrict__ part,
                                             float* __restrict__ ds, int m,
                                             int t, int h, int r) {
  gmm::add_partials<V>(ends, part, ds, m, t, h, r);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch_f32(const void* x, const void* g, const void* s,
               const void* group_ends, void* dx, void* ds, void* part, int m,
               int t, int h, int r, void* stream) {
  using gmm::Tl;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* ends = static_cast<const int*>(group_ends);
  constexpr size_t kDxSmem = gmm::Geo<gmm::kDx>::kSmem;
  constexpr size_t kDsSmem = gmm::Geo<gmm::kDs>::kSmem;
  cudaError_t e = allow_smem(grouped_matmul_dx_kernel, kDxSmem);
  if (e == cudaSuccess) e = allow_smem(grouped_matmul_ds_kernel, kDsSmem);
  if (e != cudaSuccess) return (int)e;
  const int col_tiles_t = (t + Tl::kBN - 1) / Tl::kBN;
  const int col_tiles_h = (h + Tl::kBN - 1) / Tl::kBN;
  grouped_matmul_dx_kernel<<<dim3(gmm::tile_bound(m, r), col_tiles_t),
                             Tl::kThreads, kDxSmem, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(s), ends,
      static_cast<float*>(dx), m, t, h, r, gmm::vec_ok<float>(g, h),
      gmm::vec_ok<float>(s, h));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  grouped_matmul_ds_kernel<<<dim3(gmm::chunk_bound(m, r), col_tiles_h,
                                  (t + gmm::kBM - 1) / gmm::kBM),
                             Tl::kThreads, kDsSmem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), ends,
      static_cast<float*>(ds), static_cast<float*>(part), m, t, h, r,
      gmm::vec_ok<float>(x, t), gmm::vec_ok<float>(g, h));
  e = cudaGetLastError();
  if (e != cudaSuccess || gmm::partial_slots(m) == 0) return (int)e;
  const size_t count = (size_t)t * h;
  const bool vec = count % 4 == 0;  // ds and part are 16-byte aligned
  const int threads = 256;
  const size_t blocks = ((vec ? count / 4 : count) + threads - 1) / threads;
  const auto sum_kernel = vec ? grouped_matmul_ds_sum_kernel<float4>
                              : grouped_matmul_ds_sum_kernel<float>;
  sum_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      ends, static_cast<const float*>(part), static_cast<float*>(ds), m, t,
      h, r);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
namespace gmm16b {

// The bf16 instance's third launch: gmm::add_partials's sums in its order
// (dS[g] plus each partial in chunk order, float4 a thread where [T, H]
// holds a whole number of them), with a thread's loads of a group's
// partials issued kBatch at a time ahead of its adds: add_partials waits a
// memory latency a partial (5.6 us at T = 400 on the H100).
template <typename V>
__global__ void grouped_matmul_ds_sum_bf16_kernel(
    const int* __restrict__ ends, const float* __restrict__ part,
    float* __restrict__ ds, int m, int t, int h, int r) {
  // launched as the dx kernel's dependent: until it (and through it the dS
  // kernel) has ended and its writes are seen
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int kBatch = 8;
  constexpr int kPer = sizeof(V) / sizeof(float);
  const size_t th = (size_t)t * h, count = th / kPer;
  const int lane = threadIdx.x % 32;
  int slots = 0;  // partial slots of the groups before this batch
  for (int g0 = 0; g0 < r; g0 += 32) {
    const int g = g0 + lane;
    const int pieces =
        g < r
            ? gmm::piece_count<gmm::kKC, true>(gmm::group_span(ends, g, r, m))
            : 1;
    const int incl = gmm::warp_inclusive_sum(pieces - 1);
    for (unsigned multi = __ballot_sync(~0u, pieces > 1); multi;
         multi &= multi - 1) {
      const int src = __ffs(multi) - 1;
      const int n = __shfl_sync(~0u, pieces, src);
      const int base = slots + __shfl_sync(~0u, incl, src) - (n - 1);
      V* dsg = reinterpret_cast<V*>(ds + (g0 + src) * th);
      const V* first = reinterpret_cast<const V*>(part + (size_t)base * th);
      for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
           i < count; i += (size_t)gridDim.x * blockDim.x) {
        V v = dsg[i];
        for (int c0 = 1; c0 < n; c0 += kBatch) {
          V p[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (c0 + k < n) p[k] = first[(c0 + k - 1) * count + i];
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (c0 + k < n) gmm::add_in(v, p[k]);
        }
        dsg[i] = v;
      }
    }
    slots += __shfl_sync(~0u, incl, 31);
  }
}

using hopper::bf16;
constexpr int kBN = 200;             // output columns a tile (wgmma N)
constexpr int kThreads = 384;        // two consumer warpgroups of 64 rows,
                                     // then one producer warpgroup
constexpr int kKC = 64;              // depth a ring chunk: four k-steps of
                                     // 16, one 128-byte swizzled row
constexpr int kBlockBytes = kKC * 128;  // an MN-major block [64 k, 64], 8 KB
constexpr int kBarBytes = 1024;      // the mbarriers, ahead of the ring
static_assert(kBN / 2 == hopper::kN200Vals, "the wgmma tile");

// A ring stage of each product, and the rows of a piece of its list.
template <gmm::Mode kMode>
struct Stage;
template <>
struct Stage<gmm::kDx> {  // K = H
  static constexpr int kABytes = gmm::kBM * 128;  // 128 g rows x 64 of H
  static constexpr int kBBytes = kBN * 128;       // 200 rows of S[g] x 64
  static constexpr int kPer = gmm::kBM;
  static constexpr int kStages = 4;  // chunks in the ring: all of H = 200
  // after the ring: each consumer's 64 x 200 bf16 dx tile, staged so that
  // its rows are stored 16 bytes a thread
  static constexpr int kOutBytes = 2 * 64 * kBN * 2;
};
template <>
struct Stage<gmm::kDs> {  // K = the chunk's rows
  static constexpr int kABytes = 2 * kBlockBytes;  // x: 64 rows x 128 of T
  static constexpr int kBBytes = 4 * kBlockBytes;  // g: 64 rows x 256 of H
  static constexpr int kPer = gmm::kKC;
  static constexpr int kStages = 2;  // chunks in the ring
  // after the ring: each consumer's 64 x 200 f32 dS tile, which a TMA
  // store copies out while the consumers go on to the next unit
  static constexpr int kOutBytes = 2 * 64 * kBN * 4;
};
template <gmm::Mode kMode>
constexpr int kStageBytes = Stage<kMode>::kABytes + Stage<kMode>::kBBytes;
template <gmm::Mode kMode>
constexpr int kSmem = 1024 + kBarBytes +
                      Stage<kMode>::kStages * kStageBytes<kMode> +
                      Stage<kMode>::kOutBytes;
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
static_assert(kStageBytes<gmm::kDx> % 1024 == 0 &&
                  kStageBytes<gmm::kDs> % 1024 == 0,
              "stages keep the swizzle's 1024-byte alignment");

// Phase clocks, compiled in only with -DGMM_PHASES (tools/gmm_phases.py
// builds this source so): thread 0 (a consumer) and thread 256 (the
// producer's copying thread) of each CTA add the SM cycles they spent in
// each phase into gmm_phases[kPhases * product + slot]; thread 0 also
// adds its CTA, its units and its cycles from the kernel's entry to its
// exit, and keeps the longest CTA's; the tool reads them back through
// grouped_matmul_phases_read.  Without the macro every member is empty
// and the kernels compile as if it were not there.
constexpr int kPhases = 16;  // slots a product
enum PhaseSlot {
  kFind, kFullWait, kZero, kProducts, kLastWait, kEpilogue,  // consumer
  kProducerFind, kEmptyWait, kCopies,                         // producer
  kCtaCycles = 10, kLongestCta, kCtas, kUnits
};
#ifdef GMM_PHASES
__device__ unsigned long long gmm_phases[2 * kPhases];
#endif

struct PhaseClock {
#ifdef GMM_PHASES
  long long last = 0, spent[kPhases] = {};
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
  __device__ __forceinline__ void count(int slot) { ++spent[slot]; }
  // the CTA's cycles since `entry` (now() at the kernel's entry)
  __device__ __forceinline__ void span(long long entry) {
    spent[kCtaCycles] = now() - entry;
  }
  __device__ __forceinline__ void flush(int product) {
    unsigned long long* out = gmm_phases + kPhases * product;
    for (int i = 0; i < kPhases; ++i)
      if (spent[i] != 0) atomicAdd(out + i, (unsigned long long)spent[i]);
    atomicMax(out + kLongestCta, (unsigned long long)spent[kCtaCycles]);
  }
#else
  __device__ __forceinline__ static long long now() { return 0; }
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void span(long long) {}
  __device__ __forceinline__ void flush(int) {}
#endif
};

// A unit of a CTA's walk: a piece of the list, the tile's first output
// column and (dS) its first row of T, and its k-chunks.
struct Unit {
  gmm::Piece p;
  int n0, m0, chunks;
};

// The pieces of up to 32 units in one scan of the group ends: lane l asks
// for piece target (-1: none) and gets it (group < 0 past the list's
// end); count bounds the lanes that ask.  gmm::find_piece's list, with
// each lane owning kOwn consecutive groups of a pass over them, so that a
// pass of 32 kOwn groups costs one warp scan (a dependent chain of
// shuffles) and each asking lane one ballot and the owner's answer.
// Called by all lanes of a warp.
template <int kPer, bool kDs>
__device__ gmm::Piece find_pieces(const int* __restrict__ ends, int r, int m,
                                  int target, int count) {
  constexpr int kOwn = 4;
  constexpr int kRounds = kDs ? 2 : 1;  // dS: groups of 2+ pieces first
  const int lane = threadIdx.x % 32;
  gmm::Piece mine{-1, 0, 0, 0, 0};
  int seen = 0;  // pieces before this pass, in list order
  for (int round = 0; round < kRounds; ++round) {
    int slots = 0;  // partial slots of the groups before this pass
    for (int g0 = 0; g0 < r; g0 += 32 * kOwn) {
      const int first = g0 + lane * kOwn;  // this lane's groups
      gmm::Span sp[kOwn];
      int pieces[kOwn], n[kOwn], lane_n = 0, lane_slots = 0;
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        sp[i] = {0, 0, false};
        pieces[i] = 0;
        if (first + i < r) {
          sp[i] = gmm::group_span(ends, first + i, r, m);
          pieces[i] = gmm::piece_count<kPer, kDs>(sp[i]);
        }
        n[i] = kRounds == 1 || (pieces[i] > 1) == (round == 0) ? pieces[i]
                                                                : 0;
        lane_n += n[i];
        lane_slots += max(pieces[i] - 1, 0);
      }
      const int incl = gmm::warp_inclusive_sum(lane_n);
      const int slot_incl = gmm::warp_inclusive_sum(lane_slots);
      const int lo = seen + incl - lane_n;
      const int next = seen + __shfl_sync(~0u, incl, 31);
      for (int j = 0; j < count; ++j) {
        const int want = __shfl_sync(~0u, target, j);
        if (want < seen || want >= next) continue;  // the same for the warp
        const unsigned hit =
            __ballot_sync(~0u, lane_n > 0 && want >= lo && want < lo + lane_n);
        // the owner's answer (each lane computes its own; src's is taken)
        gmm::Piece pc{-1, 0, 0, 0, 0};
        int at = lo, slot = slots + slot_incl - lane_slots;
#pragma unroll
        for (int i = 0; i < kOwn; ++i) {
          if (want >= at && want < at + n[i]) {
            const int index = want - at, row0 = sp[i].start + index * kPer;
            const int rows = (kDs && !sp[i].own) ? 0 : sp[i].end - row0;
            pc = {first + i, row0, max(0, min(kPer, rows)), index,
                  slot + index - 1};
          }
          at += n[i];
          slot += max(pieces[i] - 1, 0);
        }
        const int src = __ffs(hit) - 1;
        const gmm::Piece got{__shfl_sync(~0u, pc.group, src),
                             __shfl_sync(~0u, pc.row0, src),
                             __shfl_sync(~0u, pc.rows, src),
                             __shfl_sync(~0u, pc.index, src),
                             __shfl_sync(~0u, pc.slot, src)};
        if (lane == j) mine = got;
      }
      seen = next;
      slots += __shfl_sync(~0u, slot_incl, 31);
    }
  }
  return mine;
}

// The units a CTA walks, j = 0, 1, ...: in round j of gridDim.x units of
// the list (a piece by a column tile; dS: and by a row tile of T), unit
// blockIdx.x of the round, counted from the round's end where j is odd:
// the list holds its deepest pieces first, and the CTAs that took them in
// round 0 take the round's shallowest in round 1.  A
// warp looks up the pieces of 32 of its units at a time in one scan
// (lane l holds unit j0 + l's), where gmm::find_piece's scan a unit cost
// 1700 (dx) to 3200 (dS) SM cycles on the H100; at(j) then takes unit j's
// piece from its lane.  Called by all lanes of a warp, for j in
// increasing order.
template <gmm::Mode kMode>
struct Units {
  static constexpr bool kDs = kMode == gmm::kDs;
  static constexpr int kPer = Stage<kMode>::kPer;
  const int* ends;
  int m, h, r, row_tiles, per_piece, bound, j0 = -32;
  gmm::Piece mine{-1, 0, 0, 0, 0};

  __device__ Units(const int* e, int m_, int t, int h_, int r_)
      : ends(e), m(m_), h(h_), r(r_) {
    const int col_tiles = ((kDs ? h : t) + kBN - 1) / kBN;
    row_tiles = kDs ? (t + gmm::kBM - 1) / gmm::kBM : 1;
    per_piece = col_tiles * row_tiles;
    bound = ((m + kPer - 1) / kPer + r) * per_piece;  // the list's bound
  }
  // the list's index of unit j of this CTA
  __device__ static int index(int j) {
    const int k = j % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return j * (int)gridDim.x + k;
  }
  // unit j of this CTA (p.group < 0 past the list)
  __device__ Unit at(int j) {
    const int lane = threadIdx.x % 32;
    if (j >= j0 + 32) {
      j0 = j;
      const int u = index(j0 + lane);
      const int rounds = (bound + (int)gridDim.x - 1) / (int)gridDim.x;
      mine = find_pieces<kPer, kDs>(ends, r, m, u < bound ? u / per_piece : -1,
                                    min(32, max(0, rounds - j0)));
    }
    const int l = j - j0;
    Unit v;
    v.p = {__shfl_sync(~0u, mine.group, l), __shfl_sync(~0u, mine.row0, l),
           __shfl_sync(~0u, mine.rows, l), __shfl_sync(~0u, mine.index, l),
           __shfl_sync(~0u, mine.slot, l)};
    const int rem = index(j) % per_piece;
    v.n0 = rem / row_tiles * kBN;
    v.m0 = rem % row_tiles * gmm::kBM;
    v.chunks = ((kDs ? v.p.rows : h) + kKC - 1) / kKC;
    return v;
  }
};

// The persistent walk of one product.
//   dx: a = g [M, H], b = s [R, T, H], out = dx [M, T] bf16
//   dS: a = x [M, T], b = g [M, H], out = ds [R, T, H] f32, part = the
//       partials [slots, T, H] f32; tma_out: stored by TMA through the
//       tensor maps map_out and map_part (H a multiple of 4), else from
//       the fragments
// stage_ends: the group ends are copied into shared memory first (the
// launcher gave them room), so the warps' scans of them read no device
// memory.
// Barriers: full[i] (ring slot i has landed: its bytes, or the copying
// threads' reports), empty[i] (the consumers' 8 warps are done with it).
template <gmm::Mode kMode>
__device__ __forceinline__ void walk(
    const CUtensorMap* map_a, const CUtensorMap* map_b,
    const CUtensorMap* map_out, const CUtensorMap* map_part,
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    const int* __restrict__ ends, void* __restrict__ out,
    float* __restrict__ part, int m, int t, int h, int r, bool tma,
    bool vec_a, bool vec_b, bool tma_out, bool stage_ends) {
  using namespace hopper;
  using S = Stage<kMode>;
  constexpr bool kDs = kMode == gmm::kDs;
  constexpr int kStages = S::kStages;
  constexpr int kBytes = kStageBytes<kMode>;
  const long long entry = PhaseClock::now();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: blocks start on multiples of it
  const uint32_t raw = tf32x3::smem_u32(smem_raw);
  const uint32_t bars = (raw + 1023u) & ~1023u;
  const uint32_t ring_s = bars + kBarBytes;
  unsigned char* ring = smem_raw + (ring_s - raw);
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(full(i), tma ? 1 : 128);
      bar_init(empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int* ends_s = reinterpret_cast<int*>(ring + kStages * kBytes + S::kOutBytes);
  if (stage_ends)
    for (int i = threadIdx.x; i < r; i += kThreads) ends_s[i] = ends[i];
  __syncthreads();
  if (stage_ends) ends = ends_s;
  const int group = threadIdx.x / 128;

  if (group == 2) {  // ------------------------------------ producer
    // TMA: one warp walks the units, its lane 0 issues every copy
    if (tma && threadIdx.x >= 256 + 32) return;
    const int pt = threadIdx.x - 256;
    PhaseClock clock;
    clock.start();
    Units<kMode> units(ends, m, t, h, r);
    int q = 0;  // ring chunks so far, over all units
    for (int j = 0;; ++j) {
      const Unit v = units.at(j);
      if (pt == 0) clock.mark(kProducerFind);
      if (v.p.group < 0) break;
      for (int c = 0; c < v.chunks; ++c, ++q) {
        const int slot = q % kStages;
        // the slot's last chunk has been handed back
        if (q >= kStages) bar_wait(empty(slot), (q / kStages - 1) & 1);
        const uint32_t st = ring_s + slot * kBytes;
        unsigned char* sp = ring + slot * kBytes;
        const int k0 = c * kKC;
        if (tma) {  // lane 0 copies, the warp's other lanes wait for it
          if (pt != 0) {
            __syncwarp();
            continue;
          }
          clock.mark(kEmptyWait);
          bar_expect(full(slot), kBytes);
          if constexpr (kDs) {  // the chunk's rows k0.. of x and of g
            const int row = v.p.row0 + k0;
            for (int i = 0; i < S::kABytes / kBlockBytes; ++i)
              tma_2d(st + i * kBlockBytes, map_a, v.m0 + 64 * i, row,
                     full(slot));
            for (int i = 0; i < S::kBBytes / kBlockBytes; ++i)
              tma_2d(st + S::kABytes + i * kBlockBytes, map_b,
                     v.n0 + 64 * i, row, full(slot));
          } else {  // H k0.. of the piece's g rows and of S[g]'s T rows
            tma_2d(st, map_a, k0, v.p.row0, full(slot));
            tma_3d(st + S::kABytes, map_b, k0, v.n0, v.p.group, full(slot));
          }
          clock.mark(kCopies);
          __syncwarp();
          continue;
        }
        if constexpr (kDs) {
          const int row = v.p.row0 + k0, rows = min(kKC, v.p.rows - k0);
          load_w<kKC, 2 * 64>(sp, a + (size_t)row * t, t, rows, v.m0, vec_a,
                              pt, 128);
          load_w<kKC, 4 * 64>(sp + S::kABytes, b + (size_t)row * h, h, rows,
                              v.n0, vec_b, pt, 128);
        } else {
          const int hk = min(kKC, h - k0);
          load_x<gmm::kBM>(sp, a + (size_t)v.p.row0 * h + k0, h,
                           m - v.p.row0, hk, vec_a, pt, 128);
          load_x<kBN>(sp + S::kABytes,
                      b + ((size_t)v.p.group * t + v.n0) * h + k0, h,
                      t - v.n0, hk, vec_b, pt, 128);
        }
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<0>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(full(slot));
      }
    }
    if (pt == 0) clock.flush(kDs);
    return;
  }

  // --------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32;
  // this thread's fragment rows within the tile: row0 (values 4j, 4j + 1)
  // and row0 + 8 (4j + 2, 4j + 3), columns n0 + 8j + 2 (lane % 4) + {0, 1}
  const int row0 = group * 64 + threadIdx.x % 128 / 32 * 16 + lane / 4;
  auto hand_back = [&](int q) {
    if (lane == 0) bar_arrive(empty(q % kStages));
  };
  // the descriptors of slot 0's first k-step; a k-step adds its byte
  // offset, in 16-byte units, to their start-address field: 32 bytes along
  // a K-major row (dx), 16 rows of 128 bytes down an MN-major block (dS)
  const uint64_t a0 = kDs ? desc(ring_s + group * kBlockBytes, kBlockBytes,
                                 1024)
                          : desc(ring_s + group * 64 * 128, 16, 1024);
  const uint64_t b0 = kDs ? desc(ring_s + S::kABytes, kBlockBytes, 1024)
                          : desc(ring_s + S::kABytes, 16, 1024);
  constexpr int kStepBytes = kDs ? 16 * 128 : 32;
  float acc[kN200Vals];
  PhaseClock clock;
  clock.start();
  if (threadIdx.x == 0) clock.count(kCtas);
  Units<kMode> units(ends, m, t, h, r);
  int q = 0, j = 0;
  Unit v = units.at(j);
  clock.mark(kFind);
  while (v.p.group >= 0) {
    if (threadIdx.x == 0) clock.count(kUnits);
    const bool busy = kDs ? v.m0 + group * 64 < t : group * 64 < v.p.rows;
#pragma unroll
    for (int i = 0; i < kN200Vals; ++i) acc[i] = 0.0f;
    for (int c = 0; c < v.chunks; ++c, ++q) {
      const int slot = q % kStages;
      bar_wait(full(slot), q / kStages & 1);
      clock.mark(kFullWait);
      if constexpr (kDs) {
        const int valid = v.p.rows - c * kKC;
        if (valid < kKC) {  // the next group's rows ride in the boxes
          uint4* sp = reinterpret_cast<uint4*>(ring + slot * kBytes);
          // 16-byte pieces of the slot's rows (six blocks of 64 rows)
          for (int i = threadIdx.x; i < kBytes / 16; i += 256)
            if (i / 8 % kKC >= valid) sp[i] = make_uint4(0, 0, 0, 0);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
          clock.mark(kZero);
        }
      }
      if (!busy) {
        hand_back(q);
        continue;
      }
      mma_fence();
#pragma unroll
      for (int k = 0; k < kKC / 16; ++k) {
        const int off = (slot * kBytes + k * kStepBytes) >> 4;
        mma_200<kDs, kDs>(acc, a0 + off, b0 + off, c > 0 || k > 0);
      }
      mma_commit();
      if (c > 0) {  // the previous chunk's products are done
        mma_wait<1>();
        hand_back(q - 1);
      }
      clock.mark(kProducts);
    }
    // the next unit, found while the last products run
    const Unit unit = v;
    v = units.at(++j);
    clock.mark(kFind);
    if (!busy) continue;
    mma_wait<0>();
    fence_regs(acc);
    if (unit.chunks > 0) hand_back(q - 1);
    clock.mark(kLastWait);

    if (kDs && tma_out) {  // f32, staged, one TMA store a warpgroup
      float* tile = reinterpret_cast<float*>(ring + kStages * kBytes) +
                    group * 64 * kBN;
      const int id = 2 + group;  // the warpgroup's named barrier
      const bool issuer = threadIdx.x % 128 == 0;
      if (issuer) bulk_wait<0, true>();  // the last store has read the tile
      asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
      const int r0 = row0 - group * 64;
#pragma unroll
      for (int j = 0; j < kN200Vals / 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; i += 2)
          *reinterpret_cast<float2*>(
              tile + (r0 + (i & 2 ? 8 : 0)) * kBN + 8 * j + 2 * (lane % 4)) =
              make_float2(acc[4 * j + i], acc[4 * j + i + 1]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
      if (issuer) {  // rows past T and columns past H are not written
        const bool first = unit.p.index == 0;
        tma_store_3d(first ? map_out : map_part,
                     ring_s + kStages * kBytes + group * 64 * kBN * 4,
                     unit.n0, unit.m0 + group * 64,
                     first ? unit.p.group : unit.p.slot);
        bulk_commit();
      }
    } else if constexpr (kDs) {  // f32, two columns a store where H is even
      const size_t th = (size_t)t * h;
      float* dst0 = unit.p.index == 0
                        ? static_cast<float*>(out) + unit.p.group * th
                        : part + unit.p.slot * th;
      const bool pairs = h % 2 == 0;
#pragma unroll
      for (int j = 0; j < kN200Vals / 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int row = unit.m0 + row0 + (i & 2 ? 8 : 0);
          const int col = unit.n0 + 8 * j + 2 * (lane % 4);
          if (row >= t || col >= h) continue;
          float* dst = dst0 + (size_t)row * h + col;
          const float v0 = acc[4 * j + i], v1 = acc[4 * j + i + 1];
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (col + 1 < h) dst[1] = v1;
          }
        }
    } else {  // bf16, rounded once, staged in shared memory by fragment
      bf16* tile = reinterpret_cast<bf16*>(ring + kStages * kBytes) +
                   group * 64 * kBN;
      const int id = 2 + group;  // the warpgroup's named barrier
      // the last unit's stores have read the tile
      asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
      const int r0 = row0 - group * 64;
#pragma unroll
      for (int j = 0; j < kN200Vals / 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; i += 2)
          *reinterpret_cast<__nv_bfloat162*>(
              tile + (r0 + (i & 2 ? 8 : 0)) * kBN + 8 * j + 2 * (lane % 4)) =
              __floats2bfloat162_rn(acc[4 * j + i], acc[4 * j + i + 1]);
      asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
      // the tile's rows of the group, 8 columns (16 bytes) a thread, the
      // warpgroup's threads along each row
      bf16* dx = static_cast<bf16*>(out) +
                 (size_t)(unit.p.row0 + group * 64) * t + unit.n0;
      const int rows = min(64, unit.p.rows - group * 64);
      const int cols = min(kBN, t - unit.n0);
      const bool vec = t % 8 == 0;  // rows 16-byte aligned, cols whole 8s
      for (int i = threadIdx.x % 128; i < rows * (kBN / 8); i += 128) {
        const int row = i / (kBN / 8), col = i % (kBN / 8) * 8;
        if (col >= cols) continue;
        const bf16* src = tile + row * kBN + col;
        bf16* dst = dx + (size_t)row * t + col;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < min(8, cols - col); ++k) dst[k] = src[k];
        }
      }
    }
    clock.mark(kEpilogue);
  }
  // the last stores have completed before the CTA's shared memory goes
  if (kDs && tma_out && threadIdx.x % 128 == 0) bulk_wait<0, false>();
  clock.span(entry);
  if (threadIdx.x == 0) clock.flush(kDs);
}

__global__ void __launch_bounds__(kThreads, 1)
grouped_matmul_dx_bf16_kernel(const __grid_constant__ CUtensorMap map_g,
                              const __grid_constant__ CUtensorMap map_s,
                              const bf16* __restrict__ g,
                              const bf16* __restrict__ s,
                              const int* __restrict__ ends,
                              bf16* __restrict__ dx, int m, int t, int h,
                              int r, bool tma, bool vec_g, bool vec_s,
                              bool stage_ends) {
  walk<gmm::kDx>(&map_g, &map_s, nullptr, nullptr, g, s, ends, dx, nullptr,
                 m, t, h, r, tma, vec_g, vec_s, false, stage_ends);
  // launched as the dS kernel's dependent, it reads nothing dS writes, but
  // lets the partials' sum be scheduled only once each of its CTAs is
  // done, and ends only after the dS kernel, so that the sum, and what
  // follows in the stream, find dS written
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
grouped_matmul_ds_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_g,
                              const __grid_constant__ CUtensorMap map_ds,
                              const __grid_constant__ CUtensorMap map_part,
                              const bf16* __restrict__ x,
                              const bf16* __restrict__ g,
                              const int* __restrict__ ends,
                              float* __restrict__ ds,
                              float* __restrict__ part, int m, int t, int h,
                              int r, bool tma, bool vec_x, bool vec_g,
                              bool tma_out, bool stage_ends) {
  // the dx kernel may be scheduled now, onto the SMs this grid leaves
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  walk<gmm::kDs>(&map_x, &map_g, &map_ds, &map_part, x, g, ends, ds, part, m,
                 t, h, r, tma, vec_x, vec_g, tma_out, stage_ends);
}

// A programmatic dependent launch of kernel on st: its CTAs may be
// scheduled once every CTA of the kernel before it in the stream has run
// griddepcontrol.launch_dependents or ended.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned grid,
                             int smem, cudaStream_t st, int threads,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The 2D tensor map of a row-major bf16 matrix [rows, cols] in boxes of
// box_rows rows by 64 columns.
bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return hopper::bf16_tensor_map(map, base, 2, dim, stride, box);
}

int launch(const void* x, const void* g, const void* s, const void* group_ends,
           void* dx, void* ds, void* part, int m, int t, int h, int r,
           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int* ends = static_cast<const int*>(group_ends);
  // the group ends in shared memory where they fit beside the rings
  const int ends_bytes = (4 * r + 15) / 16 * 16;
  const bool stage_dx = kSmem<gmm::kDx> + ends_bytes <= kSmemLimit;
  const bool stage_ds = kSmem<gmm::kDs> + ends_bytes <= kSmemLimit;
  const int dx_smem = kSmem<gmm::kDx> + (stage_dx ? ends_bytes : 0);
  const int ds_smem = kSmem<gmm::kDs> + (stage_ds ? ends_bytes : 0);
  cudaError_t e = allow_smem(grouped_matmul_dx_bf16_kernel, dx_smem);
  if (e == cudaSuccess) e = allow_smem(grouped_matmul_ds_bf16_kernel, ds_smem);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  // TMA takes 16-byte-aligned bases and row strides; other operands go
  // through the copying warpgroup
  const bool vec_x = gmm::vec_ok<bf16>(x, t), vec_g = gmm::vec_ok<bf16>(g, h),
             vec_s = gmm::vec_ok<bf16>(s, h);
  // dx: g in boxes of 128 rows, S [R, T, H] in boxes of one group's 200
  // rows of T, each by 64 of H
  CUtensorMap map_g128{}, map_s{}, map_x{}, map_g64{};
  const cuuint64_t s_dim[3] = {(cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)r};
  const cuuint64_t s_stride[2] = {(cuuint64_t)h * 2, (cuuint64_t)t * h * 2};
  const cuuint32_t s_box[3] = {64, kBN, 1};
  const bool tma_dx =
      vec_g && vec_s && matrix_map(&map_g128, g, m, h, gmm::kBM) &&
      hopper::bf16_tensor_map(&map_s, s, 3, s_dim, s_stride, s_box);
  // dS: x and g in boxes of 64 rows by 64 columns
  const bool tma_ds = vec_x && vec_g && matrix_map(&map_x, x, m, t, kKC) &&
                      matrix_map(&map_g64, g, m, h, kKC);
  // dS and its partials [*, T, H] f32, stored by TMA in boxes of 64 rows
  // of T by 200 of H where H is a multiple of 4 (16-byte row strides)
  CUtensorMap map_ds{}, map_part{};
  const int slots = gmm::partial_slots(m);
  const cuuint64_t ds_dim[3] = {(cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)r};
  const cuuint64_t part_dim[3] = {(cuuint64_t)h, (cuuint64_t)t,
                                  (cuuint64_t)slots};
  const cuuint64_t f32_stride[2] = {(cuuint64_t)h * 4, (cuuint64_t)t * h * 4};
  const cuuint32_t out_box[3] = {kBN, 64, 1};
  const bool tma_out =
      h % 4 == 0 &&
      hopper::tensor_map(&map_ds, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ds, 3,
                         ds_dim, f32_stride, out_box, false) &&
      (slots == 0 ||
       hopper::tensor_map(&map_part, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, part, 3,
                          part_dim, f32_stride, out_box, false));
  const int dx_units = gmm::tile_bound(m, r) * ((t + kBN - 1) / kBN);
  const int ds_units = gmm::chunk_bound(m, r) * ((h + kBN - 1) / kBN) *
                       ((t + gmm::kBM - 1) / gmm::kBM);
  // dS first, then dx and the partials' sum as programmatic dependents:
  // dx's CTAs take the SMs that dS's leave while its longest units run
  // (the list puts them first), and the sum's prologue overlaps dx's end
  grouped_matmul_ds_bf16_kernel<<<std::min(ds_units, sms), kThreads, ds_smem,
                                  st>>>(
      map_x, map_g64, map_ds, map_part, static_cast<const bf16*>(x),
      static_cast<const bf16*>(g), ends, static_cast<float*>(ds),
      static_cast<float*>(part), m, t, h, r, tma_ds, vec_x, vec_g, tma_out,
      stage_ds);
  e = cudaGetLastError();
  if (e == cudaSuccess)
    e = launch_dependent(grouped_matmul_dx_bf16_kernel,
                         std::min(dx_units, sms), dx_smem, st, kThreads,
                         map_g128, map_s, static_cast<const bf16*>(g),
                         static_cast<const bf16*>(s), ends,
                         static_cast<bf16*>(dx), m, t, h, r, tma_dx, vec_g,
                         vec_s, stage_dx);
  if (e != cudaSuccess || slots == 0) return (int)e;
  const size_t count = (size_t)t * h;
  const bool vec = count % 4 == 0;  // ds and part are 16-byte aligned
  const int threads = 128;
  const size_t blocks = ((vec ? count / 4 : count) + threads - 1) / threads;
  e = vec ? launch_dependent(grouped_matmul_ds_sum_bf16_kernel<float4>,
                             (unsigned)blocks, 0, st, threads, ends,
                             static_cast<const float*>(part),
                             static_cast<float*>(ds), m, t, h, r)
          : launch_dependent(grouped_matmul_ds_sum_bf16_kernel<float>,
                             (unsigned)blocks, 0, st, threads, ends,
                             static_cast<const float*>(part),
                             static_cast<float*>(ds), m, t, h, r);
  return (int)e;
}

}  // namespace gmm16b

}  // namespace

extern "C" {

// The [T, H] partial slots that part must hold for M rows.
int grouped_matmul_backward_partials(int m) { return gmm::partial_slots(m); }

int grouped_matmul_backward_f32(const void* x, const void* g, const void* s,
                                const void* group_ends, void* dx, void* ds,
                                void* part, int m, int t, int h, int r,
                                void* stream) {
  return launch_f32(x, g, s, group_ends, dx, ds, part, m, t, h, r, stream);
}

int grouped_matmul_backward_bf16(const void* x, const void* g, const void* s,
                                 const void* group_ends, void* dx, void* ds,
                                 void* part, int m, int t, int h, int r,
                                 void* stream) {
  return gmm16b::launch(x, g, s, group_ends, dx, ds, part, m, t, h, r,
                        stream);
}

#ifdef GMM_PHASES
int grouped_matmul_phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gmm16b::gmm_phases,
                                   sizeof(gmm16b::gmm_phases));
}
int grouped_matmul_phases_zero() {
  const unsigned long long zero[2 * gmm16b::kPhases] = {};
  return (int)cudaMemcpyToSymbol(gmm16b::gmm_phases, zero, sizeof(zero));
}
#endif

const char* grouped_matmul_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
