// The grouped (ragged) matmul's work lists, and its three f32 products on
// the 3xTF32 tensor-core mainloop (tf32x3_tile.cuh) over them:
//   forward  y[rows of g]  = x[rows of g] S[g]         (grouped_matmul.cu)
//   dx       dx[rows of g] = g[rows of g] S[g]ᵀ        (grouped_matmul_backward.cu)
//   dS       dS[g]         = x[rows of g]ᵀ g[rows of g]
// Rows are sorted so that each group is contiguous; group_ends [R] int32 is
// cumsum(group_sizes), and rows past the last end belong to the last group.
//
// The work lists.  A group's rows are cut into pieces: tiles of kBM rows
// for the forward and dx, chunks of at most kKC rows for dS.  An empty
// group has no tile, but one dS chunk of no rows, which writes its zeros
// (a group with no rows of its own gets zeros even where rows past the sum
// fall into it).  The forward's and dx's lists hold the pieces in group
// order (their tiles are of one depth); dS's puts the groups of more than
// one chunk first, then the others, each in group order, so the padding
// groups' deepest chunks start in the first wave (in group order, dS took
// 13 % longer at T = 400).  The grid is the list's static upper bound,
// ceil(M / per) + R pieces; warp 0 of each CTA finds its piece by a warp
// scan of the pieces per group over the group ends, and a CTA past the
// list's end returns at once.  Nothing is read back on the host, so a
// call can be captured in a CUDA graph.
//
// The tile.  A CTA owns one piece by 208 output columns: kernel 11's block
// (tf32x3::Tile<4, 2, 2, 13>, 8 warps of 32 x 104), so the forward and dx
// take all H = 200 columns in one tile and dx's T = 400 in two.  A warp
// whose 32 rows hold nothing of the piece issues no MMA.  Both operands
// stream through a three-stage cp.async ring in chunks of 32 of K:
//   mode  A (rows x K)              stored           B (K x columns)     stored
//   fwd   x rows, K = T             [row][k]         S[g]                [k][col]
//   dx    g rows, K = H             [row][k]         S[g]ᵀ               [col][k]
//   dS    x rowsᵀ (A[t][k] = x[k][t]) [k][t]         g rows              [k][col]
// at row strides that keep every fragment read free of bank conflicts
// (36 where k is inner; tf32x3::padded_ld where it is outer).
//
// dS.  A chunk of at most kKC rows computes one [T, H] product.  The first
// chunk of a group writes dS[g]; each later one writes a partial into the
// scratch the wrapper allocates, and grouped_matmul_ds_sum_kernel adds the
// partials into dS[g] in chunk order.  No block walks more than kKC rows,
// there are no float atomics, and two calls give the same bits.
//
// The bf16 instances are wgmma kernels of their own on the same lists
// (grouped_matmul.cu's forward, grouped_matmul_backward.cu's dx and dS):
// their products are bound by bytes on the bf16 tensor cores, where the
// 3xTF32 mainloop over bf16 widened to f32 ran a quarter of the TF32 peak
// with two of its three products adding exact zeros.  They share
// find_piece, the partial slots and add_partials with the f32 instances.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3_tile.cuh"

namespace gmm {

using Tl = tf32x3::Tile<4, 2, 2, 13>;  // 128 x 208 a block, 256 threads
using tf32x3::kBK;
using tf32x3::kStages;
constexpr int kBM = Tl::kBM;    // rows a tile of the forward and dx
constexpr int kKC = 256;        // rows a dS chunk at most
constexpr int kGroup = 7;       // n-tiles per fresh accumulator (registers)
constexpr int kMinBlocks = 1;   // CTAs an SM must hold (__launch_bounds__)
constexpr int kLdk = kBK + 4;   // row stride of a tile whose k is inner

enum Mode { kFwd, kDx, kDs };

// Shared-memory layout of one ring stage of a mode.
template <Mode kMode>
struct Geo {
  static constexpr bool kAT = kMode == kDs;  // A stored [k][row]
  static constexpr bool kBT = kMode == kDx;  // B stored [col][k]
  static constexpr int kLda = kAT ? tf32x3::padded_ld(kBM) : kLdk;
  static constexpr int kAFloats = kAT ? kBK * kLda : kBM * kLda;
  static constexpr int kLdb = kBT ? kLdk : Tl::kLdw;
  static constexpr int kBFloats = kBT ? Tl::kBN * kLdb : kBK * kLdb;
  static constexpr int kStageFloats = kAFloats + kBFloats;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats;
};

// tf32x3::copy_tile at the block's thread count (cp.async; vec: 16 bytes
// a copy).  Rows at or past valid_rows and columns at or past cols read as
// zero.
template <int kRows, int kCols, int kLd>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int ld, int valid_rows, int c0,
                                          int cols, bool vec) {
  tf32x3::copy_tile<kRows, kCols, kLd, Tl::kThreads>(dst, src, ld, valid_rows,
                                                     c0, cols, vec);
}

// Rows [start, end) of group g (clamped to [0, m); the last group runs to
// m) and whether the group has rows of its own (its size is above 0).
struct Span {
  int start, end;
  bool own;
};

__device__ __forceinline__ Span group_span(const int* __restrict__ ends,
                                           int g, int r, int m) {
  const int lo = g > 0 ? ends[g - 1] : 0, hi = ends[g];
  return {min(lo, m), g == r - 1 ? m : min(hi, m), hi > lo};
}

// Pieces of kPer rows that group g is cut into (kDs: one at least, and
// none of the rows that fall into a group with no rows of its own).
template <int kPer, bool kDs>
__device__ __forceinline__ int piece_count(const Span& s) {
  const int n = (kDs && !s.own) ? 0 : max(0, s.end - s.start);
  const int pieces = (n + kPer - 1) / kPer;
  return kDs ? max(pieces, 1) : pieces;
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(~0u, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// A piece of the list: group, its first row and rows, its index within
// the group, and (dS) its partial slot when the index is above 0: the
// group's slots follow those of the groups before it in group order.
struct Piece {
  int group, row0, rows, index, slot;
};

// The unit-th piece of the list (group < 0 past its end); called by all
// lanes of one warp, which all return it.
template <int kPer, bool kDs>
__device__ Piece find_piece(const int* __restrict__ ends, int r, int m,
                            int unit) {
  const int lane = threadIdx.x % 32;
  constexpr int kRounds = kDs ? 2 : 1;  // dS: groups of 2+ pieces first
  int seen = 0;  // pieces of the groups before this batch, in this round
  for (int round = 0; round < kRounds; ++round) {
    int slots = 0;  // partial slots of the groups before this batch
    for (int g0 = 0; g0 < r; g0 += 32) {
      const int g = g0 + lane;
      Span s{0, 0, false};
      int pieces = 0;
      if (g < r) {
        s = group_span(ends, g, r, m);
        pieces = piece_count<kPer, kDs>(s);
      }
      const int count =
          kRounds == 1 || (pieces > 1) == (round == 0) ? pieces : 0;
      const int incl = warp_inclusive_sum(count);
      const int slot_incl = warp_inclusive_sum(max(pieces - 1, 0));
      const int lo = seen + incl - count;
      const unsigned hit =
          __ballot_sync(~0u, count > 0 && unit >= lo && unit < lo + count);
      if (hit) {
        const int src = __ffs(hit) - 1;
        const int hg = __shfl_sync(~0u, g, src);
        const int hlo = __shfl_sync(~0u, lo, src);
        const int start = __shfl_sync(~0u, s.start, src);
        const int end = __shfl_sync(~0u, s.end, src);
        const bool own = __shfl_sync(~0u, (int)s.own, src);
        const int base = slots + __shfl_sync(~0u, slot_incl, src) -
                         __shfl_sync(~0u, max(pieces - 1, 0), src);
        const int index = unit - hlo;
        const int row0 = start + index * kPer;
        const int n = (kDs && !own) ? 0 : end - row0;
        return {hg, row0, max(0, min(kPer, n)), index, base + index - 1};
      }
      seen += __shfl_sync(~0u, incl, 31);
      slots += __shfl_sync(~0u, slot_incl, 31);
    }
  }
  return {-1, 0, 0, 0, 0};
}

// One CTA of a mode: piece blockIdx.x of the list, columns blockIdx.y *
// 208.. of the output, and for dS the T rows blockIdx.z * kBM.. of dS[g].
//   fwd: a = x [M, T], b = s [R, T, H], out = y [M, H]
//   dx:  a = g [M, H], b = s [R, T, H], out = dx [M, T]
//   dS:  a = x [M, T], b = g [M, H], out = ds [R, T, H] f32, part = the
//        partials [slots, T, H] f32
template <Mode kMode>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ ends, float* __restrict__ out,
    float* __restrict__ part, int m, int t, int h, int r, bool vec_a,
    bool vec_b) {
  using G = Geo<kMode>;
  constexpr int kPer = kMode == kDs ? kKC : kBM;
  __shared__ Piece shared_piece;
  if (threadIdx.x < 32) {
    const Piece p = find_piece<kPer, kMode == kDs>(ends, r, m, blockIdx.x);
    if (threadIdx.x == 0) shared_piece = p;
  }
  __syncthreads();
  const Piece p = shared_piece;
  if (p.group < 0) return;  // past the list: the same for the whole CTA

  extern __shared__ __align__(16) float smem_f[];
  const int n0 = blockIdx.y * Tl::kBN;                    // output columns
  const int m0 = kMode == kDs ? blockIdx.z * kBM : 0;     // dS: T rows
  const size_t th = (size_t)t * h;
  const int depth = kMode == kFwd ? t : kMode == kDx ? h : p.rows;
  const int chunks = (depth + kBK - 1) / kBK;
  auto issue = [&](int c) {
    if (c < chunks) {
      float* as = smem_f + (c % kStages) * G::kStageFloats;
      float* bs = as + G::kAFloats;
      const int k0 = c * kBK;
      if constexpr (kMode == kFwd) {
        load_tile<kBM, kBK, G::kLda>(as, a + (size_t)p.row0 * t, t, p.rows,
                                     k0, t, vec_a);
        load_tile<kBK, Tl::kBN, G::kLdb>(
            bs, b + p.group * th + (size_t)k0 * h, h, t - k0, n0, h, vec_b);
      } else if constexpr (kMode == kDx) {
        load_tile<kBM, kBK, G::kLda>(as, a + (size_t)p.row0 * h, h, p.rows,
                                     k0, h, vec_a);
        load_tile<Tl::kBN, kBK, G::kLdb>(
            bs, b + p.group * th + (size_t)n0 * h, h, t - n0, k0, h, vec_b);
      } else {
        const size_t row = (size_t)p.row0 + k0;
        load_tile<kBK, kBM, G::kLda>(as, a + row * t, t, p.rows - k0, m0, t,
                                     vec_a);
        load_tile<kBK, Tl::kBN, G::kLdb>(bs, b + row * h, h, p.rows - k0, n0,
                                         h, vec_b);
      }
    }
    tf32x3::cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  const int wrow = wm * 16 * Tl::kMT;  // the warp's first row in the tile
  const int wcol = wn * 8 * Tl::kNT;   // and first column
  // the warp's rows hold something of the piece (dS: of T)
  const bool busy = kMode == kDs ? m0 + wrow < t : wrow < p.rows;

  float acc[Tl::kMT][Tl::kNT][4];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    tf32x3::ring_wait();
    issue(c + kStages - 1);
    if (!busy) continue;
    const float* as = smem_f + (c % kStages) * G::kStageFloats;
    const float* bs = as + G::kAFloats;
    auto a_frag = [&](int mt, int ks, float (&v)[4]) {
      if constexpr (G::kAT) {  // A[row][k] at as[k][row]
        const float* p0 = as + (ks * 8 + q) * G::kLda + wrow + mt * 16 + g;
        v[0] = p0[0];
        v[1] = p0[8];
        v[2] = p0[4 * G::kLda];
        v[3] = p0[4 * G::kLda + 8];
      } else {  // A[row][k] at as[row][k]
        const float* p0 = as + (wrow + mt * 16 + g) * G::kLda + ks * 8 + q;
        v[0] = p0[0];
        v[1] = p0[8 * G::kLda];
        v[2] = p0[4];
        v[3] = p0[8 * G::kLda + 4];
      }
    };
    auto b_frag = [&](int j, int ks, float (&v)[2]) {
      if constexpr (G::kBT) {  // B[k][col] at bs[col][k]
        const float* p0 = bs + (wcol + j * 8 + g) * G::kLdb + ks * 8 + q;
        v[0] = p0[0];
        v[1] = p0[4];
      } else {  // B[k][col] at bs[k][col]
        const float* p0 = bs + (ks * 8 + q) * G::kLdb + wcol + j * 8 + g;
        v[0] = p0[0];
        v[1] = p0[4 * G::kLdb];
      }
    };
    tf32x3::mma_chunk_ab<Tl::kMT, Tl::kNT, kGroup>(acc, a_frag, b_frag);
  }
  tf32x3::cp_async_wait<0>();  // no copy is left in flight at exit
  if (!busy) return;

  // the output tile: rows of the piece (dS: of T), columns n0..
  int rows, cols, ld;
  if constexpr (kMode == kDs) {
    rows = t - m0;
    cols = h;
    ld = h;
  } else {
    rows = p.rows;
    cols = kMode == kFwd ? h : t;
    ld = cols;
  }
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wrow + mt * 16 + hf * 8 + g;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = n0 + wcol + j * 8 + 2 * q + i;
          if (col >= cols) continue;
          const float v = acc[mt][j][hf * 2 + i];
          if constexpr (kMode == kDs) {
            float* dst = p.index == 0 ? out + p.group * th
                                      : part + p.slot * th;
            dst[(size_t)(m0 + row) * ld + col] = v;
          } else {
            out[(size_t)(p.row0 + row) * ld + col] = v;
          }
        }
    }
}

// dS[g] += its partials, in chunk order, for every group of 2+ chunks:
// float4 a thread where [T, H] holds a whole number of them (V = float4),
// over a grid that covers one group's [T, H].  Every warp scans the group
// ends itself and takes the groups of 2+ chunks in turn.
template <typename V>
__device__ __forceinline__ void add_in(V& v, const V& p) {
  if constexpr (std::is_same_v<V, float4>) {
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  } else {
    v += p;
  }
}

template <typename V>
__device__ __forceinline__ void add_partials(const int* __restrict__ ends,
                                             const float* __restrict__ part,
                                             float* __restrict__ ds, int m,
                                             int t, int h, int r) {
  constexpr int kPer = sizeof(V) / sizeof(float);
  const size_t th = (size_t)t * h, count = th / kPer;
  const int lane = threadIdx.x % 32;
  int slots = 0;  // partial slots of the groups before this batch
  for (int g0 = 0; g0 < r; g0 += 32) {
    const int g = g0 + lane;
    const int pieces =
        g < r ? piece_count<kKC, true>(group_span(ends, g, r, m)) : 1;
    const int incl = warp_inclusive_sum(pieces - 1);
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
        for (int c = 1; c < n; ++c) add_in(v, first[(c - 1) * count + i]);
        dsg[i] = v;
      }
    }
    slots += __shfl_sync(~0u, incl, 31);
  }
}

// Whether rows of ld values of T from p can be copied 16 bytes at a time.
template <typename T>
inline bool vec_ok(const void* p, int ld) {
  constexpr int kPer = 16 / sizeof(T);
  return ld % kPer == 0 && (uintptr_t)p % 16 == 0;
}

// Upper bounds of the lists' lengths, the grids' x extents.
inline int tile_bound(int m, int r) { return (m + kBM - 1) / kBM + r; }
inline int chunk_bound(int m, int r) { return (m + kKC - 1) / kKC + r; }
// Partial slots dS may need: a group of n rows takes ceil(n / kKC) - 1 <=
// (n - 1) / kKC of them, and the groups' rows sum to at most m.
inline int partial_slots(int m) { return m > 0 ? (m - 1) / kKC : 0; }

}  // namespace gmm
