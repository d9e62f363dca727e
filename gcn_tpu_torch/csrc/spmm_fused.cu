// Regular-mode GCN layer straight from padded edge lists, forward and the
// symmetric pair product of its backward.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/spmm_fused.py:
//   _kernel           (launched by _forward, reached through
//                      fused_gcn_spmm)          -> spmm_fused_forward_f32
//   _sym_pair_kernel  (launched by _sym_pair, the forward's backward)
//                                               -> spmm_fused_sym_pair_f32
// Same contract, f32:
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
// The sym pair's blocks build the sentence's adjacency lists in shared
// memory (edge_lists.cuh: each list keeps edge order).
//
// The forward does the W product in its own body.  A block owns 48 rows
// of one sentence and all H columns (one 224-wide tile for H <= 224;
// wider H takes more column blocks), so each (S h) element is gathered
// once: 100 blocks of 12 warps at B = 50, N = 96, for 132 SMs.  It loads
// the sentence's edge slots into shared memory and finds each row's
// neighbours by warp ballots over them (gather_rows), which needs none of
// the list build's serial scan and rank loop, the longest part of a
// block's start here, where one block runs on each SM.  It gathers (S h)
// 256 columns of T at a time into shared memory, every row's next
// neighbour load in flight together, and runs the 3xTF32 mainloop over
// them with W streaming through a three-stage cp.async ring of 32-row
// chunks.  The epilogue adds 2b, divides by denom (the ballots' counts)
// and applies the ReLU.  T, H and N need not be multiples of a tile (360
// and 200 at the main path's layers): the ragged edges read as zero.

#include <cuda_runtime.h>

#include <stdint.h>

#include "edge_lists.cuh"
#include "tf32x3_tile.cuh"

namespace {

using edge_lists::Lists;
using edge_lists::build_lists;
using edge_lists::lists_bytes;
using edge_lists::set_smem;
using tf32x3::kStages;

// forward: 3 x 4 warps, each 16 rows x 56 columns: 48 x 224 a block
using FwdTile = tf32x3::Tile<3, 4, 1, 7>;
constexpr int kAK = 256;                   // forward: (S h) columns per gather
constexpr int kLda = kAK + 4;              // conflict-free A fragment reads
constexpr size_t kFwdTiles =  // the forward's degrees and tiles
    sizeof(int) * FwdTile::kBM + sizeof(float) * FwdTile::kBM * kLda +
    FwdTile::kRingBytes;
static_assert(kAK % tf32x3::kBK == 0, "a gather covers whole W chunks");
constexpr int kThreads = 256;              // sym pair
constexpr int kCols = 64;                  // sym pair: columns per block
constexpr int kRowLanes = kThreads / kCols;

// (S x)[i, k] for one row i of a sentence whose rows start at x, width t.
__device__ __forceinline__ float sym_row(const Lists& L,
                                         const float* __restrict__ x, int i,
                                         int k, int t) {
  const int f0 = L.start_f[i], f1 = L.start_f[i + 1];
  const int r0 = L.start_r[i], r1 = L.start_r[i + 1];
  float v = 0.0f;
  for (int q = f0; q < f1; ++q) v += x[(size_t)L.nbr_f[q] * t + k];
  for (int q = r0; q < r1; ++q) v += x[(size_t)L.nbr_r[q] * t + k];
  const float diag = ((f1 - f0) + (r1 - r0) > 0 ? 1.0f : 0.0f) + 1.0f;
  return v + diag * x[(size_t)i * t + k];
}

// The forward finds each row's neighbours by warp ballots over the
// sentence's edge slots in shared memory (ep, ec: an edge's parent and
// child, -1 for a slot that does not count), 32 slots a step: the set
// bits of ballot(ep[q] == i) are row i's forward neighbours in edge order,
// those of ballot(ec[q] == i) its reverse ones, the order the adjacency
// lists of edge_lists.cuh keep, with no block-wide list build.

// Loads the block's edge slots into ep, ec [e]; ends with a barrier.
__device__ __forceinline__ void load_edges(
    const int* __restrict__ parent, const int* __restrict__ child,
    const unsigned char* __restrict__ mask, int n, int e, int* ep, int* ec) {
  for (int q = threadIdx.x; q < e; q += blockDim.x) {
    const int p = parent[q], c = child[q];
    const bool ok = mask[q] != 0 && p >= 0 && p < n && c >= 0 && c < n;
    ep[q] = ok ? p : -1;
    ec[q] = ok ? c : -1;
  }
  __syncthreads();
}

// (S h) rows m0.. (kBM of them) and columns k0..k0 + kAK of one sentence
// (rows start at hb, width t) into a_s [kBM][kLda], zero past n and t; the
// first call (k0 = 0) also writes each row's degree to deg [kBM].
// Warp w takes rows w, w + kWarps, ...; lane l the columns 4l..4l + 3 of
// each 128 (16-byte loads with kVec: t a multiple of 4, hb aligned).  The
// rows' loads go out together, one neighbour of every row at a time, so a
// step costs one load latency and not one per row; each row sums in
// sym_row's order (forward neighbours, reverse ones, then diag * self).
template <bool kVec>
__device__ __forceinline__ void gather_rows(const int* __restrict__ ep,
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
  const int kc = lane * 4;
  auto load = [&](int row, int u) {
    const int k = k0 + kc + 128 * u;
    const float* p = hb + (size_t)row * t + k;
    if (kVec)
      return k < t ? *reinterpret_cast<const float4*>(p)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return make_float4(k < t ? p[0] : 0.0f, k + 1 < t ? p[1] : 0.0f,
                       k + 2 < t ? p[2] : 0.0f, k + 3 < t ? p[3] : 0.0f);
  };
  auto add = [](float4& v, const float4& u) {
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  };
  int row[kRows], nd[kRows];
  float4 v[kRows][kV], self[kRows][kV];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = m0 + warp + j * kWarps;
    row[j] = i < n ? i : -2;  // matches no slot (-1 marks a dropped one)
    nd[j] = 0;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      v[j][u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      self[j][u] = i < n ? load(i, u) : v[j][u];
    }
  }
  // forward neighbours (slots whose parent is the row, their children),
  // then reverse ones (slots whose child is the row, their parents)
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const int* key = dir == 0 ? ep : ec;
    const int* nbr = dir == 0 ? ec : ep;
    for (int q0 = 0; q0 < e; q0 += 32) {
      const int kq = q0 + lane < e ? key[q0 + lane] : -1;
      unsigned bits[kRows];
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        bits[j] = __ballot_sync(0xffffffffu, kq == row[j]);
        nd[j] += __popc(bits[j]);
        any |= bits[j];
      }
      while (any) {
        any = 0;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (bits[j]) {
            const int nb = nbr[q0 + __ffs(bits[j]) - 1];
#pragma unroll
            for (int u = 0; u < kV; ++u) add(v[j][u], load(nb, u));
            bits[j] &= bits[j] - 1;
            any |= bits[j];
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = warp + j * kWarps;
    if (k0 == 0 && lane == 0) deg[r] = nd[j];
    const float diag = (nd[j] > 0 ? 1.0f : 0.0f) + 1.0f;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const float4 sf = self[j][u];
      float4 out = v[j][u];
      add(out, make_float4(diag * sf.x, diag * sf.y, diag * sf.z,
                           diag * sf.w));
      *reinterpret_cast<float4*>(a_s + r * kLda + kc + 128 * u) = out;
    }
  }
}

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
  float* ring = a_s + Tl::kBM * kLda;  // W chunks, [kBK][kLdw] each
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * Tl::kBN;
  const int m0 = blockIdx.z * Tl::kBM;
  const int chunks = (t + tf32x3::kBK - 1) / tf32x3::kBK;
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
        gather_rows<true>(ep, ec, deg, hb, a_s, m0, n, e, t,
                          c * tf32x3::kBK);
      else
        gather_rows<false>(ep, ec, deg, hb, a_s, m0, n, e, t,
                           c * tf32x3::kBK);
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
}

__global__ void __launch_bounds__(kThreads)
spmm_sym_pair_kernel(const int* __restrict__ parent,
                     const int* __restrict__ child,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ x1,
                     const float* __restrict__ x2, float* __restrict__ o1,
                     float* __restrict__ o2, int n, int e, int t1, int t2) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const Lists L = build_lists(parent + (size_t)b * e, child + (size_t)b * e,
                              mask + (size_t)b * e, n, e, smem);
  // column tiles of x1 first, then of x2
  const int tiles1 = (t1 + kCols - 1) / kCols;
  const bool first = (int)blockIdx.y < tiles1;
  const int t = first ? t1 : t2;
  const int col = (first ? blockIdx.y : blockIdx.y - tiles1) * kCols +
                  threadIdx.x % kCols;
  if (col >= t) return;  // no barrier follows
  const float* x = (first ? x1 : x2) + (size_t)b * n * t;
  float* o = (first ? o1 : o2) + (size_t)b * n * t;
  for (int i = threadIdx.x / kCols; i < n; i += kRowLanes)
    o[(size_t)i * t + col] = sym_row(L, x, i, col, t);
}

}  // namespace

extern "C" {

int spmm_fused_forward_f32(const void* parent, const void* child,
                           const void* mask, const void* h, const void* w,
                           const void* bias, void* out, int b, int n, int e,
                           int t, int hdim, void* stream) {
  const size_t tiles_at = (8 * (size_t)e + 15) / 16 * 16;  // after ep, ec
  const size_t smem = tiles_at + kFwdTiles;
  cudaError_t err = set_smem(spmm_fused_fwd_kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  const bool vec_h = t % 4 == 0 && (uintptr_t)h % 16 == 0;
  const bool vec_w = hdim % 4 == 0 && (uintptr_t)w % 16 == 0;
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

int spmm_fused_sym_pair_f32(const void* parent, const void* child,
                            const void* mask, const void* x1, const void* x2,
                            void* o1, void* o2, int b, int n, int e, int t1,
                            int t2, void* stream) {
  const size_t smem = lists_bytes(n, e);
  cudaError_t err = set_smem(spmm_sym_pair_kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, (t1 + kCols - 1) / kCols + (t2 + kCols - 1) / kCols);
  spmm_sym_pair_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(x1),
      static_cast<const float*>(x2), static_cast<float*>(o1),
      static_cast<float*>(o2), n, e, t1, t2);
  return (int)cudaGetLastError();
}

const char* spmm_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
