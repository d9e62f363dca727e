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
// The forward does the W product in its own body.  A block owns 48 rows
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
// The sym pair's block owns 8 rows of one sentence, one a warp, and a
// warp covers a whole row of x1 or of x2, up to 384 columns (128 kV, kV =
// 1-3 chosen from T1 and T2; wider takes more column blocks): x1's tiles
// and x2's lie along the grid, 1200 blocks at B = 50, N = 96.  A lane
// covers 4 columns of each 128 by 16-byte loads, with several neighbour
// rows in flight.  That timed faster than both operands in one warp, which
// shares the ballots but holds twice the registers, and than two or four
// rows a warp in lockstep.
//
// The bf16 instances round where the TPU kernel rounds: the forward sums
// (S h) in f32, rounds it to bf16 in its A tile (the TPU kernel casts
// (S h) to h's dtype before the product with W), multiplies by the bf16 W
// in f32 and rounds the output once; the sym pair sums in f32 and rounds
// each output once.  Their rows move as bf16 (edge_gather.cuh's typed
// loads and stores), and W streams through the ring as bf16.  The
// forward's product then runs one TF32 pass a k-step instead of three
// (tf32x3_tile.cuh, kExact: bf16 values and their products are exact in
// TF32 and its f32 accumulator), its A tile and fragments as in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "edge_gather.cuh"
#include "tf32x3_tile.cuh"

namespace {

using edge_gather::add4;
using edge_gather::edges_bytes;
using edge_gather::from_f32;
using edge_gather::round_to;
using edge_gather::to_f32;
using edge_gather::vec_bytes;
using edge_gather::gather_row;
using edge_gather::gather_rows;
using edge_gather::load4;
using edge_gather::load_edges;
using edge_gather::set_smem;
using edge_gather::store4;
using edge_gather::zero4;
using tf32x3::kStages;

// forward: 3 x 4 warps, each 16 rows x 56 columns: 48 x 224 a block
using FwdTile = tf32x3::Tile<3, 4, 1, 7>;
constexpr int kAK = 256;                   // forward: (S h) columns per gather
constexpr int kLda = kAK + 4;              // conflict-free A fragment reads
// the forward's degrees and tiles: the A tile in f32, the W ring in T
template <typename T>
constexpr size_t fwd_tiles() {
  return sizeof(int) * FwdTile::kBM + sizeof(float) * FwdTile::kBM * kLda +
         sizeof(T) * (size_t)kStages * FwdTile::kStageFloats;
}
static_assert(kAK % tf32x3::kBK == 0, "a gather covers whole W chunks");
constexpr int kPairThreads = 256;  // sym pair: 8 warps, a row each
constexpr int kPairRows = kPairThreads / 32;

// (S h) rows m0.. (kBM of them) and columns k0..k0 + kAK of one sentence
// (rows start at hb, width t) into a_s [kBM][kLda], zero past n and t; the
// first call (k0 = 0) also writes each row's degree to deg [kBM].
// Warp w takes rows w, w + kWarps, ...; lane l the columns 4l..4l + 3 of
// each 128 (4 columns a load with kVec: t a multiple of 4, hb aligned).
// Each row sums its forward neighbours, its reverse ones
// (edge_gather.cuh), then diag * self, in f32; a_s holds the sums rounded
// to T (bf16 rounds them there, as the TPU kernel does, f32 keeps them).
template <typename T, bool kVec>
__device__ __forceinline__ void gather_tile(const int* __restrict__ ep,
                                            const int* __restrict__ ec,
                                            int* __restrict__ deg,
                                            const T* __restrict__ hb,
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
      out = make_float4(round_to<T>(out.x), round_to<T>(out.y),
                        round_to<T>(out.z), round_to<T>(out.w));
      *reinterpret_cast<float4*>(a_s + r * kLda + lane * 4 + 128 * u) = out;
    }
  }
}

// T: the storage of h, W, b and out, f32 or bf16; a bf16 product runs one
// TF32 pass a k-step (kExact).
template <typename T>
__global__ void __launch_bounds__(FwdTile::kThreads, 1)
spmm_fused_fwd_kernel(const int* __restrict__ parent,
                      const int* __restrict__ child,
                      const unsigned char* __restrict__ mask,
                      const T* __restrict__ hin,
                      const T* __restrict__ w,
                      const T* __restrict__ bias,
                      T* __restrict__ out, int n, int e, int t, int hdim,
                      size_t tiles_at, bool vec_h, bool vec_w) {
  using Tl = FwdTile;
  constexpr bool kExact = sizeof(T) == 2;
  extern __shared__ __align__(16) int fwd_smem[];
  int* ep = fwd_smem;  // [e] the edge slots, then (16-byte aligned) the rest
  int* ec = ep + e;
  int* deg = reinterpret_cast<int*>(reinterpret_cast<char*>(fwd_smem) +
                                    tiles_at);  // [kBM]
  float* a_s = reinterpret_cast<float*>(deg + Tl::kBM);
  // W chunks, [kBK][kLdw] each
  T* ring = reinterpret_cast<T*>(a_s + Tl::kBM * kLda);
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
  const T* hb = hin + (size_t)b * n * t;
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
        gather_tile<T, true>(ep, ec, deg, hb, a_s, m0, n, e, t,
                             c * tf32x3::kBK);
      else
        gather_tile<T, false>(ep, ec, deg, hb, a_s, m0, n, e, t,
                              c * tf32x3::kBK);
    }
    tf32x3::ring_wait();  // also publishes the gather
    if (c == chunks) break;
    issue(c + kStages - 1);
    const float* as = a_s + (wm * 16 + g) * kLda + kk + q;
    tf32x3::mma_chunk<1, Tl::kNT, Tl::kNT, Tl::kLdw, kExact>(
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
    T* orow = out + ((size_t)b * n + row) * hdim;
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n0 + wn * Tl::kNT * 8 + j * 8 + 2 * q + i;
        if (col >= hdim) continue;
        const float z =
            (acc[0][j][half * 2 + i] + 2.0f * to_f32(bias[col])) / denom;
        orow[col] = from_f32<T>(fmaxf(z, 0.0f));
      }
    }
  }
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

bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

template <typename T>
int forward(const void* parent, const void* child, const void* mask,
            const void* h, const void* w, const void* bias, void* out, int b,
            int n, int e, int t, int hdim, void* stream) {
  const size_t tiles_at = edges_bytes(e);  // the tiles follow ep, ec
  const size_t smem = tiles_at + fwd_tiles<T>();
  cudaError_t err = set_smem(spmm_fused_fwd_kernel<T>, smem, 0);
  if (err != cudaSuccess) return (int)err;
  const bool vec_h = t % 4 == 0 && aligned(h, vec_bytes<T>());
  // W chunks stream by 16-byte copies, 16 / sizeof(T) columns each
  const bool vec_w = hdim % (16 / (int)sizeof(T)) == 0 && aligned(w, 16);
  dim3 grid(b, (hdim + FwdTile::kBN - 1) / FwdTile::kBN,
            (n + FwdTile::kBM - 1) / FwdTile::kBM);
  spmm_fused_fwd_kernel<T><<<grid, FwdTile::kThreads, smem,
                             (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(h),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), n, e, t, hdim, tiles_at, vec_h, vec_w);
  return (int)cudaGetLastError();
}

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

int spmm_fused_forward_f32(const void* parent, const void* child,
                           const void* mask, const void* h, const void* w,
                           const void* bias, void* out, int b, int n, int e,
                           int t, int hdim, void* stream) {
  return forward<float>(parent, child, mask, h, w, bias, out, b, n, e, t,
                        hdim, stream);
}

int spmm_fused_forward_bf16(const void* parent, const void* child,
                            const void* mask, const void* h, const void* w,
                            const void* bias, void* out, int b, int n, int e,
                            int t, int hdim, void* stream) {
  return forward<__nv_bfloat16>(parent, child, mask, h, w, bias, out, b, n,
                                e, t, hdim, stream);
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
  return sym_pair<__nv_bfloat16>(parent, child, mask, x1, x2, o1, o2, b, n,
                                 e, t1, t2, stream);
}

const char* spmm_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
