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
// What bounds it on the H100.  The forward's product with W is 2*B*N*T*H
// FLOPs (0.69 GFLOP at B = 50, N = 96, T = 360, H = 200) against some
// 7 MB moved: bound by the f32 FMA rate (CUDA cores in this first
// version), while S h is a gather of fewer than 2E + N rows per sentence.
// The sym pair is a gather alone, memory bound.  The TPU kernel built the
// N x N bands in VMEM with one-hot MXU contractions and multiplied them
// densely; on the card each block builds the sentence's adjacency lists
// in shared memory instead (edge_lists.cuh: each list keeps edge order),
// takes the degrees from the list lengths and gathers neighbour rows in
// a fixed order: the same bits on every run, with no float atomics.  The
// forward does the W product in its own body: a block owns 32 rows x 64
// columns of out for one sentence, builds (S h) for its rows 32 columns
// of T at a time into shared memory, stages the matching 32 rows of W
// beside it, and accumulates 2 x 4 outputs a thread in registers, then
// adds 2b, divides by denom and applies the ReLU.  T and H need not be
// multiples of a tile (360 and 200 at the main path's first layer): the
// ragged edges read as zero.  Tensor-core tiles (wgmma) are the next step.

#include <cuda_runtime.h>

#include "edge_lists.cuh"

namespace {

using edge_lists::Lists;
using edge_lists::build_lists;
using edge_lists::lists_bytes;
using edge_lists::set_smem;

constexpr int kThreads = 256;
constexpr int kTM = 32;                    // forward: rows per block
constexpr int kTN = 64;                    // forward: columns per block
constexpr int kTK = 32;                    // forward: depth per chunk
constexpr int kCols = 64;                  // sym pair: columns per block
constexpr int kRowLanes = kThreads / kCols;
constexpr size_t kStaticSmem =             // the forward's fixed tiles
    sizeof(float) * (kTK * (kTM + 1) + kTK * (kTN + 4));

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

__global__ void __launch_bounds__(kThreads)
spmm_fused_fwd_kernel(const int* __restrict__ parent,
                      const int* __restrict__ child,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ hin,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int n, int e, int t, int hdim) {
  extern __shared__ int smem[];
  __shared__ float ah[kTK][kTM + 1];  // (S h) chunk, transposed: ah[k][row]
  __shared__ float ws[kTK][kTN + 4];  // W rows k0.., columns n0..
  const int b = blockIdx.x;
  const int n0 = blockIdx.y * kTN;
  const int m0 = blockIdx.z * kTM;
  const Lists L = build_lists(parent + (size_t)b * e, child + (size_t)b * e,
                              mask + (size_t)b * e, n, e, smem);
  const float* hb = hin + (size_t)b * n * t;
  const int tx = threadIdx.x % 16;  // output columns tx*4 .. tx*4+3
  const int ty = threadIdx.x / 16;  // output rows    ty*2 .. ty*2+1

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < t; k0 += kTK) {
    // a warp takes 32 neighbouring k of one row: coalesced row gathers
    for (int idx = threadIdx.x; idx < kTM * kTK; idx += kThreads) {
      const int r = idx / kTK, kk = idx % kTK;
      const int i = m0 + r, k = k0 + kk;
      ah[kk][r] = (i < n && k < t) ? sym_row(L, hb, i, k, t) : 0.0f;
    }
    for (int idx = threadIdx.x; idx < kTK * kTN; idx += kThreads) {
      const int kk = idx / kTN, c = idx % kTN;
      const int k = k0 + kk, col = n0 + c;
      ws[kk][c] = (k < t && col < hdim) ? w[(size_t)k * hdim + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const float a0 = ah[kk][ty * 2], a1 = ah[kk][ty * 2 + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = ws[kk][tx * 4 + j];
        acc[0][j] = fmaf(a0, wv, acc[0][j]);
        acc[1][j] = fmaf(a1, wv, acc[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty * 2 + i;
    if (row >= n) continue;
    const int deg = (L.start_f[row + 1] - L.start_f[row]) +
                    (L.start_r[row + 1] - L.start_r[row]);
    const float denom = (float)deg + (deg > 0 ? 1.0f : 0.0f) + 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= hdim) continue;
      const float z = (acc[i][j] + 2.0f * bias[col]) / denom;
      out[((size_t)b * n + row) * hdim + col] = fmaxf(z, 0.0f);
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
  const size_t smem = lists_bytes(n, e);
  cudaError_t err = set_smem(spmm_fused_fwd_kernel, smem, kStaticSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, (hdim + kTN - 1) / kTN, (n + kTM - 1) / kTM);
  spmm_fused_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), n, e, t, hdim);
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
