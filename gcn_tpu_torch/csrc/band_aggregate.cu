// Banded aggregation straight from padded edge lists, forward and backward.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/band_aggregate.py:
//   _kernel       (launched by _forward, reached through
//                  fused_band_aggregate)    -> band_aggregate_forward_f32
//   _pair_kernel  (launched by pair_aggregate, the forward's backward)
//                                           -> band_aggregate_pair_f32
// Same contract, f32:
//   parent, child  [B, E] int32   edge p -> c of sentence b
//   mask           [B, E] uint8   0 = padded slot
//   forward:  out = act((A_f x_f + A_f^T x_r + x_s) / denom)
//             x_f, x_r, x_s, out [B, N, H]
//             denom = deg_out + deg_in + incident + 1
//   pair:     (out_t, out_f) = (A_f^T x, A_f x),  x, out_t, out_f [B, N, H]
// where A_f[p, c] counts the edges p -> c whose mask is set and whose ends
// both lie in [0, N): a duplicated edge counts twice, an edge with an end
// outside is dropped (the TPU's one-hot band build drops it too).
//
// What bounds it on the H100.  At the main path's shapes (B = 50, N = E =
// 96, H = 200) a sentence has fewer than N edges, so the aggregation is
// 2*E*H adds against 4*N*H values moved: memory bound (about 15 MB for
// the forward, 11.5 MB for the pair, a few microseconds at 3.35 TB/s).
// The TPU kernel built both N x N bands in VMEM with two one-hot MXU
// contractions and multiplied them densely, which suits a 128 x 128
// matrix unit.  On the card a dense band would do N/deg times the work,
// so each block builds the sentence's adjacency lists in shared memory
// (edge_lists.cuh: the lists keep edge order whatever order the threads
// run in), takes the degrees from the list lengths, and gathers neighbour
// rows: each output element sums its neighbours in edge order, so every
// run gives the same bits, with no float atomics.  One block per
// (sentence, tile of 64 columns): threads of a warp read 32 neighbouring
// columns of one row, coalesced.

#include <cuda_runtime.h>

#include "edge_lists.cuh"

namespace {

using edge_lists::Lists;
using edge_lists::build_lists;
using edge_lists::lists_bytes;
using edge_lists::set_smem;

constexpr int kCols = 64;                     // output columns per block
constexpr int kThreads = 256;                 // 4 row lanes x 64 columns
constexpr int kRowLanes = kThreads / kCols;

__global__ void __launch_bounds__(kThreads)
band_aggregate_fwd_kernel(const int* __restrict__ parent,
                          const int* __restrict__ child,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ xf,
                          const float* __restrict__ xr,
                          const float* __restrict__ xs,
                          float* __restrict__ out, int n, int e, int h,
                          int relu) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const Lists L = build_lists(parent + (size_t)b * e, child + (size_t)b * e,
                              mask + (size_t)b * e, n, e, smem);
  const int col = blockIdx.y * kCols + threadIdx.x % kCols;
  if (col >= h) return;  // no barrier follows
  const size_t base = (size_t)b * n * h + col;
  for (int i = threadIdx.x / kCols; i < n; i += kRowLanes) {
    const int f0 = L.start_f[i], f1 = L.start_f[i + 1];
    const int r0 = L.start_r[i], r1 = L.start_r[i + 1];
    float acc = 0.0f;
    for (int k = f0; k < f1; ++k) acc += xf[base + (size_t)L.nbr_f[k] * h];
    for (int k = r0; k < r1; ++k) acc += xr[base + (size_t)L.nbr_r[k] * h];
    acc += xs[base + (size_t)i * h];
    const int deg = (f1 - f0) + (r1 - r0);
    const float denom = (float)deg + (deg > 0 ? 1.0f : 0.0f) + 1.0f;
    const float z = acc / denom;
    out[base + (size_t)i * h] = relu ? fmaxf(z, 0.0f) : z;
  }
}

__global__ void __launch_bounds__(kThreads)
band_pair_kernel(const int* __restrict__ parent,
                 const int* __restrict__ child,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ x, float* __restrict__ out_t,
                 float* __restrict__ out_f, int n, int e, int h) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const Lists L = build_lists(parent + (size_t)b * e, child + (size_t)b * e,
                              mask + (size_t)b * e, n, e, smem);
  const int col = blockIdx.y * kCols + threadIdx.x % kCols;
  if (col >= h) return;  // no barrier follows
  const size_t base = (size_t)b * n * h + col;
  for (int i = threadIdx.x / kCols; i < n; i += kRowLanes) {
    float t = 0.0f, f = 0.0f;
    // (A_f^T x)[i] sums x over the parents of i, (A_f x)[i] over its children
    for (int k = L.start_r[i]; k < L.start_r[i + 1]; ++k)
      t += x[base + (size_t)L.nbr_r[k] * h];
    for (int k = L.start_f[i]; k < L.start_f[i + 1]; ++k)
      f += x[base + (size_t)L.nbr_f[k] * h];
    out_t[base + (size_t)i * h] = t;
    out_f[base + (size_t)i * h] = f;
  }
}

}  // namespace

extern "C" {

int band_aggregate_forward_f32(const void* parent, const void* child,
                               const void* mask, const void* xf,
                               const void* xr, const void* xs, void* out,
                               int b, int n, int e, int h, int relu,
                               void* stream) {
  const size_t smem = lists_bytes(n, e);
  cudaError_t err = set_smem(band_aggregate_fwd_kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, (h + kCols - 1) / kCols);
  band_aggregate_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(xf),
      static_cast<const float*>(xr), static_cast<const float*>(xs),
      static_cast<float*>(out), n, e, h, relu);
  return (int)cudaGetLastError();
}

int band_aggregate_pair_f32(const void* parent, const void* child,
                            const void* mask, const void* x, void* out_t,
                            void* out_f, int b, int n, int e, int h,
                            void* stream) {
  const size_t smem = lists_bytes(n, e);
  cudaError_t err = set_smem(band_pair_kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, (h + kCols - 1) / kCols);
  band_pair_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(x),
      static_cast<float*>(out_t), static_cast<float*>(out_f), n, e, h);
  return (int)cudaGetLastError();
}

const char* band_aggregate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
