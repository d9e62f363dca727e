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
// so rows gather their neighbour rows instead, each output element
// summing its neighbours in edge order: every run gives the same bits,
// with no float atomics.
//
// The forward finds each row's neighbours by warp ballots over the
// sentence's edge slots in shared memory (edge_gather.cuh, the gather of
// the fused GCN layer too), with no list build.  A block owns 8 rows of
// one sentence, one a warp, and a warp covers a whole row of up to 384
// columns (128 kV, kV = 1-3 chosen from H; wider H takes more column
// blocks): 600 blocks at B = 50, N = 96, H = 200.  A lane covers 4 columns
// of each 128 by 16-byte loads, with several neighbour rows in flight.
// The epilogue adds x_s, divides by denom (the ballots' counts give the
// degree) and applies the ReLU.  One row a warp, its walk unrolled, timed
// faster than two or four rows a warp in lockstep.
//
// The pair builds the sentence's adjacency lists in shared memory
// (edge_lists.cuh: each list keeps edge order) and takes the degrees from
// the list lengths.  One block per (sentence, tile of 64 columns): threads
// of a warp read 32 neighbouring columns of one row, coalesced.

#include <cuda_runtime.h>

#include <stdint.h>

#include "edge_gather.cuh"
#include "edge_lists.cuh"

namespace {

using edge_gather::add4;
using edge_gather::edges_bytes;
using edge_gather::gather_row;
using edge_gather::load4;
using edge_gather::load_edges;
using edge_gather::set_smem;
using edge_gather::store4;
using edge_gather::zero4;
using edge_lists::Lists;
using edge_lists::build_lists;
using edge_lists::lists_bytes;

constexpr int kFwdThreads = 256;              // forward: 8 warps,
constexpr int kFwdRows = kFwdThreads / 32;    // a row each
constexpr int kCols = 64;                     // pair: columns per block
constexpr int kThreads = 256;                 // pair: 4 row lanes x 64
constexpr int kRowLanes = kThreads / kCols;

// Rows blockIdx.y * kFwdRows.. of sentence blockIdx.x, one a warp, 128 kV
// columns from column tile blockIdx.z.  A row sums x_f over its forward
// neighbours, x_r over its reverse ones (edge_gather.cuh), then x_s, and
// divides by deg + [deg > 0] + 1.
template <int kV, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
band_aggregate_fwd_kernel(const int* __restrict__ parent,
                          const int* __restrict__ child,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ xf,
                          const float* __restrict__ xr,
                          const float* __restrict__ xs,
                          float* __restrict__ out, int n, int e, int h,
                          int relu) {
  extern __shared__ int fwd_smem[];
  int* ep = fwd_smem;
  int* ec = ep + e;
  const int b = blockIdx.x;
  load_edges(parent + (size_t)b * e, child + (size_t)b * e,
             mask + (size_t)b * e, n, e, ep, ec);
  const int i = blockIdx.y * kFwdRows + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp; no barrier follows
  const size_t at = (size_t)b * n * h;
  xf += at;
  xr += at;
  xs += at;
  out += at;
  const int kc = blockIdx.z * 128 * kV + threadIdx.x % 32 * 4;
  float4 v[kV], self[kV];
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    v[u] = zero4();
    self[u] = load4<kVec>(xs, i, kc + 128 * u, h);
  }
  const int deg = gather_row(ep, ec, e, i,
                             [&](int dir, int r, int u) {
                               return load4<kVec>(dir == 0 ? xf : xr, r,
                                                  kc + 128 * u, h);
                             },
                             v);
  const float denom = (float)deg + (deg > 0 ? 1.0f : 0.0f) + 1.0f;
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    float4 z = v[u];
    add4(z, self[u]);
    z = make_float4(z.x / denom, z.y / denom, z.z / denom, z.w / denom);
    if (relu)
      z = make_float4(fmaxf(z.x, 0.0f), fmaxf(z.y, 0.0f), fmaxf(z.z, 0.0f),
                      fmaxf(z.w, 0.0f));
    store4<kVec>(out, i, kc + 128 * u, h, z);
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
  const bool vec = h % 4 == 0 && (uintptr_t)xf % 16 == 0 &&
                   (uintptr_t)xr % 16 == 0 && (uintptr_t)xs % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  // 128 kV columns a tile, kV = 1-3 so that one tile covers up to 384
  const int groups = (h + 127) / 128;
  const int kv = groups <= 1 ? 1 : groups == 2 ? 2 : 3;
  const dim3 grid(b, (n + kFwdRows - 1) / kFwdRows,
                  (h + 128 * kv - 1) / (128 * kv));
  const size_t smem = edges_bytes(e);
  auto launch = [&](auto kernel) {
    cudaError_t err = set_smem(kernel, smem, 0);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kFwdThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const int*>(parent), static_cast<const int*>(child),
        static_cast<const unsigned char*>(mask),
        static_cast<const float*>(xf), static_cast<const float*>(xr),
        static_cast<const float*>(xs), static_cast<float*>(out), n, e, h,
        relu);
    return (int)cudaGetLastError();
  };
  if (vec)
    return kv == 1   ? launch(band_aggregate_fwd_kernel<1, true>)
           : kv == 2 ? launch(band_aggregate_fwd_kernel<2, true>)
                     : launch(band_aggregate_fwd_kernel<3, true>);
  return kv == 1   ? launch(band_aggregate_fwd_kernel<1, false>)
         : kv == 2 ? launch(band_aggregate_fwd_kernel<2, false>)
                   : launch(band_aggregate_fwd_kernel<3, false>);
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
