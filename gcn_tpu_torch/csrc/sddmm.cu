// Per-edge scores from padded edge lists (SDDMM), forward and backward.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/sddmm.py:
//   _kernel      (launched by _forward, reached through sddmm)
//                                          -> sddmm_forward_f32
//   _bwd_kernel  (launched by _backward, sddmm's custom VJP)
//                                          -> sddmm_backward_f32
// Same contract, f32:
//   parent, child  [B, E] int32   edge p -> c of sentence b
//   mask           [B, E] uint8   0 = padded slot
//   u, v           [B, N, H]
//   forward:   s[b, e] = mask_e * sum_h u[b, p_e, h] * v[b, c_e, h]   [B, E]
//   backward:  with gm_e = g[b, e] * mask_e (g [B, E]),
//              du[b, i] = sum over edges e with p_e = i of gm_e * v[b, c_e]
//              dv[b, j] = sum over edges e with c_e = j of gm_e * u[b, p_e]
// An edge counts when its mask is set and both ends lie in [0, N); an edge
// with an end outside scores 0 and adds nothing to du or dv (the TPU's
// one-hot selection gives it an empty row, so it scores 0 there too).
//
// What bounds it on the H100.  At the attention layer's shapes (B = 50,
// N = E = 96, H = 200) the forward does 2 E H flops against the 2 N H
// rows it reads, the backward 4 E H against 4 N H values moved: both are
// memory bound (about 7.7 MB and 15 MB, a few microseconds at 3.35 TB/s).
// The TPU kernels select rows with one-hot [E, N] MXU contractions, which
// suits a 128 x 128 matrix unit; on the card that is N times the work of
// a gather.  So the forward gives each edge one warp, whose lanes read 32
// neighbouring columns of the two rows at a time (coalesced) and reduce
// by shuffles in a fixed order.  The backward is a per-node sum over the
// node's own edges: each block builds the sentence's adjacency lists in
// shared memory (edge_lists.cuh, with edge ids to read g), and each output
// element sums its edges in edge order, so there are no float atomics and
// every run gives the same bits.  One block per (sentence, 64 columns).

#include <cuda_runtime.h>

#include "edge_lists.cuh"

namespace {

using edge_lists::Lists;
using edge_lists::build_lists;
using edge_lists::lists_bytes;
using edge_lists::set_smem;

constexpr int kWarps = 8;                     // forward: edges per block
constexpr int kCols = 64;                     // backward: columns per block
constexpr int kThreads = 256;
constexpr int kRowLanes = kThreads / kCols;

__global__ void __launch_bounds__(kWarps * 32)
sddmm_fwd_kernel(const int* __restrict__ parent,
                 const int* __restrict__ child,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ u, const float* __restrict__ v,
                 float* __restrict__ out, int b_sz, int n, int e, int h) {
  const int lane = threadIdx.x % 32;
  const long long edge = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (edge >= (long long)b_sz * e) return;  // no barrier follows
  const int b = (int)(edge / e);
  const int p = parent[edge], c = child[edge];
  const bool ok = mask[edge] != 0 && p >= 0 && p < n && c >= 0 && c < n;
  float acc = 0.0f;
  if (ok) {
    const float* up = u + ((size_t)b * n + p) * h;
    const float* vc = v + ((size_t)b * n + c) * h;
    for (int k = lane; k < h; k += 32) acc += up[k] * vc[k];
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[edge] = acc;
}

__global__ void __launch_bounds__(kThreads)
sddmm_bwd_kernel(const int* __restrict__ parent,
                 const int* __restrict__ child,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ g, const float* __restrict__ u,
                 const float* __restrict__ v, float* __restrict__ du,
                 float* __restrict__ dv, int n, int e, int h) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const Lists L = build_lists<true>(parent + (size_t)b * e,
                                    child + (size_t)b * e,
                                    mask + (size_t)b * e, n, e, smem);
  const int col = blockIdx.y * kCols + threadIdx.x % kCols;
  if (col >= h) return;  // no barrier follows
  const float* gb = g + (size_t)b * e;
  const size_t base = (size_t)b * n * h + col;
  for (int i = threadIdx.x / kCols; i < n; i += kRowLanes) {
    // du[i]: the edges whose parent is i, through their children's v rows;
    // dv[i]: the edges whose child is i, through their parents' u rows
    float su = 0.0f, sv = 0.0f;
    for (int k = L.start_f[i]; k < L.start_f[i + 1]; ++k)
      su += gb[L.edge_f[k]] * v[base + (size_t)L.nbr_f[k] * h];
    for (int k = L.start_r[i]; k < L.start_r[i + 1]; ++k)
      sv += gb[L.edge_r[k]] * u[base + (size_t)L.nbr_r[k] * h];
    du[base + (size_t)i * h] = su;
    dv[base + (size_t)i * h] = sv;
  }
}

}  // namespace

extern "C" {

int sddmm_forward_f32(const void* parent, const void* child,
                      const void* mask, const void* u, const void* v,
                      void* out, int b, int n, int e, int h, void* stream) {
  const long long edges = (long long)b * e;
  const long long blocks = (edges + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sddmm_fwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<float*>(out), b, n, e, h);
  return (int)cudaGetLastError();
}

int sddmm_backward_f32(const void* parent, const void* child,
                       const void* mask, const void* g, const void* u,
                       const void* v, void* du, void* dv, int b, int n,
                       int e, int h, void* stream) {
  const size_t smem = lists_bytes(n, e, true);
  cudaError_t err = set_smem(sddmm_bwd_kernel, smem, 0);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, (h + kCols - 1) / kCols);
  sddmm_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(g),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(du), static_cast<float*>(dv), n, e, h);
  return (int)cudaGetLastError();
}

const char* sddmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
