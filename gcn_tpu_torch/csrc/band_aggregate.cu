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
// Both kernels find each row's neighbours by warp ballots over the
// sentence's edge slots in shared memory (edge_gather.cuh, the gather of
// the fused GCN layer too), with no list build.  A block owns 8 rows of
// one sentence, one a warp, and a warp covers a whole row of up to 384
// columns (128 kV, kV = 1-3 chosen from H; wider H takes more column
// blocks): 600 blocks at B = 50, N = 96, H = 200.  A lane covers 4 columns
// of each 128 by 16-byte loads, with several neighbour rows in flight.
// The forward sums a row's forward neighbours of x_f and its reverse ones
// of x_r into one sum; its epilogue adds x_s, divides by denom (the
// ballots' counts give the degree) and applies the ReLU.  One row a warp,
// its walk unrolled, timed faster than two or four rows a warp in
// lockstep.  The pair walks the same ballots with the two directions
// kept apart (gather_pair): (A_f x)[i] sums x over the children of i,
// (A_f^T x)[i] over its parents, each in edge order.

#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "edge_gather.cuh"

namespace {

using edge_gather::add4;
using edge_gather::edges_bytes;
using edge_gather::gather_pair;
using edge_gather::gather_row;
using edge_gather::load4;
using edge_gather::load_edges;
using edge_gather::set_smem;
using edge_gather::store4;
using edge_gather::zero4;

constexpr int kThreads = 256;           // 8 warps,
constexpr int kRows = kThreads / 32;    // a row each

// Rows blockIdx.y * kRows.. of sentence blockIdx.x, one a warp, 128 kV
// columns from column tile blockIdx.z.  A row sums x_f over its forward
// neighbours, x_r over its reverse ones (edge_gather.cuh), then x_s, and
// divides by deg + [deg > 0] + 1.
template <int kV, bool kVec>
__global__ void __launch_bounds__(kThreads)
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
  const int i = blockIdx.y * kRows + threadIdx.x / 32;
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

// The same rows and columns: out_f[i] sums x over the forward neighbours
// of i (its children), out_t[i] over its reverse ones (its parents).
template <int kV, bool kVec>
__global__ void __launch_bounds__(kThreads)
band_pair_kernel(const int* __restrict__ parent,
                 const int* __restrict__ child,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ x, float* __restrict__ out_t,
                 float* __restrict__ out_f, int n, int e, int h) {
  extern __shared__ int pair_smem[];
  int* ep = pair_smem;
  int* ec = ep + e;
  const int b = blockIdx.x;
  load_edges(parent + (size_t)b * e, child + (size_t)b * e,
             mask + (size_t)b * e, n, e, ep, ec);
  const int i = blockIdx.y * kRows + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp; no barrier follows
  const size_t at = (size_t)b * n * h;
  x += at;
  out_t += at;
  out_f += at;
  const int kc = blockIdx.z * 128 * kV + threadIdx.x % 32 * 4;
  float4 f[kV], t[kV];
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    f[u] = zero4();
    t[u] = zero4();
  }
  gather_pair(ep, ec, e, i,
              [&](int, int r, int u) {
                return load4<kVec>(x, r, kc + 128 * u, h);
              },
              f, t);
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    store4<kVec>(out_f, i, kc + 128 * u, h, f[u]);
    store4<kVec>(out_t, i, kc + 128 * u, h, t[u]);
  }
}

// Launches pick(kV, kVec) (the kernel instance; kV and kVec come as
// std::integral_constant values) with args over rows of width h: blocks of
// kRows rows of one sentence and 128 kV columns, kV = 1-3 so that one tile
// covers up to 384 columns, with the sentence's edge slots in shared
// memory.  kVec: 16-byte loads and stores (h % 4 == 0, operands aligned).
template <class Pick, class... Args>
int launch_rows(int b, int n, int e, int h, bool vec, void* stream,
                Pick&& pick, Args... args) {
  const int groups = (h + 127) / 128;
  const int kv = groups <= 1 ? 1 : groups == 2 ? 2 : 3;
  const dim3 grid(b, (n + kRows - 1) / kRows,
                  (h + 128 * kv - 1) / (128 * kv));
  const size_t smem = edges_bytes(e);
  auto run = [&](auto kernel) {
    const cudaError_t err = set_smem(kernel, smem, 0);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
  };
  using std::integral_constant;
  auto by_kv = [&](auto vec_c) {
    return kv == 1   ? run(pick(integral_constant<int, 1>{}, vec_c))
           : kv == 2 ? run(pick(integral_constant<int, 2>{}, vec_c))
                     : run(pick(integral_constant<int, 3>{}, vec_c));
  };
  return vec ? by_kv(std::true_type{}) : by_kv(std::false_type{});
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

int band_aggregate_forward_f32(const void* parent, const void* child,
                               const void* mask, const void* xf,
                               const void* xr, const void* xs, void* out,
                               int b, int n, int e, int h, int relu,
                               void* stream) {
  const bool vec = h % 4 == 0 && aligned16(xf) && aligned16(xr) &&
                   aligned16(xs) && aligned16(out);
  return launch_rows(
      b, n, e, h, vec, stream,
      [](auto kv, auto kvec) {
        return band_aggregate_fwd_kernel<decltype(kv)::value,
                                         decltype(kvec)::value>;
      },
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(xf),
      static_cast<const float*>(xr), static_cast<const float*>(xs),
      static_cast<float*>(out), n, e, h, relu);
}

int band_aggregate_pair_f32(const void* parent, const void* child,
                            const void* mask, const void* x, void* out_t,
                            void* out_f, int b, int n, int e, int h,
                            void* stream) {
  const bool vec = h % 4 == 0 && aligned16(x) && aligned16(out_t) &&
                   aligned16(out_f);
  return launch_rows(
      b, n, e, h, vec, stream,
      [](auto kv, auto kvec) {
        return band_pair_kernel<decltype(kv)::value, decltype(kvec)::value>;
      },
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(x),
      static_cast<float*>(out_t), static_cast<float*>(out_f), n, e, h);
}

const char* band_aggregate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
