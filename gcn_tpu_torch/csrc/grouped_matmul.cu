// Grouped (ragged) matmul, forward: y[m] = x[m] @ s[gid(m)] over rows sorted
// so that each group is contiguous.
//
// Replaces the Pallas TPU kernel gcn_tpu/ops/pallas/grouped_matmul.py::
// _fwd_kernel together with its visit schedule _schedule (launched by
// _gmm_forward, reached through grouped_matmul).  Same contract:
//   x           [M, T]
//   s           [R, T, H]
//   group_ends  [R] int32   cumsum(group_sizes); rows past the last end
//                           belong to the last group, empty groups are skipped
//   y           [M, H]      in x's dtype, accumulated in f32
// Storage is f32 or bf16.
//
// What bounds it on the H100.  At the main path's shapes (M = 9600 stacked
// band rows, T = 400 or 200, H = 200, R = 87) it does 2 M T H = 1.5 (0.77)
// GFLOP and moves x, the used groups' S and y once, 49 (28) MB: on the
// 3xTF32 tensor-core mainloop (165 TFLOP/s effective) the bytes bound it,
// 0.015 (0.008) ms, where the CUDA cores' f32 FMA rate would set 0.023
// (0.011).  The TPU kernel walked a scalar-prefetched list of (row tile,
// group) visits on a sequential grid, revisiting one output block in
// VMEM; a row tile that met k groups took k masked products.  Here the
// list is cut per group (grouped_tiles.cuh): each CTA owns 128 rows of one
// group by all 208 columns, so no product is masked and each output row
// is stored once.  Each group's rows start a tile, so at the main path's
// group sizes (80 groups of 44-97 rows, two padding groups of about 2070)
// the 9600 rows make 114 tiles of 128 rows: one wave on 132 SMs, where
// 196 tiles of 64 rows put two on 64 SMs (the same longest SM) and read
// S[g] from L2 twice as often (and were slower, two CTAs an SM at 128
// registers).  A warp whose 32 rows are past the group's end issues no
// MMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grouped_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gmm::Tl::kThreads, gmm::kMinBlocks)
grouped_matmul_fwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                          const int* __restrict__ group_ends,
                          T* __restrict__ y, int m, int t, int h, int r,
                          bool vec_x, bool vec_s) {
  gmm::tile_product<gmm::kFwd, T>(x, s, group_ends, y, nullptr, m, t, h, r,
                                  vec_x, vec_s);
}

template <typename T>
int launch(const void* x, const void* s, const void* group_ends, void* y,
           int m, int t, int h, int r, void* stream) {
  const auto kernel = grouped_matmul_fwd_kernel<T>;
  constexpr size_t kSmem = gmm::Geo<gmm::kFwd>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(gmm::tile_bound(m, r),
                  (h + gmm::Tl::kBN - 1) / gmm::Tl::kBN);
  kernel<<<grid, gmm::Tl::kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const int*>(group_ends), static_cast<T*>(y), m, t, h, r,
      gmm::vec_ok<T>(x, t), gmm::vec_ok<T>(s, h));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grouped_matmul_forward_f32(const void* x, const void* s,
                               const void* group_ends, void* y, int m, int t,
                               int h, int r, void* stream) {
  return launch<float>(x, s, group_ends, y, m, t, h, r, stream);
}

int grouped_matmul_forward_bf16(const void* x, const void* s,
                                const void* group_ends, void* y, int m, int t,
                                int h, int r, void* stream) {
  return launch<__nv_bfloat16>(x, s, group_ends, y, m, t, h, r, stream);
}

const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
