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
// GFLOP and moves x, g, the used groups' S in and dx, all R groups' dS out
// once, 92 (50) MB: on the 3xTF32 tensor-core mainloop (165 TFLOP/s
// effective) the bytes bound it, 0.028 (0.015) ms, where the CUDA cores'
// f32 FMA rate would set 0.046 (0.023).
//
// The TPU kernel fused both products into one pass over the visit schedule
// so that each group's S block was read from HBM once, while dS of that
// group stayed resident in VMEM across its consecutive visits.  On the card
// the two products have different natural tilings, so the entry point
// launches them back to back, each over a work list cut per group
// (grouped_tiles.cuh), on the 3xTF32 mainloop:
//   * dx takes the forward's list, 128 rows of one group a CTA, by 208
//     columns of T (two tiles at T = 400), with S[g]'s rows streamed as
//     [208 of T] x [32 of H] slabs and read transposed;
//   * dS cuts each group into chunks of at most 256 rows (kKC): a CTA takes
//     one chunk by 128 rows of T by all 208 columns of H, A = the chunk's x
//     rows read transposed, B = its g rows.  The padding groups hold about
//     2070 of the 9600 rows each, the next largest 97: where one block
//     walked a whole group, the two padding groups set the tail; at 256
//     rows a chunk their CTAs are 8 k-chunks deep against 2-4 for the
//     others, and the list starts them first.  (Chunks of 128 rows halve
//     that depth for twice the partials, and were slower.)  A group's
//     first chunk writes dS[g], each later one a partial, and a third
//     launch adds the partials into dS[g] in chunk order: no float
//     atomics, so two calls give the same bits, and an empty group's
//     single chunk of no rows writes its zeros.
// g is read by both products and x by the forward and dS; S only by dx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grouped_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gmm::Tl::kThreads, gmm::kMinBlocks)
grouped_matmul_dx_kernel(const T* __restrict__ g, const T* __restrict__ s,
                         const int* __restrict__ group_ends,
                         T* __restrict__ dx, int m, int t, int h, int r,
                         bool vec_g, bool vec_s) {
  gmm::tile_product<gmm::kDx, T>(g, s, group_ends, dx, nullptr, m, t, h, r,
                                 vec_g, vec_s);
}

template <typename T>
__global__ void __launch_bounds__(gmm::Tl::kThreads, gmm::kMinBlocks)
grouped_matmul_ds_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const int* __restrict__ group_ends,
                         float* __restrict__ ds, float* __restrict__ part,
                         int m, int t, int h, int r, bool vec_x, bool vec_g) {
  gmm::tile_product<gmm::kDs, T>(x, g, group_ends, ds, part, m, t, h, r,
                                 vec_x, vec_g);
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

template <typename T>
int launch(const void* x, const void* g, const void* s, const void* group_ends,
           void* dx, void* ds, void* part, int m, int t, int h, int r,
           void* stream) {
  using gmm::Tl;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* ends = static_cast<const int*>(group_ends);
  const auto dx_kernel = grouped_matmul_dx_kernel<T>;
  const auto ds_kernel = grouped_matmul_ds_kernel<T>;
  constexpr size_t kDxSmem = gmm::Geo<gmm::kDx>::kSmem;
  constexpr size_t kDsSmem = gmm::Geo<gmm::kDs>::kSmem;
  cudaError_t e = allow_smem(dx_kernel, kDxSmem);
  if (e == cudaSuccess) e = allow_smem(ds_kernel, kDsSmem);
  if (e != cudaSuccess) return (int)e;
  const int col_tiles_t = (t + Tl::kBN - 1) / Tl::kBN;
  const int col_tiles_h = (h + Tl::kBN - 1) / Tl::kBN;
  dx_kernel<<<dim3(gmm::tile_bound(m, r), col_tiles_t), Tl::kThreads,
              kDxSmem, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(s), ends,
      static_cast<T*>(dx), m, t, h, r, gmm::vec_ok<T>(g, h),
      gmm::vec_ok<T>(s, h));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ds_kernel<<<dim3(gmm::chunk_bound(m, r), col_tiles_h,
                   (t + gmm::kBM - 1) / gmm::kBM),
              Tl::kThreads, kDsSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ends,
      static_cast<float*>(ds), static_cast<float*>(part), m, t, h, r,
      gmm::vec_ok<T>(x, t), gmm::vec_ok<T>(g, h));
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

}  // namespace

extern "C" {

// The [T, H] partial slots that part must hold for M rows.
int grouped_matmul_backward_partials(int m) { return gmm::partial_slots(m); }

int grouped_matmul_backward_f32(const void* x, const void* g, const void* s,
                                const void* group_ends, void* dx, void* ds,
                                void* part, int m, int t, int h, int r,
                                void* stream) {
  return launch<float>(x, g, s, group_ends, dx, ds, part, m, t, h, r, stream);
}

int grouped_matmul_backward_bf16(const void* x, const void* g, const void* s,
                                 const void* group_ends, void* dx, void* ds,
                                 void* part, int m, int t, int h, int r,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, g, s, group_ends, dx, ds, part, m, t, h, r,
                               stream);
}

const char* grouped_matmul_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
