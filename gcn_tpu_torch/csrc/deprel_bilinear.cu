// The deprel-conditioned bilinear transform over flattened tokens, f32.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/deprel_bilinear.py:
//   _kernel_v2  (launched by _core_v2_forward, reached through
//                deprel_bilinear_v2 and deprel_bilinear_batched, the
//                non-factored full_deprel on the fused path)
//                                          -> deprel_bilinear_v2_f32
//   _kernel     (launched by _core_forward, reached through the public
//                deprel_bilinear)          -> deprel_bilinear_v1_f32
// Same contract:
//   x [M, T], e [M, D], W [D, T, H]  ->  out [M, H]
//   out[m, h] = sum_d e[m, d] * sum_t x[m, t] * W[d, t, h]
// (the bias term e @ b stays outside the kernels, as in JAX).
//
// What bounds it on the H100.  At the C-GCN layer's shapes (M = 4800,
// T = 400 or 200, D = 50, H = 200) it is 2 M D T H = 38.4 (19.2) GFLOP
// against 28.5 MB moved: bound by operations, 0.573 (0.287) ms at the f32
// rate of 67 TFLOP/s.  The TPU's v2 packs W into one [T, D*Hp] operand
// (H padded to 128 lanes) for one wide MXU product per row tile and then
// gates lane slices by e; v1 streams W[d] through VMEM along a sequential
// grid axis and accumulates e[:, d] * (x W[d]) in the resident output
// block.  Neither padding nor the sequential grid carries over.  Both
// kernels here are one SIMT f32 tiled GEMM: a block computes a 64 x 64
// output tile, 256 threads with a 4 x 4 register tile each, stepping 16
// deep through shared memory, and never writes the [M, D*T] intermediate.
//   v2 is an implicit GEMM over K = D*T: the A tile e[m, d] * x[m, t] is
//      formed in shared memory from an x tile and the e column of the
//      current d, and multiplied with the matching rows of W (W [D, T, H]
//      is already the [D*T, H] operand).
//   v1 is d-streamed: for each d a second register tile accumulates
//      x W[d] and is folded into the output tile scaled by e[:, d].
// Each output element sums in a fixed order (d, then t), so two calls
// give the same bits.  SIMT f32 keeps the plain version's precision;
// TF32 or wgmma tiles would change the results.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 16;        // depth of one shared-memory step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // keeps the A stores off one bank

template <bool kStreamD>
__device__ __forceinline__ void bilinear_tile(
    const float* __restrict__ x, const float* __restrict__ e,
    const float* __restrict__ w, float* __restrict__ out, int m, int t,
    int d_dim, int h) {
  __shared__ __align__(16) float as[kBK][kBM + kPad];  // A tile, k-major
  __shared__ __align__(16) float bs[kBK][kBN];         // W rows
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  // loader roles: A 64 rows x 16 deep, B 16 deep x 64 columns, 4 each
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const int b_k = tid / 16, b_col = (tid % 16) * 4;
  const int gm = m0 + a_row;
  float acc[4][4] = {};
  float part[4][4];
  for (int d = 0; d < d_dim; ++d) {
    // v2 scales A by e[m, d] as it forms the tile; v1 folds e in below
    const float ea =
        (!kStreamD && gm < m) ? e[(size_t)gm * d_dim + d] : 1.0f;
    if (kStreamD) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
    }
    const float* wd = w + (size_t)d * t * h;
    for (int t0 = 0; t0 < t; t0 += kBK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tk = t0 + a_k + j;
        const float xv = (gm < m && tk < t) ? x[(size_t)gm * t + tk] : 0.0f;
        as[a_k + j][a_row] = kStreamD ? xv : ea * xv;
      }
      const int tk = t0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + b_col + j;
        bs[b_k][b_col + j] =
            (tk < t && col < h) ? wd[(size_t)tk * h + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kStreamD)
              part[i][j] = fmaf(av[i], bv[j], part[i][j]);
            else
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
      }
      __syncthreads();
    }
    if (kStreamD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        const float ed = row < m ? e[(size_t)row * d_dim + d] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ed, part[i][j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < h) out[(size_t)row * h + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
deprel_bilinear_v2_kernel(const float* __restrict__ x,
                          const float* __restrict__ e,
                          const float* __restrict__ w,
                          float* __restrict__ out, int m, int t, int d_dim,
                          int h) {
  bilinear_tile<false>(x, e, w, out, m, t, d_dim, h);
}

__global__ void __launch_bounds__(kThreads)
deprel_bilinear_v1_kernel(const float* __restrict__ x,
                          const float* __restrict__ e,
                          const float* __restrict__ w,
                          float* __restrict__ out, int m, int t, int d_dim,
                          int h) {
  bilinear_tile<true>(x, e, w, out, m, t, d_dim, h);
}

template <typename K>
int launch(K kernel, const void* x, const void* e, const void* w, void* out,
           int m, int t, int d_dim, int h, void* stream) {
  const long long rows = ((long long)m + kBM - 1) / kBM;
  const int cols = (h + kBN - 1) / kBN;
  if (rows > 0x7fffffffLL || cols > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)rows, cols);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(w), static_cast<float*>(out), m, t, d_dim,
      h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int deprel_bilinear_v2_f32(const void* x, const void* e, const void* w,
                           void* out, int m, int t, int d_dim, int h,
                           void* stream) {
  return launch(deprel_bilinear_v2_kernel, x, e, w, out, m, t, d_dim, h,
                stream);
}

int deprel_bilinear_v1_f32(const void* x, const void* e, const void* w,
                           void* out, int m, int t, int d_dim, int h,
                           void* stream) {
  return launch(deprel_bilinear_v1_kernel, x, e, w, out, m, t, d_dim, h,
                stream);
}

const char* deprel_bilinear_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
