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
// Storage is f32 or bf16.
//
// What bounds it on the H100.  At the main path's shapes (M = 9600 stacked
// band rows, T = 400 or 200, H = 200, R = 87) it does 4*M*T*H FLOPs and
// moves M*T + 2*M*H + R*T*H values in and M*T + R*T*H out once, so like
// the forward it is bound by f32 FMA issue (CUDA cores, no tensor cores in
// this first version), not by memory.
//
// The TPU kernel fused both products into one pass over the visit schedule
// so that each group's S block was read from HBM once, while dS of that
// group stayed resident in VMEM across its consecutive visits.  On the card
// the two products have different natural tilings, so they are two kernels
// launched back to back from one C entry point:
//   * dx mirrors the forward kernel (grouped_matmul.cu) with S transposed
//     on its way into shared memory: a block owns a 64-row x 64-column tile
//     of dx, walks the groups that meet its rows and zero-masks rows outside
//     the visited group, so visits add into disjoint rows of one register
//     accumulator;
//   * dS gives each (group, 64 x 64 tile of [T, H]) one block that walks the
//     group's contiguous rows in a fixed order: no atomics, so two runs give
//     the same bits, and an empty group's block writes zeros.
// Only g is read twice (M*H values, 4% of the traffic at T=400); S is read
// once, by dx, and dS reads no S at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 64;       // rows per block
constexpr int kTN = 64;       // columns per block
constexpr int kTK = 16;       // depth per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[i][j] += Σ_kk a_s[kk][ty*4+i] * b_s[kk][tx*4+j]
__device__ __forceinline__ void tile_fma(const float (*a_s)[kTM + 4],
                                         const float (*b_s)[kTN + 4],
                                         int tx, int ty, float acc[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kTK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx * 4 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_dx_kernel(const T* __restrict__ g, const T* __restrict__ s,
                         const int* __restrict__ group_ends,
                         T* __restrict__ dx, int m, int t, int h, int r) {
  __shared__ float gs[kTK][kTM + 4];  // g tile, transposed: gs[k][row]
  __shared__ float st[kTK][kTN + 4];  // s[grp]ᵀ tile: st[k][col] = s[col][k]

  const int m0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;  // columns of dx (the T axis)
  const int m1 = min(m0 + kTM, m);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  int start = 0;
  for (int grp = 0; grp < r; ++grp) {
    const int end_g = group_ends[grp];
    const int end = (grp == r - 1) ? max(end_g, m) : end_g;
    const int lo = max(start, m0);
    const int hi = min(end, m1);
    start = end_g;
    if (lo >= hi) continue;  // same for every thread of the block
    const T* sg = s + (size_t)grp * t * h;
    for (int k0 = 0; k0 < h; k0 += kTK) {
      for (int i = threadIdx.x; i < kTM * kTK; i += kThreads) {
        const int rr = i / kTK, kk = i % kTK;
        const int row = m0 + rr, k = k0 + kk;
        gs[kk][rr] = (row >= lo && row < hi && k < h)
                         ? to_f32(g[(size_t)row * h + k])
                         : 0.0f;
      }
      for (int i = threadIdx.x; i < kTN * kTK; i += kThreads) {
        const int nn = i / kTK, kk = i % kTK;
        const int col = n0 + nn, k = k0 + kk;
        st[kk][nn] =
            (col < t && k < h) ? to_f32(sg[(size_t)col * h + k]) : 0.0f;
      }
      __syncthreads();
      tile_fma(gs, st, tx, ty, acc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < t) dx[(size_t)row * t + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_ds_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const int* __restrict__ group_ends,
                         float* __restrict__ ds, int m, int t, int h, int r) {
  __shared__ float xs[kTK][kTM + 4];  // x tile:  xs[row][tcol]
  __shared__ float gt[kTK][kTN + 4];  // g tile:  gt[row][hcol]

  const int grp = blockIdx.z;
  const int t0 = blockIdx.x * kTM;
  const int h0 = blockIdx.y * kTN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int start = grp > 0 ? group_ends[grp - 1] : 0;
  const int end_g = group_ends[grp];
  const int end = min(m, (grp == r - 1) ? max(end_g, m) : end_g);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (end_g > start) {  // an empty group keeps its zeros
    for (int q0 = start; q0 < end; q0 += kTK) {
      for (int i = threadIdx.x; i < kTK * kTM; i += kThreads) {
        const int qq = i / kTM, mm = i % kTM;
        const int row = q0 + qq, col = t0 + mm;
        xs[qq][mm] = (row < end && col < t) ? to_f32(x[(size_t)row * t + col])
                                            : 0.0f;
      }
      for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
        const int qq = i / kTN, nn = i % kTN;
        const int row = q0 + qq, col = h0 + nn;
        gt[qq][nn] = (row < end && col < h) ? to_f32(g[(size_t)row * h + col])
                                            : 0.0f;
      }
      __syncthreads();
      tile_fma(xs, gt, tx, ty, acc);
      __syncthreads();
    }
  }

  float* dsg = ds + (size_t)grp * t * h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + ty * 4 + i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = h0 + tx * 4 + j;
      if (col < h) dsg[(size_t)row * h + col] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* s, const void* group_ends,
           void* dx, void* ds, int m, int t, int h, int r, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* ends = static_cast<const int*>(group_ends);
  dim3 grid_dx((m + kTM - 1) / kTM, (t + kTN - 1) / kTN);
  grouped_matmul_dx_kernel<T><<<grid_dx, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(s), ends,
      static_cast<T*>(dx), m, t, h, r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_ds((t + kTM - 1) / kTM, (h + kTN - 1) / kTN, r);
  grouped_matmul_ds_kernel<T><<<grid_ds, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ends,
      static_cast<float*>(ds), m, t, h, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grouped_matmul_backward_f32(const void* x, const void* g, const void* s,
                                const void* group_ends, void* dx, void* ds,
                                int m, int t, int h, int r, void* stream) {
  return launch<float>(x, g, s, group_ends, dx, ds, m, t, h, r, stream);
}

int grouped_matmul_backward_bf16(const void* x, const void* g, const void* s,
                                 const void* group_ends, void* dx, void* ds,
                                 int m, int t, int h, int r, void* stream) {
  return launch<__nv_bfloat16>(x, g, s, group_ends, dx, ds, m, t, h, r,
                               stream);
}

const char* grouped_matmul_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
