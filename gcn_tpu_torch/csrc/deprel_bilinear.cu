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
// What bounds it on the H100 (SXM, 700 W).  At the C-GCN layer's shapes
// (M = 4800, T = 400 or 200, D = 50, H = 200) it is 2 M D T H = 38.4
// (19.2) GFLOP against 28.5 MB moved: bound by operations.  The TPU's v2
// packs W into one [T, D*Hp] operand (H padded to 128 lanes) for one wide
// MXU product per row tile and then gates lane slices by e; v1 streams
// W[d] through VMEM along a sequential grid axis and accumulates
// e[:, d] * (x W[d]) in the resident output block.  Neither padding nor
// the sequential grid carries over.  Neither kernel writes the [M, D*T]
// intermediate.
//
// Both versions are one kernel template, an implicit GEMM over K = D*T on
// the 3xTF32 tensor-core mainloop of tf32x3_tile.cuh (f32 error, three
// TF32 products a k-step): bound at an effective 165 TFLOP/s, 0.233
// (0.116) ms, against 0.573 (0.287) ms at the f32 FMA rate.  They differ
// only in where e enters:
//   v2 forms A = e[m, d] * x[m, t] on the fly (e read from device memory
//      one d ahead) and adds each chunk's product into the sum;
//   v1 takes A = x[m, t] as it is and folds each chunk's product c of
//      (t chunk, d) in as acc = e[m, d] * c + acc (one fmaf), the
//      d-streamed form of the TPU's v1, which spares the per-d forming of
//      A that is much of v2's work beside the MMAs.
// A block owns 128 rows and all H = 200 columns (one 208-wide tile), so A
// is formed once per (t chunk, d) and not once per column block.  The
// k-loop puts t outside d: an x tile of 128 rows x 32 t arrives once
// (cp.async, a three-deep ring) and serves every d of the block's slice,
// each warp reading its A fragments from it and splitting them in
// registers; W [D, T, H] is already the [D*T, H] operand, whose 32-row
// chunk (d, t chunk) streams through a three-stage cp.async ring.  4800
// rows make only 38 row tiles for 132 SMs, so K is split over d into S
// slices (S = SMs / row tiles, 3 here: 114 blocks of 16-17 values of d),
// each writing an [M, H] partial that a second kernel, launched by the
// same entry point, sums in slice order.  W (16 MB at T = 400) is read
// from L2 once per row tile, 0.6 GB a call at 128 rows (1.2 GB at 64,
// which is why the tile is 128 rows tall).  Each output element sums in
// a fixed order (t chunk, then d, then the slices), so two calls give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace {

using tf32x3::kStages;

// 4 x 2 warps, each 32 rows x 104 columns: 128 x 208 a block
using BTile = tf32x3::Tile<4, 2, 2, 13>;
constexpr int kGroup = 7;  // n-tiles per fresh accumulator (registers)
constexpr int kLdx = tf32x3::kBK + 4;  // x tile row stride: conflict-free
constexpr int kXFloats = BTile::kBM * kLdx;
constexpr size_t kSmem =  // the W ring, then a ring of as many x tiles
    BTile::kRingBytes + sizeof(float) * kStages * kXFloats;

// Block (row tile, column tile, slice s): rows m0.., columns n0.., d in
// [s D / S, (s + 1) D / S).  Writes out (S == 1) or the slice's [M, H]
// partial at out + s M H.  kV1: e enters at the fold (v1), else in A (v2).
template <bool kV1>
__global__ void __launch_bounds__(BTile::kThreads, 1)
deprel_bilinear_kernel(const float* __restrict__ x,
                       const float* __restrict__ e,
                       const float* __restrict__ w, float* __restrict__ out,
                       int m, int t, int d_dim, int h, int slices,
                       bool vec_x, bool vec_w) {
  using Tl = BTile;
  constexpr int kBK = tf32x3::kBK;
  extern __shared__ __align__(16) float smem_f[];
  float* wring = smem_f;
  float* xring = smem_f + kStages * Tl::kStageFloats;
  const int m0 = blockIdx.x * Tl::kBM, n0 = blockIdx.y * Tl::kBN;
  const int d0 = (int)((long long)blockIdx.z * d_dim / slices);
  const int ds = (int)((long long)(blockIdx.z + 1) * d_dim / slices) - d0;
  const int chunks = (t + kBK - 1) / kBK * ds;  // (t chunk, d), d inner
  auto issue = [&](int c) {
    if (c < chunks) {
      const int tc = c / ds, d = d0 + c % ds;
      tf32x3::copy_tile<kBK, Tl::kBN, Tl::kLdw, Tl::kThreads>(
          wring + (c % kStages) * Tl::kStageFloats,
          w + ((size_t)d * t + (size_t)tc * kBK) * h, h,
          min(kBK, t - tc * kBK), n0, h, vec_w);
      if (c % ds == 0)  // the x tile rides with its t chunk's first d
        tf32x3::copy_tile<Tl::kBM, kBK, kLdx, Tl::kThreads>(
            xring + (tc % kStages) * kXFloats, x + (size_t)m0 * t, t,
            m - m0, tc * kBK, t, vec_x);
    }
    tf32x3::cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  // this lane's A rows: m-tile mt, half hf -> m0 + wm*32 + mt*16 + hf*8 + g
  const float* erow[Tl::kMT][2];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 16 * Tl::kMT + mt * 16 + hf * 8 + g;
      erow[mt][hf] = row < m ? e + (size_t)row * d_dim : nullptr;
    }
  auto e_at = [&](float (&ev)[Tl::kMT][2], int d) {
#pragma unroll
    for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        ev[mt][hf] = erow[mt][hf] ? erow[mt][hf][d] : 0.0f;
  };
  float ev[Tl::kMT][2], ev_next[Tl::kMT][2];
  e_at(ev, d0);

  float acc[Tl::kMT][Tl::kNT][4];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) e_at(ev_next, d0 + (c + 1) % ds);
    tf32x3::ring_wait();
    issue(c + kStages - 1);
    const float* xs = xring + (c / ds % kStages) * kXFloats +
                      (wm * 16 * Tl::kMT + g) * kLdx + q;
    const float* ws =
        wring + (c % kStages) * Tl::kStageFloats + wn * Tl::kNT * 8;
    if constexpr (kV1) {
      tf32x3::mma_chunk<Tl::kMT, Tl::kNT, kGroup, Tl::kLdw>(
          acc, ws,
          [&](int mt, int ks, float (&a)[4]) {
            const float* p = xs + mt * 16 * kLdx + ks * 8;
            a[0] = p[0];
            a[1] = p[8 * kLdx];
            a[2] = p[4];
            a[3] = p[8 * kLdx + 4];
          },
          [&](int mt, int i, float sum, float part) {
            return fmaf(ev[mt][i / 2], part, sum);
          });
    } else {
      tf32x3::mma_chunk<Tl::kMT, Tl::kNT, kGroup, Tl::kLdw>(
          acc, ws, [&](int mt, int ks, float (&a)[4]) {
            const float* p = xs + mt * 16 * kLdx + ks * 8;
            a[0] = __fmul_rn(ev[mt][0], p[0]);
            a[1] = __fmul_rn(ev[mt][1], p[8 * kLdx]);
            a[2] = __fmul_rn(ev[mt][0], p[4]);
            a[3] = __fmul_rn(ev[mt][1], p[8 * kLdx + 4]);
          });
    }
#pragma unroll
    for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) ev[mt][hf] = ev_next[mt][hf];
  }

  float* dst = out + (size_t)blockIdx.z * m * h;
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 16 * Tl::kMT + mt * 16 + hf * 8 + g;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = n0 + wn * Tl::kNT * 8 + j * 8 + 2 * q + i;
          if (col < h) dst[(size_t)row * h + col] = acc[mt][j][hf * 2 + i];
        }
    }
}

// Launches of deprel_bilinear_sum_kernel this library has made, read by
// deprel_bilinear_sum_launches().
int g_sum_launches = 0;

// out = sum of the slices' partials, in slice order.
__global__ void deprel_bilinear_sum_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           int slices, size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < slices; ++s) v += part[s * count + i];
    out[i] = v;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <bool kV1>
int launch(const void* x, const void* e, const void* w, void* out,
           void* part, int m, int t, int d_dim, int h, int slices,
           void* stream) {
  const long long rows = ((long long)m + BTile::kBM - 1) / BTile::kBM;
  const int cols = (h + BTile::kBN - 1) / BTile::kBN;
  if (rows > 0x7fffffffLL || cols > 65535 || slices < 1 || slices > d_dim ||
      slices > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      deprel_bilinear_kernel<kV1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = t % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_w = h % 4 == 0 && (uintptr_t)w % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  float* dst = static_cast<float*>(slices > 1 ? part : out);
  deprel_bilinear_kernel<kV1><<<dim3((unsigned)rows, cols, slices),
                                BTile::kThreads, kSmem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(w), dst, m, t, d_dim, h, slices, vec_x,
      vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t count = (size_t)m * h;
  const int threads = 256;
  const size_t blocks = (count + threads - 1) / threads;
  const int grid = (int)(blocks < 4096 ? blocks : 4096);
  deprel_bilinear_sum_kernel<<<grid, threads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), slices,
      count);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_sum_launches;
  return (int)err;
}

}  // namespace

extern "C" {

// The number of d slices both versions split K into for these shapes:
// enough blocks for one wave on this device's SMs, at most D.  The
// wrapper allocates [slices, M, H] of scratch when it is above 1.
int deprel_bilinear_slices(int m, int d_dim, int h) {
  const long long tiles = ((long long)m + BTile::kBM - 1) / BTile::kBM *
                          ((h + BTile::kBN - 1) / BTile::kBN);
  const long long fit = tiles > 0 ? sm_count() / tiles : 1;
  return (int)(fit < 1 ? 1 : (fit > d_dim ? d_dim : fit));
}

// How many slice sums the launchers below have launched, both versions
// together: a call launches one exactly where it splits K into slices.
int deprel_bilinear_sum_launches() { return g_sum_launches; }

// v2 (e in A) and v1 (e at the fold) into out; with slices > 1 the
// slices' partials go to part [slices, M, H] first.
int deprel_bilinear_v2_f32(const void* x, const void* e, const void* w,
                           void* out, void* part, int m, int t, int d_dim,
                           int h, int slices, void* stream) {
  return launch<false>(x, e, w, out, part, m, t, d_dim, h, slices, stream);
}

int deprel_bilinear_v1_f32(const void* x, const void* e, const void* w,
                           void* out, void* part, int m, int t, int d_dim,
                           int h, int slices, void* stream) {
  return launch<true>(x, e, w, out, part, m, t, d_dim, h, slices, stream);
}

const char* deprel_bilinear_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
