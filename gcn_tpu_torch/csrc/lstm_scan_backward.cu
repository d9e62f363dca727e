// Masked LSTM scan, backward: full BPTT through G independent LSTMs over T
// steps, and the gradient of their recurrent weights.
//
// Replaces the Pallas TPU kernel gcn_tpu/ops/pallas/lstm_scan.py::
// _bwd_kernel (launched by _run_backward from the custom VJP of
// lstm_scan_stacked).  Same contract:
//   gy      [T, G, B, H] f32  cotangent of the h states, zero at t >= length
//   xp      [T, G, B, 4H]     the forward's input projections (i, f, g, o)
//   h, c    [T, G, B, H]      the forward's states, in xp's dtype
//   w_hh    [G, H, 4H]  and  w_hh_t [G, 4H, H], the same weights transposed
//   keep    [T, G, B] f32     optional carry factor of step t
//   lengths [B] int32
//   dxp     [T, G, B, 4H] f32 gradient of the gate pre-activations
//   dw_hh   [G, H, 4H] f32    Σ_t Σ_b h_prev[t,b]ᵀ dxp[t,b]
// Storage is f32 or bf16; all math is f32.  The gates are recomputed from
// xp + h_prev @ w_hh with the rounded states the forward stored, as the TPU
// kernel does, instead of saving a [T, G, B, 4H] residual.
//
// Rows at t >= length froze their carry in the forward, so there their gate
// gradients are zero and the incoming dh/dc pass through to t-1 unchanged.
// The carry into step t was keep[t]·state[t-1] (zero at t = 0), so h_prev
// and c_prev carry that factor, and so does the cotangent sent to t-1.
//
// What bounds it on the H100.  Like the forward, the T steps are a serial
// chain, so one block owns (direction g, kRows batch rows), keeps dh and dc
// in shared memory for all T steps and needs no grid-wide sync (14 blocks
// at G=2, B=50).  Each step streams w_hh twice from L2 through the SM (once
// for the gate recompute, h_prev @ w_hh, once for dh_prev = dgates @ w_hhᵀ
// from the transposed copy, so that both reads are coalesced), twice the
// forward's traffic, and does 4·kRows·H·4H FMAs.  Like the forward it is
// bound by the L2 stream through one SM per block, not by device memory.
//
// dW_hh is not serial in t: it is a per-direction [H × T·B] @ [T·B × 4H]
// product over the stored states and dxp.  The TPU kernel accumulated it in
// VMEM across its sequential grid; here the 7 row-blocks of a direction run
// in parallel, so a second kernel launched after the scan computes it as a
// tiled reduction in a fixed order (no atomics: two runs give the same
// bits).  Both launches together are the port of _bwd_kernel and go out
// from one C entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;      // batch rows per scan block
constexpr int kMaxSplit = 8;  // column chunks of the dh_prev product
constexpr int kTM = 64;       // dW tile: units of h_prev
constexpr int kTN = 64;       // dW tile: gate columns
constexpr int kTK = 16;       // dW depth per shared-memory stage: (t, b)
constexpr int kThreads = 256; // dW block: 16 x 16 threads, 4 x 4 each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(1024)
lstm_scan_bwd_kernel(const float* __restrict__ gy, const T* __restrict__ xp,
                     const T* __restrict__ h_st, const T* __restrict__ c_st,
                     const T* __restrict__ w_hh, const T* __restrict__ w_hh_t,
                     const float* __restrict__ keep,
                     const int* __restrict__ lengths, float* __restrict__ dxp,
                     int t_dim, int g_dim, int b_dim, int hd, int split) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  __shared__ int len_s[kRows];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h4 = 4 * hd;
  float* hp_s = smem;               // [kRows][hd]  h_prev of this step
  float* dh_s = hp_s + kRows * hd;  // [kRows][hd]  dh carried to step t
  float* dc_s = dh_s + kRows * hd;  // [kRows][hd]  dc carried to step t
  float* g_s = dc_s + kRows * hd;   // [kRows][h4]  gates, then dgates
  float* p_s = g_s + kRows * h4;    // [split][kRows][hd] partial dh_prev

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, b_dim - row0);
  const T* w = w_hh + (size_t)g * hd * h4;
  const T* wt = w_hh_t + (size_t)g * h4 * hd;

  if (threadIdx.x < kRows)
    len_s[threadIdx.x] = threadIdx.x < nrows ? lengths[row0 + threadIdx.x] : 0;
  for (int i = threadIdx.x; i < kRows * hd; i += blockDim.x) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  // rows past nrows are never written below; they must read as zeros
  for (int i = threadIdx.x; i < kRows * h4; i += blockDim.x) g_s[i] = 0.0f;
  __syncthreads();

  for (int t = t_dim - 1; t >= 0; --t) {
    const size_t step = (size_t)t * g_dim + g;              // [B, .] slab
    const size_t prev = (size_t)(t > 0 ? t - 1 : 0) * g_dim + g;

    // phase 0: h_prev = keep[t] * h[t-1], zero at t = 0
    for (int idx = threadIdx.x; idx < kRows * hd; idx += blockDim.x) {
      const int r = idx / hd;
      const int j = idx - r * hd;
      float v = 0.0f;
      if (t > 0 && r < nrows) {
        v = to_f32(h_st[(prev * b_dim + row0 + r) * hd + j]);
        if (keep != nullptr) v *= keep[step * b_dim + row0 + r];
      }
      hp_s[idx] = v;
    }
    __syncthreads();

    // phase 1: recompute gates[r, col] = xp[t, g, r, col] + h_prev[r] @ w
    for (int col = threadIdx.x; col < h4; col += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      int k = 0;
      if ((hd & 3) == 0) {
        for (; k < hd; k += 4) {
          const float w0 = to_f32(w[(size_t)(k + 0) * h4 + col]);
          const float w1 = to_f32(w[(size_t)(k + 1) * h4 + col]);
          const float w2 = to_f32(w[(size_t)(k + 2) * h4 + col]);
          const float w3 = to_f32(w[(size_t)(k + 3) * h4 + col]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 hv =
                *reinterpret_cast<const float4*>(hp_s + r * hd + k);
            acc[r] = fmaf(hv.x, w0, acc[r]);
            acc[r] = fmaf(hv.y, w1, acc[r]);
            acc[r] = fmaf(hv.z, w2, acc[r]);
            acc[r] = fmaf(hv.w, w3, acc[r]);
          }
        }
      }
      for (; k < hd; ++k) {
        const float wv = to_f32(w[(size_t)k * h4 + col]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(hp_s[r * hd + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nrows)
          g_s[r * h4 + col] =
              to_f32(xp[(step * b_dim + row0 + r) * h4 + col]) + acc[r];
    }
    __syncthreads();

    // phase 2: gate gradients (written over the gates and out to dxp[t]),
    // the cell cotangent sent to t-1, and the pass-through of frozen rows
    for (int idx = threadIdx.x; idx < nrows * hd; idx += blockDim.x) {
      const int r = idx / hd;
      const int j = idx - r * hd;
      float* gr = g_s + r * h4;
      const float ig = sigmoid(gr[j]);
      const float fg = sigmoid(gr[hd + j]);
      const float gg = tanhf(gr[2 * hd + j]);
      const float og = sigmoid(gr[3 * hd + j]);
      const size_t o = (step * b_dim + row0 + r) * hd + j;
      const float kp =
          keep != nullptr ? keep[step * b_dim + row0 + r] : 1.0f;
      const float c_new = to_f32(c_st[o]);
      const float c_prev =
          t > 0 ? kp * to_f32(c_st[(prev * b_dim + row0 + r) * hd + j])
                : 0.0f;
      const float dh_tot = dh_s[idx] + gy[o];
      const float dc_tot = dc_s[idx];
      const float tc = tanhf(c_new);
      const float dc_all = dc_tot + dh_tot * og * (1.0f - tc * tc);
      float di = dc_all * gg * ig * (1.0f - ig);
      float df = dc_all * c_prev * fg * (1.0f - fg);
      float dg = dc_all * ig * (1.0f - gg * gg);
      float dov = dh_tot * tc * og * (1.0f - og);
      if (t < len_s[r]) {
        dc_s[idx] = dc_all * fg * kp;
      } else {
        di = df = dg = dov = 0.0f;
        dh_s[idx] = dh_tot;
        dc_s[idx] = dc_tot;
      }
      gr[j] = di;
      gr[hd + j] = df;
      gr[2 * hd + j] = dg;
      gr[3 * hd + j] = dov;
      float* out = dxp + (step * b_dim + row0 + r) * h4;
      out[j] = di;
      out[hd + j] = df;
      out[2 * hd + j] = dg;
      out[3 * hd + j] = dov;
    }
    __syncthreads();

    // phase 3: dgates @ w_hhᵀ in `split` column chunks, one partial each
    const int chunk = (h4 + split - 1) / split;
    for (int idx = threadIdx.x; idx < split * hd; idx += blockDim.x) {
      const int part = idx / hd;
      const int k = idx - part * hd;
      const int c0 = part * chunk;
      const int c1 = min(h4, c0 + chunk);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int col = c0; col < c1; ++col) {
        const float wv = to_f32(wt[(size_t)col * hd + k]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(g_s[r * h4 + col], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) p_s[(part * kRows + r) * hd + k] = acc[r];
    }
    __syncthreads();

    // phase 4: dh sent to t-1 = keep[t] * Σ partials on rows still valid
    for (int idx = threadIdx.x; idx < nrows * hd; idx += blockDim.x) {
      const int r = idx / hd;
      const int j = idx - r * hd;
      if (t < len_s[r]) {
        float s = 0.0f;
        for (int p = 0; p < split; ++p) s += p_s[(p * kRows + r) * hd + j];
        const float kp =
            keep != nullptr ? keep[step * b_dim + row0 + r] : 1.0f;
        dh_s[idx] = s * kp;
      }
    }
    __syncthreads();
  }
}

// dw[g][k][col] = Σ_{t >= 1} Σ_b keep[t,g,b]·h[t-1,g,b,k] · dxp[t,g,b,col]
// (the t = 0 term has h_prev = 0).  One block per 64 x 64 output tile of
// one direction, the (t, b) depth walked in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_dw_kernel(const T* __restrict__ h_st, const float* __restrict__ keep,
               const float* __restrict__ dxp, float* __restrict__ dw,
               int t_dim, int g_dim, int b_dim, int hd) {
  __shared__ float as[kTK][kTM + 4];  // h_prev tile: as[q][k]
  __shared__ float bs[kTK][kTN + 4];  // dxp tile:    bs[q][col]

  const int g = blockIdx.z;
  const int k0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int h4 = 4 * hd;
  const int total = (t_dim - 1) * b_dim;
  const int tx = threadIdx.x % 16;  // output columns tx*4 .. tx*4+3
  const int ty = threadIdx.x / 16;  // output rows    ty*4 .. ty*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int q0 = 0; q0 < total; q0 += kTK) {
    for (int i = threadIdx.x; i < kTK * kTM; i += kThreads) {
      const int qq = i / kTM, mm = i % kTM;
      const int q = q0 + qq, k = k0 + mm;
      float v = 0.0f;
      if (q < total && k < hd) {
        const int t = 1 + q / b_dim, b = q % b_dim;
        v = to_f32(h_st[(((size_t)(t - 1) * g_dim + g) * b_dim + b) * hd + k]);
        if (keep != nullptr) v *= keep[((size_t)t * g_dim + g) * b_dim + b];
      }
      as[qq][mm] = v;
    }
    for (int i = threadIdx.x; i < kTK * kTN; i += kThreads) {
      const int qq = i / kTN, nn = i % kTN;
      const int q = q0 + qq, col = n0 + nn;
      float v = 0.0f;
      if (q < total && col < h4) {
        const int t = 1 + q / b_dim, b = q % b_dim;
        v = dxp[(((size_t)t * g_dim + g) * b_dim + b) * h4 + col];
      }
      bs[qq][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int qq = 0; qq < kTK; ++qq) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[qq][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[qq][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= hd) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < h4) dw[((size_t)g * hd + k) * h4 + col] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* gy, const void* xp, const void* h_st, const void* c_st,
           const void* w_hh, const void* w_hh_t, const void* keep,
           const void* lengths, void* dxp, void* dw, int t_dim, int g_dim,
           int b_dim, int hd, void* stream) {
  const int h4 = 4 * hd;
  const int padded = ((h4 + 31) / 32) * 32;
  const int threads = padded < 1024 ? padded : 1024;
  int split = threads / hd;
  split = split < 1 ? 1 : (split > kMaxSplit ? kMaxSplit : split);
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (3 * hd + h4) + (size_t)split * kRows * hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((b_dim + kRows - 1) / kRows, g_dim);
  lstm_scan_bwd_kernel<T><<<grid, threads, smem, s>>>(
      static_cast<const float*>(gy), static_cast<const T*>(xp),
      static_cast<const T*>(h_st), static_cast<const T*>(c_st),
      static_cast<const T*>(w_hh), static_cast<const T*>(w_hh_t),
      static_cast<const float*>(keep), static_cast<const int*>(lengths),
      static_cast<float*>(dxp), t_dim, g_dim, b_dim, hd, split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_w((hd + kTM - 1) / kTM, (h4 + kTN - 1) / kTN, g_dim);
  lstm_dw_kernel<T><<<grid_w, kThreads, 0, s>>>(
      static_cast<const T*>(h_st), static_cast<const float*>(keep),
      static_cast<const float*>(dxp), static_cast<float*>(dw), t_dim, g_dim,
      b_dim, hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_scan_backward_f32(const void* gy, const void* xp, const void* h_st,
                           const void* c_st, const void* w_hh,
                           const void* w_hh_t, const void* keep,
                           const void* lengths, void* dxp, void* dw, int t_dim,
                           int g_dim, int b_dim, int hd, void* stream) {
  return launch<float>(gy, xp, h_st, c_st, w_hh, w_hh_t, keep, lengths, dxp,
                       dw, t_dim, g_dim, b_dim, hd, stream);
}

int lstm_scan_backward_bf16(const void* gy, const void* xp, const void* h_st,
                            const void* c_st, const void* w_hh,
                            const void* w_hh_t, const void* keep,
                            const void* lengths, void* dxp, void* dw,
                            int t_dim, int g_dim, int b_dim, int hd,
                            void* stream) {
  return launch<__nv_bfloat16>(gy, xp, h_st, c_st, w_hh, w_hh_t, keep,
                               lengths, dxp, dw, t_dim, g_dim, b_dim, hd,
                               stream);
}

const char* lstm_scan_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
