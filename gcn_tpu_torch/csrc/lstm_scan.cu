// Masked LSTM scan, forward: h/c states for G independent LSTMs over T steps.
//
// Replaces the Pallas TPU kernel gcn_tpu/ops/pallas/lstm_scan.py::_fwd_kernel
// (launched by _run_forward, reached through lstm_scan_stacked).  Same
// contract:
//   xp     [T, G, B, 4H]  input projections x @ W_ih + b, gate order i,f,g,o
//   lengths[B] int32      rows freeze their h/c at t >= length
//   w_hh   [G, H, 4H]
//   keep   [T, G, B] f32  optional carry factor applied before step t
//   h, c   [T, G, B, H]   the state after every step, in xp's dtype
// Gate math is f32 whatever the storage type (f32 or bf16).
//
// What bounds it on the H100.  Not device memory (xp, h and c are read or
// written once, 0.02 ms at the C-GCN's shapes) but the serial chain of T
// steps: a step costs its share of the 2·rows·4H·H FLOPs on the SMs that
// hold the tile, plus one exchange of h among them.  The TPU kernel ran the
// time axis as a sequential grid with w_hh resident in VMEM; w_hh[g] at
// H = 200 is 640 KB in f32, more than one SM's 227 KB, so the first CUDA
// version streamed it from L2 once per block and step, on 14 blocks.
//
// Design (lstm_cluster.cuh): a cluster of C CTAs owns (direction g, tile of
// `rows` batch rows); each CTA holds the gate columns of its H/C units in
// shared memory for the whole loop, and a copy of the tile's full h[t-1].
// A step: the CTA's warps form its gates, h[t-1] @ slice, on the tensor
// cores in 3xTF32 into shared memory; a thread that owns rr rows of one
// unit applies keep, xp, the activations and the length mask, keeps c in
// its registers, and stores its h into every CTA's next h buffer through
// distributed shared memory (st.async, counted against the receiver's
// transaction barrier; h is double-buffered by step parity).  A CTA starts
// a step once its barrier says all of h[t-1] has arrived: no cluster-wide
// barrier a step.  A cluster runs the product only up to the longest
// length among its rows; from there every row is frozen, and each thread
// writes keep·state.  One cluster barrier at the end keeps every CTA
// until the cluster is done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_cluster.cuh"

namespace {

using lstm::Layout;

// The gates' product of a step: g_s[r][c] = Σ_k h_s[r][k] · w[k][c] for
// r < rows_pad and c < cols, h_s [rows_pad][h_ld] zero past H, in 3xTF32
// m16n8k8.  Each warp takes 16 x 8 tiles; each output sums 32-deep chunks
// of k in a fresh accumulator, added in k order: the arithmetic of
// tf32x3::mma_chunk, so in f32 the gates here are the backward gates
// pass's bit for bit (zero k-steps past H are skipped: they add exact
// zeros).  A tile's chunks, kChunks at a time, run interleaved, so that
// their MMAs do not wait for each other.  With bf16 w_hh the resident
// slice goes to the MMAs unsplit in two passes (lstm::mma3's kExactB): the
// same sums.  (The streaming route keeps three: in two, ptxas gave its
// bf16 instance 64 registers and 172 bytes of spills.)
template <bool kResident, typename T>
__device__ __forceinline__ void gate_product(float* g_s, const float* h_s,
                                             const float* w_s,
                                             const T* __restrict__ w,
                                             const Layout& l, int u0,
                                             int nu) {
  constexpr int kBK = tf32x3::kBK, kChunks = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int mtiles = l.rows_pad / 16;
  for (int tile = warp; tile < l.gate_tiles(); tile += blockDim.x / 32) {
    const int m0 = (tile % mtiles) * 16, n0 = (tile / mtiles) * 8;
    const float* a = h_s + (m0 + g) * l.h_ld + q;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kg = 0; kg < l.hp; kg += kChunks * kBK) {
      float c[kChunks][4];
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[ch][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks)
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const int k0 = kg + ch * kBK + 8 * ks;
          if (k0 >= l.hp) continue;
          lstm::mma3<sizeof(T) == 2 && kResident>(
              c[ch],
              lstm::split_frag(a[k0], a[8 * l.h_ld + k0], a[k0 + 4],
                               a[8 * l.h_ld + k0 + 4]),
              lstm::slice_at<kResident>(w_s, w, l, k0 + q, n0 + g, u0, nu),
              lstm::slice_at<kResident>(w_s, w, l, k0 + q + 4, n0 + g, u0,
                                        nu));
        }
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
        if (kg + ch * kBK < l.hp)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = acc[i] + c[ch][i];
    }
    float* out = g_s + (m0 + g) * l.ldw + n0 + 2 * q;
    out[0] = acc[0];
    out[1] = acc[1];
    out[8 * l.ldw] = acc[2];
    out[8 * l.ldw + 1] = acc[3];
  }
}

template <typename T, int RR, bool kResident>
__global__ void __launch_bounds__(512)
lstm_scan_fwd_kernel(const T* __restrict__ xp, const int* __restrict__ lengths,
                     const T* __restrict__ w_hh,
                     const float* __restrict__ keep, T* __restrict__ h_out,
                     T* __restrict__ c_out, int t_dim, int g_dim, int b_dim,
                     Layout lp) {
  const Layout l = lp;  // in registers: lambdas below take it by reference
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);      // [hp][ldw]
  float* h_buf = w_s + l.slice_floats(kResident);    // [2][rows_pad][h_ld]
  float* g_s = h_buf + 2 * l.h_floats();             // [rows_pad][ldw]
  lstm::cg::cluster_group cluster = lstm::cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * l.rows;
  const int nrows = min(l.rows, b_dim - row0);
  const int hd = l.hd, h4 = 4 * hd;
  const int u0 = l.unit0(rank), nu = l.unit_count(rank);
  const T* w = w_hh + (size_t)g * hd * h4;

  // this thread: unit u of the CTA, rows r0 + 8 i
  const lstm::Owned me = lstm::owned(l);
  const int u = me.u, j = u0 + u;
  const bool active = u < nu && me.r0 < nrows;
  bool ok[RR];
  int len[RR];
  int longest = 0;  // the cluster's product stops at its longest row
  for (int r = 0; r < nrows; ++r)
    longest = max(longest, min(lengths[row0 + r], t_dim));
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const int r = me.r0 + 8 * i;
    ok[i] = active && r < nrows;
    len[i] = ok[i] ? lengths[row0 + r] : 0;
  }

  // bars[p]: h buffer p has received all of h[t-1] for the step t that
  // reads it (nrows x H floats, from every rank)
  __shared__ __align__(8) uint64_t bars[2];
  if (threadIdx.x == 0) {
    lstm::mbar_init(&bars[0]);
    lstm::mbar_init(&bars[1]);
    lstm::mbar_init_fence();
  }
  if (kResident) lstm::load_slice(w_s, w, l, u0, nu);
  for (int i = threadIdx.x; i < 2 * l.h_floats(); i += blockDim.x)
    h_buf[i] = 0.0f;
  lstm::cluster_sync();  // every CTA's buffers are set before any store
  const uint32_t bytes = 4u * nrows * hd;
  const uint32_t h_addr = lstm::smem_u32(h_buf);
  const uint32_t bar_addr = lstm::smem_u32(bars);
  uint32_t parity = 0;  // bit p: the phase of bars[p] to wait for

  // xp and keep of step t for this thread's rows, into (xv, kv)
  float xv[RR][4], kv[RR];
  auto load_inputs = [&](int t) {
    const size_t step = (size_t)t * g_dim + g;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const size_t o = step * b_dim + row0 + me.r0 + 8 * i;
      kv[i] = (keep != nullptr && ok[i]) ? keep[o] : 1.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xv[i][q] = ok[i] ? lstm::to_f32(xp[o * h4 + q * hd + j]) : 0.0f;
    }
  };
  float h_reg[RR], c_reg[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) h_reg[i] = c_reg[i] = 0.0f;
  auto store_state = [&](int t) {
    const size_t step = (size_t)t * g_dim + g;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (!ok[i]) continue;
      const size_t o = (step * b_dim + row0 + me.r0 + 8 * i) * hd + j;
      h_out[o] = lstm::from_f32<T>(h_reg[i]);
      c_out[o] = lstm::from_f32<T>(c_reg[i]);
    }
  };

  // phases (scan_phases.py): 0 the wait for h[t-1], 1 the gate product,
  // 2 the cell update and the h exchange, 3 the state stores and the next
  // step's loads
  lstm::PhaseClock phases;
  phases.start();
  if (longest > 0) load_inputs(0);
  for (int t = 0; t < longest; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const bool push = t + 1 < longest;
    if (t > 0) {  // h[t-1] has arrived from every rank
      lstm::mbar_wait(&bars[cur], (parity >> cur) & 1);
      parity ^= 1u << cur;
    }
    phases.mark(0);
    if (push && threadIdx.x == 0) lstm::mbar_expect(&bars[nxt], bytes);
    gate_product<kResident>(g_s, h_buf + cur * l.h_floats(), w_s, w, l, u0,
                            nu);
    __syncthreads();
    phases.mark(1);
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (!ok[i]) continue;
      const int r = me.r0 + 8 * i;
      const float4 acc =
          *reinterpret_cast<const float4*>(g_s + r * l.ldw + 4 * u);
      const float ig = lstm::sigmoid(fmaf(kv[i], acc.x, xv[i][0]));
      const float fg = lstm::sigmoid(fmaf(kv[i], acc.y, xv[i][1]));
      const float gg = tanhf(fmaf(kv[i], acc.z, xv[i][2]));
      const float og = lstm::sigmoid(fmaf(kv[i], acc.w, xv[i][3]));
      const float c_prev = c_reg[i] * kv[i];
      const float h_prev = h_reg[i] * kv[i];
      const float c_new = fg * c_prev + ig * gg;
      const float h_new = og * tanhf(c_new);
      const bool valid = t < len[i];
      h_reg[i] = valid ? h_new : h_prev;
      c_reg[i] = valid ? c_new : c_prev;
      if (push) {
        const uint32_t dst =
            h_addr + 4u * (nxt * l.h_floats() + r * l.h_ld + j);
        for (int q = 0; q < l.cluster; ++q)
          lstm::st_async(lstm::map_rank(dst, q), h_reg[i],
                         lstm::map_rank(bar_addr + 8u * nxt, q));
      }
    }
    phases.mark(2);
    store_state(t);
    if (push) load_inputs(t + 1);
    __syncthreads();  // the gates are read before the next step's product
    phases.mark(3);
    phases.step();
  }
  phases.flush(8);

  // every row is frozen: the state only takes the keep factor
  for (int t = longest; t < t_dim; ++t) {
    const size_t step = (size_t)t * g_dim + g;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const float kp = (keep != nullptr && ok[i])
                           ? keep[step * b_dim + row0 + me.r0 + 8 * i]
                           : 1.0f;
      h_reg[i] *= kp;
      c_reg[i] *= kp;
    }
    store_state(t);
  }
  lstm::cluster_sync();  // no CTA leaves while the cluster still runs
}

template <typename T, int RR, bool kResident>
cudaError_t launch_as(const void* xp, const void* lengths, const void* w_hh,
                      const void* keep, void* h_out, void* c_out, int t_dim,
                      int g_dim, int b_dim, const Layout& l, int threads,
                      size_t smem, cudaStream_t stream, int* max_clusters) {
  auto kernel = lstm_scan_fwd_kernel<T, RR, kResident>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (l.cluster > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.cluster, (b_dim + l.rows - 1) / l.rows, g_dim);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(xp), static_cast<const int*>(lengths),
      static_cast<const T*>(w_hh), static_cast<const float*>(keep),
      static_cast<T*>(h_out), static_cast<T*>(c_out), t_dim, g_dim, b_dim, l);
}

// Launches (or, with max_clusters, asks how many clusters of the launch can
// be resident at once).  The plan (cluster, rows, rows_per_thread,
// resident, threads, smem_bytes) comes from ops/lstm_scan.py's scan_plan;
// a plan whose shared memory or threads disagree with this file's layout
// is refused.
template <typename T>
int launch(const void* xp, const void* lengths, const void* w_hh,
           const void* keep, void* h_out, void* c_out, int t_dim, int g_dim,
           int b_dim, int hd, int cluster, int rows, int rr, int resident,
           int threads, int smem_bytes, void* stream, int* max_clusters) {
  const Layout l = lstm::make_layout(hd, cluster, rows, rr, false);
  if (cluster < 1 || cluster > 16 || cluster > hd || rows < 1 ||
      threads != l.threads() || threads > 512 ||
      (size_t)smem_bytes != l.forward_bytes(resident != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LSTM_FWD(RR, RES)                                                     \
  launch_as<T, RR, RES>(xp, lengths, w_hh, keep, h_out, c_out, t_dim, g_dim, \
                        b_dim, l, threads, smem_bytes, s, max_clusters)
  cudaError_t e;
  if (rr == 1)
    e = resident ? LSTM_FWD(1, true) : LSTM_FWD(1, false);
  else if (rr == 2)
    e = resident ? LSTM_FWD(2, true) : LSTM_FWD(2, false);
  else
    e = cudaErrorInvalidValue;
#undef LSTM_FWD
  if (e != cudaSuccess) return (int)e;
  return max_clusters != nullptr ? 0 : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_scan_forward_f32(const void* xp, const void* lengths,
                          const void* w_hh, const void* keep, void* h_out,
                          void* c_out, int t_dim, int g_dim, int b_dim, int hd,
                          int cluster, int rows, int rr, int resident,
                          int threads, int smem_bytes, void* stream) {
  return launch<float>(xp, lengths, w_hh, keep, h_out, c_out, t_dim, g_dim,
                       b_dim, hd, cluster, rows, rr, resident,
                       threads, smem_bytes, stream, nullptr);
}

int lstm_scan_forward_bf16(const void* xp, const void* lengths,
                           const void* w_hh, const void* keep, void* h_out,
                           void* c_out, int t_dim, int g_dim, int b_dim,
                           int hd, int cluster, int rows, int rr, int resident,
                           int threads, int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(xp, lengths, w_hh, keep, h_out, c_out, t_dim,
                               g_dim, b_dim, hd, cluster, rows, rr, resident,
                               threads, smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the f32 launch of this plan, into *out.
int lstm_scan_forward_max_clusters(int b_dim, int g_dim, int hd, int cluster,
                                   int rows, int rr, int resident, int threads,
                                   int smem_bytes, int* out) {
  return launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                       g_dim, b_dim, hd, cluster, rows, rr, resident,
                       threads, smem_bytes, nullptr, out);
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
