// Masked LSTM scan, backward: full BPTT through G independent LSTMs over T
// steps, and the gradient of their recurrent weights.
//
// Replaces the Pallas TPU kernel gcn_tpu/ops/pallas/lstm_scan.py::
// _bwd_kernel (launched by _run_backward from the custom VJP of
// lstm_scan_stacked).  Same contract:
//   gy      [T, G, B, H] f32  cotangent of the h states, zero at t >= length
//   xp      [T, G, B, 4H]     the forward's input projections (i, f, g, o)
//   h, c    [T, G, B, H]      the forward's states, in xp's dtype
//   w_hh    [G, H, 4H]
//   keep    [T, G, B] f32     optional carry factor of step t
//   lengths [B] int32
//   dxp     [T, G, B, 4H] f32 gradient of the gate pre-activations
//   dw_hh   [G, H, 4H] f32    Σ_t Σ_b h_prev[t,b]ᵀ dxp[t,b]
// Storage is f32 or bf16; all math is f32.  The gates are recomputed from
// xp + keep·(h[t-1] @ w_hh) with the states the forward stored, as the TPU
// kernel does, instead of saving them in the forward.
//
// Rows at t >= length froze their carry in the forward, so there their gate
// gradients are zero and the incoming dh/dc pass through to t-1 unchanged.
// The carry into step t was keep[t]·state[t-1] (zero at t = 0), so h_prev
// and c_prev carry that factor, and so does the cotangent sent to t-1.
//
// What bounds it on the H100.  Device memory moves some 0.07 ms of data at
// the C-GCN's shapes; the 6·ΣL·4H·H FLOPs take 0.01 ms at the f32 rate on
// all SMs.  What sets the time is the serial chain of T steps, as in the
// forward (lstm_scan.cu).  So only what is serial stays in the chain, and
// the rest runs as parallel kernels around it, three launches from one C
// entry point:
//
//  1. lstm_gates_kernel: the gates xp + keep·(h[t-1] @ w_hh) of every
//     (t, b) at once, a [T·B, H] by [H, 4H] product per direction into an
//     f32 scratch [T, G, B, 4H], on the 3xTF32 mainloop (tf32x3_tile.cuh)
//     with the forward's chunking and epilogue: the same bits as the
//     forward's gates.
//  2. lstm_chain_kernel: the chain in the forward's cluster layout
//     (lstm_cluster.cuh).  Each CTA owns the gate columns of H/C units.  A
//     step: (a) as owner, once its transaction barrier says every rank's
//     partials have come, sum the C partial dh_prev of the step after in
//     rank order; (b) form the gate gradients of its units and rows and
//     keep dc in registers; (c) form a partial dh_prev over its own 4H/C
//     columns for all H units from the same resident slice on the tensor
//     cores (so no transposed copy of w_hh is needed) and st.async each
//     owner its part; (d) write dxp and load the next step's inputs.  No
//     float atomics: two runs give the same bits.  Steps at or past the
//     cluster's longest row have zero gate gradients: they only pass gy
//     into dh.
//  3. lstm_dw_kernel: dW_hh = Σ (keep·h_prev)ᵀ dxp, a [H × (T-1)·B] by
//     [(T-1)·B × 4H] product per direction on the 3xTF32 tensor-core
//     mainloop (tf32x3_tile.cuh): h_prev rows, keep and dxp rows stream
//     through the cp.async ring, and the fragment reads transpose h and
//     scale it by keep.  The depth is split over the S CTAs of a cluster to
//     fill the SMs; their partial tiles meet in shared memory and are
//     summed in rank order (fixed), and the kernel writes dW whole.
//
// The bf16 instance (bf16 xp, h, c, w_hh) runs the same arithmetic with
// the passes that would add exact zeros left out (a bf16 value is exact in
// TF32), so 2 and 3 give the sums of their three-pass form bit for bit,
// and copies its bf16 operands 16 bytes at a time: 1 is
// lstm_gates_bf16_kernel (h and w_hh staged in bf16 by cp.async, the
// product on the bf16 tensor cores, xp's tile copied in during the
// mainloop, the epilogue through shared memory); 2's partials take two
// passes (the slice of w_hh unsplit); 3 stages h's rows in bf16 by
// cp.async and, without keep, takes two passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "lstm_cluster.cuh"
#include "tf32x3_tile.cuh"

namespace {

using lstm::Layout;
using lstm::to_f32;

// ---------------------------------------------------------------- gates
// 4 x 2 warps, each 32 rows x 64 gate columns: 128 x 128 a block
using GTile = tf32x3::Tile<4, 2, 2, 8>;
constexpr int kGLda = tf32x3::kBK + 4;  // A chunk row stride (ld / 4 odd)
constexpr int kGRows = GTile::kThreads / 8;  // A rows a pass of 8 lanes a row
// a ring stage: the A chunk [kBM][kGLda] (h rows), the B chunk [kBK][kLdw]
constexpr int kGStage = GTile::kBM * kGLda + tf32x3::kBK * GTile::kLdw;
constexpr size_t kGBytes = sizeof(float) * tf32x3::kStages * kGStage;

// gates[t, g, b] = xp[t, g, b] + keep[t, g, b] · (h[t-1, g, b] @ w_hh[g])
// (zero h at t = 0) for every (t, b) of a direction: rows m = t·B + b, a
// [T·B, H] by [H, 4H] product on the 3xTF32 mainloop, and the epilogue
// fmaf(keep, sum, xp): the forward's gates bit for bit.  A (h rows) and B
// (w rows) come through a three-stage cp.async ring.  The bf16 instance is
// lstm_gates_bf16_kernel.
__global__ void __launch_bounds__(GTile::kThreads)
lstm_gates_kernel(const float* __restrict__ xp, const float* __restrict__ h_st,
                  const float* __restrict__ w_hh,
                  const float* __restrict__ keep, float* __restrict__ gates,
                  int t_dim, int g_dim, int b_dim, int hd) {
  using Tl = GTile;
  constexpr int kBK = tf32x3::kBK, kStages = tf32x3::kStages;
  extern __shared__ float4 g_smem4[];
  float* ring = reinterpret_cast<float*>(g_smem4);  // kStages x kGStage
  auto a_of = [&](int c) { return ring + (c % kStages) * kGStage; };
  auto b_of = [&](int c) { return a_of(c) + Tl::kBM * kGLda; };
  const int g = blockIdx.z;
  const int n0 = blockIdx.x * Tl::kBN, m0 = blockIdx.y * Tl::kBM;
  const int h4 = 4 * hd, m_dim = t_dim * b_dim;
  const float* w = w_hh + (size_t)g * hd * h4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, qq = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  const int chunks = (hd + kBK - 1) / kBK;
  // this thread's A rows: la_r + kGRows·i (i < 4), 4 of k at la_k
  const int la_r = threadIdx.x / 8, la_k = (threadIdx.x % 8) * 4;
  const float* a_rows[Tl::kBM / kGRows];  // h[t-1] of each, null at t = 0 or M
#pragma unroll
  for (int i = 0; i < Tl::kBM / kGRows; ++i) {
    const int m = m0 + la_r + kGRows * i;
    a_rows[i] = nullptr;
    if (m < m_dim && m >= b_dim) {
      const int t = m / b_dim, b = m - t * b_dim;
      a_rows[i] = h_st + (((size_t)(t - 1) * g_dim + g) * b_dim + b) * hd;
    }
  }
  const bool vec = hd % 4 == 0;
  // a valid source for a cp.async that copies nothing (its size is 0)
  const float* dummy = xp;
  auto issue = [&](int c) {  // chunk c into slot c % kStages
    if (c < chunks) {
      const int k0 = c * kBK;
      float* ad = a_of(c);
#pragma unroll
      for (int i = 0; i < Tl::kBM / kGRows; ++i) {
        const float* row = a_rows[i];
        float* dst = ad + (la_r + kGRows * i) * kGLda + la_k;
        const int k = k0 + la_k;
        if (vec) {
          const bool ok = row != nullptr && k < hd;
          tf32x3::cp_async16(dst, ok ? row + k : dummy, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row != nullptr && k + e < hd;
            tf32x3::cp_async4(dst + e, ok ? row + k + e : dummy,
                              ok);
          }
        }
      }
      tf32x3::copy_tile<kBK, Tl::kBN, Tl::kLdw, Tl::kThreads>(
          b_of(c), w + (size_t)k0 * h4, h4,
          min(kBK, hd - k0), n0, h4, true);
    }
    tf32x3::cp_async_commit();
  };
  float acc[Tl::kMT][Tl::kNT][4];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;
  // phases (scan_phases.py): 6 the mainloop, 7 the epilogue
  lstm::PhaseClock phases;
  phases.start();
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    tf32x3::ring_wait();  // chunk c has landed
    issue(c + kStages - 1);
    const float* as = a_of(c) + (wm * 16 * Tl::kMT + gq) * kGLda + qq;
    tf32x3::mma_chunk<Tl::kMT, Tl::kNT, 4, Tl::kLdw>(
        acc, b_of(c) + wn * Tl::kNT * 8,
        [&](int mt, int ks, float (&a)[4]) {
          const float* p = as + mt * 16 * kGLda + ks * 8;
          a[0] = p[0];
          a[1] = p[8 * kGLda];
          a[2] = p[4];
          a[3] = p[8 * kGLda + 4];
        });
  }
  phases.mark(6);

#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 16 * Tl::kMT + mt * 16 + gq + 8 * half;
      if (m >= m_dim) continue;
      const int t = m / b_dim, b = m - t * b_dim;
      const size_t row = ((size_t)t * g_dim + g) * b_dim + b;
      const float kp = keep != nullptr ? keep[row] : 1.0f;
#pragma unroll
      for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = n0 + wn * Tl::kNT * 8 + j * 8 + 2 * qq + i;
          if (n < h4)
            gates[row * h4 + n] =
                fmaf(kp, acc[mt][j][2 * half + i], xp[row * h4 + n]);
        }
    }
  phases.mark(7);
  phases.step(chunks);
  phases.flush(12);
}

// 8 bf16 of a row into shared memory: n of them (at most 8; none where
// n <= 0) from src, zero past n.  With vec (src and dst 16-byte aligned, n 8 or
// none) one 16-byte cp.async that the caller commits; else plain loads and
// stores, done when this returns.
__device__ __forceinline__ void lstm_stage8(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src, int n,
                                            bool vec, const void* dummy) {
  if (vec) {
    tf32x3::cp_async16(dst, n > 0 ? static_cast<const void*>(src) : dummy,
                       n > 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = e < n ? src[e] : __float2bfloat16(0.0f);
}

// c += A B on the bf16 tensor cores: A 16 x 16 and B 16 x 8 bf16, c f32
// (mma.sync.m16n8k16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 gates: GTile's block and warps, the bf16 A chunk [kBM][kGbLda]
// (h rows) and B chunk [kBK][kGbLdb] (w rows) of a stage copied by 16-byte
// cp.async (8 bf16) into a three-stage ring, the f32 out tile
// [kBM][kGbLdo] that the epilogue stages through the ring's memory, and
// beside them the block's xp tile [kBM][kGbLdb] in bf16.  Both operand
// strides put a fragment read's 32 lanes in distinct banks (A: rows 20
// words apart, B: 68).
constexpr int kGroup = 4;  // n-tiles a fresh accumulator takes at once
constexpr int kGbLda = tf32x3::kBK + 8;
constexpr int kGbLdb = GTile::kBN + 8;
constexpr int kGbLdo = GTile::kBN + 8;
constexpr int kGbStage = GTile::kBM * kGbLda + tf32x3::kBK * kGbLdb;
constexpr size_t kGbRing = 2 * tf32x3::kStages * (size_t)kGbStage;
constexpr size_t kGbOut = sizeof(float) * GTile::kBM * kGbLdo;
constexpr size_t kGbXp = kGbRing > kGbOut ? kGbRing : kGbOut;  // its offset
constexpr size_t kGbBytes = kGbXp + 2 * GTile::kBM * kGbLdb;

// lstm_gates_kernel's function for bf16 h and w_hh, on the bf16 tensor
// cores: mma.sync.m16n8k16 on the staged bf16 tiles (no conversion, two
// k-steps a chunk), each 32-deep chunk into a fresh f32 accumulator folded
// in k order, as tf32x3::mma_chunk folds.  Every product of two bf16
// values is exact in f32; the tensor cores add sixteen of them a step
// where one TF32 pass of the operands unsplit (the three passes' bits)
// adds eight, so the sums part from that route's in their last bits
// (tests/test_torch_port_scan_bf16_mainloop.py emulates both; they never
// were the forward's: its carry is f32, the stored h bf16).  The block's
// xp tile is copied in with the last chunk's group, so it lands during the
// mainloop.  The epilogue writes the tile's sums into shared memory, then
// each lane takes 4 consecutive columns of a row: xp's 4 bf16 from the xp
// tile, the 4 gates out in one 16-byte store (a warp a 512-byte row
// segment).  Rows of h are copied 16 bytes at a time where H is a
// multiple of 8 (w_hh's and xp's where H is even), else by plain loads.
__global__ void __launch_bounds__(GTile::kThreads)
lstm_gates_bf16_kernel(const __nv_bfloat16* __restrict__ xp,
                       const __nv_bfloat16* __restrict__ h_st,
                       const __nv_bfloat16* __restrict__ w_hh,
                       const float* __restrict__ keep,
                       float* __restrict__ gates, int t_dim, int g_dim,
                       int b_dim, int hd) {
  using Tl = GTile;
  using bf16 = __nv_bfloat16;
  constexpr int kBK = tf32x3::kBK, kStages = tf32x3::kStages;
  constexpr int kAVecs = kBK / 8, kBVecs = Tl::kBN / 8;  // 16-byte copies a row
  static_assert(Tl::kBM * kAVecs == 2 * Tl::kThreads &&
                    kBK * kBVecs == 2 * Tl::kThreads,
                "a thread copies two pieces of A and two of B a chunk");
  extern __shared__ float4 gb_smem4[];
  bf16* ring = reinterpret_cast<bf16*>(gb_smem4);  // kStages x kGbStage
  auto a_of = [&](int c) { return ring + (c % kStages) * kGbStage; };
  auto b_of = [&](int c) { return a_of(c) + Tl::kBM * kGbLda; };
  const int g = blockIdx.z;
  const int n0 = blockIdx.x * Tl::kBN, m0 = blockIdx.y * Tl::kBM;
  const int h4 = 4 * hd, m_dim = t_dim * b_dim;
  const bf16* w = w_hh + (size_t)g * hd * h4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, qq = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  const int chunks = (hd + kBK - 1) / kBK;
  // this thread's copies: A rows la_r + kBM/2·i at k la_k, B rows
  // lb_k + kBK/2·i at column lb_n (i < 2)
  const int la_r = threadIdx.x / kAVecs, la_k = (threadIdx.x % kAVecs) * 8;
  const int lb_k = threadIdx.x / kBVecs, lb_n = (threadIdx.x % kBVecs) * 8;
  const bf16* a_rows[2];  // h[t-1] of each, null at t = 0 or past M
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + la_r + Tl::kBM / 2 * i;
    a_rows[i] = nullptr;
    if (m < m_dim && m >= b_dim) {
      const int t = m / b_dim, b = m - t * b_dim;
      a_rows[i] = h_st + (((size_t)(t - 1) * g_dim + g) * b_dim + b) * hd;
    }
  }
  const bool vec_a = hd % 8 == 0 && reinterpret_cast<uintptr_t>(h_st) % 16 == 0;
  const bool vec_b = hd % 2 == 0 && reinterpret_cast<uintptr_t>(w_hh) % 16 == 0;
  bf16* xp_s = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(gb_smem4) + kGbXp);  // [kBM][kGbLdb]
  const bool vec_x = hd % 2 == 0 && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
  auto issue = [&](int c) {  // chunk c into slot c % kStages
    if (c < chunks) {
      const int k0 = c * kBK;
      if (c == chunks - 1) {  // and the xp tile
        for (int i = threadIdx.x; i < Tl::kBM * kBVecs; i += Tl::kThreads) {
          const int r = i / kBVecs, n = n0 + (i % kBVecs) * 8;
          const int m = m0 + r;
          const int t = m / b_dim, b = m - t * b_dim;
          const size_t row = ((size_t)t * g_dim + g) * b_dim + b;
          lstm_stage8(xp_s + r * kGbLdb + (i % kBVecs) * 8,
                      xp + row * h4 + n, m < m_dim ? h4 - n : 0, vec_x, xp);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = la_r + Tl::kBM / 2 * i, k = k0 + la_k;
        lstm_stage8(a_of(c) + r * kGbLda + la_k, a_rows[i] + k,
                    a_rows[i] != nullptr ? hd - k : 0, vec_a, xp);
        const int kr = lb_k + kBK / 2 * i, n = n0 + lb_n;
        lstm_stage8(b_of(c) + kr * kGbLdb + lb_n,
                    w + (size_t)(k0 + kr) * h4 + n,
                    k0 + kr < hd ? h4 - n : 0, vec_b, xp);
      }
    }
    tf32x3::cp_async_commit();
  };
  float acc[Tl::kMT][Tl::kNT][4];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;
  // phases (scan_phases.py): 6 the mainloop, 7 the epilogue
  lstm::PhaseClock phases;
  phases.start();
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    tf32x3::ring_wait();  // chunk c has landed
    issue(c + kStages - 1);
    // a fragment of A (16 x 16) and one of B (16 x 8) for lane (gq, qq):
    // A[gq (+8)][2qq, 2qq + 1 (+8)] as 32-bit pairs, B[2qq, 2qq + 1
    // (+8)][gq] packed from two rows
    const bf16* as = a_of(c) + (wm * 16 * Tl::kMT + gq) * kGbLda + 2 * qq;
    const unsigned short* bs = reinterpret_cast<const unsigned short*>(
        b_of(c) + 2 * qq * kGbLdb + wn * Tl::kNT * 8 + gq);
#pragma unroll
    for (int j0 = 0; j0 < Tl::kNT; j0 += kGroup) {
      float cc[Tl::kMT][kGroup][4];  // the chunk's fresh accumulator
#pragma unroll
      for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) cc[mt][j][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t af[Tl::kMT][4];
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt) {
          const bf16* p = as + mt * 16 * kGbLda + ks * 16;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kGbLda);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kGbLda + 8);
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const unsigned short* q = bs + ks * 16 * kGbLdb + (j0 + j) * 8;
          const uint32_t b0 = q[0] | ((uint32_t)q[kGbLdb] << 16);
          const uint32_t b1 = q[8 * kGbLdb] | ((uint32_t)q[9 * kGbLdb] << 16);
#pragma unroll
          for (int mt = 0; mt < Tl::kMT; ++mt)
            mma_bf16(cc[mt][j], af[mt], b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][j0 + j][i] += cc[mt][j][i];
    }
  }
  phases.mark(6);

  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the out tile
  float* out = reinterpret_cast<float*>(gb_smem4);  // [kBM][kGbLdo]
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 * Tl::kMT + mt * 16 + gq + 8 * half;
        const int col = wn * Tl::kNT * 8 + j * 8 + 2 * qq;
        *reinterpret_cast<float2*>(out + r * kGbLdo + col) = make_float2(
            acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
      }
  __syncthreads();
  constexpr int kQuads = Tl::kBN / 4;  // 4-column pieces of a row
  for (int e = threadIdx.x; e < Tl::kBM * kQuads; e += Tl::kThreads) {
    const int r = e / kQuads, col = (e % kQuads) * 4;
    const int m = m0 + r, n = n0 + col;
    if (m >= m_dim || n >= h4) continue;  // h4 is a multiple of 4
    const int t = m / b_dim, b = m - t * b_dim;
    const size_t row = ((size_t)t * g_dim + g) * b_dim + b;
    const float kp = keep != nullptr ? keep[row] : 1.0f;
    const float4 sum = *reinterpret_cast<const float4*>(out + r * kGbLdo + col);
    const uint2 v = *reinterpret_cast<const uint2*>(xp_s + r * kGbLdb + col);
    const float2 x01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 x23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    const float4 xv = make_float4(x01.x, x01.y, x23.x, x23.y);
    *reinterpret_cast<float4*>(gates + row * h4 + n) =
        make_float4(fmaf(kp, sum.x, xv.x), fmaf(kp, sum.y, xv.y),
                    fmaf(kp, sum.z, xv.z), fmaf(kp, sum.w, xv.w));
  }
  phases.mark(7);
  phases.step(chunks);
  phases.flush(12);
}
// ---------------------------------------------------------------- chain
// (c) of a step: part[r][k] = Σ_c dg_s[r][c] · w[k][c] over this CTA's
// columns c = 4u + gate, for every row r < nrows and unit k < H, each sent
// to k's owner by st.async: recv[parity][rank][k - unit0(owner)][r],
// counted against the owner's barrier bar.  3xTF32 m16n8k8 with the slice
// as B ("col": B[c][k] = w_s[k][c]), 32 columns a chunk folded in order.
// A bf16 slice goes to the MMAs unsplit in two passes (lstm::mma3's
// kExactB): the same sums.
// A warp takes a 16-row tile by kTiles n-tiles of 8 units and kChunks
// chunks at once, all their MMAs independent and each A fragment shared.
template <bool kResident, typename T>
__device__ __forceinline__ void send_partials(
    const float* w_s, const T* __restrict__ w, const float* dg_s,
    uint32_t recv_par, uint32_t bar, const Layout& l, int rank, int u0,
    int nu, int nrows, lstm::PhaseClock& phases) {
  constexpr int kBK = tf32x3::kBK, kTiles = 4, kChunks = 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int mtiles = (nrows + 15) / 16;
  const int groups = (l.hd + 8 * kTiles - 1) / (8 * kTiles);
  const int cols = (4 * nu + 7) / 8 * 8;
  for (int item = warp; item < mtiles * groups; item += blockDim.x / 32) {
    const int m0 = (item % mtiles) * 16, n0 = (item / mtiles) * 8 * kTiles;
    const float* a = dg_s + (m0 + g) * l.ldw + q;
    float acc[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    for (int cg0 = 0; cg0 < cols; cg0 += kChunks * kBK) {
      float c[kChunks][kTiles][4];
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[ch][j][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks)
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          const int c0 = cg0 + ch * kBK + 8 * ks;
          if (c0 >= cols) continue;
          const lstm::Frag af = lstm::split_frag(
              a[c0], a[8 * l.ldw + c0], a[c0 + 4], a[8 * l.ldw + c0 + 4]);
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            const int k = n0 + 8 * j + g;
            if (n0 + 8 * j >= l.hp) continue;
            lstm::mma3<sizeof(T) == 2>(
                c[ch][j], af,
                lstm::slice_at<kResident>(w_s, w, l, k, c0 + q, u0, nu),
                lstm::slice_at<kResident>(w_s, w, l, k, c0 + q + 4, u0, nu));
          }
        }
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
        if (cg0 + ch * kBK < cols)
#pragma unroll
          for (int j = 0; j < kTiles; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = acc[j][i] + c[ch][j][i];
    }
    phases.mark(2);  // thread 0's item: its product, then its sends
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + g + 8 * (i / 2), k = n0 + 8 * j + 2 * q + i % 2;
        if (r >= nrows || k >= l.hd) continue;
        const int own = l.owner(k);
        const uint32_t dst =
            recv_par +
            4u * ((rank * l.units + (k - l.unit0(own))) * l.rows_pad + r);
        lstm::st_async(lstm::map_rank(dst, own), acc[j][i],
                       lstm::map_rank(bar, own));
      }
    phases.mark(14);
  }
}

template <typename T, int RR, bool kResident>
__global__ void __launch_bounds__(512)
lstm_chain_kernel(const float* __restrict__ gy, const T* __restrict__ xp,
                  const T* __restrict__ h_st, const T* __restrict__ c_st,
                  const T* __restrict__ w_hh, const float* __restrict__ keep,
                  const int* __restrict__ lengths,
                  const float* __restrict__ gates, float* __restrict__ dxp,
                  int t_dim, int g_dim, int b_dim, Layout lp) {
  const Layout l = lp;  // in registers: lambdas below take it by reference
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);     // [hp][ldw]
  float* dg_s = w_s + l.slice_floats(kResident);    // [rows_pad][ldw]
  float* recv = dg_s + l.tile_floats();             // [2][C][units][rows_pad]
  lstm::cg::cluster_group cluster = lstm::cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * l.rows;
  const int nrows = min(l.rows, b_dim - row0);
  const int hd = l.hd, h4 = 4 * hd;
  const int u0 = l.unit0(rank), nu = l.unit_count(rank);
  const T* w = w_hh + (size_t)g * hd * h4;

  const lstm::Owned me = lstm::owned(l);
  const int u = me.u, j = u0 + u;
  const bool active = u < nu && me.r0 < nrows;
  bool ok[RR];
  int len[RR];
  int longest = 0;
  for (int r = 0; r < nrows; ++r)
    longest = max(longest, min(lengths[row0 + r], t_dim));
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    ok[i] = active && me.r0 + 8 * i < nrows;
    len[i] = ok[i] ? lengths[row0 + me.r0 + 8 * i] : 0;
  }

  // bars[p]: recv[p] has received every rank's partials for this CTA's
  // units (C x nu x nrows floats)
  __shared__ __align__(8) uint64_t bars[2];
  if (threadIdx.x == 0) {
    lstm::mbar_init(&bars[0]);
    lstm::mbar_init(&bars[1]);
    lstm::mbar_init_fence();
  }
  if (kResident) lstm::load_slice(w_s, w, l, u0, nu);
  // rows and units this CTA does not own must read as zero gradients
  for (int i = threadIdx.x; i < l.tile_floats(); i += blockDim.x)
    dg_s[i] = 0.0f;
  lstm::cluster_sync();  // every CTA has started and set its buffers
  const uint32_t bytes = 4u * l.cluster * nu * nrows;
  const uint32_t recv_addr = lstm::smem_u32(recv);
  const uint32_t bar_addr = lstm::smem_u32(bars);
  uint32_t parity = 0;  // bit p: the phase of bars[p] to wait for

  float dh[RR], dc[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) dh[i] = dc[i] = 0.0f;
  // steps at or past the longest row: every row is frozen, gy (zero there
  // by the contract) passes into dh, the gate gradients are zero
  for (int t = t_dim - 1; t >= longest; --t) {
    const size_t step = (size_t)t * g_dim + g;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (!ok[i]) continue;
      const size_t o = step * b_dim + row0 + me.r0 + 8 * i;
      dh[i] += gy[o * hd + j];
      float* out = dxp + o * h4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q * hd] = 0.0f;
    }
  }

  // the step's inputs, loaded ahead of the step
  float gt[RR][4], kp[RR], c_now[RR], c_before[RR], gyv[RR];
  auto prepare = [&](int t) {
    const size_t step = (size_t)t * g_dim + g;
    const size_t prev = (size_t)(t > 0 ? t - 1 : 0) * g_dim + g;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int r = row0 + me.r0 + 8 * i;
      const size_t o = step * b_dim + r;
      kp[i] = (keep != nullptr && ok[i]) ? keep[o] : 1.0f;
      c_now[i] = ok[i] ? to_f32(c_st[o * hd + j]) : 0.0f;
      c_before[i] = (ok[i] && t > 0)
                        ? to_f32(c_st[(prev * b_dim + r) * hd + j])
                        : 0.0f;
      gyv[i] = ok[i] ? gy[o * hd + j] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gt[i][q] = ok[i] ? gates[o * h4 + q * hd + j] : 0.0f;
    }
  };

  float4 dq[RR];        // the step's gate gradients, written late
  bool was_valid[RR];   // the step after's row state, for the owner's sum
  float was_kp[RR], was_dh[RR];
  auto write_dxp = [&](int t) {
    const size_t step = (size_t)t * g_dim + g;
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (!ok[i]) continue;
      float* out = dxp + (step * b_dim + row0 + me.r0 + 8 * i) * h4 + j;
      out[0] = dq[i].x;
      out[hd] = dq[i].y;
      out[2 * hd] = dq[i].z;
      out[3 * hd] = dq[i].w;
    }
  };
  // phases (scan_phases.py): 0 the wait for the partials and their sum,
  // 1 the gate gradients, 2 the partial dh_prev, 14 its sends (thread 0's
  // item), 3 the dxp stores and the next step's loads
  lstm::PhaseClock phases;
  phases.start();
  if (longest > 0) prepare(longest - 1);
  for (int t = longest - 1; t >= 0; --t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (t > 0 && threadIdx.x == 0) lstm::mbar_expect(&bars[cur], bytes);
    // (a) dh carried into step t: the partials of step t + 1, rank order
    if (t + 1 < longest) {
      lstm::mbar_wait(&bars[nxt], (parity >> nxt) & 1);
      parity ^= 1u << nxt;
      const float* in = recv + nxt * l.recv_floats();
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        if (!ok[i]) continue;
        float s = 0.0f;
        for (int q = 0; q < l.cluster; ++q)
          s += in[(q * l.units + u) * l.rows_pad + me.r0 + 8 * i];
        dh[i] = was_valid[i] ? s * was_kp[i] : was_dh[i];
      }
    }
    phases.mark(0);
    // (b) the gate gradients of this CTA's units
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (!ok[i]) continue;
      const float ig = lstm::sigmoid(gt[i][0]);
      const float fg = lstm::sigmoid(gt[i][1]);
      const float gg = tanhf(gt[i][2]);
      const float og = lstm::sigmoid(gt[i][3]);
      const float c_prev = kp[i] * c_before[i];
      const float dh_tot = dh[i] + gyv[i];
      const float dc_tot = dc[i];
      const float tc = tanhf(c_now[i]);
      const float dc_all = dc_tot + dh_tot * og * (1.0f - tc * tc);
      float di = dc_all * gg * ig * (1.0f - ig);
      float df = dc_all * c_prev * fg * (1.0f - fg);
      float dg = dc_all * ig * (1.0f - gg * gg);
      float dov = dh_tot * tc * og * (1.0f - og);
      was_valid[i] = t < len[i];
      was_kp[i] = kp[i];
      was_dh[i] = dh_tot;
      if (was_valid[i]) {
        dc[i] = dc_all * fg * kp[i];
      } else {
        di = df = dg = dov = 0.0f;
        dh[i] = dh_tot;  // the frozen row's dh passes through to t - 1
        dc[i] = dc_tot;
      }
      dq[i] = make_float4(di, df, dg, dov);
      *reinterpret_cast<float4*>(dg_s + (me.r0 + 8 * i) * l.ldw + 4 * u) =
          dq[i];
    }
    if (t == 0) {  // nothing is sent to t = -1
      write_dxp(0);
      break;
    }
    __syncthreads();
    phases.mark(1);
    // (c) the partial dh_prev to each owner
    send_partials<kResident>(w_s, w, dg_s,
                             recv_addr + 4u * cur * l.recv_floats(),
                             bar_addr + 8u * cur, l, rank, u0, nu, nrows,
                             phases);
    phases.mark(2);
    // (d) the step's dxp out, the next step's inputs in
    write_dxp(t);
    prepare(t - 1);
    __syncthreads();  // (c) has read dg_s before (b) writes it again
    phases.mark(3);
    phases.step();
  }
  phases.flush(8);
  lstm::cluster_sync();  // no CTA leaves while the cluster still runs
}

// ---------------------------------------------------------------- dW_hh
// 2 x 4 warps, each 32 units x 40 gate columns: 64 x 160 a block
using DwTile = tf32x3::Tile<2, 4, 2, 5>;
constexpr int kDwLdr = DwTile::kBN + 4;  // partial tile stride
// A chunk row stride, in elements of h's type: f32 8 or 24 mod 32 floats;
// bf16 64 + 16 (40 words, 8 mod 32: the fragment reads' lanes in distinct
// words, two lanes a word; 160-byte rows for 16-byte copies)
template <typename T>
constexpr int kDwLda =
    sizeof(T) == 2 ? DwTile::kBM + 16 : tf32x3::padded_ld(DwTile::kBM);
// a ring stage, in floats: the dxp chunk [kBK][kLdw], the A chunk
// [kBK][kDwLda] in h's type (h rows, transposed by the fragment reads) and
// the chunk's keep [kBK]
template <typename T>
constexpr int kDwStage = DwTile::kStageFloats +
                         tf32x3::kBK * kDwLda<T> * (int)sizeof(T) / 4 +
                         tf32x3::kBK;
template <typename T>
constexpr size_t kDwBytes = sizeof(float) * tf32x3::kStages * kDwStage<T>;
static_assert(DwTile::kBM * kDwLdr <= tf32x3::kStages * kDwStage<float> &&
                  DwTile::kBM * kDwLdr <=
                      tf32x3::kStages * kDwStage<__nv_bfloat16>,
              "the partial tile reuses the ring");
static_assert(tf32x3::kBK * DwTile::kBM == 8 * DwTile::kThreads,
              "a thread copies 8 bf16 of the A chunk");

// dw[g][k][col] = Σ_{t >= 1} Σ_b keep[t,g,b]·h[t-1,g,b,k] · dxp[t,g,b,col]
// (the t = 0 term has h_prev = 0) over the depth q = (t - 1)·B + b.  Block
// (rank s, tile, g) of a cluster of S along x sums the 32-deep chunks
// [s·chunks/S, (s+1)·chunks/S) of the tile; rank s then sums the cluster's
// S partials of its share of the tile's rows, in rank order.  Each chunk's
// dxp rows, h rows and keep come through a three-stage cp.async ring (bf16
// h rows 16 bytes, 8 values, a copy, widened at the fragment read), and
// the fragment reads scale h by keep.  bf16 h is exact in TF32, so
// without keep the mainloop leaves out the pass of its zero lo
// (tf32x3::mma_chunk's kExactA: a_hi b_lo, a_hi b_hi, the three passes'
// bits); keep·h is
// not exact for every keep the wrapper takes, so with keep all three run.
template <typename T>
__global__ void __launch_bounds__(DwTile::kThreads)
lstm_dw_kernel(const T* __restrict__ h_st, const float* __restrict__ keep,
               const float* __restrict__ dxp, float* __restrict__ dw,
               int t_dim, int g_dim, int b_dim, int hd) {
  using Tl = DwTile;
  constexpr int kBK = tf32x3::kBK, kStages = tf32x3::kStages;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kLda = kDwLda<T>, kStage = kDwStage<T>;
  extern __shared__ float4 dw_smem4[];
  float* ring = reinterpret_cast<float*>(dw_smem4);  // kStages x kDwStage
  lstm::cg::cluster_group cluster = lstm::cg::this_cluster();
  const int slices = gridDim.x;  // the cluster spans the grid's x
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.z;
  const int h4 = 4 * hd;
  const int mtiles = (hd + Tl::kBM - 1) / Tl::kBM;
  const int m0 = (blockIdx.y % mtiles) * Tl::kBM;
  const int n0 = (blockIdx.y / mtiles) * Tl::kBN;
  const int depth = (t_dim - 1) * b_dim;
  const int chunks = (depth + kBK - 1) / kBK;
  const int c0 = rank * chunks / slices, c1 = (rank + 1) * chunks / slices;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, qq = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  // 16-byte copies of h rows
  const bool vec_h =
      kBf16 ? hd % 8 == 0 && reinterpret_cast<uintptr_t>(h_st) % 16 == 0
            : hd % 4 == 0;
  auto w_of = [&](int c) { return ring + (c % kStages) * kStage; };
  auto a_of = [&](int c) {
    return reinterpret_cast<T*>(w_of(c) + Tl::kStageFloats);
  };
  auto kp_of = [&](int c) {
    return w_of(c) + Tl::kStageFloats + kBK * kLda * (int)sizeof(T) / 4;
  };

  // depth row q is (t, b) = (1 + q / B, q % B); rows r apart from a known
  // (t, b) step there without a division
  auto step_rows = [&](int& t, int& b, int r) {
    for (b += r; b >= b_dim; b -= b_dim) ++t;
  };
  // the rows (t, g, b) of depth rows q of chunk c: index into [T, G, B]
  auto row_at = [&](int t, int b) {
    return ((size_t)t * g_dim + g) * b_dim + b;
  };
  auto issue = [&](int c) {  // chunk c into slot c % kStages
    if (c < c1) {
      const int qc = c * kBK;
      const int tc = 1 + qc / b_dim, bc = qc - (tc - 1) * b_dim;
      float* wd = w_of(c);
      constexpr int kVecs = Tl::kBN / 4;
      for (int i = threadIdx.x; i < kBK * kVecs; i += Tl::kThreads) {
        const int r = i / kVecs, col = (i % kVecs) * 4;
        int t = tc, b = bc;
        step_rows(t, b, r);
        const bool ok = qc + r < depth && n0 + col < h4;
        tf32x3::cp_async16(wd + r * Tl::kLdw + col,
                           ok ? dxp + row_at(t, b) * h4 + n0 + col : dxp, ok);
      }
      if constexpr (kBf16) {  // h rows t - 1, columns m0.. of the tile
        constexpr int kVecs = Tl::kBM / 8;
        const int r = threadIdx.x / kVecs, m = (threadIdx.x % kVecs) * 8;
        int t = tc, b = bc;
        step_rows(t, b, r);
        const bool ok = qc + r < depth;
        lstm_stage8(a_of(c) + r * kLda + m,
                    ok ? h_st + row_at(t - 1, b) * hd + m0 + m : h_st,
                    ok ? hd - (m0 + m) : 0, vec_h, dxp);
      } else {  // h rows t - 1 (f32), columns m0.. of the tile
        const float* h = h_st;
        float* ad = a_of(c);
        const int per_row = vec_h ? Tl::kBM / 4 : Tl::kBM;
        for (int i = threadIdx.x; i < kBK * per_row; i += Tl::kThreads) {
          const int r = i / per_row, m = (i % per_row) * (vec_h ? 4 : 1);
          int t = tc, b = bc;
          step_rows(t, b, r);
          const bool ok = qc + r < depth && m0 + m < hd;
          const float* src = ok ? h + row_at(t - 1, b) * hd + m0 + m : h;
          if (vec_h)
            tf32x3::cp_async16(ad + r * kLda + m, src, ok);
          else
            tf32x3::cp_async4(ad + r * kLda + m, src, ok);
        }
      }
      if (keep != nullptr && threadIdx.x < kBK) {
        const int r = threadIdx.x;
        int t = tc, b = bc;
        step_rows(t, b, r);
        const bool ok = qc + r < depth;
        tf32x3::cp_async4(kp_of(c) + r, ok ? keep + row_at(t, b) : keep, ok);
      }
    }
    tf32x3::cp_async_commit();
  };
  float acc[Tl::kMT][Tl::kNT][4];
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;

  // phases (scan_phases.py): 4 the mainloop, 5 the partial tiles' sum
  lstm::PhaseClock phases;
  phases.start();
  for (int c = c0; c < c0 + kStages - 1; ++c) issue(c);
  for (int c = c0; c < c1; ++c) {
    tf32x3::ring_wait();  // chunk c has landed
    issue(c + kStages - 1);
    const T* as = a_of(c) + qq * kLda + wm * 16 * Tl::kMT + gq;
    const float* kp = kp_of(c) + qq;
    const float* ws = w_of(c) + wn * Tl::kNT * 8;
    auto a_frag = [&](int mt, int ks, float (&a)[4]) {
      const T* p = as + ks * 8 * kLda + mt * 16;
      a[0] = to_f32(p[0]);
      a[1] = to_f32(p[8]);
      a[2] = to_f32(p[4 * kLda]);
      a[3] = to_f32(p[4 * kLda + 8]);
      if (keep != nullptr) {
        const float k0 = kp[ks * 8], k4 = kp[ks * 8 + 4];
        a[0] *= k0;
        a[1] *= k0;
        a[2] *= k4;
        a[3] *= k4;
      }
    };
    if (!kBf16 || keep != nullptr)
      tf32x3::mma_chunk<Tl::kMT, Tl::kNT, Tl::kNT, Tl::kLdw>(acc, ws, a_frag);
    else
      tf32x3::mma_chunk<Tl::kMT, Tl::kNT, Tl::kNT, Tl::kLdw, true>(
          acc, ws, a_frag);
  }
  phases.mark(4);
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the partial tile

  float* part = ring;  // [kBM][kDwLdr]
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 16 * Tl::kMT + mt * 16 + gq + (i / 2) * 8;
        const int col = wn * Tl::kNT * 8 + j * 8 + 2 * qq + (i % 2);
        part[r * kDwLdr + col] = acc[mt][j][i];
      }
  lstm::cluster_sync();  // every rank's partial tile is in place

  const int r0 = rank * Tl::kBM / slices, r1 = (rank + 1) * Tl::kBM / slices;
  for (int e = threadIdx.x; e < (r1 - r0) * Tl::kBN; e += Tl::kThreads) {
    const int r = r0 + e / Tl::kBN, col = e % Tl::kBN;
    const int k = m0 + r, n = n0 + col;
    if (k >= hd || n >= h4) continue;
    float s = 0.0f;
    for (int q = 0; q < slices; ++q)
      s += *cluster.map_shared_rank(part + r * kDwLdr + col, q);
    dw[((size_t)g * hd + k) * h4 + n] = s;
  }
  lstm::cluster_sync();  // no rank leaves while another reads its tile
  phases.mark(5);
  phases.step(c1 - c0);
  phases.flush(10);
}

// ---------------------------------------------------------------- launch
template <class K, class... Args>
cudaError_t launch_cluster(K kernel, dim3 grid, int cluster, int threads,
                           size_t smem, cudaStream_t stream, int* max_clusters,
                           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int RR, bool kRes>
cudaError_t launch_chain(const void* gy, const void* xp, const void* h_st,
                         const void* c_st, const void* w_hh, const void* keep,
                         const void* lengths, const void* gates, void* dxp,
                         int t_dim, int g_dim, int b_dim, const Layout& l,
                         int threads, size_t smem, cudaStream_t s,
                         int* max_clusters) {
  return launch_cluster(
      lstm_chain_kernel<T, RR, kRes>,
      dim3(l.cluster, (b_dim + l.rows - 1) / l.rows, g_dim), l.cluster,
      threads, smem, s, max_clusters, static_cast<const float*>(gy),
      static_cast<const T*>(xp), static_cast<const T*>(h_st),
      static_cast<const T*>(c_st), static_cast<const T*>(w_hh),
      static_cast<const float*>(keep), static_cast<const int*>(lengths),
      static_cast<const float*>(gates), static_cast<float*>(dxp), t_dim, g_dim,
      b_dim, l);
}

// The clusters of the dW launch: S CTAs split the depth, as many as fill
// the SMs with one CTA each (1 to 8).
int dw_slices(int g_dim, int hd) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = g_dim * ((hd + DwTile::kBM - 1) / DwTile::kBM) *
                    ((4 * hd + DwTile::kBN - 1) / DwTile::kBN);
  const int s = sms / tiles;
  return s < 1 ? 1 : (s > 8 ? 8 : s);
}

template <typename T>
int launch(const void* gy, const void* xp, const void* h_st, const void* c_st,
           const void* w_hh, const void* keep, const void* lengths,
           void* gates, void* dxp, void* dw, int t_dim, int g_dim, int b_dim,
           int hd, int cluster, int rows, int rr, int resident,
           int threads, int smem_bytes, void* stream, int* max_clusters) {
  const Layout l = lstm::make_layout(hd, cluster, rows, rr, true);
  if (cluster < 1 || cluster > 16 || cluster > hd || rows < 1 ||
      threads != l.threads() || threads > 512 ||
      (size_t)smem_bytes != l.backward_bytes(resident != 0) ||
      (gates == nullptr && max_clusters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (max_clusters == nullptr) {
    auto gates_kernel = [&](auto kernel, size_t bytes) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      dim3 grid((4 * hd + GTile::kBN - 1) / GTile::kBN,
                (t_dim * b_dim + GTile::kBM - 1) / GTile::kBM, g_dim);
      kernel<<<grid, GTile::kThreads, bytes, s>>>(
          static_cast<const T*>(xp), static_cast<const T*>(h_st),
          static_cast<const T*>(w_hh), static_cast<const float*>(keep),
          static_cast<float*>(gates), t_dim, g_dim, b_dim, hd);
      return cudaGetLastError();
    };
    if constexpr (sizeof(T) == 2)
      e = gates_kernel(lstm_gates_bf16_kernel, kGbBytes);
    else
      e = gates_kernel(lstm_gates_kernel, kGBytes);
    if (e != cudaSuccess) return (int)e;
  }
#define LSTM_CHAIN(RR, RES)                                                   \
  launch_chain<T, RR, RES>(gy, xp, h_st, c_st, w_hh, keep, lengths, gates,    \
                           dxp, t_dim, g_dim, b_dim, l, threads, smem_bytes,  \
                           s, max_clusters)
  if (rr == 1)
    e = resident ? LSTM_CHAIN(1, true) : LSTM_CHAIN(1, false);
  else if (rr == 2)
    e = resident ? LSTM_CHAIN(2, true) : LSTM_CHAIN(2, false);
  else
    e = cudaErrorInvalidValue;
#undef LSTM_CHAIN
  if (e != cudaSuccess || max_clusters != nullptr) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int slices = dw_slices(g_dim, hd);
  const int tiles = ((hd + DwTile::kBM - 1) / DwTile::kBM) *
                    ((4 * hd + DwTile::kBN - 1) / DwTile::kBN);
  e = launch_cluster(lstm_dw_kernel<T>, dim3(slices, tiles, g_dim), slices,
                     DwTile::kThreads, kDwBytes<T>, s, nullptr,
                     static_cast<const T*>(h_st),
                     static_cast<const float*>(keep),
                     static_cast<const float*>(dxp), static_cast<float*>(dw),
                     t_dim, g_dim, b_dim, hd);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lstm_scan_backward_f32(const void* gy, const void* xp, const void* h_st,
                           const void* c_st, const void* w_hh,
                           const void* keep, const void* lengths, void* gates,
                           void* dxp, void* dw, int t_dim, int g_dim,
                           int b_dim, int hd, int cluster, int rows, int rr,
                           int resident, int threads, int smem_bytes,
                           void* stream) {
  return launch<float>(gy, xp, h_st, c_st, w_hh, keep, lengths, gates, dxp,
                       dw, t_dim, g_dim, b_dim, hd, cluster, rows, rr,
                       resident, threads, smem_bytes, stream, nullptr);
}

int lstm_scan_backward_bf16(const void* gy, const void* xp, const void* h_st,
                            const void* c_st, const void* w_hh,
                            const void* keep, const void* lengths, void* gates,
                            void* dxp, void* dw, int t_dim, int g_dim,
                            int b_dim, int hd, int cluster, int rows, int rr,
                            int resident, int threads, int smem_bytes,
                            void* stream) {
  return launch<__nv_bfloat16>(gy, xp, h_st, c_st, w_hh, keep, lengths,
                               gates, dxp, dw, t_dim, g_dim, b_dim, hd,
                               cluster, rows, rr, resident, threads,
                               smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the f32 chain launch of this plan.
int lstm_scan_backward_max_clusters(int b_dim, int g_dim, int hd, int cluster,
                                    int rows, int rr, int resident,
                                    int threads, int smem_bytes, int* out) {
  return launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, 1, g_dim, b_dim,
                       hd, cluster, rows, rr, resident, threads,
                       smem_bytes, nullptr, out);
}

// The CTAs of a dW cluster (the depth split) on this device.
int lstm_scan_backward_dw_slices(int g_dim, int hd) {
  return dw_slices(g_dim, hd);
}

const char* lstm_scan_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
