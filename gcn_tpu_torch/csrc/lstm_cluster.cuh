// The cluster layout shared by the BiLSTM scan kernels, forward
// (lstm_scan.cu) and backward (lstm_scan_backward.cu).
//
// The T steps of a scan are a serial chain: step t needs all of h[t-1].
// Batch rows and the G directions are independent, so a thread-block
// cluster of C CTAs owns one (direction g, tile of `rows` batch rows) and
// runs the whole time loop; clusters never wait for each other.  Inside a
// cluster each CTA owns a slice of the H hidden units (H need not be a
// multiple of C: the first H % C ranks take one unit more) and, for each of
// its units j, the four gate columns j, H+j, 2H+j, 3H+j of w_hh[g]: that
// slice, [H][4 * units] in f32, is loaded into shared memory once and stays
// there for the whole loop ("resident"), as the TPU kernel kept w_hh in
// VMEM across its sequential grid.  At H = 200 it is 44.8 KB at C = 16.  A
// slice too wide for shared memory is read from L2 at every step instead
// ("streaming"); the wrapper's plan picks the route from the shape.
//
// Shared-memory slice layout: w_s[k * ldw + 4 * u + gate] for k < hp (H
// rounded up to 8) and unit u of the CTA, zero past H and past the CTA's
// own units.  The ranks exchange per-step data through distributed shared
// memory, double-buffered by step parity, with transaction barriers (see
// below) in place of a cluster barrier a step: a cluster barrier's release
// waits for each thread's earlier stores, global ones too, and every CTA
// waits for the slowest.
//
// The per-step products run on the tensor cores in 3xTF32
// (tf32x3_tile.cuh: f32-level error; a resident bf16 slice's values are
// exact in TF32, so its a_hi b_lo pass is left out, mma3's kExactB): a
// CTA's step is a [rows x H] by
// [H x 4·units] product, 0.7 MFLOP at the C-GCN's shapes.  On the CUDA
// cores in f32, one FMA a term in k order, it is bound by shared-memory
// loads: a 128-bit load takes four cycles of the SM's shared-memory pipe
// however many lanes share its address.  The gate sums are chunked like
// tf32x3::mma_chunk's (32-deep chunks, a fresh accumulator each, folded in
// order), so the backward's gates pass, which runs that mainloop,
// recomputes the forward's gates bit for bit.
//
// Threads.  In the per-element phases a thread owns rr rows (strided by 8)
// of one unit; a warp covers 8 rows of 4 consecutive units (Owned).  In the
// products a warp owns 16 x 8 output tiles.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace lstm {

namespace cg = cooperative_groups;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Distributed shared memory with transaction barriers.  A step's data go
// to the other CTAs by st.async, each store counted (in bytes) against the
// receiving CTA's mbarrier, which one thread of the receiver arms with the
// bytes it expects; the receiver's threads wait on that barrier's phase
// alone.  No cluster-wide barrier a step, and no release that would wait
// for the sender's global stores.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the address of shared::cta address a in the CTA of rank r
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(r));
  return out;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
// makes the initialised barriers visible to the cluster's complete_tx
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this phase of bar completes once `bytes` have arrived (one arrival)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// waits for the phase of bar with this parity; a phase that never
// completes (a lost store) ends the kernel with an error, not a hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 26)) __trap();
  }
}
// st.async of one f32 into the shared::cluster address a, counted against
// the receiver's barrier at shared::cluster address bar
__device__ __forceinline__ void st_async(uint32_t a, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(a),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// Phase clocks, compiled in only with -DLSTM_PHASES (tools/scan_phases.py
// builds the scan sources so): thread 0 of each CTA adds the SM cycles it
// spent in each phase of its loop into lstm_phases[slot], its steps into
// lstm_phases[steps_slot] and 1 into lstm_phases[steps_slot + 1]; the
// tool reads them back through lstm_phases_read.  Slots: the forward's
// and the chain's phases 0-3 (the chain's sends 14), steps 8-9; dW 4-5,
// steps 10-11; the gates pass 6-7, steps 12-13.  Without the macro every
// member is empty and the kernels compile as if it were not there.
#ifdef LSTM_PHASES
__device__ unsigned long long lstm_phases[16];
extern "C" int lstm_phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lstm_phases, sizeof(lstm_phases));
}
extern "C" int lstm_phases_zero() {
  const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(lstm_phases, zero, sizeof(zero));
}
#endif

struct PhaseClock {
#ifdef LSTM_PHASES
  long long last = 0, steps = 0, spent[16] = {};
  __device__ __forceinline__ static long long now() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    return t;
  }
  __device__ __forceinline__ void start() { last = now(); }
  // the cycles since the last mark or start go to slot
  __device__ __forceinline__ void mark(int slot) {
    const long long t = now();
    spent[slot] += t - last;
    last = t;
  }
  __device__ __forceinline__ void step(int n = 1) { steps += n; }
  __device__ __forceinline__ void flush(int steps_slot) {
    if (threadIdx.x != 0) return;
    for (int i = 0; i < 16; ++i)
      if (spent[i] != 0) atomicAdd(&lstm_phases[i], (unsigned long long)spent[i]);
    atomicAdd(&lstm_phases[steps_slot], (unsigned long long)steps);
    atomicAdd(&lstm_phases[steps_slot + 1], 1ull);
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void step(int = 1) {}
  __device__ __forceinline__ void flush(int) {}
#endif
};

// The partition of one scan launch, as ops/lstm_scan.py's scan_plan makes
// it (the launcher checks that both give the same shared-memory bytes and
// threads).
struct Layout {
  int hd;        // H
  int hp;        // H rounded up to 8: the padded k extent
  int h_ld;      // row stride of an h tile: hp, or hp + 4 (ld / 4 odd)
  int cluster;   // C, CTAs per cluster (C <= H)
  int rows;      // batch rows per cluster
  int rows_pad;  // rows rounded up to 16
  int units;     // ceil(H / C): the units of the largest CTA
  int cols;      // its 4 * units gate columns, rounded up to 8
  int ldw;       // row stride of the slice and of the gate tiles (below)
  int rr;        // batch rows per thread (1 or 2)
  bool backward;

  __host__ __device__ int unit0(int rank) const {  // first unit of a rank
    const int q = hd / cluster, rem = hd % cluster;
    return rank * q + (rank < rem ? rank : rem);
  }
  __host__ __device__ int unit_count(int rank) const {
    return hd / cluster + (rank < hd % cluster ? 1 : 0);
  }
  __host__ __device__ int owner(int k) const {  // the rank that owns unit k
    const int q = hd / cluster, rem = hd % cluster;
    const int edge = rem * (q + 1);
    return k < edge ? k / (q + 1) : rem + (k - edge) / q;
  }
  __host__ __device__ int slice_floats(bool resident) const {
    return resident ? hp * ldw : 0;
  }
  __host__ __device__ int h_floats() const { return rows_pad * h_ld; }
  __host__ __device__ int tile_floats() const { return rows_pad * ldw; }
  __host__ __device__ int recv_floats() const {
    return cluster * units * rows_pad;
  }
  // the gate product's 16 x 8 tiles, a warp each
  __host__ __device__ int gate_tiles() const {
    return rows_pad / 16 * (cols / 8);
  }
  __host__ __device__ int partial_items() const {  // send_partials'
    return rows_pad / 16 * ((hd + 31) / 32);
  }
  // forward: the slice, h[t-1] of the tile's rows (double-buffered) and
  // the step's gates
  __host__ __device__ size_t forward_bytes(bool resident) const {
    return sizeof(float) * ((size_t)slice_floats(resident) + 2 * h_floats() +
                            tile_floats());
  }
  // backward: the slice, the step's gate gradients and the partial
  // dh_prev that each rank sends each owner, double-buffered:
  // recv[parity][src rank][unit][row]
  __host__ __device__ size_t backward_bytes(bool resident) const {
    return sizeof(float) * ((size_t)slice_floats(resident) + tile_floats() +
                            2 * (size_t)recv_floats());
  }
  // the threads of a CTA: enough warps for the per-element phases (8 rows
  // x 4 units a warp, rr rows a thread) and, up to 16 warps, one for each
  // unit of work of the products
  __host__ __device__ int row_blocks() const {
    return (rows + 8 * rr - 1) / (8 * rr);
  }
  __host__ __device__ int threads() const {
    const int elem = row_blocks() * ((units + 3) / 4);
    int work = backward ? partial_items() : gate_tiles();
    if (work > 16) work = 16;
    return 32 * (elem > work ? elem : work);
  }
};

// ldw: the forward reads the slice by rows (B[k][c] at k * ldw + c, lanes
// over 4 k's and 8 c's), so ldw is 8 or 24 mod 32; the backward reads it
// and its gate-gradient tile by columns (lanes over 8 rows and 4 c's), so
// ldw is 4 mod 8 there.  Either way a fragment read is conflict-free.
inline Layout make_layout(int hd, int cluster, int rows, int rr,
                          bool backward) {
  Layout l;
  l.hd = hd;
  l.hp = (hd + 7) / 8 * 8;
  l.h_ld = l.hp + (l.hp / 4 % 2 == 0 ? 4 : 0);
  l.cluster = cluster;
  l.rows = rows;
  l.rows_pad = (rows + 15) / 16 * 16;
  l.units = (hd + cluster - 1) / cluster;
  l.cols = (4 * l.units + 7) / 8 * 8;
  l.ldw = backward ? l.cols + 4 : tf32x3::padded_ld(l.cols);
  l.rr = rr;
  l.backward = backward;
  return l;
}

// The rows and the unit that a thread owns in the per-element phases: unit
// u of the CTA and rows r0 + 8 i, i < rr.
struct Owned {
  int u, r0;
};
__device__ __forceinline__ Owned owned(const Layout& l) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrb = l.row_blocks();
  return {(warp / nrb) * 4 + lane / 8, (warp % nrb) * 8 * l.rr + lane % 8};
}

// Loads this rank's columns of w (w_hh[g], [H][4H]) into the resident
// slice w_s [hp][ldw], zero elsewhere; consecutive threads read
// consecutive units of one gate row, so the global reads are coalesced.
template <typename T>
__device__ __forceinline__ void load_slice(float* w_s, const T* __restrict__ w,
                                           const Layout& l, int u0, int nu) {
  const int h4 = 4 * l.hd;
  for (int i = threadIdx.x; i < l.hp * l.ldw; i += blockDim.x) {
    const int k = i / l.ldw, c = i - k * l.ldw;
    const int gate = c / l.units, u = c - gate * l.units;
    if (gate >= 4) {  // the columns past 4 * units
      w_s[k * l.ldw + c] = 0.0f;
      continue;
    }
    float v = 0.0f;
    if (k < l.hd && u < nu)
      v = to_f32(w[(size_t)k * h4 + gate * l.hd + u0 + u]);
    w_s[k * l.ldw + 4 * u + gate] = v;
  }
}

// Column c = 4u + gate of the slice at row k: from shared memory, or
// (streaming) from w in L2, zero past H and past the CTA's units.
template <bool kResident, typename T>
__device__ __forceinline__ float slice_at(const float* w_s,
                                          const T* __restrict__ w,
                                          const Layout& l, int k, int c,
                                          int u0, int nu) {
  if (kResident) return w_s[k * l.ldw + c];
  const int u = c / 4;
  if (k >= l.hd || u >= nu) return 0.0f;
  return to_f32(w[(size_t)k * 4 * l.hd + (c % 4) * l.hd + u0 + u]);
}

// An A fragment split into its TF32 parts (tf32x3::split).
struct Frag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ Frag split_frag(float a0, float a1, float a2,
                                           float a3) {
  Frag f;
  tf32x3::split(a0, f.hi[0], f.lo[0]);
  tf32x3::split(a1, f.hi[1], f.lo[1]);
  tf32x3::split(a2, f.hi[2], f.lo[2]);
  tf32x3::split(a3, f.hi[3], f.lo[3]);
  return f;
}

// One 3xTF32 k-step (m16n8k8) into c: the small products first, as
// tf32x3::mma_chunk orders them.  With kExactB (a bf16 slice of w_hh,
// widened: exact in TF32, so its lo is zero) B goes to the MMA unsplit
// and the a_hi b_lo pass, which would add exact zeros, is left out: the
// same sums in two passes.
template <bool kExactB = false>
__device__ __forceinline__ void mma3(float (&c)[4], const Frag& a, float b0,
                                     float b1) {
  if constexpr (kExactB) {
    const uint32_t b[2] = {__float_as_uint(b0), __float_as_uint(b1)};
    tf32x3::mma_tf32(c, a.lo, b);
    tf32x3::mma_tf32(c, a.hi, b);
  } else {
    uint32_t bhi[2], blo[2];
    tf32x3::split(b0, bhi[0], blo[0]);
    tf32x3::split(b1, bhi[1], blo[1]);
    tf32x3::mma_tf32(c, a.lo, bhi);
    tf32x3::mma_tf32(c, a.hi, blo);
    tf32x3::mma_tf32(c, a.hi, bhi);
  }
}

}  // namespace lstm
