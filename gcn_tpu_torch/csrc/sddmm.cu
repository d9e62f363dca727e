// Per-edge scores from padded edge lists (SDDMM), forward and backward.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/sddmm.py:
//   _kernel      (launched by _forward, reached through sddmm)
//                                          -> sddmm_forward_{f32,bf16}
//   _bwd_kernel  (launched by _backward, sddmm's custom VJP)
//                                          -> sddmm_backward_{f32,bf16}
// Same contract, with u, v, du and dv in f32 or bf16 (one type a call, as
// the TPU kernels take the operands' dtype); the scores and g stay f32:
//   parent, child  [B, E] int32   edge p -> c of sentence b
//   mask           [B, E] uint8   0 = padded slot
//   u, v           [B, N, H]
//   forward:   s[b, e] = mask_e * sum_h u[b, p_e, h] * v[b, c_e, h]   [B, E]
//   backward:  with gm_e = g[b, e] * mask_e (g [B, E]),
//              du[b, i] = sum over edges e with p_e = i of gm_e * v[b, c_e]
//              dv[b, j] = sum over edges e with c_e = j of gm_e * u[b, p_e]
// bf16 rounds where the TPU kernels round: the forward widens the rows and
// sums the dot in f32 (its one-hot selections are exact, its product
// accumulates in f32); the backward rounds each message gm_e * v[c_e] to
// bf16 (the TPU kernel's .astype before its selection product), sums the
// messages in f32 and rounds du and dv once, at the store.
// An edge counts when its mask is set and both ends lie in [0, N); an edge
// with an end outside scores 0 and adds nothing to du or dv (the TPU's
// one-hot selection gives it an empty row, so it scores 0 there too).
//
// What bounds it on the H100.  At the attention layer's shapes (B = 50,
// N = E = 96, H = 200) the forward does 2 E H flops against the rows it
// reads, the backward 4 E H against the rows it reads and du, dv: both
// are memory bound.  The forward reads only the rows its counted edges
// touch (about 1.2 MB at the path's 1055 edges, a fraction of a microsecond
// at 3.35 TB/s, below a graph replay's few microseconds; at N = E = 1200
// about 58 MB, 0.017 ms); the backward also writes du and dv (at N = E =
// 1200, where attention_impl="auto" takes this backend, about 154 MB,
// 0.046 ms).  The TPU kernels select rows with one-hot [E, N] MXU
// contractions, which suits a 128 x 128 matrix unit; on the card that is
// N times the work of a gather.
//
// The forward gives each edge kLanes = 16 lanes, two edges a warp (timed
// faster than a whole warp or a quarter of one an edge).  A lane covers
// columns P (lane + kLanes g) .. +P-1 for g < kV, P the values of one
// 16-byte load (4 f32, 8 bf16) and kV fixed at compile time from H (kV = 4
// at H = 200 in f32, 2 in bf16: a bf16 row is 25 loads), by 16-byte loads
// where H % P == 0 and u, v are aligned.  It issues every load of both
// rows before its first product, so one edge's loads go out together
// behind its index loads.
// The lane sums its products in a fixed order (group by group, column by
// column, one fmaf each), then the edge's lanes add by xor shuffles from
// kLanes / 2 down to 1: every run gives the same bits.  A slot that does
// not count loads no row and stores 0.
//
// The backward is a per-node sum over the node's own edges.  In f32
// (kernel 10) it is two kernels launched by one entry point:
//  1. sddmm_lists_kernel, one block per sentence, builds the sentence's
//     two adjacency lists once, with edge ids (by parent for du, by child
//     for dv), into a scratch the wrapper allocates: per-node counts by
//     shared-memory integer atomics, a block-wide scan for the starts,
//     then each list placed by one warp in edge order, 32 edges a step
//     (__match_any_sync finds an edge's same-node peers in the step; its
//     place is the node's running count plus the peers below it).  O(E)
//     work, the lists in edge order: the list of node i is what a stable
//     sort of the counted edges by node gives.
//  2. sddmm_gather_kernel, one warp per (sentence, node, list), lanes over
//     H (16 bytes a lane where H % P == 0): the neighbours' rows scaled by
//     g and summed in list order, so there are no float atomics and every
//     run gives the same bits.  B N 2 independent row jobs (120k at
//     N = 1200) keep many gathers in flight, where a block per sentence
//     and column slice that rebuilt the lists left a few warps per SM
//     walking N nodes each.
// The build's shared memory is 8 (N + 1) bytes (the counts): E has no cap.
// In bf16 (10b) it is one kernel, sddmm_bwd_bf16_kernel (below): each
// block builds the lists of its own nodes in shared memory and gathers
// over them, so no gather waits on a list in device memory or on a
// launch over the whole batch; the same order, the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_gather.cuh"

namespace {

using edge_gather::from_f32;
using edge_gather::round_to;
using edge_gather::to_f32;

constexpr int kWarps = 8;           // forward: warps a block
constexpr int kLanes = 16;          // forward: lanes an edge
constexpr int kMaxV = 4;            // forward: column groups a lane at most
constexpr int kBuildThreads = 512;  // backward: list build, one sentence
constexpr int kSteps = 8;           // placement steps of 32 edges per load
constexpr int kGatherWarps = 8;     // backward: row jobs per block
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

// Phase clocks, compiled in only with -DSDDMM_PHASES (tools/
// sddmm_phases.py builds the source so): lane 0 of each warp adds the SM
// cycles it spent in each phase into its block's slots of its kernel,
// sddmm_phases[kernel][block][...]: the cycles of phase p at [p], the
// warps that reached p at [kClockPhases + p], then the warps, their spans
// summed and the longest span (blocks past kClockBlocks folded over).  A
// load's wait falls in the phase that first uses its value (use() marks a
// use where the kernel has none before the next mark).  Without the macro
// every member is empty and the kernels compile as if it were not there.
enum ClockKernel { kClockLists, kClockGatherF32, kClockGatherBf16,
                   kClockBwdBf16, kClockKernels };
constexpr int kClockPhases = 12;
constexpr int kClockBlocks = 4096;
constexpr int kClockSlots = 2 * kClockPhases + 3;
#ifdef SDDMM_PHASES
__device__ unsigned long long sddmm_phases[kClockKernels][kClockBlocks]
                                          [kClockSlots];
#endif

template <int kKernel>
struct Clock {
#ifdef SDDMM_PHASES
  long long first = 0, last = 0, spent[kClockPhases] = {};
  unsigned reached = 0;
  __device__ __forceinline__ static long long now() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    return t;
  }
  __device__ __forceinline__ void start() { first = last = now(); }
  // the cycles since the last mark or start go to phase
  __device__ __forceinline__ void mark(int phase) {
    const long long t = now();
    spent[phase] += t - last;
    last = t;
    reached |= 1u << phase;
  }
  // the value is waited for here
  __device__ __forceinline__ static void use(float x) {
    asm volatile("" ::"f"(x));
  }
  __device__ __forceinline__ static void use(int x) {
    asm volatile("" ::"r"(x));
  }
  __device__ __forceinline__ void flush() {
    if (threadIdx.x % 32 != 0) return;
    unsigned long long* slot =
        sddmm_phases[kKernel][(blockIdx.x + gridDim.x * blockIdx.y) %
                              kClockBlocks];
    for (int i = 0; i < kClockPhases; ++i)
      if (reached >> i & 1u) {
        atomicAdd(&slot[i], (unsigned long long)spent[i]);
        atomicAdd(&slot[kClockPhases + i], 1ull);
      }
    atomicAdd(&slot[2 * kClockPhases], 1ull);
    atomicAdd(&slot[2 * kClockPhases + 1], (unsigned long long)(last - first));
    atomicMax(&slot[2 * kClockPhases + 2], (unsigned long long)(last - first));
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ static void use(float) {}
  __device__ __forceinline__ static void use(int) {}
  __device__ __forceinline__ void flush() {}
#endif
};

// The values of one 16-byte load: 4 f32 or 8 bf16.
template <typename T>
constexpr int kPer = 16 / (int)sizeof(T);

// 16 bytes as f32 values: 4 f32, or 8 bf16 widened (bf16 is the high half
// of an f32; element 2j is the low half of word j).
__device__ __forceinline__ void widen16(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void widen16(const uint4& q, float (&v)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// f32 values as 16 bytes of T: 4 f32, or 8 rounded to bf16 (to nearest
// even).
__device__ __forceinline__ uint4 narrow16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 narrow16(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 pr = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const unsigned*>(&pr);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Columns k..k+kPer-1 of a row p of width h as f32, zero past h: one
// 16-byte load with kVec (h a multiple of kPer, the row 16-byte aligned),
// else one load a value.
template <typename T, bool kVec>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, int k,
                                          int h, float (&v)[kPer<T>]) {
  if (kVec) {
    if (k < h) {
      widen16(*reinterpret_cast<const uint4*>(p + k), v);
    } else {
#pragma unroll
      for (int i = 0; i < kPer<T>; ++i) v[i] = 0.0f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer<T>; ++i) v[i] = k + i < h ? to_f32(p[k + i]) : 0.0f;
}

// Edge (blockIdx.x kWarps 32 + threadIdx.x) / kLanes.  An H above
// kPer kLanes kMaxV columns takes further rounds of kV groups.  T: the
// rows' storage, f32 or bf16; the dot sums in f32 either way.
template <typename T, int kV, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_fwd_kernel(const int* __restrict__ parent,
                 const int* __restrict__ child,
                 const unsigned char* __restrict__ mask,
                 const T* __restrict__ u, const T* __restrict__ v,
                 float* __restrict__ out, int b_sz, int n, int e, int h) {
  constexpr int kP = kPer<T>;
  const int lane = threadIdx.x % kLanes;
  const long long edge =
      ((long long)blockIdx.x * kWarps * 32 + threadIdx.x) / kLanes;
  const bool in = edge < (long long)b_sz * e;  // a warp may straddle the end
  bool ok = false;
  const T* up = u;
  const T* vc = v;
  if (in) {
    const int b = (int)(edge / e);
    const int p = parent[edge], c = child[edge];
    ok = mask[edge] != 0 && p >= 0 && p < n && c >= 0 && c < n;
    up += ((size_t)b * n + p) * h;
    vc += ((size_t)b * n + c) * h;
  }
  float acc = 0.0f;
  if (ok) {
    for (int k0 = 0; k0 < h; k0 += kP * kLanes * kV) {
      float a[kV][kP], w[kV][kP];
#pragma unroll
      for (int g = 0; g < kV; ++g) {
        const int k = k0 + kP * (lane + kLanes * g);
        load_cols<T, kVec>(up, k, h, a[g]);
        load_cols<T, kVec>(vc, k, h, w[g]);
      }
#pragma unroll
      for (int g = 0; g < kV; ++g)
#pragma unroll
        for (int i = 0; i < kP; ++i) acc = fmaf(a[g][i], w[g][i], acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kAll, acc, off);
  if (in && lane == 0) out[edge] = acc;
}

// One sentence's lists in the scratch, in ints:
//   start_f [N + 1], start_r [N + 1]   node i's entries are
//                                      [start[i], start[i + 1])
//   ent_f [E] (edge, child), ent_r [E] (edge, parent), as int2, in edge
//   order per node; the slots past the counted edges hold (-1, -1).
__device__ inline size_t list_ints(int n, int e) {
  return 2 * ((size_t)n + 1) + 4 * (size_t)e;
}

// In-place exclusive scan of a[0, len) in shared memory by the whole
// block; warp_sums holds 32 ints.  Every thread calls it; it ends with a
// barrier.
__device__ void block_exclusive_scan(int* a, int len, int* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  int carry = 0;
  for (int base = 0; base < len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < len ? a[i] : 0;
    int x = v;  // inclusive scan within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kAll, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = lane < warps ? warp_sums[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kAll, s, off);
        if (lane >= off) s += y;
      }
      warp_sums[lane] = s;  // inclusive over the warps
    }
    __syncthreads();
    if (i < len)
      a[i] = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    carry += warp_sums[warps - 1];
    __syncthreads();  // before warp_sums is written again
  }
}

__global__ void __launch_bounds__(kBuildThreads)
sddmm_lists_kernel(const int* __restrict__ parent,
                   const int* __restrict__ child,
                   const unsigned char* __restrict__ mask,
                   int* __restrict__ lists, int n, int e) {
  extern __shared__ int cnt[];  // [2][n + 1]: counts, starts, then cursors
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int* pb = parent + (size_t)b * e;
  const int* cb = child + (size_t)b * e;
  const unsigned char* mb = mask + (size_t)b * e;
  int* out = lists + (size_t)b * list_ints(n, e);
  Clock<kClockLists> clk;  // phases: counts, scans, placement
  clk.start();
  for (int i = threadIdx.x; i < 2 * (n + 1); i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    const int p = pb[i], c = cb[i];
    if (mb[i] != 0 && p >= 0 && p < n && c >= 0 && c < n) {
      atomicAdd(&cnt[p], 1);
      atomicAdd(&cnt[n + 1 + c], 1);
    }
  }
  __syncthreads();
  clk.mark(0);
  block_exclusive_scan(cnt, n + 1, warp_sums);
  block_exclusive_scan(cnt + n + 1, n + 1, warp_sums);
  for (int i = threadIdx.x; i < 2 * (n + 1); i += blockDim.x)
    out[i] = cnt[i];
  __syncthreads();  // the starts are read before the cursors move on
  clk.mark(1);

  // warp 0 places the forward list (by parent), warp 1 the reverse one
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 2) {  // no barrier follows
    clk.flush();
    return;
  }
  int* cursor = cnt + warp * (n + 1);
  int2* ent = reinterpret_cast<int2*>(out + 2 * (n + 1)) + (size_t)warp * e;
  const unsigned below = (1u << lane) - 1u;
  auto load = [&](int i, int& key, int& other) {
    key = -1;
    other = -1;
    if (i < e) {
      const int p = pb[i], c = cb[i];
      if (mb[i] != 0 && p >= 0 && p < n && c >= 0 && c < n) {
        key = warp == 0 ? p : c;
        other = warp == 0 ? c : p;
      }
    }
  };
  for (int base = 0; base < e; base += 32 * kSteps) {
    int key[kSteps], other[kSteps];  // kSteps steps' edges, loaded at once
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      load(base + 32 * s + lane, key[s], other[s]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (base + 32 * s >= e) break;
      const unsigned peers = __match_any_sync(kAll, key[s]);
      const int at = key[s] >= 0 ? cursor[key[s]] : 0;
      __syncwarp();  // every peer has read the cursor
      if (key[s] >= 0) {
        ent[at + __popc(peers & below)] =
            make_int2(base + 32 * s + lane, other[s]);
        if (lane == 31 - __clz(peers)) cursor[key[s]] = at + __popc(peers);
      }
      __syncwarp();  // the cursors are up to date for the next step
    }
  }
  for (int k = cursor[n] + lane; k < e; k += 32) ent[k] = make_int2(-1, -1);
  clk.mark(2);
  clk.flush();
}

// One message added to a sum: f32 adds g x by one fmaf; bf16 rounds the
// message g x to bf16 first (the TPU kernel's .astype of gm * v[child]
// before its selection product) and adds it in f32.
template <typename T>
__device__ __forceinline__ float add_msg(float acc, float g, float x);
template <>
__device__ __forceinline__ float add_msg<float>(float acc, float g, float x) {
  return fmaf(g, x, acc);
}
template <>
__device__ __forceinline__ float add_msg<__nv_bfloat16>(float acc, float g,
                                                        float x) {
  return acc + round_to<__nv_bfloat16>(g * x);
}

// du (list 0: the forward lists, through v) or dv (list 1: the reverse
// lists, through u) of one (sentence, node) per warp.  A lane owns
// columns of kP values, kP = kPer<T> where the rows take 16-byte loads
// (kVec: H % kPer == 0, rows aligned), else 1: columns lane and lane + 32
// of each 64-wide block of them.  T: the rows' storage, f32 or bf16; the
// sums run in f32 and round once at the store.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kGatherWarps * 32)
sddmm_gather_kernel(const int* __restrict__ lists,
                    const float* __restrict__ g, const T* __restrict__ u,
                    const T* __restrict__ v, T* __restrict__ du,
                    T* __restrict__ dv, int b_sz, int n, int e, int h) {
  constexpr int kP = kVec ? kPer<T> : 1;
  const long long job =
      (long long)blockIdx.x * kGatherWarps + threadIdx.x / 32;
  if (job >= 2LL * b_sz * n) return;  // no barrier follows
  const int lane = threadIdx.x % 32;
  const int list = (int)(job & 1);
  const long long row = job >> 1;  // b * n + i
  const int b = (int)(row / n), i = (int)(row % n);
  const int* L = lists + (size_t)b * list_ints(n, e);
  // phases: index loads, row loads and adds, store
  Clock<sizeof(T) == 4 ? kClockGatherF32 : kClockGatherBf16> clk;
  clk.start();
  const int k0 = L[list * (n + 1) + i], k1 = L[list * (n + 1) + i + 1];
  clk.use(k0);
  clk.use(k1);
  clk.mark(0);
  const int2* ent = reinterpret_cast<const int2*>(L + 2 * (n + 1)) +
                    (size_t)list * e;
  const float* gb = g + (size_t)b * e;
  const int hv = h / kP;  // column groups of a row
  const T* src = (list ? u : v) + (size_t)b * n * h;
  T* dst = (list ? dv : du) + (size_t)row * h;
  auto load = [&](const T* r, int c, float (&x)[kP]) {
    if constexpr (kVec) {
      widen16(*reinterpret_cast<const uint4*>(r + c * kP), x);
    } else {
      x[0] = to_f32(r[c]);
    }
  };
  for (int c0 = 0; c0 < hv; c0 += 64) {
    const int ca = c0 + lane, cb = c0 + 32 + lane;
    float sa[kP], sb[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) sa[q] = sb[q] = 0.0f;
    for (int k = k0; k < k1; k += 32) {
      // up to 32 entries at a time: lane j holds entry k + j and its g
      const int cnt = min(32, k1 - k);
      const int2 en = lane < cnt ? ent[k + lane] : make_int2(0, 0);
      const float gl = lane < cnt ? gb[en.x] : 0.0f;
      clk.use(gl);
      clk.use(en.y);
      clk.mark(0);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float gj = __shfl_sync(kAll, gl, j);
        const T* r = src + (size_t)__shfl_sync(kAll, en.y, j) * h;
        float x[kP];
        if (ca < hv) {
          load(r, ca, x);
#pragma unroll
          for (int q = 0; q < kP; ++q) sa[q] = add_msg<T>(sa[q], gj, x[q]);
        }
        if (cb < hv) {
          load(r, cb, x);
#pragma unroll
          for (int q = 0; q < kP; ++q) sb[q] = add_msg<T>(sb[q], gj, x[q]);
        }
      }
      clk.mark(1);
    }
    if constexpr (kVec) {
      if (ca < hv) *reinterpret_cast<uint4*>(dst + ca * kP) = narrow16(sa);
      if (cb < hv) *reinterpret_cast<uint4*>(dst + cb * kP) = narrow16(sb);
    } else {
      if (ca < hv) dst[ca] = from_f32<T>(sa[0]);
      if (cb < hv) dst[cb] = from_f32<T>(sb[0]);
    }
    clk.mark(2);
  }
  clk.flush();
}

// ------------------------------------------------------------------ 10b
//
// sddmm_bwd_bf16_kernel: du and dv of bf16 u, v in one launch, with no
// list in device memory.  Block x of sentence b takes the nodes [i0, i0 +
// r) (r at most `nodes`, set by the launcher so that every block fits the
// card at once) and both lists' rows of them: local row k < r is du[b, i0
// + k] (the counted edges with parent i0 + k, through v[child]), row r +
// k is dv[b, i0 + k] (child i0 + k, through u[parent]).  Every block reads
// the whole sentence's edges, from L2 after the first.
//  1. The edges, `window` at a time, staged in shared memory: warp w loads
//     a run of the window's 32-edge steps (kStageSteps at once): parent
//     and child (-1 where the edge does not count) and g.
//  2. Counts: the same warp counts each local row's edges of its steps in
//     its own counters cnt[w][row] (shared atomics on counters no other
//     warp touches), with no barrier between.
//  3. The rows' totals (kRowsPer rows a thread, the counts loaded before
//     the first add), scanned: row j's entries are [start[j], start[j +
//     1]) of the block's list.  Offsets: cnt[w][row] becomes the place of
//     warp w's first edge of the row, the row's start plus the earlier
//     warps' counts; so a row's entries keep edge order across warps.
//  4. Placement by every warp over its own steps: an edge's same-row peers
//     in the step come from ballots over the bits of its row, its place
//     is the warp's cursor plus the peers below it.  An entry is (g,
//     neighbour | row << 16).
//  5. Rows with no entry: zeros, 16 bytes a lane, warps round the rows,
//     before the placement (which needs shared memory only while they
//     drain).
//  6. Gather: warp w takes the rows whose entries start in its eighth of
//     the block's entries (found by ballots over 32 probes of the starts)
//     and walks them kQueue entries at a time: lane c issues its 16-byte
//     loads (columns 8c..8c+7) of the kQueue rows together, then adds
//     their messages in order, storing a row's sum when the next entry
//     belongs to another row.
// Shapes past shared memory: windows of `window` edges, steps 1-4 over
// each in turn (the cursors carried on), and the rows in passes of at most
// `cap` entries; a row with more entries than that alone, in parts, warp 0
// carrying its sums from part to part.  Columns past 32 groups take further
// rounds.  Each row's messages g x are rounded to bf16 and summed in f32
// in edge order from zero, then rounded once: the bits of the two-kernel
// route that kernel 10 keeps in f32.
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kRowsPer = 2;           // local rows a thread scans
constexpr int kMaxRows = kRowsPer * kBwdThreads;  // local rows a block
constexpr int kWindow = 2048;          // edges staged at a time at most
constexpr int kMaxEntries = 4096;      // list entries held at a time at most
constexpr int kQueue = 8;  // row loads a lane has in flight
// blocks an SM: the registers' bound (two at 256 threads leave 128 a
// thread, where the kernel spills none; at three or four it spilled and
// ran slower)
constexpr int kBwdMinBlocks = 2;
// blocks a launch at most: two an SM of the H100's 132, so that the whole
// grid runs at once
constexpr int kWaveBlocks = 264;
constexpr int kStageSteps = 4;  // 32-edge steps a warp loads at once

// The lanes of the warp whose key equals this lane's, for keys below
// 2^bits: a ballot a bit (__match_any_sync timed slower).
__device__ __forceinline__ unsigned peers_of(unsigned key, int bits) {
  unsigned peers = kAll;
  for (int i = 0; i < bits; ++i) {
    const unsigned ones = __ballot_sync(kAll, key >> i & 1u);
    peers &= key >> i & 1u ? ones : ~ones;
  }
  return peers;
}

// Dynamic shared memory of a block: ent [cap] int2, then edge parents,
// children [window] int, g [window] f32, cnt [kBwdWarps][rows],
// start [rows + 1], cursor [rows] int.
size_t bwd_smem(int rows, int window, int cap) {
  return 8 * (size_t)cap +
         4 * (3 * (size_t)window + (kBwdWarps + 2) * (size_t)rows + 1);
}

template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
sddmm_bwd_bf16_kernel(const int* __restrict__ parent,
                      const int* __restrict__ child,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ g,
                      const __nv_bfloat16* __restrict__ u,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ du,
                      __nv_bfloat16* __restrict__ dv, int n, int e, int h,
                      int nodes, int window, int cap) {
  using T = __nv_bfloat16;
  constexpr int kP = kVec ? kPer<T> : 1;  // columns a lane's load
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  __shared__ int warp_sums[kBwdWarps];
  const int per = (n + nodes - 1) / nodes;  // blocks a sentence
  const int b = blockIdx.x / per, i0 = (blockIdx.x % per) * nodes;
  const int r = min(nodes, n - i0), rows = 2 * r;
  int2* ent = reinterpret_cast<int2*>(bwd_smem_raw);
  int* ep = reinterpret_cast<int*>(ent + cap);
  int* ec = ep + window;
  float* eg = reinterpret_cast<float*>(ec + window);
  int* cnt = reinterpret_cast<int*>(eg + window);  // [kBwdWarps][rows]
  int* start = cnt + kBwdWarps * rows;             // [rows + 1]
  int* cursor = start + rows + 1;                  // [rows]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = kRowsPer * threadIdx.x;  // the local rows a thread scans
  const unsigned below = (1u << lane) - 1u;
  const int* pb = parent + (size_t)b * e;
  const int* cb = child + (size_t)b * e;
  const unsigned char* mb = mask + (size_t)b * e;
  const float* gb = g + (size_t)b * e;
  const T* ub = u + (size_t)b * n * h;  // the sentence's rows
  const T* vb = v + (size_t)b * n * h;
  int* mine = cnt + warp * rows;  // this warp's counters, then cursors
  // phases (tools/sddmm_phases.py names them): 0-1 staging and counts,
  // 2-5 the scan, 6 placement, 7 zero rows, 8 its barrier, 9 the gather,
  // 10 its stores
  Clock<kClockBwdBf16> clk;
  clk.start();

  // the local row of an edge (p, c; -1 where it does not count) in list
  // 0 (du, by parent) or 1 (dv, by child); -1 outside the block's nodes
  auto row_of = [&](int list, int p, int c) {
    const int key = list ? c : p;
    return key >= i0 && key < i0 + r ? list * r + key - i0 : -1;
  };
  // warp's run [s0, s1) of a window's 32-edge steps
  int s0 = 0, s1 = 0;
  auto steps_of = [&](int len) {
    const int steps = (len + 31) / 32;
    const int each = (steps + kBwdWarps - 1) / kBwdWarps;
    s0 = min(steps, warp * each);
    s1 = min(steps, s0 + each);
  };
  // 1-2. the warp's own steps of window w0 staged and counted; no other
  // warp reads them before the next barrier.
  auto stage_count = [&](int w0, int len) {
    steps_of(len);
    for (int k = lane; k < rows; k += 32) mine[k] = 0;
    __syncwarp();
    for (int s = s0; s < s1; s += kStageSteps) {
      int p[kStageSteps], c[kStageSteps];
      float gs[kStageSteps];
      bool ok[kStageSteps];
#pragma unroll
      for (int q = 0; q < kStageSteps; ++q) {
        const int i = 32 * (s + q) + lane;
        ok[q] = s + q < s1 && i < len;
        if (ok[q]) {
          p[q] = pb[w0 + i];
          c[q] = cb[w0 + i];
          ok[q] = mb[w0 + i] != 0;
          gs[q] = gb[w0 + i];
        }
      }
#pragma unroll
      for (int q = 0; q < kStageSteps; ++q) {
        const int i = 32 * (s + q) + lane;
        if (s + q < s1 && i < len) {
          const bool in = ok[q] && p[q] >= 0 && p[q] < n && c[q] >= 0 &&
                          c[q] < n;
          ep[i] = in ? p[q] : -1;
          ec[i] = in ? c[q] : -1;
          eg[i] = gs[q];
          const int r0 = in ? row_of(0, p[q], c[q]) : -1;
          const int r1 = in ? row_of(1, p[q], c[q]) : -1;
          if (r0 >= 0) atomicAdd(&mine[r0], 1);
          if (r1 >= 0) atomicAdd(&mine[r1], 1);
        }
      }
    }
    clk.mark(0);
    __syncthreads();
    clk.mark(1);
  };
  // 4. the entries whose places fall in [t0, t1), into ent; mine holds the
  // warp's cursors.  A row's peers in a step come from ballots over the
  // bits of its local row (bits of them; 2^bits - 1, no row, where the
  // edge has none).
  const int bits = 32 - __clz(rows);
  const unsigned none = (1u << bits) - 1u;
  auto place = [&](int len, int t0, int t1) {
    steps_of(len);
    for (int s = s0; s < s1; ++s) {
      const int i = 32 * s + lane;
      int p = -1, c = -1;
      float gi = 0.0f;
      if (i < len) {
        p = ep[i];
        c = ec[i];
        gi = eg[i];
      }
      // the two lists' rows are apart: one pass for both
      const int r0 = row_of(0, p, c), r1 = row_of(1, p, c);
      const unsigned m0 = peers_of(r0 >= 0 ? r0 : none, bits);
      const unsigned m1 = peers_of(r1 >= 0 ? r1 : none, bits);
      const int a0 = r0 >= 0 ? mine[r0] : 0;
      const int a1 = r1 >= 0 ? mine[r1] : 0;
      __syncwarp();  // every peer has read the cursors
      if (r0 >= 0) {
        const int k = a0 + __popc(m0 & below);
        if (k >= t0 && k < t1)
          ent[k - t0] = make_int2(__float_as_int(gi), c | r0 << 16);
        if (lane == 31 - __clz(m0)) mine[r0] = a0 + __popc(m0);
      }
      if (r1 >= 0) {
        const int k = a1 + __popc(m1 & below);
        if (k >= t0 && k < t1)
          ent[k - t0] = make_int2(__float_as_int(gi), p | r1 << 16);
        if (lane == 31 - __clz(m1)) mine[r1] = a1 + __popc(m1);
      }
      __syncwarp();  // the cursors are up to date for the next step
    }
    clk.mark(6);
  };

  const int hv = h / kP;  // a row's column groups
  T* dub = du + ((size_t)b * n + i0) * h;  // the block's rows
  T* dvb = dv + ((size_t)b * n + i0) * h;
  auto row_ptr = [&](int row) {
    return row < r ? dub + (size_t)row * h : dvb + (size_t)(row - r) * h;
  };
  // 3. every window counted; the rows' totals scanned into starts.  With
  // one window its counts become the warps' offsets at once.
  const bool one_window = e <= window;
  int total[kRowsPer] = {};  // the thread's rows' entries
  int before[kRowsPer][kBwdWarps];  // and the earlier warps' counts
  for (int w0 = 0; w0 < e; w0 += window) {
    if (w0 > 0) __syncthreads();  // the last window's counts are read
    stage_count(w0, min(window, e - w0));
    int k[kRowsPer][kBwdWarps];  // every load before the first add
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q)
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w)
        k[q][w] = j0 + q < rows ? cnt[w * rows + j0 + q] : 0;
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q)
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) {
        before[q][w] = total[q];
        total[q] += k[q][w];
      }
  }
  {
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q) sum += total[q];
    int x = sum;  // inclusive scan within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kAll, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    clk.mark(2);
    __syncthreads();
    clk.mark(3);
    int at = x - sum;
#pragma unroll
    for (int w = 0; w < kBwdWarps - 1; ++w)
      if (w < warp) at += warp_sums[w];
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q) {
      const int row = j0 + q;
      if (row < rows) {
        start[row] = at;
        if (row == rows - 1) start[rows] = at + total[q];
        if (one_window)  // the window's offsets
#pragma unroll
          for (int w = 0; w < kBwdWarps; ++w)
            cnt[w * rows + row] = at + before[q][w];
      }
      at += total[q];
    }
    clk.mark(4);
    __syncthreads();
    clk.mark(5);
  }

  // 5. rows with no entry: zeros, 16 bytes a lane, warps round the rows;
  // before the placement, which needs shared memory only while they drain
  auto zero_rows = [&]() {
    for (int row = warp; row < rows; row += kBwdWarps) {
      if (start[row + 1] != start[row]) continue;
      T* dst = row_ptr(row);
      for (int c = lane; c < hv; c += 32) {
        if constexpr (kVec) {
          *reinterpret_cast<uint4*>(dst + kP * c) = make_uint4(0, 0, 0, 0);
        } else {
          dst[c] = from_f32<T>(0.0f);
        }
      }
    }
    clk.mark(7);
  };

  // 6. the gather, in passes over the rows and rounds over the columns
  float acc[kP];
  int cur = -1;  // the row acc sums, -1 before the first
  int c = lane;  // the lane's column group in this round
  auto store = [&](int row) {
    clk.mark(9);
    if (c < hv) {
      if constexpr (kVec) {
        *reinterpret_cast<uint4*>(row_ptr(row) + kP * c) = narrow16(acc);
      } else {
        row_ptr(row)[c] = from_f32<T>(acc[0]);
      }
    }
    clk.mark(10);
  };
  // entries [s, s_end) of the pass that starts at t0, kQueue at a time:
  // the queue's row loads first, then its adds in order
  auto walk = [&](int s, int s_end, int t0) {
    for (int k = s; k < s_end; k += kQueue) {
      uint4 q[kQueue];
      float x1[kQueue];
#pragma unroll
      for (int i = 0; i < kQueue; ++i) {
        if (k + i < s_end && c < hv) {
          const int2 en = ent[k + i - t0];
          const T* src =
              ((en.y >> 16) >= r ? ub : vb) + (size_t)(en.y & 0xffff) * h;
          if constexpr (kVec) {
            q[i] = *reinterpret_cast<const uint4*>(src + kP * c);
          } else {
            x1[i] = to_f32(src[c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kQueue; ++i) {
        if (k + i >= s_end) break;
        const int2 en = ent[k + i - t0];
        const int row = en.y >> 16;
        if (row != cur) {
          if (cur >= 0) store(cur);
          cur = row;
#pragma unroll
          for (int m = 0; m < kP; ++m) acc[m] = 0.0f;
        }
        if (c < hv) {
          float x[kP];
          if constexpr (kVec) {
            widen16(q[i], x);
          } else {
            x[0] = x1[i];
          }
#pragma unroll
          for (int m = 0; m < kP; ++m)
            acc[m] = add_msg<T>(acc[m], __int_as_float(en.x), x[m]);
        }
      }
    }
    clk.mark(9);
  };
  // the first row in [lo, hi] with start >= x (start[hi] >= x), by the
  // whole warp, 32 probes a round: each round keeps the step between the
  // first probe that holds and the one before
  auto find = [&](int lo, int hi, int x) {
    while (lo < hi) {
      const int step = (hi - lo + 32) / 32;
      const int at = min(hi, lo + step * (lane + 1) - 1);
      const unsigned holds = __ballot_sync(kAll, start[at] >= x);
      const int f = __ffs(holds) - 1;  // holds at hi: f exists
      const int top = min(hi, lo + step * (f + 1) - 1);
      lo = f == 0 ? lo : min(hi, lo + step * f - 1) + 1;
      hi = top;
    }
    return lo;
  };
  const int entries = start[rows];
  const bool one_pass = entries <= cap;
  bool fresh = one_window;  // cnt holds the one window's offsets
  bool placed = false;      // ent holds the whole list (one pass)
  zero_rows();
  for (int c0 = 0; c0 < hv; c0 += 32) {
    c = c0 + lane;
    for (int ra = 0; ra < rows && start[ra] < entries;) {
      // rows [ra, rb) of at most cap entries, or row ra alone in parts
      int rb = start[rows] <= start[ra] + cap
                   ? rows
                   : find(ra, rows, start[ra] + cap + 1) - 1;
      const bool parts = rb == ra;
      if (parts) rb = ra + 1;
      for (int t0 = start[ra]; t0 < start[rb]; t0 += cap) {
        const int t1 = min(t0 + cap, start[rb]);
        if (!(one_pass && placed)) {
          if (fresh) {
            place(e, t0, t1);
            fresh = false;
          } else {
            for (int q = 0; q < kRowsPer; ++q)
              if (j0 + q < rows) cursor[j0 + q] = start[j0 + q];
            for (int w0 = 0; w0 < e; w0 += window) {
              const int len = min(window, e - w0);
              stage_count(w0, len);
              for (int q = 0; q < kRowsPer; ++q) {
                const int row = j0 + q;
                if (row >= rows) break;
                int t = cursor[row];  // offsets: cursor plus the earlier
                for (int w = 0; w < kBwdWarps; ++w) {  // warps' counts
                  const int k = cnt[w * rows + row];
                  cnt[w * rows + row] = t;
                  t += k;
                }
                cursor[row] = t;
              }
              __syncthreads();
              place(len, t0, t1);
              __syncthreads();  // before the next window is staged
            }
          }
          placed = true;
          __syncthreads();
          clk.mark(8);
        }
        if (parts) {  // warp 0 carries the row's sums from part to part
          if (warp == 0) {
            if (t0 == start[ra]) cur = -1;
            walk(t0, t1, t0);
            if (t1 == start[rb]) {
              store(cur);
              cur = -1;
            }
          }
        } else {  // warp w: the rows that start in its share of [t0, t1)
          const long long span = t1 - t0;
          const int s = start[find(ra, rb, t0 + (int)(span * warp /
                                                     kBwdWarps))];
          const int s_end = start[find(
              ra, rb, t0 + (int)(span * (warp + 1) / kBwdWarps))];
          cur = -1;
          walk(s, s_end, t0);
          if (cur >= 0) store(cur);
        }
        __syncthreads();  // ent is read before the next pass writes it
      }
      ra = rb;
    }
  }
  clk.flush();
}

int launch_lists(const void* parent, const void* child, const void* mask,
                 void* lists, int b, int n, int e, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * ((size_t)n + 1);
  if (smem > kMaxSmem - 32 * sizeof(int)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sddmm_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sddmm_lists_kernel<<<b, kBuildThreads, smem, stream>>>(
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<int*>(lists), n,
      e);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T>
int forward(const void* parent, const void* child, const void* mask,
            const void* u, const void* v, void* out, int b, int n, int e,
            int h, void* stream) {
  constexpr int kP = kPer<T>;
  const long long edges = (long long)b * e;
  constexpr int kEdges = kWarps * 32 / kLanes;  // a block's
  const long long blocks = (edges + kEdges - 1) / kEdges;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = h % kP == 0 && aligned16(u) && aligned16(v);
  const int groups = (h + kP * kLanes - 1) / (kP * kLanes);
  const int kv = groups < kMaxV ? groups : kMaxV;
  auto run = [&](auto kernel) {
    kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        static_cast<const int*>(parent), static_cast<const int*>(child),
        static_cast<const unsigned char*>(mask), static_cast<const T*>(u),
        static_cast<const T*>(v), static_cast<float*>(out), b, n, e, h);
    return (int)cudaGetLastError();
  };
  static_assert(kMaxV == 4, "one instance per kV below");
  if (vec)
    return kv <= 1   ? run(sddmm_fwd_kernel<T, 1, true>)
           : kv == 2 ? run(sddmm_fwd_kernel<T, 2, true>)
           : kv == 3 ? run(sddmm_fwd_kernel<T, 3, true>)
                     : run(sddmm_fwd_kernel<T, 4, true>);
  return kv <= 1   ? run(sddmm_fwd_kernel<T, 1, false>)
         : kv == 2 ? run(sddmm_fwd_kernel<T, 2, false>)
         : kv == 3 ? run(sddmm_fwd_kernel<T, 3, false>)
                   : run(sddmm_fwd_kernel<T, 4, false>);
}

// 10b: one launch of sddmm_bwd_bf16_kernel; no scratch.
int backward_bf16(const void* parent, const void* child, const void* mask,
                  const void* g, const void* u, const void* v, void* du,
                  void* dv, int b, int n, int e, int h, void* stream) {
  // nodes a block: at most kWaveBlocks blocks (one wave), at most
  // kMaxRows / 2 nodes
  const int per = b < kWaveBlocks ? kWaveBlocks / b : 1;
  const int want = (n + per - 1) / per;
  const int nodes = want < kMaxRows / 2 ? (want > 0 ? want : 1)
                                        : kMaxRows / 2;
  const long long blocks = (long long)b * ((n + nodes - 1) / nodes);
  if (blocks > 0x7fffffffLL || n >= (1 << 16))
    return (int)cudaErrorInvalidValue;
  const int window = e < kWindow ? (e > 0 ? e : 1) : kWindow;
  const long long twice = 2LL * e;
  const int cap = twice < kMaxEntries ? (twice > 0 ? (int)twice : 1)
                                      : kMaxEntries;
  const size_t smem = bwd_smem(2 * nodes, window, cap);
  const bool vec = h % kPer<__nv_bfloat16> == 0 && aligned16(u) &&
                   aligned16(v) && aligned16(du) && aligned16(dv);
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)blocks, kBwdThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const int*>(parent), static_cast<const int*>(child),
        static_cast<const unsigned char*>(mask), static_cast<const float*>(g),
        static_cast<const __nv_bfloat16*>(u),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(du), static_cast<__nv_bfloat16*>(dv), n,
        e, h, nodes, window, cap);
    return (int)cudaGetLastError();
  };
  return vec ? run(sddmm_bwd_bf16_kernel<true>)
             : run(sddmm_bwd_bf16_kernel<false>);
}

// Kernel 10 (f32): the lists into the scratch, then du and dv from them.
template <typename T>
int backward(const void* parent, const void* child, const void* mask,
             const void* g, const void* u, const void* v, void* du, void* dv,
             void* lists, int b, int n, int e, int h, void* stream) {
  const long long blocks =
      (2LL * b * n + kGatherWarps - 1) / kGatherWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_lists(parent, child, mask, lists, b, n, e, st);
  if (err != 0) return err;
  const bool vec = h % kPer<T> == 0 && aligned16(u) && aligned16(v) &&
                   aligned16(du) && aligned16(dv);
  auto run = [&](auto kernel) {
    kernel<<<(unsigned)blocks, kGatherWarps * 32, 0, st>>>(
        static_cast<const int*>(lists), static_cast<const float*>(g),
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<T*>(du), static_cast<T*>(dv), b, n, e, h);
    return (int)cudaGetLastError();
  };
  return vec ? run(sddmm_gather_kernel<T, true>)
             : run(sddmm_gather_kernel<T, false>);
}

}  // namespace

extern "C" {

int sddmm_forward_f32(const void* parent, const void* child,
                      const void* mask, const void* u, const void* v,
                      void* out, int b, int n, int e, int h, void* stream) {
  return forward<float>(parent, child, mask, u, v, out, b, n, e, h, stream);
}

int sddmm_forward_bf16(const void* parent, const void* child,
                       const void* mask, const void* u, const void* v,
                       void* out, int b, int n, int e, int h, void* stream) {
  return forward<__nv_bfloat16>(parent, child, mask, u, v, out, b, n, e, h,
                                stream);
}

// The lists alone, into lists [B, list_ints(N, E)] (the scratch that
// sddmm_backward_{f32,bf16} take too).
int sddmm_lists_i32(const void* parent, const void* child, const void* mask,
                    void* lists, int b, int n, int e, void* stream) {
  return launch_lists(parent, child, mask, lists, b, n, e,
                     (cudaStream_t)stream);
}

int sddmm_backward_f32(const void* parent, const void* child,
                       const void* mask, const void* g, const void* u,
                       const void* v, void* du, void* dv, void* lists, int b,
                       int n, int e, int h, void* stream) {
  return backward<float>(parent, child, mask, g, u, v, du, dv, lists, b, n,
                         e, h, stream);
}

int sddmm_backward_bf16(const void* parent, const void* child,
                        const void* mask, const void* g, const void* u,
                        const void* v, void* du, void* dv, void* lists,
                        int b, int n, int e, int h, void* stream) {
  return backward_bf16(parent, child, mask, g, u, v, du, dv, b, n, e, h,
                       stream);
}

const char* sddmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef SDDMM_PHASES
// The phase slots, [kClockKernels][kClockBlocks][kClockSlots], read and
// zeroed by tools/sddmm_phases.py.
int sddmm_phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, sddmm_phases, sizeof(sddmm_phases));
}
int sddmm_phases_zero() {
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, sddmm_phases);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(at, 0, sizeof(sddmm_phases));
}
#endif

}  // extern "C"
