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
// The backward is a per-node sum over the node's own edges, in two
// kernels launched by one entry point:
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
  block_exclusive_scan(cnt, n + 1, warp_sums);
  block_exclusive_scan(cnt + n + 1, n + 1, warp_sums);
  for (int i = threadIdx.x; i < 2 * (n + 1); i += blockDim.x)
    out[i] = cnt[i];
  __syncthreads();  // the starts are read before the cursors move on

  // warp 0 places the forward list (by parent), warp 1 the reverse one
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 2) return;  // no barrier follows
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
  const int k0 = L[list * (n + 1) + i], k1 = L[list * (n + 1) + i + 1];
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
    }
    if constexpr (kVec) {
      if (ca < hv) *reinterpret_cast<uint4*>(dst + ca * kP) = narrow16(sa);
      if (cb < hv) *reinterpret_cast<uint4*>(dst + cb * kP) = narrow16(sb);
    } else {
      if (ca < hv) dst[ca] = from_f32<T>(sa[0]);
      if (cb < hv) dst[cb] = from_f32<T>(sb[0]);
    }
  }
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

// The lists into the scratch, then du and dv from them.
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
  return backward<__nv_bfloat16>(parent, child, mask, g, u, v, du, dv, lists,
                                 b, n, e, h, stream);
}

const char* sddmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
