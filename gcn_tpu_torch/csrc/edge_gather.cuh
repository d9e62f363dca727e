// Neighbour-row sums straight from one sentence's padded edge list, found
// by warp ballots: the gather of the fused GCN layer and its sym pair
// (spmm_fused.cu) and of the band aggregation and its pair
// (band_aggregate.cu).
//
//   parent, child  [E] int32   edge p -> c
//   mask           [E] uint8   0 = padded slot
// An edge counts when its mask is set and both ends lie in [0, N); a
// duplicated edge counts twice, an edge with an end outside is dropped
// whole (the TPU kernels' one-hot band build drops it too).
//
// A block loads the sentence's edge slots into shared memory once
// (load_edges: ep, ec, an edge's parent and child, -1 for a slot that
// does not count).  A warp then finds its rows' neighbours by ballots over
// 32 slots at a time: the set bits of ballot(ep[q] == i) are row i's
// forward neighbours (its children) in edge order, those of
// ballot(ec[q] == i) its reverse ones (its parents).  Each row so sums its
// forward neighbours in edge order, then its reverse ones: the order a
// stable sort of the edges by node gives, with no list build, no scan and
// no float atomics, so every run gives the same bits.  The ballots'
// popcounts are the row's degree, deg_out + deg_in.  They cost
// ceil(E / 32) steps a row and direction, against O(E) for a list build:
// fewer at a sentence's E, where the build's scan and placement were the
// serial part of every block.
//
// A lane covers 4 columns of each 128 (kV groups: 128 kV columns a warp),
// by 16-byte non-coherent loads where the operand allows.  A warp walks one
// row (gather_row: several of its neighbour loads in flight at once;
// gather_pair: the same walk with the two directions summed apart) or
// several in lockstep (gather_rows: one load of every row at a time).
//
// Rows are f32 or bf16 (load4 / store4 are typed on the storage): a bf16
// lane loads its 4 columns as one 8-byte load and widens them with
// __bfloat162float, so every sum runs in f32 whatever the storage, and a
// bf16 store rounds once, to nearest even (__float2bfloat16_rn, as
// PyTorch's and JAX's casts round).  The bf16 rows keep the f32 rows' lane
// map (4 columns of each 128 a lane), so one kernel body serves both types
// and a warp still reads 256 contiguous bytes a row and group; 8 columns
// a 16-byte load would halve the loads but change the map.
//
// The bf16 band forward (5b) and the bf16 sym pair (8b) have kernels of
// their own on the second half of this file: a warp walks all its row's
// ballot steps first (walk_each), queueing the neighbours in summing
// order (Queue: kB entries in registers), and then issues the queued
// rows' loads together and adds them in list order (gather_groups), so
// that a row of up to kB neighbours waits on one round trip for them
// instead of one a ballot step that found one; a row wider than a warp's
// 32 chunks takes its groups one after another, so that a lane's
// registers do not grow with the width.  Their lanes take chunks of 8
// bf16 columns, one 16-byte load each (Chunks<8>), where the widths are
// multiples of 8 and the bases 16-byte aligned; other shapes take chunks
// of 4 (Chunks<4>: the map above).  Their edge slots load 4 a thread
// where the lists allow (load_edges_wide), and their own row's values are
// loaded before that barrier.  (A list placed one entry a lane by each
// ballot step and loads issued as the walk found the neighbours were
// both timed slower: PERF.md §6.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace edge_gather {

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

// Dynamic shared memory of a sentence's edge slots (ep, ec), rounded up to
// 16 bytes so that tiles may follow.
inline size_t edges_bytes(int e) { return (8 * (size_t)e + 15) / 16 * 16; }

// A launch's `dynamic` bytes beside the kernel's `fixed` static tiles:
// above the default 48 KB it needs the kernel's opt-in.
template <typename K>
cudaError_t set_smem(K kernel, size_t dynamic, size_t fixed) {
  if (dynamic + fixed > kMaxSmem) return cudaErrorInvalidValue;
  if (dynamic + fixed <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dynamic);
}

// Loads a sentence's edge slots into ep, ec [e]; ends with a barrier.
__device__ __forceinline__ void load_edges(
    const int* __restrict__ parent, const int* __restrict__ child,
    const unsigned char* __restrict__ mask, int n, int e, int* ep, int* ec) {
  for (int q = threadIdx.x; q < e; q += blockDim.x) {
    const int p = parent[q], c = child[q];
    const bool ok = mask[q] != 0 && p >= 0 && p < n && c >= 0 && c < n;
    ep[q] = ok ? p : -1;
    ec[q] = ok ? c : -1;
  }
  __syncthreads();
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void add4(float4& v, const float4& u) {
  v.x += u.x;
  v.y += u.y;
  v.z += u.z;
  v.w += u.w;
}

// Four bf16 values, one 8-byte load or store.
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

// An f32 value in the storage type T: itself, or rounded to bf16.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to the storage type T and widened back: what a store and a
// reload of it would give.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Bytes a kVec load or store of 4 columns reads or writes: the alignment
// its operand needs.
template <typename T>
constexpr int vec_bytes() {
  return 4 * (int)sizeof(T);
}

// Columns k..k+3 of row r of x (rows of width t), as f32, zero past t: one
// 16-byte (f32) or 8-byte (bf16) load with kVec (t a multiple of 4, x
// aligned to vec_bytes<T>()), else four of one value each; through the
// non-coherent path (LDG.CONSTANT), x being const __restrict__ (an
// explicit __ldg timed slower in the lockstep walk).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int r,
                                        int k, int t) {
  const float* p = x + (size_t)r * t + k;
  if (kVec)
    return k < t ? *reinterpret_cast<const float4*>(p) : zero4();
  return make_float4(k < t ? p[0] : 0.0f, k + 1 < t ? p[1] : 0.0f,
                     k + 2 < t ? p[2] : 0.0f, k + 3 < t ? p[3] : 0.0f);
}

template <bool kVec>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ x,
                                        int r, int k, int t) {
  const __nv_bfloat16* p = x + (size_t)r * t + k;
  if (kVec) {
    if (k >= t) return zero4();
    const bf16x4 q = *reinterpret_cast<const bf16x4*>(p);
    return make_float4(__bfloat162float(q.lo.x), __bfloat162float(q.lo.y),
                       __bfloat162float(q.hi.x), __bfloat162float(q.hi.y));
  }
  return make_float4(k < t ? __bfloat162float(p[0]) : 0.0f,
                     k + 1 < t ? __bfloat162float(p[1]) : 0.0f,
                     k + 2 < t ? __bfloat162float(p[2]) : 0.0f,
                     k + 3 < t ? __bfloat162float(p[3]) : 0.0f);
}

// Stores v to columns k..k+3 of row r of x (rows of width t), none past t;
// a bf16 row takes each value rounded to nearest even.
template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ x, int r, int k,
                                       int t, const float4& v) {
  float* p = x + (size_t)r * t + k;
  if (kVec) {
    if (k < t) *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (k < t) p[0] = v.x;
  if (k + 1 < t) p[1] = v.y;
  if (k + 2 < t) p[2] = v.z;
  if (k + 3 < t) p[3] = v.w;
}

template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ x, int r,
                                       int k, int t, const float4& v) {
  __nv_bfloat16* p = x + (size_t)r * t + k;
  if (kVec) {
    if (k < t) {
      bf16x4 q;
      q.lo = __floats2bfloat162_rn(v.x, v.y);
      q.hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<bf16x4*>(p) = q;
    }
    return;
  }
  if (k < t) p[0] = __float2bfloat16_rn(v.x);
  if (k + 1 < t) p[1] = __float2bfloat16_rn(v.y);
  if (k + 2 < t) p[2] = __float2bfloat16_rn(v.z);
  if (k + 3 < t) p[3] = __float2bfloat16_rn(v.w);
}

// Adds to v[u] the neighbour rows of the warp's row `row` and returns
// their count: the forward neighbours first, then the reverse ones, each
// in edge order.  src(dir, r, u) gives the lane's 4 columns of group u of
// neighbour row r (dir 0 forward, 1 reverse).  Every lane of the warp
// calls it with the same row.  A step's set bits are walked by a counted
// loop that the compiler unrolls, so that several of the row's neighbour
// loads are in flight at once: one row may have hundreds.
template <int kV, typename Src>
__device__ __forceinline__ int gather_row(const int* __restrict__ ep,
                                          const int* __restrict__ ec, int e,
                                          int row, Src&& src,
                                          float4 (&v)[kV]) {
  const int lane = threadIdx.x % 32;
  int nd = 0;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const int* key = dir == 0 ? ep : ec;
    const int* nbr = dir == 0 ? ec : ep;
    for (int q0 = 0; q0 < e; q0 += 32) {
      const int kq = q0 + lane < e ? key[q0 + lane] : -1;
      unsigned bits = __ballot_sync(0xffffffffu, kq == row);
      const int cnt = __popc(bits);
      nd += cnt;
#pragma unroll 4
      for (int m = 0; m < cnt; ++m) {
        const int nb = nbr[q0 + __ffs(bits) - 1];
        bits &= bits - 1;
#pragma unroll
        for (int u = 0; u < kV; ++u) add4(v[u], src(dir, nb, u));
      }
    }
  }
  return nd;
}

// gather_row's walk with the two directions summed apart: the forward
// neighbours (the row's children) into vf, the reverse ones (its parents)
// into vr, each in edge order.  A copy of the walk, not a walk shared
// with gather_row: one walk per direction called twice changed
// gather_row's register allocation (the band forward lost its spill, the
// sym pair's kV = 3 instance gained one and ran 9 % slower).
template <int kV, typename Src>
__device__ __forceinline__ void gather_pair(const int* __restrict__ ep,
                                            const int* __restrict__ ec, int e,
                                            int row, Src&& src,
                                            float4 (&vf)[kV],
                                            float4 (&vr)[kV]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const int* key = dir == 0 ? ep : ec;
    const int* nbr = dir == 0 ? ec : ep;
    float4(&v)[kV] = dir == 0 ? vf : vr;
    for (int q0 = 0; q0 < e; q0 += 32) {
      const int kq = q0 + lane < e ? key[q0 + lane] : -1;
      unsigned bits = __ballot_sync(0xffffffffu, kq == row);
      const int cnt = __popc(bits);
#pragma unroll 4
      for (int m = 0; m < cnt; ++m) {
        const int nb = nbr[q0 + __ffs(bits) - 1];
        bits &= bits - 1;
#pragma unroll
        for (int u = 0; u < kV; ++u) add4(v[u], src(dir, nb, u));
      }
    }
  }
}

// gather_row for kRows rows of a warp at once (row[j], -2 for none: it
// matches no slot, where -1 marks a dropped one), their counts in nd[j]:
// each ballot step walks one neighbour of every row that has one left at
// a time, so the rows' loads go out together.
template <int kRows, int kV, typename Src>
__device__ __forceinline__ void gather_rows(const int* __restrict__ ep,
                                            const int* __restrict__ ec, int e,
                                            const int (&row)[kRows],
                                            Src&& src,
                                            float4 (&v)[kRows][kV],
                                            int (&nd)[kRows]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const int* key = dir == 0 ? ep : ec;
    const int* nbr = dir == 0 ? ec : ep;
    for (int q0 = 0; q0 < e; q0 += 32) {
      const int kq = q0 + lane < e ? key[q0 + lane] : -1;
      unsigned bits[kRows];
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        bits[j] = __ballot_sync(0xffffffffu, kq == row[j]);
        nd[j] += __popc(bits[j]);
        any |= bits[j];
      }
      while (any) {  // one neighbour of every row that has one left
        any = 0;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (bits[j]) {
            const int nb = nbr[q0 + __ffs(bits[j]) - 1];
#pragma unroll
            for (int u = 0; u < kV; ++u) add4(v[j][u], src(dir, nb, u));
            bits[j] &= bits[j] - 1;
            any |= bits[j];
          }
        }
      }
    }
  }
}

// ------------------------------------------------ bf16 5b and 8b: lists
//
// Phase clocks of 5b and 8b, compiled in only with -DEDGE_PHASES
// (tools/edge_phases.py builds the two sources so): lane 0 of each warp
// adds the SM cycles it spent in each phase into its block's
// edge_phases[block][phase], 1 into [kPhases], its whole span into
// [kPhases + 1] and raises [kPhases + 2] to its longest span (a block's
// own slots, blocks past kPhaseBlocks folded over: one slot for all
// warps made their atomics the kernel's longest phase).  The tool reads
// them back through edge_phases_read.  A load's wait falls in the phase
// that first uses its value.  Without the macro every member is empty and
// the kernels compile as if it were not there.
enum Phase { kOwnRow, kEdges, kWalk, kLoads, kEpilogue, kPhases };
constexpr int kPhaseBlocks = 8192;
#ifdef EDGE_PHASES
__device__ unsigned long long edge_phases[kPhaseBlocks][kPhases + 3];
#endif

struct EdgeClock {
#ifdef EDGE_PHASES
  long long first = 0, last = 0, spent[kPhases] = {};
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
  }
  // lane 0 adds its warp's phases into its block's slots
  __device__ __forceinline__ void flush() {
    if (threadIdx.x % 32 != 0) return;
    unsigned long long* slot = edge_phases[
        (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) %
        kPhaseBlocks];
    for (int i = 0; i < kPhases; ++i)
      atomicAdd(&slot[i], (unsigned long long)spent[i]);
    atomicAdd(&slot[kPhases], 1ull);
    atomicAdd(&slot[kPhases + 1], (unsigned long long)(last - first));
    atomicMax(&slot[kPhases + 2], (unsigned long long)(last - first));
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush() {}
#endif
};

// load_edges with 4 slots a thread: 16-byte loads of parent and child and
// a 4-byte load of the mask where e % 4 == 0 and the lists are aligned so
// (the same slots, the same values); ends with a barrier.
__device__ __forceinline__ void load_edges_wide(
    const int* __restrict__ parent, const int* __restrict__ child,
    const unsigned char* __restrict__ mask, int n, int e, int* ep, int* ec) {
  const bool wide = e % 4 == 0 && (uintptr_t)parent % 16 == 0 &&
                    (uintptr_t)child % 16 == 0 && (uintptr_t)mask % 4 == 0;
  if (!wide) {
    load_edges(parent, child, mask, n, e, ep, ec);
    return;
  }
  auto keep = [n](int p, int c, unsigned m) {
    return m != 0 && p >= 0 && p < n && c >= 0 && c < n;
  };
  for (int q = 4 * threadIdx.x; q < e; q += 4 * blockDim.x) {
    const int4 p = *reinterpret_cast<const int4*>(parent + q);
    const int4 c = *reinterpret_cast<const int4*>(child + q);
    const uchar4 m = *reinterpret_cast<const uchar4*>(mask + q);
    const bool k0 = keep(p.x, c.x, m.x), k1 = keep(p.y, c.y, m.y);
    const bool k2 = keep(p.z, c.z, m.z), k3 = keep(p.w, c.w, m.w);
    *reinterpret_cast<int4*>(ep + q) =
        make_int4(k0 ? p.x : -1, k1 ? p.y : -1, k2 ? p.z : -1, k3 ? p.w : -1);
    *reinterpret_cast<int4*>(ec + q) =
        make_int4(k0 ? c.x : -1, k1 ? c.y : -1, k2 ? c.z : -1, k3 ? c.w : -1);
  }
  __syncthreads();
}

// A lane's chunk of kW bf16 columns of one row, as loaded (kW = 8: one
// 16-byte load, 8 values, from a column the caller keeps inside the row;
// kW = 4: one 8-byte load with kVec, else four of one value each, zero
// past the row's width t).
template <int kW>
struct Chunks;

template <>
struct Chunks<8> {
  static constexpr int kW = 8;
  using Raw = uint4;
  // columns k..k+7 of the row at p (k + 8 <= t): no bound to test, so
  // that a batch of them issues as one run of predicated loads
  template <bool>
  __device__ __forceinline__ static Raw load(
      const __nv_bfloat16* __restrict__ p, int k, int) {
    return *reinterpret_cast<const uint4*>(p + k);
  }
  // a bf16 widens exactly: its bits are an f32's upper half
  __device__ __forceinline__ static void widen(float (&a)[8], const Raw& r) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[2 * i] = __uint_as_float(w[i] << 16);
      a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void add(float (&a)[8], const Raw& r) {
    float v[8];
    widen(v, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] += v[i];
  }
  template <bool>
  __device__ __forceinline__ static void store(__nv_bfloat16* __restrict__ p,
                                               int k, int t,
                                               const float (&a)[8]) {
    if (k >= t) return;
    auto pack = [](float lo, float hi) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      return *reinterpret_cast<const unsigned*>(&v);
    };
    *reinterpret_cast<uint4*>(p + k) =
        make_uint4(pack(a[0], a[1]), pack(a[2], a[3]), pack(a[4], a[5]),
                   pack(a[6], a[7]));
  }
};

template <>
struct Chunks<4> {
  static constexpr int kW = 4;
  using Raw = float4;
  template <bool kVec>
  __device__ __forceinline__ static Raw load(
      const __nv_bfloat16* __restrict__ p, int k, int t) {
    return load4<kVec>(p, 0, k, t);
  }
  __device__ __forceinline__ static void widen(float (&a)[4], const Raw& r) {
    a[0] = r.x;
    a[1] = r.y;
    a[2] = r.z;
    a[3] = r.w;
  }
  __device__ __forceinline__ static void add(float (&a)[4], const Raw& r) {
    a[0] += r.x;
    a[1] += r.y;
    a[2] += r.z;
    a[3] += r.w;
  }
  template <bool kVec>
  __device__ __forceinline__ static void store(__nv_bfloat16* __restrict__ p,
                                               int k, int t,
                                               const float (&a)[4]) {
    store4<kVec>(p, 0, k, t, make_float4(a[0], a[1], a[2], a[3]));
  }
};

// A list entry: the neighbour row, kReverse set for a reverse neighbour.
constexpr int kReverse = 1 << 30;

// The walk of gather_row, calling visit(entry) for each neighbour of the
// warp's row in summing order: its forward neighbours (its children),
// then its reverse ones (its parents), each in edge order.  It takes
// three 32-slot ballot words an iteration, their shared-memory loads and
// ballots issued together (one word a step timed 10-25 % slower where a
// sentence has hundreds of slots).  Returns the row's degree (the
// ballots' popcounts).  Every lane of the warp calls it with the same
// row.
template <class Visit>
__device__ __forceinline__ int walk_each(const int* __restrict__ ep,
                                         const int* __restrict__ ec, int e,
                                         int row, Visit&& visit,
                                         EdgeClock& clk) {
  const int lane = threadIdx.x % 32;
  int deg = 0;
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    const int* key = dir == 0 ? ep : ec;
    const int* nbr = dir == 0 ? ec : ep;
    for (int q0 = 0; q0 < e; q0 += 32 * 3) {
      unsigned bits[3];
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const int q = q0 + 32 * w + lane;
        bits[w] = __ballot_sync(0xffffffffu, (q < e ? key[q] : -1) == row);
        deg += __popc(bits[w]);
      }
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        while (bits[w]) {
          visit(nbr[q0 + 32 * w + __ffs(bits[w]) - 1] |
                (dir == 0 ? 0 : kReverse));
          bits[w] &= bits[w] - 1;
        }
      }
    }
  }
  clk.mark(kWalk);
  return deg;
}

// A queue of up to kB listed neighbours, q[0] the newest: the rows whose
// loads go out together.
template <int kB>
struct Queue {
  int q[kB];
  int count = 0;
  __device__ __forceinline__ void push(int entry) {
#pragma unroll
    for (int j = kB - 1; j > 0; --j) q[j] = q[j - 1];
    q[0] = entry;
    ++count;
  }
  // issues the loads of the queued rows' chunks (load(entry)) together
  template <class Raw, class Load>
  __device__ __forceinline__ void issue(Load&& load, Raw (&r)[kB]) const {
#pragma unroll
    for (int j = 0; j < kB; ++j)
      if (j < count) r[j] = load(q[j]);
  }
  // adds loaded chunks to acc oldest first
  template <class C>
  __device__ __forceinline__ void sum(const typename C::Raw (&r)[kB],
                                     float (&acc)[C::kW]) const {
#pragma unroll
    for (int j = kB - 1; j >= 0; --j)
      if (j < count) C::add(acc, r[j]);
  }
  // both; the queue keeps its entries
  template <class C, class Load>
  __device__ __forceinline__ void add(Load&& load, float (&acc)[C::kW]) const {
    typename C::Raw r[kB];
    issue(load, r);
    sum<C>(r, acc);
  }
};

// A row's sums, group by group: the lane's chunk u of each of `groups`
// (32 chunks a warp each) sums load(entry, u) over the row's neighbours
// in summing order into a zeroed acc, then epilogue(u, acc, self, deg)
// takes it, with self the row's own chunk u (group 0's `self0`, loaded by
// the caller; the others by load_self(u) with the group's neighbours, so
// that they arrive together).  The walk queues the neighbours kB at a
// time, adding a full queue into group 0 before it takes the next; a row
// of at most kB neighbours so issues all its loads at once after its
// walk and keeps its queue for the other groups, whose loads go out a
// group ahead (kPipe: group u + 1's while group u's are added), and a
// longer row walks again for each of them.  A lane holds one group's sums
// and kB rows' chunks of one group (two with kPipe) at a time whatever
// the width.
template <int kB, bool kPipe, class C, class Load, class LoadSelf,
          class Epilogue>
__device__ __forceinline__ void gather_groups(
    const int* __restrict__ ep, const int* __restrict__ ec, int e, int row,
    int groups, typename C::Raw self0, Load&& load, LoadSelf&& load_self,
    Epilogue&& epilogue, EdgeClock& clk) {
  using Raw = typename C::Raw;
  Queue<kB> queue;
  float acc[C::kW] = {};
  auto group = [&](int u) { return [&, u](int ent) { return load(ent, u); }; };
  bool refill = false;  // the queue overflowed: other groups walk again
  const int deg = walk_each(ep, ec, e, row,
                            [&](int ent) {
                              if (queue.count == kB) {
                                queue.template add<C>(group(0), acc);
                                queue.count = 0;
                                refill = true;
                              }
                              queue.push(ent);
                            },
                            clk);
  if (kPipe && !refill) {  // group u + 1's loads out before group u's sum
    Raw a[kB], b[kB], self_a = self0, self_b = self0;
    queue.issue(group(0), a);
    for (int u = 0; u < groups; u += 2) {
      if (u + 1 < groups) {
        self_b = load_self(u + 1);
        queue.issue(group(u + 1), b);
      }
      float s[C::kW] = {};
      queue.template sum<C>(a, s);
      epilogue(u, s, self_a, deg);
      if (u + 1 < groups) {
        if (u + 2 < groups) {
          self_a = load_self(u + 2);
          queue.issue(group(u + 2), a);
        }
        float t[C::kW] = {};
        queue.template sum<C>(b, t);
        epilogue(u + 1, t, self_b, deg);
      }
    }
    clk.mark(kEpilogue);
    return;
  }
  queue.template add<C>(group(0), acc);
  clk.mark(kLoads);
  epilogue(0, acc, self0, deg);
  clk.mark(kEpilogue);
  for (int u = 1; u < groups; ++u) {
    const Raw self = load_self(u);
    float sum[C::kW] = {};
    if (refill) {
      queue.count = 0;
      walk_each(ep, ec, e, row,
                [&](int ent) {
                  if (queue.count == kB) {
                    queue.template add<C>(group(u), sum);
                    queue.count = 0;
                  }
                  queue.push(ent);
                },
                clk);
    }
    queue.template add<C>(group(u), sum);
    clk.mark(kLoads);
    epilogue(u, sum, self, deg);
    clk.mark(kEpilogue);
  }
}

}  // namespace edge_gather

#ifdef EDGE_PHASES
// The phase slots, [kPhaseBlocks][kPhases + 3], read and zeroed by the
// tool (one library a source, each with its own slots).
extern "C" int edge_phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, edge_gather::edge_phases,
                                   sizeof(edge_gather::edge_phases));
}
extern "C" int edge_phases_zero() {
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, edge_gather::edge_phases);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(at, 0, sizeof(edge_gather::edge_phases));
}
#endif
