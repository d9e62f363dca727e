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

#pragma once

#include <cuda_runtime.h>

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

// Columns k..k+3 of row r of x (rows of width t), zero past t: one 16-byte
// load with kVec (t a multiple of 4, x 16-byte aligned), else four 4-byte
// ones; through the non-coherent path (LDG.CONSTANT), x being const
// __restrict__ (an explicit __ldg timed slower in the lockstep walk).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int r,
                                        int k, int t) {
  const float* p = x + (size_t)r * t + k;
  if (kVec)
    return k < t ? *reinterpret_cast<const float4*>(p) : zero4();
  return make_float4(k < t ? p[0] : 0.0f, k + 1 < t ? p[1] : 0.0f,
                     k + 2 < t ? p[2] : 0.0f, k + 3 < t ? p[3] : 0.0f);
}

// Stores v to columns k..k+3 of row r of x (rows of width t), none past t.
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

}  // namespace edge_gather
