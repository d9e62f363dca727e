// One sentence's adjacency lists in shared memory, built from its padded
// edge list: the first step of the band aggregation's pair kernel
// (band_aggregate.cu).  The forward kernels gather by warp ballots over
// the edge slots instead (edge_gather.cuh), and the SDDMM backward builds
// its lists once per sentence in sddmm.cu.
//
//   parent, child  [E] int32   edge p -> c
//   mask           [E] uint8   0 = padded slot
// An edge counts when its mask is set and both ends lie in [0, N); a
// duplicated edge is listed twice, an edge with an end outside is dropped
// (the TPU kernels' one-hot band build drops it too).
//
// Counts by integer shared-memory atomics, an exclusive scan, then each
// edge placed by its rank among the edges of the same node, so every list
// keeps edge order whatever order the threads run in: a kernel that sums
// over a list in order gives the same bits on every run.

#pragma once

#include <cuda_runtime.h>

namespace edge_lists {

struct Lists {
  const int* start_f;  // [n + 1] node i's forward list: edges with parent i
  const int* nbr_f;    //         their children, in edge order
  const int* start_r;  // [n + 1] node i's reverse list: edges with child i
  const int* nbr_r;    //         their parents, in edge order
};

// Dynamic shared memory that build_lists takes.
inline size_t lists_bytes(int n, int e) {
  return sizeof(int) * (4 * (size_t)e + 4 * (size_t)n + 2);
}

// Every thread of the block calls it; it ends with a barrier.
__device__ inline Lists build_lists(const int* __restrict__ parent,
                                    const int* __restrict__ child,
                                    const unsigned char* __restrict__ mask,
                                    int n, int e, int* smem) {
  int* sp = smem;              // [e] parent of a counted edge, else -1
  int* sc = sp + e;            // [e] child of a counted edge, else -1
  int* cnt_f = sc + e;         // [n]
  int* cnt_r = cnt_f + n;      // [n]
  int* start_f = cnt_r + n;    // [n + 1]
  int* start_r = start_f + n + 1;
  int* nbr_f = start_r + n + 1;  // [e]
  int* nbr_r = nbr_f + e;        // [e]
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    const int p = parent[i], c = child[i];
    const bool ok = mask[i] != 0 && p >= 0 && p < n && c >= 0 && c < n;
    sp[i] = ok ? p : -1;
    sc[i] = ok ? c : -1;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    cnt_f[i] = 0;
    cnt_r[i] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    if (sp[i] >= 0) {
      atomicAdd(&cnt_f[sp[i]], 1);
      atomicAdd(&cnt_r[sc[i]], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 || threadIdx.x == 32) {  // two warps, one scan each
    const int* cnt = threadIdx.x == 0 ? cnt_f : cnt_r;
    int* start = threadIdx.x == 0 ? start_f : start_r;
    int acc = 0;
    for (int i = 0; i < n; ++i) {
      start[i] = acc;
      acc += cnt[i];
    }
    start[n] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < e; i += blockDim.x) {
    const int p = sp[i], c = sc[i];
    if (p < 0) continue;
    int rank_f = 0, rank_r = 0;
    for (int j = 0; j < i; ++j) {
      rank_f += sp[j] == p;
      rank_r += sc[j] == c;
    }
    nbr_f[start_f[p] + rank_f] = c;
    nbr_r[start_r[c] + rank_r] = p;
  }
  __syncthreads();
  return Lists{start_f, nbr_f, start_r, nbr_r};
}

}  // namespace edge_lists
