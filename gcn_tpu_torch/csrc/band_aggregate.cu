// Banded aggregation straight from padded edge lists, forward and backward.
//
// Replaces two Pallas TPU kernels of gcn_tpu/ops/pallas/band_aggregate.py:
//   _kernel       (launched by _forward, reached through
//                  fused_band_aggregate)    -> band_aggregate_forward_{f32,bf16}
//   _pair_kernel  (launched by pair_aggregate, the forward's backward)
//                                           -> band_aggregate_pair_{f32,bf16}
// Same contract, in f32 or bf16 (x_* and the outputs of one type, as the
// TPU kernels take their input's dtype; bf16 sums in f32 and rounds each
// output once, at its store, where the TPU kernels round):
//   parent, child  [B, E] int32   edge p -> c of sentence b
//   mask           [B, E] uint8   0 = padded slot
//   forward:  out = act((A_f x_f + A_f^T x_r + x_s) / denom)
//             x_f, x_r, x_s, out [B, N, H]
//             denom = deg_out + deg_in + incident + 1
//   pair:     (out_t, out_f) = (A_f^T x, A_f x),  x, out_t, out_f [B, N, H]
// where A_f[p, c] counts the edges p -> c whose mask is set and whose ends
// both lie in [0, N): a duplicated edge counts twice, an edge with an end
// outside is dropped (the TPU's one-hot band build drops it too).
//
// What bounds it on the H100.  At the main path's shapes (B = 50, N = E =
// 96, H = 200) a sentence has fewer than N edges, so the aggregation is
// 2*E*H adds against 4*N*H values moved: memory bound (about 15 MB for
// the forward, 11.5 MB for the pair, a few microseconds at 3.35 TB/s).
// The TPU kernel built both N x N bands in VMEM with two one-hot MXU
// contractions and multiplied them densely, which suits a 128 x 128
// matrix unit.  On the card a dense band would do N/deg times the work,
// so rows gather their neighbour rows instead, each output element
// summing its neighbours in edge order: every run gives the same bits,
// with no float atomics.
//
// Both kernels find each row's neighbours by warp ballots over the
// sentence's edge slots in shared memory (edge_gather.cuh, the gather of
// the fused GCN layer too), with no list build.  A block owns 8 rows of
// one sentence, one a warp, and a warp covers a whole row of up to 384
// columns (128 kV, kV = 1-3 chosen from H; wider H takes more column
// blocks): 600 blocks at B = 50, N = 96, H = 200.  A lane covers 4 columns
// of each 128 by 16-byte loads, with several neighbour rows in flight.
// The forward sums a row's forward neighbours of x_f and its reverse ones
// of x_r into one sum; its epilogue adds x_s, divides by denom (the
// ballots' counts give the degree) and applies the ReLU.  One row a warp,
// its walk unrolled, timed faster than two or four rows a warp in
// lockstep.  The pair walks the same ballots with the two directions
// kept apart (gather_pair): (A_f x)[i] sums x over the children of i,
// (A_f^T x)[i] over its parents, each in edge order.  The pair's bf16
// instance (6b) is the same kernel on bf16 rows (edge_gather.cuh's typed
// loads and stores: 8-byte loads where H % 4 == 0, f32 sums, a bf16
// store): its rows move half the bytes.
//
// The bf16 forward (5b) is a kernel of its own
// (band_aggregate_fwd_bf16_kernel).  At the main path's shapes its bytes
// (7.7 MB) sit warm in L2, so its time is a warp's chain of serial waits
// and the card's waves, not bandwidth: the template's warp waited on the
// edge slots, then on one round trip for each ballot step that found a
// neighbour (2-4 for a tree row), and its 4-column lanes left 14 of 32
// idle in the second group at H = 200.  Here a warp loads its row of x_s
// before the edge slots' barrier (4 slots a thread), walks all its ballot
// steps into a queue of kFwdBatch neighbours (edge_gather.cuh
// gather_groups), then issues the queued rows' loads together and adds
// them in list order; its lanes take 8 columns each, one 16-byte load (25
// lanes cover H = 200), where H % 8 == 0 and the bases are 16-byte
// aligned, other shapes 4 (the template's map).  Loads take no bound
// test (a lane past the row's end reads its last chunk and stores
// nothing), so that a batch issues as one run of predicated loads, and
// 48 registers hold five blocks an SM: the main path's 600 blocks in one
// wave.  The sums, their order and the epilogue are the template's, and
// so are its bits (tests/edge_order.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "edge_gather.cuh"

namespace {

using edge_gather::add4;
using edge_gather::Chunks;
using edge_gather::EdgeClock;
using edge_gather::edges_bytes;
using edge_gather::vec_bytes;
using edge_gather::gather_groups;
using edge_gather::gather_pair;
using edge_gather::gather_row;
using edge_gather::load4;
using edge_gather::load_edges;
using edge_gather::load_edges_wide;
using edge_gather::set_smem;
using edge_gather::store4;
using edge_gather::zero4;

constexpr int kThreads = 256;           // 8 warps,
constexpr int kRows = kThreads / 32;    // a row each

// Rows blockIdx.y * kRows.. of sentence blockIdx.x, one a warp, 128 kV
// columns from column tile blockIdx.z.  A row sums x_f over its forward
// neighbours, x_r over its reverse ones (edge_gather.cuh), then x_s, and
// divides by deg + [deg > 0] + 1.  T: the rows' storage, f32 or bf16.
template <typename T, int kV, bool kVec>
__global__ void __launch_bounds__(kThreads)
band_aggregate_fwd_kernel(const int* __restrict__ parent,
                          const int* __restrict__ child,
                          const unsigned char* __restrict__ mask,
                          const T* __restrict__ xf,
                          const T* __restrict__ xr,
                          const T* __restrict__ xs,
                          T* __restrict__ out, int n, int e, int h,
                          int relu) {
  extern __shared__ int fwd_smem[];
  int* ep = fwd_smem;
  int* ec = ep + e;
  const int b = blockIdx.x;
  load_edges(parent + (size_t)b * e, child + (size_t)b * e,
             mask + (size_t)b * e, n, e, ep, ec);
  const int i = blockIdx.y * kRows + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp; no barrier follows
  const size_t at = (size_t)b * n * h;
  xf += at;
  xr += at;
  xs += at;
  out += at;
  const int kc = blockIdx.z * 128 * kV + threadIdx.x % 32 * 4;
  float4 v[kV], self[kV];
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    v[u] = zero4();
    self[u] = load4<kVec>(xs, i, kc + 128 * u, h);
  }
  const int deg = gather_row(ep, ec, e, i,
                             [&](int dir, int r, int u) {
                               return load4<kVec>(dir == 0 ? xf : xr, r,
                                                  kc + 128 * u, h);
                             },
                             v);
  const float denom = (float)deg + (deg > 0 ? 1.0f : 0.0f) + 1.0f;
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    float4 z = v[u];
    add4(z, self[u]);
    z = make_float4(z.x / denom, z.y / denom, z.z / denom, z.w / denom);
    if (relu)
      z = make_float4(fmaxf(z.x, 0.0f), fmaxf(z.y, 0.0f), fmaxf(z.z, 0.0f),
                      fmaxf(z.w, 0.0f));
    store4<kVec>(out, i, kc + 128 * u, h, z);
  }
}

// The same rows and columns: out_f[i] sums x over the forward neighbours
// of i (its children), out_t[i] over its reverse ones (its parents).
template <typename T, int kV, bool kVec>
__global__ void __launch_bounds__(kThreads)
band_pair_kernel(const int* __restrict__ parent,
                 const int* __restrict__ child,
                 const unsigned char* __restrict__ mask,
                 const T* __restrict__ x, T* __restrict__ out_t,
                 T* __restrict__ out_f, int n, int e, int h) {
  extern __shared__ int pair_smem[];
  int* ep = pair_smem;
  int* ec = ep + e;
  const int b = blockIdx.x;
  load_edges(parent + (size_t)b * e, child + (size_t)b * e,
             mask + (size_t)b * e, n, e, ep, ec);
  const int i = blockIdx.y * kRows + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp; no barrier follows
  const size_t at = (size_t)b * n * h;
  x += at;
  out_t += at;
  out_f += at;
  const int kc = blockIdx.z * 128 * kV + threadIdx.x % 32 * 4;
  float4 f[kV], t[kV];
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    f[u] = zero4();
    t[u] = zero4();
  }
  gather_pair(ep, ec, e, i,
              [&](int, int r, int u) {
                return load4<kVec>(x, r, kc + 128 * u, h);
              },
              f, t);
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    store4<kVec>(out_f, i, kc + 128 * u, h, f[u]);
    store4<kVec>(out_t, i, kc + 128 * u, h, t[u]);
  }
}

// ------------------------------------------------- forward, bf16 (5b)
using bf16 = __nv_bfloat16;
constexpr int kFwdBatch = 4;  // 5b: listed rows whose loads are in flight
constexpr int kFwdBlocksPerSm = 5;  // 600 blocks at B = 50, N = 96: a wave

// Row blockIdx.y * kRows + warp of sentence blockIdx.x; lane l takes
// chunks l + 32 u of kW columns (C: Chunks<kW>, kVec its 8-byte loads
// where kW = 4), group u after group u - 1.  A row sums x_f over its
// forward neighbours, x_r over its reverse ones, in list order, then x_s,
// and divides by deg + [deg > 0] + 1.
template <int kW, bool kVec>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
band_aggregate_fwd_bf16_kernel(const int* __restrict__ parent,
                               const int* __restrict__ child,
                               const unsigned char* __restrict__ mask,
                               const bf16* __restrict__ xf,
                               const bf16* __restrict__ xr,
                               const bf16* __restrict__ xs,
                               bf16* __restrict__ out, int n, int e, int h,
                               int relu) {
  using C = Chunks<kW>;
  using Raw = typename C::Raw;
  extern __shared__ int fwd16_smem[];
  int* ep = fwd16_smem;
  int* ec = ep + e;
  EdgeClock clk;
  clk.start();
  const int b = blockIdx.x;
  const int i = blockIdx.y * kRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (h + kW - 1) / kW;
  // the lane's column in group u, kept inside the row: a lane past the
  // row's last chunk loads that chunk's columns and stores nothing
  auto column = [&](int u) { return min(lane + 32 * u, chunks - 1) * kW; };
  const size_t at = (size_t)b * n * h;
  const bf16* own = xs + at + (size_t)i * h;
  // group 0's own values before the edges' barrier: they need no edge
  Raw self0{};
  if (i < n) self0 = C::template load<kVec>(own, column(0), h);
  clk.mark(edge_gather::kOwnRow);
  load_edges_wide(parent + (size_t)b * e, child + (size_t)b * e,
                  mask + (size_t)b * e, n, e, ep, ec);
  clk.mark(edge_gather::kEdges);
  if (i >= n) return;  // the whole warp; no barrier follows
  const bf16* f = xf + at;
  const bf16* r = xr + at;
  gather_groups<kFwdBatch, false, C>(
      ep, ec, e, i, (chunks + 31) / 32, self0,
      [&](int ent, int u) {
        const bf16* x = ent & edge_gather::kReverse ? r : f;
        return C::template load<kVec>(
            x + (size_t)(ent & (edge_gather::kReverse - 1)) * h, column(u),
            h);
      },
      [&](int u) { return C::template load<kVec>(own, column(u), h); },
      [&](int u, float (&z)[kW], const Raw& self, int deg) {
        if (lane + 32 * u >= chunks) return;
        const float denom = (float)deg + (deg > 0 ? 1.0f : 0.0f) + 1.0f;
        C::add(z, self);
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          z[c] = z[c] / denom;
          if (relu) z[c] = fmaxf(z[c], 0.0f);
        }
        C::template store<kVec>(out + at + (size_t)i * h, column(u), h, z);
      },
      clk);
  clk.flush();
}

// Launches pick(kV, kVec) (the kernel instance; kV and kVec come as
// std::integral_constant values) with args over rows of width h: blocks of
// kRows rows of one sentence and 128 kV columns, kV = 1-3 so that one tile
// covers up to 384 columns, with the sentence's edge slots in shared
// memory.  kVec: 4 columns a load and store (h % 4 == 0, operands aligned
// to vec_bytes).
template <class Pick, class... Args>
int launch_rows(int b, int n, int e, int h, bool vec, void* stream,
                Pick&& pick, Args... args) {
  const int groups = (h + 127) / 128;
  const int kv = groups <= 1 ? 1 : groups == 2 ? 2 : 3;
  const dim3 grid(b, (n + kRows - 1) / kRows,
                  (h + 128 * kv - 1) / (128 * kv));
  const size_t smem = edges_bytes(e);
  auto run = [&](auto kernel) {
    const cudaError_t err = set_smem(kernel, smem, 0);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
  };
  using std::integral_constant;
  auto by_kv = [&](auto vec_c) {
    return kv == 1   ? run(pick(integral_constant<int, 1>{}, vec_c))
           : kv == 2 ? run(pick(integral_constant<int, 2>{}, vec_c))
                     : run(pick(integral_constant<int, 3>{}, vec_c));
  };
  return vec ? by_kv(std::true_type{}) : by_kv(std::false_type{});
}

template <typename T>
bool aligned(const void* p) {
  return (uintptr_t)p % vec_bytes<T>() == 0;
}

template <typename T>
int forward(const void* parent, const void* child, const void* mask,
            const void* xf, const void* xr, const void* xs, void* out, int b,
            int n, int e, int h, int relu, void* stream) {
  const bool vec = h % 4 == 0 && aligned<T>(xf) && aligned<T>(xr) &&
                   aligned<T>(xs) && aligned<T>(out);
  return launch_rows(
      b, n, e, h, vec, stream,
      [](auto kv, auto kvec) {
        return band_aggregate_fwd_kernel<T, decltype(kv)::value,
                                         decltype(kvec)::value>;
      },
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(xf),
      static_cast<const T*>(xr), static_cast<const T*>(xs),
      static_cast<T*>(out), n, e, h, relu);
}

// Launches 5b over rows of width h (occ null), or writes its blocks an SM
// and its grid's blocks to occ[0], occ[1]: blocks of kRows rows of one
// sentence, all of a row's columns.  Chunks of 8 columns where h % 8 == 0
// and every base is 16-byte aligned, else of 4 (8-byte loads where h % 4
// == 0 and the bases are 8-byte aligned).
int forward_bf16(const void* parent, const void* child, const void* mask,
                 const void* xf, const void* xr, const void* xs, void* out,
                 int b, int n, int e, int h, int relu, void* stream,
                 int* occ) {
  auto all_aligned = [&](int bytes) {
    for (const void* p : {xf, xr, xs, (const void*)out})
      if ((uintptr_t)p % bytes != 0) return false;
    return true;
  };
  const dim3 grid(b, (n + kRows - 1) / kRows);
  const size_t smem = edges_bytes(e);
  auto run = [&](auto kernel) {
    const cudaError_t err = set_smem(kernel, smem, 0);
    if (err != cudaSuccess) return (int)err;
    if (occ != nullptr) {
      occ[1] = (int)(grid.x * grid.y);
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ[0], kernel, kThreads, smem);
    }
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const int*>(parent), static_cast<const int*>(child),
        static_cast<const unsigned char*>(mask),
        static_cast<const bf16*>(xf), static_cast<const bf16*>(xr),
        static_cast<const bf16*>(xs), static_cast<bf16*>(out), n, e, h,
        relu);
    return (int)cudaGetLastError();
  };
  if (h % 8 == 0 && all_aligned(16))
    return run(band_aggregate_fwd_bf16_kernel<8, true>);
  return h % 4 == 0 && all_aligned(8)
             ? run(band_aggregate_fwd_bf16_kernel<4, true>)
             : run(band_aggregate_fwd_bf16_kernel<4, false>);
}

template <typename T>
int pair(const void* parent, const void* child, const void* mask,
         const void* x, void* out_t, void* out_f, int b, int n, int e, int h,
         void* stream) {
  const bool vec = h % 4 == 0 && aligned<T>(x) && aligned<T>(out_t) &&
                   aligned<T>(out_f);
  return launch_rows(
      b, n, e, h, vec, stream,
      [](auto kv, auto kvec) {
        return band_pair_kernel<T, decltype(kv)::value,
                                decltype(kvec)::value>;
      },
      static_cast<const int*>(parent), static_cast<const int*>(child),
      static_cast<const unsigned char*>(mask), static_cast<const T*>(x),
      static_cast<T*>(out_t), static_cast<T*>(out_f), n, e, h);
}

}  // namespace

extern "C" {

int band_aggregate_forward_f32(const void* parent, const void* child,
                               const void* mask, const void* xf,
                               const void* xr, const void* xs, void* out,
                               int b, int n, int e, int h, int relu,
                               void* stream) {
  return forward<float>(parent, child, mask, xf, xr, xs, out, b, n, e, h,
                        relu, stream);
}

int band_aggregate_forward_bf16(const void* parent, const void* child,
                                const void* mask, const void* xf,
                                const void* xr, const void* xs, void* out,
                                int b, int n, int e, int h, int relu,
                                void* stream) {
  return forward_bf16(parent, child, mask, xf, xr, xs, out, b, n, e, h, relu,
                      stream, nullptr);
}

// 5b's blocks an SM (occ[0]) and its grid's blocks (occ[1]) for these
// operands: what band_aggregate_forward_bf16 would launch.
int band_aggregate_forward_bf16_occupancy(const void* parent,
                                          const void* child, const void* mask,
                                          const void* xf, const void* xr,
                                          const void* xs, void* out, int b,
                                          int n, int e, int h, int relu,
                                          void* occ) {
  return forward_bf16(parent, child, mask, xf, xr, xs, out, b, n, e, h, relu,
                      nullptr, static_cast<int*>(occ));
}

int band_aggregate_pair_f32(const void* parent, const void* child,
                            const void* mask, const void* x, void* out_t,
                            void* out_f, int b, int n, int e, int h,
                            void* stream) {
  return pair<float>(parent, child, mask, x, out_t, out_f, b, n, e, h,
                     stream);
}

int band_aggregate_pair_bf16(const void* parent, const void* child,
                             const void* mask, const void* x, void* out_t,
                             void* out_f, int b, int n, int e, int h,
                             void* stream) {
  return pair<__nv_bfloat16>(parent, child, mask, x, out_t, out_f, b, n, e,
                             h, stream);
}

const char* band_aggregate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
