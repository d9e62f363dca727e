// Grouped (ragged) matmul, forward: y[m] = x[m] @ s[gid(m)] over rows sorted
// so that each group is contiguous.
//
// Replaces the Pallas TPU kernel gcn_tpu/ops/pallas/grouped_matmul.py::
// _fwd_kernel together with its visit schedule _schedule (launched by
// _gmm_forward, reached through grouped_matmul).  Same contract:
//   x           [M, T]
//   s           [R, T, H]
//   group_ends  [R] int32   cumsum(group_sizes); rows past the last end
//                           belong to the last group, empty groups are skipped
//   y           [M, H]      in x's dtype, accumulated in f32
// Storage is f32 or bf16.
//
// What bounds it on the H100.  At the main path's shapes (M = 9600 stacked
// band rows, T = 400 or 200, H = 200, R = 87) it does 2 M T H = 1.5 (0.77)
// GFLOP and moves x, the used groups' S and y once, 49 (28) MB: on the
// 3xTF32 tensor-core mainloop (165 TFLOP/s effective) the bytes bound it,
// 0.015 (0.008) ms, where the CUDA cores' f32 FMA rate would set 0.023
// (0.011).  The TPU kernel walked a scalar-prefetched list of (row tile,
// group) visits on a sequential grid, revisiting one output block in
// VMEM; a row tile that met k groups took k masked products.  Here the
// list is cut per group (grouped_tiles.cuh): each CTA owns 128 rows of one
// group by all 208 columns, so no product is masked and each output row
// is stored once.  Each group's rows start a tile, so at the main path's
// group sizes (80 groups of 44-97 rows, two padding groups of about 2070)
// the 9600 rows make 114 tiles of 128 rows: one wave on 132 SMs, where
// 196 tiles of 64 rows put two on 64 SMs (the same longest SM) and read
// S[g] from L2 twice as often (and were slower, two CTAs an SM at 128
// registers).  A warp whose 32 rows are past the group's end issues no
// MMA.  That is the f32 instance (grouped_matmul_fwd_kernel, on the
// 3xTF32 mainloop).
//
// bf16 (grouped_matmul_fwd_bf16_kernel).  It moves 25 (14) MB, so at 3.35
// TB/s the bytes bound it at 0.0074 (0.0043) ms; its 1.5 GFLOP take 0.0016
// ms at the bf16 tensor cores' 989 TFLOP/s.  A bf16 x bf16 product is
// exact in f32, so the products run on the bf16 tensor cores as they are:
// wgmma.mma_async.m64n208k16 (bf16 in, f32 sums), with no split.  The work
// list and its device-side warp scan are the f32 kernel's (grouped_tiles.cuh:
// tiles of 128 rows of one group by 208 columns), so nothing is read back
// on the host.  A block is three warpgroups: two consumers of 64 rows each
// (one 64 x 208 f32 fragment, 104 registers a thread) and one producer, of
// which one thread issues TMA copies (tensor maps from the driver's
// cuTensorMapEncodeTiled, zeros outside the matrices) into a four-stage
// ring (full and empty mbarriers); the operands stay bf16 in shared memory
// in the 128-byte-swizzled layouts that wgmma reads (hopper_tile.cuh):
//   x: the tile's 128 rows by 64 t a stage, K-major (16 KB);
//   S[g]: the same 64 t rows by 208 columns, MN-major (S[g]'s own
//   row-major layout: four blocks of 64 columns, 32 KB),
// 48 KB a stage, so three stages' bytes are in flight while the consumers
// multiply the fourth: the kernel is bound by bytes, and bytes in flight
// are what hide their latency.  A consumer keeps one chunk's products in
// flight while it waits for the next chunk (wgmma.wait_group 1) and hands
// each slot back when its products are done.  x rows past the group's end
// (the next group's) and past M (zeros) ride in the box; their outputs
// are not stored.  A consumer warpgroup whose 64 rows all lie past the
// group's end waits and hands back like the other but issues no product.
// The sums run over all of T in one f32 fragment (k-steps of 16 on zeros
// past T), rounded to bf16 once at the store, two columns a store.
// Operands that TMA cannot take (T or H not a multiple of 8, a base not
// 16-byte aligned) go through the producer's 128 threads instead: cp.async
// of 16 bytes where the rows allow, element by element where not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grouped_tiles.cuh"
#include "hopper_tile.cuh"

namespace {

__global__ void __launch_bounds__(gmm::Tl::kThreads, gmm::kMinBlocks)
grouped_matmul_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ s,
                          const int* __restrict__ group_ends,
                          float* __restrict__ y, int m, int t, int h, int r,
                          bool vec_x, bool vec_s) {
  gmm::tile_product<gmm::kFwd>(x, s, group_ends, y, nullptr, m, t, h, r,
                               vec_x, vec_s);
}

int launch_f32(const void* x, const void* s, const void* group_ends, void* y,
               int m, int t, int h, int r, void* stream) {
  constexpr size_t kSmem = gmm::Geo<gmm::kFwd>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      grouped_matmul_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(gmm::tile_bound(m, r),
                  (h + gmm::Tl::kBN - 1) / gmm::Tl::kBN);
  grouped_matmul_fwd_kernel<<<grid, gmm::Tl::kThreads, kSmem,
                              (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(s),
      static_cast<const int*>(group_ends), static_cast<float*>(y), m, t, h, r,
      gmm::vec_ok<float>(x, t), gmm::vec_ok<float>(s, h));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
namespace gmm16 {

using hopper::bf16;
constexpr int kBM = gmm::kBM;        // rows a tile: the work list's
constexpr int kBN = 208;             // columns a tile
constexpr int kThreads = 384;        // two consumer warpgroups of 64 rows,
                                     // then one producer warpgroup
constexpr int kKC = 64;              // t a chunk: four k-steps of 16, one
                                     // 128-byte swizzled row of x
constexpr int kStages = 4;           // chunks in the ring
constexpr int kLag = 2;              // chunks a copying thread has in
                                     // flight before it reports the oldest
static_assert(kLag <= kStages - 1, "the ring would deadlock");
constexpr int kXBytes = kBM * 128;   // x [128 rows, 64 t], 16 KB
constexpr int kSBlockBytes = kKC * 128;  // S[g] [64 t, 64 columns], 8 KB
constexpr int kSBytes = (kBN + 63) / 64 * kSBlockBytes;  // 32 KB
constexpr int kStageBytes = kXBytes + kSBytes;           // 48 KB
constexpr int kBarBytes = 1024;      // the mbarriers, ahead of the ring
constexpr int kSmem = 1024 + kBarBytes + kStages * kStageBytes;
static_assert(kBM == 128 && kBN / 2 == hopper::kN208Vals, "the wgmma tile");

// Tile blockIdx.x of the work list by columns blockIdx.y * 208..:
// y[rows of the tile] = x[rows of the tile] S[g], rounded to bf16 once.
// Barriers: full[i] (ring slot i has landed: its bytes, or the copying
// threads' reports), empty[i] (the consumers' 8 warps are done reading
// slot i).
__global__ void __launch_bounds__(kThreads, 1)
grouped_matmul_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                               const __grid_constant__ CUtensorMap map_s,
                               const bf16* __restrict__ x,
                               const bf16* __restrict__ s,
                               const int* __restrict__ ends,
                               bf16* __restrict__ y, int m, int t, int h,
                               int r, bool tma, bool vec_x, bool vec_s) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: blocks start on multiples of it
  const uint32_t raw = tf32x3::smem_u32(smem_raw);
  const uint32_t bars = (raw + 1023u) & ~1023u;
  const uint32_t ring_s = bars + kBarBytes;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (kStages + i); };

  __shared__ gmm::Piece shared_piece;
  if (threadIdx.x < 32) {
    const gmm::Piece p = gmm::find_piece<kBM, false>(ends, r, m, blockIdx.x);
    if (threadIdx.x == 0) {
      shared_piece = p;
      for (int i = 0; i < kStages; ++i) {
        bar_init(full(i), tma ? 1 : 128);
        bar_init(empty(i), 8);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const gmm::Piece p = shared_piece;
  if (p.group < 0) return;  // past the list: the same for the whole CTA
  const int n0 = blockIdx.y * kBN;
  const int chunks = (t + kKC - 1) / kKC;
  const int group = threadIdx.x / 128;

  if (group == 2) {  // ------------------------------------ producer
    if (tma) {  // one thread issues every copy
      if (threadIdx.x != 256) return;
      for (int c = 0; c < chunks; ++c) {
        const int slot = c % kStages;
        // the slot's last chunk has been handed back
        if (c >= kStages) bar_wait(empty(slot), (c / kStages - 1) & 1);
        const uint32_t st = ring_s + slot * kStageBytes;
        bar_expect(full(slot), kStageBytes);
        tma_2d(st, &map_x, c * kKC, p.row0, full(slot));
        for (int nb = 0; nb < kSBytes / kSBlockBytes; ++nb)
          tma_3d(st + kXBytes + nb * kSBlockBytes, &map_s, n0 + 64 * nb,
                 c * kKC, p.group, full(slot));
      }
      return;
    }
    unsigned char* ring = smem_raw + (ring_s - raw);
    const int pt = threadIdx.x - 256;
    int reported = 0;  // chunks reported landed
    for (int c = 0; c < chunks; ++c) {
      if (c >= kStages) bar_wait(empty(c % kStages), (c / kStages - 1) & 1);
      unsigned char* st = ring + c % kStages * kStageBytes;
      const int tc = c * kKC, tk = min(kKC, t - tc);
      load_x<kBM>(st, x + (size_t)p.row0 * t + tc, t, m - p.row0, tk,
                  vec_x, pt, 128);
      load_w<kKC, kBN>(st + kXBytes, s + ((size_t)p.group * t + tc) * h, h,
                       tk, n0, vec_s, pt, 128);
      tf32x3::cp_async_commit();
      if (c + 1 - reported == kLag) {  // the oldest chunk has landed
        tf32x3::cp_async_wait<kLag - 1>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(full(reported++ % kStages));
      }
    }
    tf32x3::cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    while (reported < chunks) bar_arrive(full(reported++ % kStages));
    return;
  }

  // --------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32;
  // this thread's fragment rows within the tile: row0 (values 4j, 4j + 1)
  // and row0 + 8 (4j + 2, 4j + 3), columns n0 + 8j + 2 (lane % 4) + {0, 1}
  const int row0 = group * 64 + threadIdx.x % 128 / 32 * 16 + lane / 4;
  float acc[kN208Vals];
#pragma unroll
  for (int i = 0; i < kN208Vals; ++i) acc[i] = 0.0f;
  auto hand_back = [&](int c) {
    if (lane == 0) bar_arrive(empty(c % kStages));
  };
  if (group * 64 >= p.rows) {  // no row of the group: wait and hand back
    for (int c = 0; c < chunks; ++c) {
      bar_wait(full(c % kStages), c / kStages & 1);
      hand_back(c);
    }
    return;
  }
  // the descriptors of slot 0's first k-step; a k-step adds its byte
  // offsets, in 16-byte units, to their start-address field
  const uint64_t a0 = desc(ring_s + group * 64 * 128, 16, 1024);
  const uint64_t b0 = desc(ring_s + kXBytes, kSBlockBytes, 1024);
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % kStages;
    bar_wait(full(slot), c / kStages & 1);
    mma_fence();
    // every k-step of the chunk, also past T: x and S[g] are zeros there
#pragma unroll
    for (int k = 0; k < kKC / 16; ++k)
      mma_208(acc, a0 + ((slot * kStageBytes + k * 32) >> 4),
              b0 + ((slot * kStageBytes + k * 16 * 128) >> 4), c > 0 || k > 0);
    mma_commit();
    if (c > 0) {  // the previous chunk's products are done
      mma_wait<1>();
      hand_back(c - 1);
    }
  }
  mma_wait<0>();
  fence_regs(acc);
  if (chunks > 0) hand_back(chunks - 1);

  // two neighbouring columns a store where H is even
  const bool pairs = h % 2 == 0;
#pragma unroll
  for (int j = 0; j < kN208Vals / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int row = row0 + (i & 2 ? 8 : 0);
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (row >= p.rows || col >= h) continue;
      bf16* dst = y + (size_t)(p.row0 + row) * h + col;
      const float v0 = acc[4 * j + i], v1 = acc[4 * j + i + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (col + 1 < h) dst[1] = __float2bfloat16_rn(v1);
      }
    }
}

// The tensor maps of x [M, T] (boxes of 128 rows x 64 t) and S [R, T, H]
// (boxes of one group, 64 t rows, 64 columns); false where the driver
// refuses them.
bool tensor_maps(CUtensorMap* map_x, CUtensorMap* map_s, const void* x,
                 const void* s, int m, int t, int h, int r) {
  const cuuint64_t x_dim[2] = {(cuuint64_t)t, (cuuint64_t)m};
  const cuuint64_t x_stride[1] = {(cuuint64_t)t * 2};
  const cuuint32_t x_box[2] = {64, kBM};
  const cuuint64_t s_dim[3] = {(cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)r};
  const cuuint64_t s_stride[2] = {(cuuint64_t)h * 2, (cuuint64_t)t * h * 2};
  const cuuint32_t s_box[3] = {64, kKC, 1};
  return hopper::bf16_tensor_map(map_x, x, 2, x_dim, x_stride, x_box) &&
         hopper::bf16_tensor_map(map_s, s, 3, s_dim, s_stride, s_box);
}

int launch(const void* x, const void* s, const void* group_ends, void* y,
           int m, int t, int h, int r, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      grouped_matmul_fwd_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  // TMA takes 16-byte-aligned bases and row strides; other operands go
  // through the copying warpgroup
  const bool vec_x = gmm::vec_ok<bf16>(x, t), vec_s = gmm::vec_ok<bf16>(s, h);
  CUtensorMap map_x{}, map_s{};
  const bool tma = vec_x && vec_s && t > 0 &&
                   tensor_maps(&map_x, &map_s, x, s, m, t, h, r);
  const dim3 grid(gmm::tile_bound(m, r), (h + kBN - 1) / kBN);
  grouped_matmul_fwd_bf16_kernel<<<grid, kThreads, kSmem,
                                   (cudaStream_t)stream>>>(
      map_x, map_s, static_cast<const bf16*>(x), static_cast<const bf16*>(s),
      static_cast<const int*>(group_ends), static_cast<bf16*>(y), m, t, h, r,
      tma, vec_x, vec_s);
  return (int)cudaGetLastError();
}

}  // namespace gmm16

}  // namespace

extern "C" {

int grouped_matmul_forward_f32(const void* x, const void* s,
                               const void* group_ends, void* y, int m, int t,
                               int h, int r, void* stream) {
  return launch_f32(x, s, group_ends, y, m, t, h, r, stream);
}

int grouped_matmul_forward_bf16(const void* x, const void* s,
                                const void* group_ends, void* y, int m, int t,
                                int h, int r, void* stream) {
  return gmm16::launch(x, s, group_ends, y, m, t, h, r, stream);
}

const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
