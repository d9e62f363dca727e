// Hopper helpers of the bf16 kernels whose operands TMA copies (or
// cp.async where TMA refuses them): the deprel bilinear's bf16 instances
// (deprel_bilinear.cu, kernels 11b and 12b) and the grouped matmul's,
// forward (grouped_matmul.cu, kernel 3b) and backward (dx and dS,
// grouped_matmul_backward.cu, kernel 4b), which run wgmma on them, and
// the fused GCN layer's bf16 forward (spmm_fused.cu, kernel 7b), which
// reads W's swizzled blocks by ldmatrix.
//
// Layouts.  An operand sits in shared memory in the 128-byte-swizzled
// blocks that TMA's SWIZZLE_128B writes and wgmma's layout type 1 reads:
// rows of 128 bytes (64 bf16), the 16-byte piece p of row r at piece
// p XOR (r mod 8), each block's base 1024-byte aligned.
//   K-major (A, or B with its transpose flag clear): [rows, 64 k] blocks,
//   8-row groups 1024 bytes apart.
//   MN-major (B, or A with its transpose flag set): [k rows, 64 columns]
//   blocks (a row-major matrix's own layout), 8-row groups 1024 bytes
//   apart, column blocks a block's bytes apart.
// A k-step of 16 adds its byte offset, in 16-byte units, to a
// descriptor's start-address field: 32 bytes along a K-major row, 16 rows
// of 128 bytes down an MN-major block.
//
// Pieces: the swizzle and the descriptors; the m64n208k16 wgmma (bf16 in,
// f32 out, A K-major, B MN-major) and the m64n200k16 one with either
// operand in either layout, and their fences, commits and waits;
// mbarriers; TMA copies of tensor-map boxes (one CTA, or multicast to a
// cluster) and TMA stores; cp.async copies into the same layouts for
// operands TMA cannot take (load_x, load_w); and, on the host, the
// driver's cuTensorMapEncodeTiled found through the runtime (the libraries
// link no libcuda) and a tiled map encoder.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3_tile.cuh"

namespace hopper {

using bf16 = __nv_bfloat16;
constexpr int kN208Vals = 208 / 2;  // f32 values of a 64 x 208 fragment a
                                    // thread: 104
constexpr int kN200Vals = 200 / 2;  // and of a 64 x 200 one: 100

// Byte offset of 16-byte piece p of 128-byte row r in a block of rows
// whose base is 1024-byte aligned, under the 128-byte swizzle (TMA's
// SWIZZLE_128B, wgmma's layout type 1): the piece index XOR r mod 8.
__device__ __forceinline__ int swizzled(int r, int p) {
  return r * 128 + ((p ^ (r & 7)) << 4);
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
// d (+)= A B for a 64 x 16 bf16 A (K-major) and a 16 x 208 bf16 B
// (MN-major, the transpose flag set), f32 d; accumulate 0 overwrites d.
__device__ __forceinline__ void mma_208(float (&d)[kN208Vals], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103}, %104, %105, p, 1, 1, 0, 1;\n}\n"
      : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
        WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36), WG_D4(40), WG_D4(44),
        WG_D4(48), WG_D4(52), WG_D4(56), WG_D4(60), WG_D4(64), WG_D4(68),
        WG_D4(72), WG_D4(76), WG_D4(80), WG_D4(84), WG_D4(88), WG_D4(92),
        WG_D4(96), WG_D4(100)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for a 64 x 16 bf16 A and a 16 x 200 bf16 B, f32 d, with the
// transpose flags as given: 0 for a K-major operand, 1 for an MN-major one
// (the grouped matmul backward's dx takes both K-major, its dS both
// MN-major).
template <int kTransA, int kTransB>
__device__ __forceinline__ void mma_200(float (&d)[kN200Vals], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99}, %100, %101, p, 1, 1, %103, %104;"
      "\n}\n"
      : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
        WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36), WG_D4(40), WG_D4(44),
        WG_D4(48), WG_D4(52), WG_D4(56), WG_D4(60), WG_D4(64), WG_D4(68),
        WG_D4(72), WG_D4(76), WG_D4(80), WG_D4(84), WG_D4(88), WG_D4(92),
        WG_D4(96)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}
#undef WG_D4

// The compiler must not move reads or writes of d across the wgmma that
// own it in flight: each register passes through an empty asm.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival, with release semantics: this thread's earlier writes are
// seen by whoever waits for the phase
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival on the barrier at the same place in CTA `rank` of the
// cluster.  CTA-scope release: what it orders is the caller's reads of the
// slot, which its wgmma wait has already completed (a cluster-scope
// release would fence all of device memory at every arrival)
__device__ __forceinline__ void bar_arrive_remote(uint32_t bar,
                                                  uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
// until the phase of this parity has completed (acquire)
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// one arrival that also expects `bytes` more of asynchronous copies
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// TMA: the box at coordinates c (innermost first) of the tensor map into
// shared memory at dst; its bytes count against bar's expected bytes.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
// ... into the same place of every CTA of the cluster in `ctas` (a bit a
// rank), each counting the bytes against its own barrier at bar
__device__ __forceinline__ void tma_3d_multicast(uint32_t dst,
                                                 const CUtensorMap* map,
                                                 int c0, int c1, int c2,
                                                 uint32_t bar,
                                                 uint16_t ctas) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar), "h"(ctas)
      : "memory");
}

// TMA, the other way: the box at coordinates c (innermost first) of the
// tensor map from shared memory at src, in the issuing thread's bulk
// group; rows and columns outside the tensor are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the issuing thread's bulk groups but n have read their shared
// memory (kRead) or completed
template <int n, bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(n) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows [0, kRows) of the row-major matrix rows at src (row stride h),
// columns [n0, n0 + kCols), into MN-major blocks of 64 columns, each
// [kRows, 128 bytes] swizzled.  Rows at or past `rows` and columns at or
// past h are zeros.  vec: h a multiple of 8 and src 16-byte aligned.
// i0, step: this thread's first piece and the copying threads' count.
template <int kRows, int kCols>
__device__ __forceinline__ void load_w(unsigned char* dst, const bf16* src,
                                       int h, int rows, int n0, bool vec,
                                       int i0, int step) {
  constexpr int kBlockBytes = kRows * 128;
  constexpr int kPieces = kCols / 8;  // 16-byte pieces of a row
  if (vec) {
    for (int i = i0; i < kRows * kPieces; i += step) {
      const int r = i / kPieces, p = i % kPieces, col = n0 + p * 8;
      const bool ok = r < rows && col < h;
      tf32x3::cp_async16(dst + (p / 8) * kBlockBytes + swizzled(r, p % 8),
                         ok ? src + (size_t)r * h + col : src, ok);
    }
  } else {
    for (int i = i0; i < kRows * kCols; i += step) {
      const int r = i / kCols, c = i % kCols, col = n0 + c;
      *reinterpret_cast<bf16*>(dst + (c / 64) * kBlockBytes +
                               swizzled(r, c % 64 / 8) + c % 8 * 2) =
          r < rows && col < h ? src[(size_t)r * h + col]
                              : __float2bfloat16_rn(0.0f);
    }
  }
}

// Columns [0, cols) of the kRows rows at src (row stride ld; rows at or
// past `rows` are zeros) into K-major blocks of 64 columns, each [kRows
// rows, 128 bytes] swizzled; columns past cols, up to the last block's
// end, are zeros.  vec: ld a multiple of 8 and src 16-byte aligned.
template <int kRows>
__device__ __forceinline__ void load_x(unsigned char* dst, const bf16* src,
                                       int ld, int rows, int cols, bool vec,
                                       int i0, int step) {
  constexpr int kBlockBytes = kRows * 128;
  const int blocks = (cols + 63) / 64;
  if (vec) {
    const int pieces = blocks * 8;
    for (int i = i0; i < kRows * pieces; i += step) {
      const int r = i / pieces, p = i % pieces;
      const bool ok = r < rows && p * 8 < cols;
      tf32x3::cp_async16(dst + (p / 8) * kBlockBytes + swizzled(r, p % 8),
                         ok ? src + (size_t)r * ld + p * 8 : src, ok);
    }
  } else {
    const int vals = blocks * 64;
    for (int i = i0; i < kRows * vals; i += step) {
      const int r = i / vals, c = i % vals;
      *reinterpret_cast<bf16*>(dst + (c / 64) * kBlockBytes +
                               swizzled(r, c % 64 / 8) + c % 8 * 2) =
          r < rows && c < cols ? src[(size_t)r * ld + c]
                               : __float2bfloat16_rn(0.0f);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda)
inline decltype(&cuTensorMapEncodeTiled) tensor_map_encoder() {
  static decltype(&cuTensorMapEncodeTiled) fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p)
               : nullptr;
  }();
  return fn;
}

// The tiled map of a tensor of `type` and `rank` dimensions (innermost
// first: extents, the outer dimensions' byte strides, the box), 128-byte
// swizzled (or not), zeros outside; false where the driver refuses it.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       bool swizzle) {
  const auto encode = tensor_map_encoder();
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode && rank <= 3 &&
         encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
inline bool bf16_tensor_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims,
                            const cuuint64_t* strides,
                            const cuuint32_t* box, bool swizzle = true) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                    strides, box, swizzle);
}

}  // namespace hopper
