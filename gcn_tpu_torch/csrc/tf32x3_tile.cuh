// One block-tile GEMM mainloop on the tensor cores in 3xTF32, f32 in and
// f32 out: the shared core of the fused GCN layer (spmm_fused.cu, which
// replaces gcn_tpu/ops/pallas/spmm_fused.py:88 _forward -> _kernel), of
// the deprel bilinear v2 and v1 (deprel_bilinear.cu, which replaces
// gcn_tpu/ops/pallas/deprel_bilinear.py:143 _core_v2_forward ->
// _kernel_v2 and :57 _core_forward -> _kernel), of the scan backward's
// dW_hh (lstm_scan_backward.cu) and of the grouped matmul's three
// products (grouped_tiles.cuh, for gcn_tpu/ops/pallas/grouped_matmul.py:
// 153 and :208).  All are an implicit GEMM out = A W  whose A tile each
// kernel forms itself (the gathered S h rows; e[m, d] * x[m, t] in v2;
// x[m, t] in v1, which scales each chunk's product by e[m, d] where it is
// folded; x read transposed in the grouped dS), and whose W [K, H] rows
// stream from device memory (the grouped dx reads S[g] transposed).
//
// The split.  Each operand value a becomes a_hi = rna_tf32(a) and
// a_lo = a - a_hi (truncated to TF32 by the MMA), and every k-step issues
// three tensor-core products into an f32 accumulator, the small ones
// first:
//   c += a_lo b_hi;  c += a_hi b_lo;  c += a_hi b_hi
// (the a_lo b_lo term, below 2^-22 |a b|, is dropped), and each 32-deep
// chunk's c is folded into the running sum on the CUDA cores (mma_chunk
// says why).  The result keeps f32-level error (tests/
// test_torch_port_tf32x3.py emulates it), so the kernels keep the f32
// tolerances of their plain versions; plain 1xTF32 would not.  The
// effective rate is a third of the TF32 peak: 495 / 3 = 165 TFLOP/s on
// the H100 SXM (700 W), 2.5x the 67 TFLOP/s of the CUDA cores' f32 FMA
// that the earlier SIMT loops of these kernels were held to.
//
// Why mma.sync and not wgmma.  mma.sync.m16n8k8 (tf32) takes its A and B
// fragments from registers, so each kernel forms and splits A in any layout
// it likes (kernel 11 scales x by e on the fly, with no A tile in shared
// memory at all), and W's fragments are split where they are read.  wgmma
// would need both operands K-major in shared memory, already split: a
// transposed, pre-split copy of W per call (twice W's bytes through L2 for
// every row tile) and a split A tile per k-step, and its accumulator and
// the per-chunk one below would take the registers that the fragments
// use here.  mma.sync is the simpler route; it runs these products well
// below the tensor cores' peak (PERF.md gives the measured rates), so
// wgmma is the next step for the bilinear kernels.
//
// The pieces:
//  * Tile<...>: the block's warp grid; each warp owns kMT x kNT fragments
//    of 16 x 8, so a block covers 16 kMT kWarpsM rows by 8 kNT kWarpsN
//    columns (the kernels take all H = 200 columns in one tile: 224 wide
//    in the fused layer, 208 in the bilinear).
//  * copy_tile: a [rows x cols] tile of a row-major matrix into shared
//    memory by cp.async, 16 bytes a thread where the rows allow it (4
//    otherwise); what lies outside the matrix is zero-filled, so ragged
//    T, H, M and N read as zero.
//  * the W ring: kStages chunks of kBK = 32 rows of W, each copy committed
//    as one cp.async group, so the copy of chunk c + kStages - 1 overlaps
//    the MMAs of chunk c (ring_wait before a chunk is read).
//  * mma_chunk: one warp's 4 k-steps over a W chunk into a fresh
//    accumulator, then folded into the running one (added, or by a
//    functor the kernel passes: v1's e[m, d] * c + acc); the kernel passes
//    a functor that returns its A fragment values (f32), which are split
//    here.
// Every output element sums its k-chunks in one fixed order and there are
// no float atomics: two calls give the same bits.
//
// bf16 operands (the bf16 instances of the fused GCN layer and of the
// bilinear v1; the bilinear v2's A = e x, a product of two bf16 values,
// is not exact in TF32 and keeps the split).  A bf16 value
// widened to f32 is exact in TF32 (8 significand bits of TF32's 11), and
// so is the product of two of them in the f32 accumulator, so the split's
// lo parts are zero and 3xTF32's two correction products add nothing:
// with kExact, mma_chunk_ab issues one TF32 product a k-step, at the TF32
// rate (495 TFLOP/s) and with the f32 accumulation and chunk fold of the
// f32 path.  One TF32 pass, not bf16 mma.sync.m16n8k16: the A and B
// fragments keep this file's m16n8k8 layout, so the kernels' A tiles,
// their fragment functors and the W ring serve both types; only the ring's
// storage (copy_tile and mma_chunk take bf16 W rows, half the bytes) and
// the pass count change.  The bf16 MMA's 2x rate would matter where the
// product bounds a kernel, which the fused layer's is not (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int kBK = 32;     // depth of one W chunk: four m16n8k8 k-steps
constexpr int kStages = 3;  // W chunks in the ring: two in flight

// A row stride (in floats) for a shared tile n wide, n a multiple of 8,
// at which the B fragment reads (row q, column g of an 8 x 8 tile, for
// q < 4, g < 8) fall in 32 distinct banks.
constexpr int padded_ld(int n) {
  return (n % 32 == 8 || n % 32 == 24) ? n : padded_ld(n + 8);
}

template <int kWarpsM_, int kWarpsN_, int kMT_, int kNT_>
struct Tile {
  static constexpr int kWarpsM = kWarpsM_, kWarpsN = kWarpsN_;
  static constexpr int kMT = kMT_, kNT = kNT_;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kBM = 16 * kMT * kWarpsM;  // rows per block
  static constexpr int kBN = 8 * kNT * kWarpsN;   // columns per block
  static constexpr int kLdw = padded_ld(kBN);     // W chunk row stride
  static constexpr int kStageFloats = kBK * kLdw;
  static constexpr size_t kRingBytes =
      sizeof(float) * (size_t)kStages * kStageFloats;
};

// x = hi + lo for a finite f32 x: hi = x rounded to TF32 (as cvt.rna.tf32.f32
// rounds: to nearest, ties away from zero, by integer ops at full rate),
// lo = x - hi, exact in f32, handed to the MMA as it is (the tensor cores
// read the top 19 bits of a TF32 operand, so lo is truncated to TF32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; with ok false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n cp.async groups of this thread are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Rows [0, kRows) and columns [c0, c0 + kCols) of a row-major matrix with
// row stride ld whose first row is src, into dst [kRows][kLd]: rows at or
// past valid_rows and columns at or past cols are zero-filled.  T: f32 or
// bf16.  With vec (ld, c0 and cols multiples of 16 / sizeof(T), src and
// the rows of dst 16-byte aligned) 16 bytes a copy, else one value: 4-byte
// copies for f32, plain loads and stores for bf16 (cp.async moves no
// fewer than 4 bytes), which the ring's barrier publishes alike.  Issues
// the copies only: the caller commits the group.
template <int kRows, int kCols, int kLd, int kThreads, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int ld,
                                          int valid_rows, int c0, int cols,
                                          bool vec) {
  constexpr int kPer = 16 / (int)sizeof(T);  // values a 16-byte copy
  static_assert(sizeof(T) == 4 ||
                    (kCols % kPer == 0 && (kLd * sizeof(T)) % 16 == 0),
                "16-byte copies of whole bf16 rows");
  if (vec) {
    constexpr int kVecs = kCols / kPer;
    for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
      const int r = i / kVecs, c = (i % kVecs) * kPer;
      const bool ok = r < valid_rows && c0 + c < cols;
      cp_async16(dst + r * kLd + c, ok ? src + (size_t)r * ld + c0 + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const bool ok = r < valid_rows && c0 + c < cols;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * kLd + c, ok ? src + (size_t)r * ld + c0 + c : src,
                  ok);
      } else {
        dst[r * kLd + c] = ok ? src[(size_t)r * ld + c0 + c] : T(0.0f);
      }
    }
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Before reading chunk c of a ring whose chunks are committed one group
// each, kStages - 1 ahead: wait for chunk c's group (and so for every group
// before it), then a barrier, after which every thread has also finished
// chunk c - 1, whose slot the next copy may take.
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<kStages - 2>();
  __syncthreads();
}

// One warp's share of one W chunk: acc[mt][nt] += A[mt rows, 32] *
// W[32, nt columns] in 3xTF32.  ws points at the chunk's row 0, at the
// warp's first column.  a_frag(mt, ks, a) writes the f32 values of the A
// fragment of m-tile mt at k-step ks, in the m16n8k8 row layout for lane
// (g = lane / 4, q = lane % 4):
//   a[0] = A[g][q], a[1] = A[g + 8][q], a[2] = A[g][q + 4],
//   a[3] = A[g + 8][q + 4]
// (rows within the m-tile, columns within the k-step).  The accumulator
// fragment holds C[g][2q], C[g][2q + 1], C[g + 8][2q], C[g + 8][2q + 1].
//
// The tensor cores round their f32 accumulator toward zero, so a long run
// of products into one accumulator drifts toward zero (at K = 20000 to
// 51x the error of f32 FMAs in the emulation of
// tests/test_torch_port_tf32x3.py).  So each chunk's 12 products per
// element go into a fresh accumulator, added into acc by one rounded f32
// add: the tensor cores' roundings stay relative to a 32-term partial
// sum.  fold(mt, i, acc, c) gives the new running value of accumulator
// element i of m-tile mt from the old one and the chunk's c: acc + c by
// default (AddFold); elements 0-1 lie in row g, 2-3 in row g + 8, which
// lets a fold scale by a per-row factor.  The chunk's n-tiles
// go kG at a time (a_frag is asked again for each group), which bounds
// the fresh accumulators' registers; within a group the three passes run
// over all its fragments in turn, so neighbouring MMAs are independent.
//
// mma_chunk_ab takes B's fragments from a functor too: b_frag(j, ks, b)
// writes the f32 values B[q][g] and B[q + 4][g] of n-tile j at k-step ks
// (rows within the k-step, column within the n-tile), so a kernel can
// keep B's chunk transposed in shared memory (the grouped matmul's dx
// reads S[g] rows as columns).  mma_chunk is mma_chunk_ab with B the
// row-major W chunk at ws (f32 or bf16 values).  kExact: every A and B
// value is exact in TF32 (bf16 values), so one product a k-step, a_hi
// b_hi, gives what the three would.
struct AddFold {
  __device__ __forceinline__ float operator()(int, int, float acc,
                                              float c) const {
    return acc + c;
  }
};

template <int kMT, int kNT, int kG, bool kExact = false, class AFrag,
          class BFrag, class Fold = AddFold>
__device__ __forceinline__ void mma_chunk_ab(float (&acc)[kMT][kNT][4],
                                             AFrag a_frag, BFrag b_frag,
                                             Fold fold = Fold()) {
#pragma unroll
  for (int n0 = 0; n0 < kNT; n0 += kG) {
    constexpr int kLast = kNT % kG == 0 ? kG : kNT % kG;
    const int gn = n0 + kG <= kNT ? kG : kLast;  // n-tiles in this group
    float c[kMT][kG][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mt][j][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float a[4];
        a_frag(mt, ks, a);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(a[i], ahi[mt][i], alo[mt][i]);
      }
      uint32_t bhi[kG][2], blo[kG][2];
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        if (j >= gn) break;
        float b[2];
        b_frag(n0 + j, ks, b);
        split(b[0], bhi[j][0], blo[j][0]);
        split(b[1], bhi[j][1], blo[j][1]);
      }
      // the small products first, each pass over the whole group
      if constexpr (!kExact) {
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            if (j < gn) mma_tf32(c[mt][j], alo[mt], bhi[j]);
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            if (j < gn) mma_tf32(c[mt][j], ahi[mt], blo[j]);
      }
#pragma unroll
      for (int j = 0; j < kG; ++j)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          if (j < gn) mma_tf32(c[mt][j], ahi[mt], bhi[j]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j < gn)
            acc[mt][n0 + j][i] = fold(mt, i, acc[mt][n0 + j][i], c[mt][j][i]);
  }
}

template <int kMT, int kNT, int kG, int kLdw, bool kExact = false, class W,
          class AFrag, class Fold = AddFold>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMT][kNT][4],
                                          const W* __restrict__ ws,
                                          AFrag a_frag, Fold fold = Fold()) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  mma_chunk_ab<kMT, kNT, kG, kExact>(
      acc, a_frag,
      [&](int j, int ks, float (&b)[2]) {
        const W* w0 = ws + (ks * 8 + q) * kLdw + j * 8 + g;
        b[0] = widen(w0[0]);
        b[1] = widen(w0[4 * kLdw]);
      },
      fold);
}

}  // namespace tf32x3
