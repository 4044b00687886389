// Building blocks shared by the bf16 attention kernels for Hopper (sm_90a):
// 16-byte cp.async copies into shared memory (zero-filled where the source
// is out of range), ldmatrix loads of 8 x 8 bf16 tiles, and the
// mma.sync.m16n8k16 product with bf16 operands and fp32 accumulators.
//
// Tiles in shared memory are rows of `pitch` bf16 values, where pitch is the
// padded head dim plus 8: a row then spans an odd number of 16-byte chunks,
// so the 8 row addresses of one ldmatrix fall in 8 different 16-byte bank
// groups and the load is free of bank conflicts for any head dim that is a
// multiple of 16 (an XOR swizzle over 8 chunks would need the row to hold a
// multiple of 8 chunks, which D 80 = 10 chunks does not).
//
// Fragment layouts of m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// c = (lane % 4) * 2): A (16 x 16, row-major) a0 = (g, c..c+1),
// a1 = (g+8, c..c+1), a2 = (g, c+8..c+9), a3 = (g+8, c+8..c+9);
// B (16 x 8, k x n) b0 = (k c..c+1, n g), b1 = (k c+8..c+9, n g);
// C (16 x 8, fp32) c0, c1 = (g, c..c+1), c2, c3 = (g+8, c..c+1).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously: the first `bytes`
// (0..16) are read from src, the rest are zeroed.
__device__ __forceinline__ void cp_async_16_partial(void* dst, const void* src,
                                                    int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// All 16 bytes when `valid`; none read, 16 zeroed, when not.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  cp_async_16_partial(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives r[i] from matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same with each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a · b: a 16 x 16 bf16, b 16 x 8 bf16, d 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (round to nearest even), lo in the low
// half: the order mma.sync reads a fragment register in.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy a tile of `rows` rows of `chunks` 16-byte chunks each (the padded
// head dim / 8) from global memory (row r at src + r * row_stride elements)
// into shared memory at pitch `pitch`; rows >= valid_rows and chunks at or
// past `dim` are zero-filled.  Every thread of the block takes part.
template <int kThreads>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long row_stride,
    int rows, int valid_rows, int chunks, int dim, int pitch) {
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks;
    const bool ok = r < valid_rows && c * 8 < dim;
    const __nv_bfloat16* s = ok ? src + r * row_stride + c * 8 : src;
    cp_async_16(dst + r * pitch + c * 8, s, ok);
  }
}

}  // namespace bf16mma
