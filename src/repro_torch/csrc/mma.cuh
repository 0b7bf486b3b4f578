// Helpers of the tensor-core and asynchronous-copy paths (sm_90a): 16-byte
// cp.async into shared memory, ldmatrix, and the m16n8k16 bf16 mma.sync with
// fp32 accumulators. Fragment layouts are those of the PTX ISA: for lane l,
// g = l / 4 and t = l % 4; A (16 x 16, row) holds (g, 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B (16 x 8, col) holds
// (k = 2t..2t+1, n = g) and (k = 2t + 8.., n = g); C (16 x 8) holds
// (g, 2t..2t+1) and (g + 8, 2t..2t+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device memory to shared memory without the registers;
// with src_bytes = 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copy of `rows` rows of W bf16 elements (`stride` apart in
// device memory) into shared memory rows `pitch` apart, NTHREADS threads
// together, 16 bytes a copy; rows at or past `valid` are zero-filled without
// a read. Rows and pitch must be 16-byte aligned.
template <int W, int NTHREADS>
__device__ __forceinline__ void cp_async_rows(
    __nv_bfloat16* dst, int pitch, const __nv_bfloat16* __restrict__ src,
    long stride, int rows, int valid) {
  constexpr int CPR = W / 8;  // 16-byte chunks a row
  static_assert(W % 16 == 0, "row must be a whole number of k-steps");
  for (int i = threadIdx.x; i < rows * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * pitch + c, ok ? src + r * stride + c : src,
                ok ? 16 : 0);
  }
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way to the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
// (lanes 16..31 are not read but must hold a valid address).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: a 16 x 16 and b 16 x 8 in bf16, d in fp32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats (x0 in the low half, as pack_bf16x2) split into bf16 pairs hi
// and lo with hi + lo equal to them within 2^-17 relative: an fp32 operand
// of an mma that must keep more than bf16's 8 bits is issued twice, once
// with each half.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace repro_torch
