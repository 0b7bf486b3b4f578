// Shared helpers of the attention kernels: dtype conversion and the staging
// of a tile of rows from device memory into shared memory as fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float NEG_INF = -1e30f;  // the reference's mask value, not -inf
constexpr int PAD = 1;             // shared-memory row padding (bank spread)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copy `rows` rows of D elements, `stride` elements apart in device memory,
// into `dst` (row pitch `pitch` floats), multiplied by `scale`. Rows at or
// past `valid` are zero-filled: ragged edges are masked here, with no padded
// copy in device memory. Each thread moves 16 bytes per load, neighbouring
// threads on neighbouring addresses; the caller guarantees 16-byte aligned
// rows (the wrappers check it).
template <typename T, int D>
__device__ __forceinline__ void stage_rows_pitch(float* __restrict__ dst,
                                                 int pitch,
                                                 const T* __restrict__ src,
                                                 long stride, int rows,
                                                 int valid, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // vectors per row
  static_assert(D % VEC == 0, "row must be a whole number of 16-byte vectors");
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float* out = dst + r * pitch + c;
    if (r < valid) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = to_float(e[j]) * scale;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = 0.f;
    }
  }
}

// stage_rows_pitch with the row pitch D + PAD.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           long stride, int rows, int valid,
                                           float scale) {
  stage_rows_pitch<T, D>(dst, D + PAD, src, stride, rows, valid, scale);
}

}  // namespace repro_torch
