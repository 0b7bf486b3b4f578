// The second pass of the split-K decode kernels (K4, K5): merge each row's
// per-split partials (m, l, acc) into its output, deterministically.
//
// A split kernel writes, for row b, split s and query head h (h = hk * G +
// gh over Hkv KV heads of G query heads each), the fp32 partial row
// ((b * Hkv + hk) * nsplit + s) * G + gh: acc[DV] into part_acc and (m, l)
// into part_ml, with m in the log2 domain (scores scaled by scale *
// log2(e)). Splits past the row's filled length are never written and never
// read: row b has ceil(n_b / SPLIT) splits, n_b = min(pos_b, S - 1) + 1
// (none for pos_b < 0, which gives zeros). Split boundaries depend on SPLIT
// alone and no sum uses atomics, so a row's bits depend only on its own
// inputs, whatever the batch and the other rows' positions.
#pragma once

#include "tile.cuh"

namespace repro_torch {

constexpr int COMBINE_THREADS = 256;

// Slots 0..pos of a cache of S slots, at most S (pos >= S reads all of
// them: the ring cache), none for a negative pos.
__device__ __forceinline__ int visible_slots(const int* pos_vec,
                                             int pos_scalar, int b, int S) {
  const int pos = pos_vec != nullptr ? pos_vec[b] : pos_scalar;
  return max(0, min(pos, S - 1) + 1);
}

// One block per (query head, row, chunk of COMBINE_THREADS columns), a
// thread a column. The largest m is taken over the splits, then each chunk
// of COMBINE_THREADS splits has its weights exp2(m_s - M) put in shared
// memory, and each column sums l_s w_s and acc_s w_s in split order; no
// load of a column's sum waits on another.
template <typename T, int SPLIT>
__global__ void __launch_bounds__(COMBINE_THREADS)
split_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, T* __restrict__ o,
                     const int* __restrict__ pos_vec, int pos_scalar, int S,
                     int H, int Hkv, int DV, int nsplit) {
  constexpr int WARPS = COMBINE_THREADS / 32;
  __shared__ float sw[COMBINE_THREADS];
  __shared__ float sm[WARPS];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int col = blockIdx.z * COMBINE_THREADS + tid;
  const int n = visible_slots(pos_vec, pos_scalar, b, S);
  const int ns = (n + SPLIT - 1) / SPLIT;
  // split s of head h is row r0 + s * G of the partials
  const long r0 = ((long)b * Hkv + h / G) * nsplit * G + h % G;

  float mx = NEG_INF;
  for (int s = tid; s < ns; s += COMBINE_THREADS)
    mx = fmaxf(mx, part_ml[(r0 + (long)s * G) * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (tid % 32 == 0) sm[tid / 32] = mx;
  __syncthreads();
  float M = sm[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) M = fmaxf(M, sm[w]);

  float den = 0.f, num = 0.f;
  for (int c0 = 0; c0 < ns; c0 += COMBINE_THREADS) {
    __syncthreads();  // the last chunk's weights are read
    const int s = c0 + tid;
    sw[tid] = s < ns ? exp2f(part_ml[(r0 + (long)s * G) * 2] - M) : 0.f;
    __syncthreads();
    if (col < DV) {
      const int cn = min(COMBINE_THREADS, ns - c0);
#pragma unroll 8
      for (int j = 0; j < cn; ++j) {
        const long r = r0 + (long)(c0 + j) * G;
        den = fmaf(part_ml[r * 2 + 1], sw[j], den);
        num = fmaf(part_acc[r * DV + col], sw[j], num);
      }
    }
  }
  if (col < DV)
    store(o + ((long)b * H + h) * DV + col, num / fmaxf(den, 1e-30f));
}

// Launch the merge of B rows of H heads, DV columns each, on `stream`.
template <typename T, int SPLIT>
cudaError_t launch_split_combine(const float* part_acc, const float* part_ml,
                                 T* o, const int* pos_vec, int pos_scalar,
                                 int B, int S, int H, int Hkv, int DV,
                                 int nsplit, cudaStream_t stream) {
  const dim3 grid(H, B, (DV + COMBINE_THREADS - 1) / COMBINE_THREADS);
  split_combine_kernel<T, SPLIT><<<grid, COMBINE_THREADS, 0, stream>>>(
      part_acc, part_ml, o, pos_vec, pos_scalar, S, H, Hkv, DV, nsplit);
  return cudaGetLastError();
}

}  // namespace repro_torch
