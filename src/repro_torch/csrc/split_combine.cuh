// The second pass of the split-K decode kernels (K4, K5): merge each row's
// per-split partials (m, l, acc) into its output, deterministically.
//
// A split kernel writes, for row b, split s and query head h (h = hk * G +
// gh over Hkv KV heads of G query heads each), the fp32 partial row
// ((b * Hkv + hk) * nsplit + s) * G + gh: acc[DV] into part_acc and (m, l)
// into part_ml, with m in the log2 domain (scores scaled by scale *
// log2(e)). Row b sees the slots LiveSlots gives: with window 0, slots
// 0..min(pos_b, S - 1) (none for pos_b < 0, which gives zeros); with a
// window w > 0, the ring's slots younger than min(w, pos_b + 1). A split
// with no live slot is never written and never read: the live splits are
// at most two runs of split indices (live_splits), which the split kernel
// and the combine compute by the same rule. Split boundaries depend on
// SPLIT alone and no sum uses atomics, so a row's bits depend only on its
// own inputs, whatever the batch and the other rows' positions.
#pragma once

#include "tile.cuh"

namespace repro_torch {

constexpr int COMBINE_THREADS = 256;

// The slots row b attends to: `count` slots ending at `newest` and going
// back around the ring, newest, newest - 1, ... (mod S). Without a window
// (window <= 0) that is slots 0..min(pos, S - 1), all S once pos >= S (the
// ring cache), none for a negative pos. With a window w > 0 it is the
// reference's ring rule: slot j holds the token of age (pos mod S - j) mod
// S and is live iff that age < min(w, pos + 1).
struct LiveSlots {
  int newest;  // the newest live slot
  int count;   // live slots, 0..S
  int S;

  // slot j (0 <= j < S) is live
  __device__ __forceinline__ bool at(int j) const {
    int age = newest - j;
    if (age < 0) age += S;
    return age < count;
  }
  // some slot of [a, b) is live (0 <= a < b <= S)
  __device__ __forceinline__ bool any(int a, int b) const {
    if (count <= 0) return false;
    const int lo = newest - count + 1;  // < 0: the run wraps past slot 0
    if (lo >= 0) return a <= newest && b - 1 >= lo;
    return a <= newest || b - 1 >= lo + S;
  }
};

__device__ __forceinline__ LiveSlots live_slots(const int* pos_vec,
                                                int pos_scalar, int b, int S,
                                                int window) {
  const int pos = pos_vec != nullptr ? pos_vec[b] : pos_scalar;
  if (window <= 0) {
    const int n = max(0, min(pos, S - 1) + 1);
    return {n - 1, n, S};
  }
  if (pos < 0) return {0, 0, S};
  const int w = min(window, S);
  return {pos % S, pos < w ? pos + 1 : w, S};
}

// The splits of SPLIT slots that hold a live slot, in increasing order, as
// two runs [a0, a0 + na) and [b0, b0 + nb) (nb = 0 unless the live slots
// wrap past slot 0 and leave a whole split between the runs dead). Without
// a window this is splits 0 .. ceil(n / SPLIT) - 1, as before the window
// existed.
struct LiveSplits {
  int a0, na, b0, nb;
  __device__ __forceinline__ int total() const { return na + nb; }
  __device__ __forceinline__ int split(int k) const {
    return k < na ? a0 + k : b0 + (k - na);
  }
};

template <int SPLIT>
__device__ __forceinline__ LiveSplits live_splits(const LiveSlots& L,
                                                  int nsplit) {
  if (L.count <= 0) return {0, 0, 0, 0};
  const int lo = L.newest - L.count + 1;
  const int hi = L.newest / SPLIT;
  if (lo >= 0) return {lo / SPLIT, hi - lo / SPLIT + 1, 0, 0};
  const int b0 = (lo + L.S) / SPLIT;  // the split of the oldest live slot
  if (b0 <= hi + 1) return {0, nsplit, 0, 0};
  return {0, hi + 1, b0, nsplit - b0};
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
                     int window, int H, int Hkv, int DV, int nsplit) {
  constexpr int WARPS = COMBINE_THREADS / 32;
  __shared__ float sw[COMBINE_THREADS];
  __shared__ float sm[WARPS];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int col = blockIdx.z * COMBINE_THREADS + tid;
  const LiveSplits live = live_splits<SPLIT>(
      live_slots(pos_vec, pos_scalar, b, S, window), nsplit);
  const int ns = live.total();
  // split s of head h is row r0 + s * G of the partials
  const long r0 = ((long)b * Hkv + h / G) * nsplit * G + h % G;

  float mx = NEG_INF;
  for (int k = tid; k < ns; k += COMBINE_THREADS)
    mx = fmaxf(mx, part_ml[(r0 + (long)live.split(k) * G) * 2]);
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
    const int k = c0 + tid;
    sw[tid] = k < ns ? exp2f(part_ml[(r0 + (long)live.split(k) * G) * 2] - M)
                     : 0.f;
    __syncthreads();
    if (col < DV) {
      const int cn = min(COMBINE_THREADS, ns - c0);
#pragma unroll 8
      for (int j = 0; j < cn; ++j) {
        const long r = r0 + (long)live.split(c0 + j) * G;
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
                                 int window, int B, int S, int H, int Hkv,
                                 int DV, int nsplit, cudaStream_t stream) {
  const dim3 grid(H, B, (DV + COMBINE_THREADS - 1) / COMBINE_THREADS);
  split_combine_kernel<T, SPLIT><<<grid, COMBINE_THREADS, 0, stream>>>(
      part_acc, part_ml, o, pos_vec, pos_scalar, S, window, H, Hkv, DV,
      nsplit);
  return cudaGetLastError();
}

}  // namespace repro_torch
