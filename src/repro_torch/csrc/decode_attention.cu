// K4: single-token (decode) GQA attention over a KV cache, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_pallas
// (pl.pallas_call at :103). For q (B, H, D) and caches (B, S, Hkv, D), row b
// attends to the cache slots 0..pos_b: out = softmax(q k^T * scale) v over
// those slots, with an fp32 online softmax over KV tiles; output (B, H, D)
// in q's dtype. The TPU kernel takes one scalar pos; this one also takes a
// per-row (B,) int32 pos, which the serving engine decodes with.
//
// What bounds it on the H100: each cached K/V element is used by the G query
// heads of its KV head, so the work is about G flops a byte in bf16 (7 at
// G = 7), far under the card's ridge (~295): it is bound by bytes, and the
// bytes are the filled part of the cache.
// What the design does about it: one block per (KV head, row) stages each
// K/V tile once into shared memory and serves all G query heads from it, so
// the cache is read once, never once per query head and never expanded. The
// block loads its own bound (pos[b], or the scalar) and stops its walk at
// pos: tiles past it are never read, so the bytes follow the filled length,
// not the capacity. Loads are 16 bytes a thread, neighbouring threads on
// neighbouring addresses. With B*Hkv blocks (32 at 8 rows, 4 KV heads) the
// card is far from full; splitting the walk across blocks (split-K) is
// later work.

#include "tile.cuh"

namespace repro_torch {
namespace {

constexpr int BK = 64;         // cache slots per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;       // most query heads per KV head

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (GMAX * (D + PAD) + 2 * BK * (D + PAD) + GMAX * BK + 3 * GMAX);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o,
              const int* __restrict__ pos_vec, int pos_scalar, int S, int H,
              int Hkv, float scale) {
  constexpr int GPP = THREADS / D;                  // heads per PV pass
  constexpr int NACC = (GMAX + GPP - 1) / GPP;      // accumulators a thread
  extern __shared__ float smem[];
  float* sQ = smem;                   // G x (D + PAD), pre-scaled
  float* sK = sQ + GMAX * (D + PAD);  // BK x (D + PAD)
  float* sV = sK + BK * (D + PAD);    // BK x (D + PAD)
  float* sP = sV + BK * (D + PAD);    // G x BK: scores, then probs
  float* sM = sP + GMAX * BK;         // running max per head
  float* sL = sM + GMAX;              // running denominator per head
  float* sC = sL + GMAX;              // this tile's rescale factor per head

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;

  const int pos = pos_vec != nullptr ? pos_vec[b] : pos_scalar;
  const int n = min(pos + 1, S);  // slots 0..pos are visible

  stage_rows<T, D>(sQ, q + ((long)b * H + (long)hk * G) * D, D, G, G, scale);
  if (tid < G) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int d_own = tid % D;
  const int g_own = tid / D;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  const long stride = (long)Hkv * D;
  const T* kb = kc + (long)b * S * stride + (long)hk * D;
  const T* vb = vc + (long)b * S * stride + (long)hk * D;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    const int valid = min(BK, n - k0);
    stage_rows<T, D>(sK, kb + k0 * stride, stride, BK, valid, 1.f);
    stage_rows<T, D>(sV, vb + k0 * stride, stride, BK, valid, 1.f);
    __syncthreads();

    // scores: thread owns slot kk of the tile, for heads g, g + THREADS/BK...
    {
      const int kk = tid % BK;
      for (int g = tid / BK; g < G; g += THREADS / BK) {
        const float* qr = sQ + g * (D + PAD);
        const float* kr = sK + kk * (D + PAD);
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        sP[g * BK + kk] = kk < valid ? s : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: one warp a head, two slots a lane
    {
      const int w = tid / 32;
      const int lane = tid % 32;
      for (int g = w; g < G; g += WARPS) {
        float* row = sP + g * BK;
        float a = row[lane];
        float c = row[lane + 32];
        float mx = fmaxf(a, c);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = sM[g];
        const float m_new = fmaxf(m_prev, mx);
        a = expf(a - m_new);
        c = expf(c - m_new);
        row[lane] = a;
        row[lane + 32] = c;
        float sum = a + c;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          sC[g] = corr;
          sL[g] = sL[g] * corr + sum;
          sM[g] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: thread owns column d_own of heads g_own + GPP*j
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int g = g_own + GPP * j;
      if (g < G) {
        const float* pr = sP + g * BK;
        float a = acc[j] * sC[g];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a = fmaf(pr[kk], sV[kk * (D + PAD) + d_own], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int g = g_own + GPP * j;
    if (g < G) {
      const float l = fmaxf(sL[g], 1e-30f);
      store(o + ((long)b * H + (long)hk * G + g) * D + d_own, acc[j] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, void* o,
           const int* pos_vec, int pos_scalar, int B, int S, int H, int Hkv,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), pos_vec, pos_scalar, S,
      H, Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kc, const void* vc, void* o,
               const int* pos_vec, int pos_scalar, int B, int S, int H,
               int Hkv, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kc, vc, o, pos_vec, pos_scalar, B, S, H, Hkv, scale, stream);
    case 64:
      return launch<T, 64>(q, kc, vc, o, pos_vec, pos_scalar, B, S, H, Hkv, scale, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, o, pos_vec, pos_scalar, B, S, H, Hkv, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. pos_vec
// is a device pointer to B int32 positions, or null to use pos_scalar.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, void* o,
                                    const void* pos_vec, int pos_scalar, int B,
                                    int S, int H, int Hkv, int D, int dtype,
                                    float scale, void* stream) {
  using namespace repro_torch;
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > GMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pv = static_cast<const int*>(pos_vec);
  if (dtype == 0)
    return dispatch_d<float>(D, q, kc, vc, o, pv, pos_scalar, B, S, H, Hkv, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, kc, vc, o, pv, pos_scalar, B, S, H, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
