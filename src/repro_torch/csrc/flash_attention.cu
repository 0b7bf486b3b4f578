// K3: prefill flash attention, forward, for Hopper (sm_90a): the fp32 path.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (pl.pallas_call at :113). Computes, for q (B, Sq, H, D), k (B, Sk, Hkv, D)
// and v (B, Sk, Hkv, Dv), out = softmax(q k^T * scale + mask) v, shaped
// (B, Sq, H, Dv) as the TPU kernel writes it, with an online
// softmax over KV tiles: fp32 running max, denominator and accumulator;
// causal (k <= q) and sliding-window (k > q - window) masks; GQA reads KV
// head h / (H / Hkv). Dv may differ from D: MLA prefill has q/k 96 wide
// and v 64 (minicpm3-4b), 192 and 128 (deepseek-v2), 48 and 32 at the
// reduced config; zamba2-7b's attention is 112 wide. Masked scores are
// -1e30 and the denominator is clamped at 1e-30, as in the TPU kernel. A
// query row that sees no key at all (possible only with Sq > Sk and a
// window) has no defined output: ref.py averages every value row, the TPU
// kernel and this one average the rows of the tiles they ran.
// When the caller passes an lse buffer (B, Sq, H) fp32, each row also writes
// its log-sum-exp m + log(max(l, 1e-30)), what the reference's _flash_fwd
// returns for the backward (src/repro/models/attention.py:95); a row that
// saw no key keeps m = -1e30, the reference's clamped value.
//
// This file is the float32 instantiation, the parity path: the card is held
// against the CPU in fp32 with TF32 off (chip_smoke.py's model phase,
// tests/test_torch_cuda.py), so its products stay in full fp32 FMA on the
// CUDA cores (67 TFLOP/s, not the tensor cores' TF32). bf16, the serving
// dtype, runs on the tensor cores in flash_attention_bf16.cu.
// What bounds it on the H100: ~4*D*S^2/2 flops a head over ~0.3 MB a head at
// S = 512, D = 128 in fp32: on the CUDA cores it is bound by operations.
// What the design does about it: one block per (query tile of 64 rows,
// head, batch) keeps the Q tile, one K tile and one V tile in shared memory,
// so every K/V element read from device memory serves 64 query rows; each
// thread keeps a 4 x (Dv/16) register tile of the accumulator and a 4 x 4
// tile of scores, so each shared-memory load feeds several FMAs. K/V tiles
// of KV head h / G are staged from the un-expanded cache; the causal mask
// skips every KV tile past the diagonal and a window skips the tiles before
// it, so skipped tiles are never read. Ragged Sq and Sk are masked in the
// kernel (zero-filled rows, masked scores), with no padded copies.

#include "tile.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int TY = 16;        // thread grid: TY x TX
constexpr int TX = 16;
constexpr int THREADS = TY * TX;
constexpr int RPT = BQ / TY;  // query rows per thread
constexpr int SPT = BK / TX;  // score columns per thread
constexpr int LPR = THREADS / BQ;  // softmax lanes per row

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + PAD) + BK * (D + PAD) + BK * (DV + PAD) +
                          BQ * (BK + PAD) + 3 * BQ);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int causal, int window, float scale) {
  constexpr int OPT = DV / TX;  // output columns per thread
  static_assert(DV % TX == 0, "v width must be a multiple of the thread grid");
  extern __shared__ float smem[];
  float* sQ = smem;                  // BQ x (D + PAD), pre-scaled
  float* sK = sQ + BQ * (D + PAD);   // BK x (D + PAD)
  float* sV = sK + BK * (D + PAD);   // BK x (DV + PAD)
  float* sP = sV + BK * (DV + PAD);  // BQ x (BK + PAD): scores, then probs
  float* sM = sP + BQ * (BK + PAD);  // running max per row
  float* sL = sM + BQ;               // running denominator per row
  float* sC = sL + BQ;               // this tile's rescale factor per row

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;

  const long q_stride = (long)H * D;
  const long k_stride = (long)Hkv * D;
  const long v_stride = (long)Hkv * DV;
  const long o_stride = (long)H * DV;
  stage_rows<T, D>(sQ, q + ((long)b * Sq + q0) * q_stride + (long)h * D,
                   q_stride, BQ, min(BQ, Sq - q0), scale);
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;

  // KV tiles that hold a key some row of this block may see: causal stops
  // at the diagonal, a window starts at the oldest key the first row sees.
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + (long)b * Sk * k_stride + (long)hk * D;
  const T* vb = v + (long)b * Sk * v_stride + (long)hk * DV;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    const int valid = min(BK, Sk - k0);
    stage_rows<T, D>(sK, kb + k0 * k_stride, k_stride, BK, valid, 1.f);
    stage_rows<T, DV>(sV, vb + k0 * v_stride, v_stride, BK, valid, 1.f);
    __syncthreads();

    // scores: rows ty*RPT + i, keys tx + TX*j
    float s[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[SPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * (D + PAD) + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) kv[j] = sK[(tx + TX * j) * (D + PAD) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int kp = k0 + tx + TX * j;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        sP[(ty * RPT + i) * (BK + PAD) + tx + TX * j] = ok ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: LPR neighbouring lanes share a row
    {
      const int r = tid / LPR;
      const int part = tid % LPR;
      float* row = sP + r * (BK + PAD) + part * (BK / LPR);
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BK / LPR; ++c) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 1; off < LPR; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / LPR; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < LPR; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float c = sC[ty * RPT + i];
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * (BK + PAD) + kk];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vv[j] = sV[kk * (DV + PAD) + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int qp = q0 + r;
    if (qp < Sq) {
      const float inv = 1.f / fmaxf(sL[r], 1e-30f);
      T* out = o + ((long)b * Sq + qp) * o_stride + (long)h * DV;
#pragma unroll
      for (int j = 0; j < OPT; ++j) store(out + tx + TX * j, acc[i][j] * inv);
    }
  }
  if (lse != nullptr && tid < BQ && q0 + tid < Sq)
    lse[((long)b * Sq + q0 + tid) * H + h] =
        sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, Hkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_dv(int DV, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  switch (DV) {
    case 32:
      return launch<T, D, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 64:
      return launch<T, D, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 112:
      return launch<T, D, 112>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 128:
      return launch<T, D, 128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_d(int D, int DV, const void* q, const void* k, const void* v,
               void* o, float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
               int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_dv<T, 32>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 48:
      return dispatch_dv<T, 48>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 64:
      return dispatch_dv<T, 64>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 96:
      return dispatch_dv<T, 96>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 112:
      return dispatch_dv<T, 112>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 128:
      return dispatch_dv<T, 128>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 192:
      return dispatch_dv<T, 192>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes; float32 tensors only, lse (B, Sq, H)
// float32 or null. Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Sk,
                                   int H, int Hkv, int D, int Dv, int causal,
                                   int window, float scale, void* stream) {
  using namespace repro_torch;
  return dispatch_d<float>(D, Dv, q, k, v, o, static_cast<float*>(lse), B, Sq,
                           Sk, H, Hkv, causal, window, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
