// K5: absorbed (latent-space) MLA decode attention, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mla_decode.py::mla_decode_attention_pallas
// (pl.pallas_call at :113). For the absorbed queries q_lat (B, H, R) (W_uk
// already folded in by the caller) and q_rope (B, H, Rr), the compressed
// cache c (B, S, R) and the shared roped keys kr (B, S, Rr), row b attends
// to the slots 0..pos_b:
//     s_k = (q_lat . c_k + q_rope . kr_k) * scale,   k <= pos_b
//     out = sum_k softmax(s)_k c_k                   (B, H, R), q_lat's dtype
// with an fp32 online softmax (running max, denominator and accumulator)
// over tiles of slots. The caller applies W_uv to the latent output. The TPU
// kernel takes one scalar pos; this one also takes a per-row (B,) int32 pos,
// which the serving engine decodes with. A row whose pos is negative sees no
// slot and gets zeros.
//
// What bounds it on the H100: every cached latent element is used by all H
// heads twice (score and combine), about 2H flops a byte in bf16 (80 at
// minicpm3-4b's H = 40, 256 at deepseek-v2's H = 128): under the card's
// bf16 ridge (~295), so the least time is set by the bytes of the filled
// part of the cache. This first version multiplies on the CUDA cores in
// fp32 FMA (67 TFLOP/s, not the tensor cores' 989), so in practice it is
// bound by operations.
// What the design does about it: one block per (head block of 8, row);
// each warp is one head. A tile of 32 slots of (c || kr) is staged once
// into shared memory as fp32 and serves both passes of every head of the
// block: the scores (lane j takes slot j, so a warp's 32 scores need no
// reduction across warps and the online softmax stays in registers) and
// the latent combine (lane l accumulates columns l, l + 32, ... of R, so
// acc lives in R / 32 registers a thread). The walk stops at the row's own
// pos: slots past it are never read. Each block still reads the whole
// filled cache of its row, once per head block (5 times at H = 40);
// splitting the walk over blocks (split-K) and wgmma/TMA are later work.

#include "tile.cuh"

namespace repro_torch {
namespace {

constexpr int HB = 8;              // heads per block, one warp each
constexpr int BK = 32;             // slots per tile, one a lane
constexpr int THREADS = HB * 32;

template <int R, int RR>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((HB + BK) * (R + RR + PAD) + HB * BK);
}

template <typename T, int R, int RR>
__global__ void __launch_bounds__(THREADS)
mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ c, const T* __restrict__ kr,
                  T* __restrict__ o, const int* __restrict__ pos_vec,
                  int pos_scalar, int S, int H, float scale) {
  constexpr int W = R + RR + PAD;  // odd: R, RR are multiples of 16
  constexpr int RPL = R / 32;  // latent columns a lane accumulates
  extern __shared__ float smem[];
  float* sQ = smem;         // HB x W: q_lat || q_rope
  float* sC = sQ + HB * W;  // BK x W: c || kr of this tile's slots
  float* sP = sC + BK * W;  // HB x BK: this tile's probabilities

  const int h0 = blockIdx.x * HB;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nh = min(HB, H - h0);  // heads of this block that exist

  stage_rows_pitch<T, R>(sQ, W, q_lat + ((long)b * H + h0) * R, R, HB, nh, 1.f);
  stage_rows_pitch<T, RR>(sQ + R, W, q_rope + ((long)b * H + h0) * RR, RR, HB,
                          nh, 1.f);
  const int pos = pos_vec ? pos_vec[b] : pos_scalar;
  const int n_keys = min(S, pos + 1);  // slots 0..pos

  float m = NEG_INF, l = 0.f;
  float acc[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) acc[i] = 0.f;

  const T* cb = c + (long)b * S * R;
  const T* kb = kr + (long)b * S * RR;
  const float* qrow = sQ + warp * W;
  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();  // sQ staged; the previous tile's reads of sC, sP done
    const int valid = min(BK, n_keys - k0);
    stage_rows_pitch<T, R>(sC, W, cb + (long)k0 * R, R, BK, valid, 1.f);
    stage_rows_pitch<T, RR>(sC + R, W, kb + (long)k0 * RR, RR, BK, valid, 1.f);
    __syncthreads();

    // score of head `warp` against slot k0 + lane
    const float* crow = sC + lane * W;
    float sl = 0.f, sr = 0.f;
#pragma unroll 8
    for (int r = 0; r < R; ++r) sl = fmaf(qrow[r], crow[r], sl);
#pragma unroll
    for (int r = R; r < R + RR; ++r) sr = fmaf(qrow[r], crow[r], sr);
    const float s = lane < valid ? (sl + sr) * scale : NEG_INF;

    // online softmax over the warp's 32 scores
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float p = expf(s - m_new);
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    sP[warp * BK + lane] = p;
    __syncwarp();

    // latent combine from the same tile: acc = acc * corr + sum_j p_j c_j
#pragma unroll
    for (int i = 0; i < RPL; ++i) acc[i] *= corr;
    for (int j = 0; j < valid; ++j) {
      const float pj = sP[warp * BK + j];
      const float* cj = sC + j * W + lane;
#pragma unroll
      for (int i = 0; i < RPL; ++i) acc[i] = fmaf(pj, cj[32 * i], acc[i]);
    }
  }

  if (warp < nh) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* out = o + ((long)b * H + h0 + warp) * R + lane;
#pragma unroll
    for (int i = 0; i < RPL; ++i) store(out + 32 * i, acc[i] * inv);
  }
}

template <typename T, int R, int RR>
int launch(const void* q_lat, const void* q_rope, const void* c, const void* kr,
           void* o, const int* pos_vec, int pos_scalar, int B, int S, int H,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<R, RR>();
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel<T, R, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + HB - 1) / HB, B);
  mla_decode_kernel<T, R, RR><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(c), static_cast<const T*>(kr), static_cast<T*>(o),
      pos_vec, pos_scalar, S, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int dispatch_rr(int RR, const void* ql, const void* qr, const void* c,
                const void* kr, void* o, const int* pv, int ps, int B, int S,
                int H, float scale, cudaStream_t st) {
  switch (RR) {
    case 16: return launch<T, R, 16>(ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    case 32: return launch<T, R, 32>(ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    case 64: return launch<T, R, 64>(ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_r(int R, int RR, const void* ql, const void* qr, const void* c,
               const void* kr, void* o, const int* pv, int ps, int B, int S,
               int H, float scale, cudaStream_t st) {
  switch (R) {
    case 32: return dispatch_rr<T, 32>(RR, ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    case 64: return dispatch_rr<T, 64>(RR, ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    case 128: return dispatch_rr<T, 128>(RR, ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    case 256: return dispatch_rr<T, 256>(RR, ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    case 512: return dispatch_rr<T, 512>(RR, ql, qr, c, kr, o, pv, ps, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. pos_vec
// is a (B,) int32 device pointer, or null to use pos_scalar for every row.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int mla_decode_fwd(const void* q_lat, const void* q_rope,
                              const void* c, const void* kr, void* o,
                              const int* pos_vec, int pos_scalar, int B, int S,
                              int H, int R, int RR, int dtype, float scale,
                              void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_r<float>(R, RR, q_lat, q_rope, c, kr, o, pos_vec, pos_scalar,
                             B, S, H, scale, st);
  if (dtype == 1)
    return dispatch_r<__nv_bfloat16>(R, RR, q_lat, q_rope, c, kr, o, pos_vec,
                                     pos_scalar, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mla_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
