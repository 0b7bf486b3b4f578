// K3: prefill flash attention, forward, for Hopper (sm_90a): the bf16 path,
// on the tensor cores.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (pl.pallas_call at :113), for bf16 q (B, Sq, H, D), k (B, Sk, Hkv, D) and
// v (B, Sk, Hkv, Dv): out = softmax(q k^T * scale + mask) v, (B, Sq, H, Dv)
// in bf16, with what flash_attention.cu (the fp32 path) computes: causal and
// sliding-window masks, GQA by h / (H / Hkv), masked scores of -1e30, the
// denominator clamped at 1e-30, ragged Sq and Sk masked in the kernel with
// no padded copy, tiles past the diagonal or before the window never read.
// When the caller passes an lse buffer (B, Sq, H) fp32, each row also writes
// its log-sum-exp m + log(l) in natural-log units, what the reference's
// _flash_fwd returns for the backward (src/repro/models/attention.py:95):
// the row max kept in base 2 is turned back once, at the write. A row that
// saw no key keeps m = -1e30, the reference's clamped value.
//
// What bounds it on the H100: at the serving shapes (S = 512, D = 128,
// G = 7, causal) the work is ~4*D*S^2/2 flops a head over ~0.3 MB a head,
// about 220 flops a byte, under the card's bf16 ridge (~295): the least time
// is set by bytes. On the tensor cores the operations stop being the limit;
// what holds the kernel back is the latency of each block's chain of tiles
// (ldmatrix, mma, the softmax's shuffles and exponentials, a barrier a
// tile), with 16 query rows a warp.
// What the design does about it (the FlashAttention-2 arrangement):
// - Four warps a block, each owning 16 of the block's 64 query rows. Both
//   products run on the tensor cores, mma.sync m16n8k16 bf16 with fp32
//   accumulators, fed by ldmatrix: S = Q K^T stays in registers, the online
//   softmax runs on its fragments in fp32 (2^x on scores scaled by
//   scale * log2(e), so q is rounded once, on its way in), and P, rounded to
//   bf16 in registers, is the A operand of P V without a trip through
//   shared memory. The row max and denominator are reduced over the four
//   lanes that share a row.
// - Q, K and V tiles stay bf16 in shared memory, rows padded by 16 bytes so
//   that the eight rows an ldmatrix phase reads fall on distinct banks.
// - K/V tiles of 32 keys come in a ring of three stages filled by 16-byte
//   cp.async: tiles j + 1 and j + 2 load while tile j computes, one barrier
//   a tile. At D = 128 a block holds 70 KB, so three blocks share an SM.
// - Causal blocks launch heaviest first (the last query tile of every head
//   before the first), and only tiles that straddle the diagonal, the
//   window's edge or the end of the keys pay for the mask.
// - Q's fragments stay in registers up to D = 128; at D = 192 they are
//   read again from shared memory for every tile, which keeps the registers
//   (scores, the 16 x Dv accumulator) clear of spills.
// The fp32 path (flash_attention.cu) keeps the CUDA-core design. wgmma with
// a TMA producer warp is not used; PERF.md records what the mma.sync design
// reaches and what a later one would change.

#include "mma.cuh"
#include "tile.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

// BK and STAGES: scripts/k3_variants.py times other values of the two.
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per KV tile
constexpr int STAGES = 3;     // K/V tiles in the ring
constexpr int WARPS = 4;      // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr int SPAD = 8;       // row pad in bf16 elements (16 bytes)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x; ex2.approx.ftz flushes results below 2^-126 to 0 (a p that small
// adds nothing to a sum whose largest term is 1).
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int DV>
struct Tiles {
  static constexpr int QP = D + SPAD;   // row pitches, in elements
  static constexpr int KP = D + SPAD;
  static constexpr int VP = DV + SPAD;
  static constexpr int Q = BQ * QP;     // tile sizes, in elements
  static constexpr int K = BK * KP;
  static constexpr int V = BK * VP;
  static constexpr size_t bytes = sizeof(bf16) * (Q + STAGES * (K + V));
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                      int causal, int window, float scale_log2) {
  using L = Tiles<D, DV>;
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;       // n-tiles of the scores (keys)
  constexpr int NO = DV / 8;       // n-tiles of the output
  constexpr bool Q_IN_REGS = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + L::Q;            // STAGES tiles
  bf16* sV = sK + STAGES * L::K;   // STAGES tiles

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long q_stride = (long)H * D;
  const long k_stride = (long)Hkv * D;
  const long v_stride = (long)Hkv * DV;
  const long o_stride = (long)H * DV;
  const bf16* kb = k + (long)b * Sk * k_stride + (long)hk * D;
  const bf16* vb = v + (long)b * Sk * v_stride + (long)hk * DV;

  // KV tiles that hold a key some row of this block may see: causal stops
  // at the diagonal, a window starts at the oldest key the first row sees.
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK;
  const int t_hi = (k_hi + BK - 1) / BK;

  // Q and the first STAGES - 1 tiles in flight, one commit group each tile
  auto load_tile = [&](int it, int st) {
    const int k0 = it * BK;
    cp_async_rows<D, THREADS>(sK + st * L::K, L::KP, kb + k0 * k_stride,
                              k_stride, BK, min(BK, Sk - k0));
    cp_async_rows<DV, THREADS>(sV + st * L::V, L::VP, vb + k0 * v_stride,
                               v_stride, BK, min(BK, Sk - k0));
  };
  if (t_lo < t_hi)
    cp_async_rows<D, THREADS>(
        sQ, L::QP, q + ((long)b * Sq + q0) * q_stride + (long)h * D, q_stride,
        BQ, min(BQ, Sq - q0));
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_lo + i < t_hi) load_tile(t_lo + i, i);
    cp_async_commit();
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp's 16
  float l[2] = {0.f, 0.f};          // this lane's share of the denominator
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];

  // ldmatrix addresses: A rows of the warp, K rows (keys) and V rows (keys)
  const bf16* qa = sQ + (warp * 16 + (lane % 16)) * L::QP + (lane / 16) * 8;
  const int kr = (lane % 8) + 8 * (lane / 16);
  const int kc = 8 * ((lane / 8) % 2);
  const int vr = (lane % 8) + 8 * ((lane / 8) % 2);
  const int vc = 8 * (lane / 16);
  const int row0 = q0 + warp * 16 + g;  // query positions of rows g, g + 8

  int st = 0;  // the stage of tile it
  for (int it = t_lo; it < t_hi; ++it, st = st + 1 == STAGES ? 0 : st + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + STAGES - 1 < t_hi)  // into the stage tile it - 1 used
      load_tile(it + STAGES - 1, st == 0 ? STAGES - 1 : st - 1);
    cp_async_commit();
    if constexpr (Q_IN_REGS) {
      if (it == t_lo) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
      }
    }
    const bf16* sk = sK + st * L::K;
    const bf16* sv = sV + st * L::V;
    const int k0 = it * BK;

    // S = Q K^T, 16 x 64 a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qa + kk * 16);
      }
#pragma unroll
      for (int nn = 0; nn < NS / 2; ++nn) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sk + (nn * 16 + kr) * L::KP + kk * 16 + kc);
        mma_bf16_16816(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // scale into the log2 domain; mask only where the tile needs it
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int qp = row0 + 8 * (e / 2);
          const int kp = k0 + 8 * j + 2 * t + (e % 2);
          bool ok = kp < Sk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax on the fragments
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2_(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = exp2_(s[j][2 * r] - mx);
        s[j][2 * r + 1] = exp2_(s[j][2 * r + 1] - mx);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V, P from the score registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sv + (kk * 16 + vr) * L::VP + nn * 16 + vc);
        mma_bf16_16816(acc[2 * nn], a, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * nn + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp < Sq) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      bf16* out = o + ((long)b * Sq + qp) * o_stride + (long)h * DV + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16x2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      if (lse != nullptr && t == 0) {  // m from base 2 to natural log
        const float mn = m[r] == NEG_INF ? NEG_INF : m[r] * LN2;
        lse[((long)b * Sq + qp) * H + h] = mn + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = Tiles<D, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<D, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, H,
      Hkv, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_dv(int DV, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  switch (DV) {
    case 32:
      return launch<D, 32>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 64:
      return launch<D, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 112:
      return launch<D, 112>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 128:
      return launch<D, 128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch_d(int D, int DV, const void* q, const void* k, const void* v,
               void* o, float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
               int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_dv<32>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 48:
      return dispatch_dv<48>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 64:
      return dispatch_dv<64>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 96:
      return dispatch_dv<96>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 112:
      return dispatch_dv<112>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 128:
      return dispatch_dv<128>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    case 192:
      return dispatch_dv<192>(DV, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes; bfloat16 tensors only, lse (B, Sq, H)
// float32 or null. Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention_bf16_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int Sq, int Sk, int H, int Hkv,
                                        int D, int Dv, int causal, int window,
                                        float scale, void* stream) {
  using namespace repro_torch;
  return dispatch_d(D, Dv, q, k, v, o, static_cast<float*>(lse), B, Sq, Sk,
                    H, Hkv, causal, window, scale,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
