// K4: single-token (decode) GQA attention over a KV cache, for Hopper (sm_90a),
// as split-K flash-decoding.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_pallas
// (pl.pallas_call at :103). For q (B, H, D), a k cache (B, S, Hkv, D) and a
// v cache (B, S, Hkv, Dv), row b attends to the cache slots 0..pos_b:
// out = softmax(q k^T * scale) v over those slots, with fp32 running max,
// denominator and accumulator; output (B, H, Dv) in q's dtype. The TPU
// kernel takes one scalar pos; this one also takes a per-row (B,) int32 pos,
// which the serving engine decodes with. pos >= S reads all S slots (the
// ring cache). A window w > 0, which the TPU kernel does not take (an
// extension, for a call whose window is narrower than its ring), keeps the
// slots of the reference's age rule: slot j is live iff (pos mod S - j) mod
// S < min(w, pos + 1) (split_combine.cuh's LiveSlots).
//
// What bounds it on the H100: each cached K/V element is used by the G query
// heads of its KV head, so the work is about G flops a byte in bf16 (7 at
// G = 7), far under the card's ridge (~295): it is bound by bytes, and the
// bytes are the filled part of the cache. One block per (KV head, row)
// walking its cache alone, as the first version did, leaves most of the 132
// SMs idle (32 blocks at 8 rows and 4 KV heads) and each block waiting on
// its own loads.
// What the design does about it:
// - The walk is split across blocks: a grid of (Hkv, B, ceil(S / SPLIT))
//   blocks, each over SPLIT = 64 slots. The grid is sized from the capacity
//   S; a block whose split holds no live slot (past pos_b, or wholly
//   before the window) exits at once, so the bytes read follow the live
//   slots and pos never goes to the host. Within a split, a tile with no
//   live slot is skipped, a dead slot's row is zero-filled without a read
//   and its score masked.
// - Within a split, K/V tiles of 32 slots stay in the cache's dtype in
//   shared memory (rows padded by 16 bytes), filled by 16-byte cp.async into
//   two stages, both issued at the start: the second tile loads while the
//   first computes, and the block waits on device memory once. Each
//   tile serves all G query heads of its KV head, so the cache is read once,
//   never once per query head and never expanded.
// - A warp serves heads w and w + 8 (eight warps, so that at G = 7 each
//   warp carries one head's chain): lane j scores slot j, the online
//   softmax runs in the warp's registers (max and sum by shuffles), and lane
//   l accumulates value columns 2l, 2l + 1, 2l + 64, 2l + 65.
// - Each split writes its (m, l, acc[Dv]) in fp32 to scratch the wrapper
//   allocates; split_combine_kernel (split_combine.cuh, shared with K5), one
//   block per (query head, row) and a thread a column, merges the live
//   splits (0 .. ceil((pos_b + 1) / SPLIT) - 1 without a window), summing
//   in split order with loads that do not wait on each other. Split
//   boundaries depend on SPLIT alone and no sum uses atomics, so row b's
//   result depends only on its own q, cache and pos: the same bits whether
//   it is decoded alone or beside other rows.

#include "mma.cuh"
#include "split_combine.cuh"
#include "tile.cuh"

namespace repro_torch {
namespace {

constexpr int SPLIT = 64;      // cache slots a block: the split boundaries
constexpr int BK = 32;         // slots a tile: one a lane; a split is 2 tiles
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int GMAX = 16;       // most query heads per KV head
constexpr int HPW = GMAX / WARPS;  // heads a warp serves at most
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D, int DV>
struct Tiles {
  static constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte chunk
  static constexpr int KP = D + VEC;          // row pitches, in elements
  static constexpr int VP = DV + VEC;
  static constexpr int K = BK * KP;           // one stage, in elements
  static constexpr int V = BK * VP;
  static constexpr size_t bytes =
      sizeof(float) * GMAX * D + sizeof(T) * 2 * (K + V);
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Issue the copy of a tile's BK rows of W elements, `stride` apart in device
// memory, into shared memory rows `pitch` apart; row r is slot t0 + r, and
// a row past the cache or not live is zero-filled without a read.
template <typename T, int W>
__device__ __forceinline__ void load_rows(T* dst, int pitch,
                                          const T* __restrict__ src,
                                          long stride, int t0,
                                          const LiveSlots& live) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = W / VEC;
  static_assert(W % VEC == 0, "row must be a whole number of 16-byte chunks");
  for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * VEC;
    const bool ok = t0 + r < live.S && live.at(t0 + r);
    cp_async_16(dst + r * pitch + c, ok ? src + r * stride + c : src,
                ok ? 16 : 0);
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos_vec,
                    int pos_scalar, int S, int window, int H, int Hkv,
                    float scale_log2, float* __restrict__ part_acc,
                    float* __restrict__ part_ml) {
  using L = Tiles<T, D, DV>;
  constexpr int NP = (DV + 63) / 64;  // column pairs a lane, per head
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const LiveSlots live = live_slots(pos_vec, pos_scalar, b, S, window);
  const int s0 = sp * SPLIT;
  const int s1 = min(s0 + SPLIT, S);
  // no live slot: nothing to read, nothing to write (the combine skips it)
  if (!live.any(s0, s1)) return;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // G x D, fp32
  T* sK = reinterpret_cast<T*>(sQ + GMAX * D);     // two stages
  T* sV = sK + 2 * L::K;                           // two stages

  const long k_stride = (long)Hkv * D;
  const long v_stride = (long)Hkv * DV;
  const T* kb = kc + (long)b * S * k_stride + (long)hk * D;
  const T* vb = vc + (long)b * S * v_stride + (long)hk * DV;
  // both tiles of the split in flight at once, each into its own stage;
  // a tile with no live slot is neither loaded nor computed
  bool tile_live[2];
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int t0 = s0 + st * BK;
    tile_live[st] = t0 < s1 && live.any(t0, min(t0 + BK, s1));
    if (tile_live[st]) {
      load_rows<T, D>(sK + st * L::K, L::KP, kb + t0 * k_stride, k_stride, t0,
                      live);
      load_rows<T, DV>(sV + st * L::V, L::VP, vb + t0 * v_stride, v_stride,
                       t0, live);
    }
    cp_async_commit();
  }
  const T* qb = q + ((long)b * H + (long)hk * G) * D;  // G rows of D
  for (int i = threadIdx.x; i < G * D / L::VEC; i += THREADS) {
    const uint4 u = *reinterpret_cast<const uint4*>(qb + i * L::VEC);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) sQ[i * L::VEC + j] = to_float(e[j]);
  }

  float m[HPW], l[HPW], acc[HPW][NP][2];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[hh][c][0] = acc[hh][c][1] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int t0 = s0 + st * BK;
    if (!tile_live[st]) continue;
    if (st == 0)
      cp_async_wait<1>();  // the first tile landed; the second may be loading
    else
      cp_async_wait<0>();
    __syncthreads();  // tile st (and q) visible to every warp
    const bool lane_live = t0 + lane < s1 && live.at(t0 + lane);
    const T* kr = sK + st * L::K + lane * L::KP;
    const T* sv = sV + st * L::V;

    // scores: lane j against slot t0 + j, for each head of the warp
    float s[HPW];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) s[hh] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += L::VEC) {
      const uint4 u = *reinterpret_cast<const uint4*>(kr + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const int gh = warp + WARPS * hh;
        if (gh < G) {
          const float* qr = sQ + gh * D + c;
#pragma unroll
          for (int j = 0; j < L::VEC; ++j) s[hh] = fmaf(qr[j], to_float(e[j]), s[hh]);
        }
      }
    }

#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int gh = warp + WARPS * hh;
      if (gh >= G) continue;
      const float x = lane_live ? s[hh] * scale_log2 : NEG_INF;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[hh], mx);
      const float p = exp2f(x - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = exp2f(m[hh] - m_new);
      l[hh] = l[hh] * corr + sum;
      m[hh] = m_new;
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        acc[hh][c][0] *= corr;
        acc[hh][c][1] *= corr;
      }
      // dead slots have p = 0 and zero-filled v rows
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          const int col = 2 * lane + 64 * c;
          if (col < DV) {
            const float2 vv = load2(sv + j * L::VP + col);
            acc[hh][c][0] = fmaf(pj, vv.x, acc[hh][c][0]);
            acc[hh][c][1] = fmaf(pj, vv.y, acc[hh][c][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // this split's partial: (B, Hkv, nsplit, G) x [acc[DV]] and x [m, l]
  const long base = (((long)b * Hkv + hk) * gridDim.z + sp) * G;
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int gh = warp + WARPS * hh;
    if (gh >= G) continue;
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const int col = 2 * lane + 64 * c;
      if (col < DV)
        *reinterpret_cast<float2*>(part_acc + (base + gh) * DV + col) =
            make_float2(acc[hh][c][0], acc[hh][c][1]);
    }
    if (lane == 0)
      *reinterpret_cast<float2*>(part_ml + (base + gh) * 2) =
          make_float2(m[hh], l[hh]);
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* kc, const void* vc, void* o,
           const int* pos_vec, int pos_scalar, int window, float* part,
           int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  static_assert(SPLIT == 2 * BK, "a split is the two stages' tiles");
  constexpr size_t smem = Tiles<T, D, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (S + SPLIT - 1) / SPLIT;
  const int G = H / Hkv;
  float* part_acc = part;
  float* part_ml = part + (long)B * Hkv * nsplit * G * DV;
  decode_split_kernel<T, D, DV><<<dim3(Hkv, B, nsplit), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos_vec, pos_scalar, S, window, H, Hkv,
      scale * LOG2E, part_acc, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_combine<T, SPLIT>(part_acc, part_ml,
                                             static_cast<T*>(o), pos_vec,
                                             pos_scalar, window, B, S, H, Hkv,
                                             DV, nsplit, stream);
}

template <typename T, int D>
int dispatch_dv(int DV, const void* q, const void* kc, const void* vc, void* o,
                const int* pos_vec, int pos_scalar, int window, float* part,
                int B, int S, int H, int Hkv, float scale,
                cudaStream_t stream) {
  switch (DV) {
    case 32:
      return launch<T, D, 32>(q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    case 64:
      return launch<T, D, 64>(q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    case 112:
      return launch<T, D, 112>(q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    case 128:
      return launch<T, D, 128>(q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_d(int D, int DV, const void* q, const void* kc, const void* vc,
               void* o, const int* pos_vec, int pos_scalar, int window,
               float* part, int B, int S, int H, int Hkv, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_dv<T, 32>(DV, q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    case 64:
      return dispatch_dv<T, 64>(DV, q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    case 112:
      return dispatch_dv<T, 112>(DV, q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    case 128:
      return dispatch_dv<T, 128>(DV, q, kc, vc, o, pos_vec, pos_scalar, window, part, B, S, H, Hkv, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. pos_vec
// is a device pointer to B int32 positions, or null to use pos_scalar;
// window is 0 (slots 0..pos) or the ring's window (> 0).
// part is fp32 scratch on the card of at least B * Hkv * nsplit * (H / Hkv)
// * (Dv + 2) floats, nsplit = ceil(S / SPLIT); a caller whose nsplit differs
// (another SPLIT) is refused. Returns the CUDA error code of the launches
// (0 = launched).
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, void* o,
                                    const void* pos_vec, int pos_scalar,
                                    int window, void* part, int nsplit,
                                    int B, int S,
                                    int H, int Hkv, int D, int Dv, int dtype,
                                    float scale, void* stream) {
  using namespace repro_torch;
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > GMAX) return (int)cudaErrorInvalidValue;
  if (S < 1 || nsplit != (S + SPLIT - 1) / SPLIT || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pv = static_cast<const int*>(pos_vec);
  float* pt = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_d<float>(D, Dv, q, kc, vc, o, pv, pos_scalar, window, pt, B, S, H, Hkv, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, Dv, q, kc, vc, o, pv, pos_scalar, window, pt, B, S, H, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
