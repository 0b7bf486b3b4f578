// K5: absorbed (latent-space) MLA decode attention, for Hopper (sm_90a): the
// bf16 path, as split-K on the tensor cores.
//
// Replaces src/repro/kernels/mla_decode.py::mla_decode_attention_pallas
// (pl.pallas_call at :113), for bf16 q_lat (B, H, R), q_rope (B, H, Rr) and
// the caches c (B, S, R) and kr (B, S, Rr): what mla_decode.cu (the fp32
// path) computes,
//     s_k = (q_lat . c_k + q_rope . kr_k) * scale,   k <= pos_b
//     out = sum_k softmax(s)_k c_k                   (B, H, R), bf16
// with a scalar or a per-row (B,) int32 pos, pos >= S reading all S slots
// and a negative pos giving zeros. A window w > 0, which the TPU kernel does
// not take (an extension, as K4's), keeps the ring's slots of age < min(w,
// pos + 1) (split_combine.cuh's LiveSlots).
//
// What bounds it on the H100: every cached latent element is used by all H
// heads twice (score and combine), about 2H flops a byte (80 at
// minicpm3-4b's H = 40, 256 at deepseek-v2's H = 128), under the card's bf16
// ridge (~295): the least time is set by the bytes of the filled part of
// the cache, a few microseconds at the serving shapes. What holds a kernel
// back there is how many SMs wait on loads at once and how long each
// block's chain is.
// What the design does about it (FlashMLA's arrangement, on mma.sync):
// - Split-K over slots, as K4: a grid of (ceil(H / 16), ceil(S / SPLIT), B)
//   blocks, each over SPLIT = 64 slots of one row for a tile of 16 heads.
//   The grid follows the capacity S; a block whose split holds no live slot
//   (past pos_b, or wholly before the window) exits, so pos never goes to
//   the host. A tile with no live slot is skipped; a dead slot's row is
//   zero-filled without a read and its score masked. split_combine.cuh's kernel (K4's)
//   merges the splits in split order, without atomics, so a row's bits do
//   not depend on the batch or on the other rows' positions.
// - The split's two tiles of 32 slots of (c || kr) are staged once, as bf16
//   rows padded by 16 bytes, by 16-byte cp.async into two stages issued at
//   the start: the second loads while the first computes. Each tile serves
//   both products of all 16 heads of the block.
// - Both products on the tensor cores (mma.sync m16n8k16, fp32
//   accumulators): the 16 heads are the m dimension. Scores S = [q_lat ||
//   q_rope] (16 x (R + Rr)) . [c || kr]^T; the online softmax runs on S's
//   fragments in fp32 (log2 domain), and P, rounded to bf16 in registers,
//   is the A operand of O += P . c. Four warps share the scores (each
//   computes them, which costs no barrier) and split R: warp w owns columns
//   [w R / 4, (w + 1) R / 4), so R = 512 keeps 64 accumulators a lane.
// - Query fragments stay in registers up to R + Rr = 288 (minicpm3-4b) and
//   are read again from shared memory for each tile above that.
// wgmma, TMA and one block over all heads of a row are not used.

#include "mma.cuh"
#include "split_combine.cuh"
#include "tile.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int SPLIT = 64;   // slots a block: the split boundaries
constexpr int BK = 32;      // slots a tile: a split is the two stages' tiles
constexpr int HT = 16;      // heads a block: the mma's m dimension
constexpr int WARPS = 4;    // each a quarter of R's columns
constexpr int THREADS = 32 * WARPS;
constexpr int SPAD = 8;     // row pad in bf16 elements (16 bytes)
constexpr float LOG2E = 1.4426950408889634f;

template <int R, int RR>
struct Tiles {
  static constexpr int KW = R + RR;      // score depth
  static constexpr int KP = KW + SPAD;   // row pitch, in elements
  static constexpr int Q = HT * KP;      // q_lat || q_rope of the 16 heads
  static constexpr int T = BK * KP;      // one stage of c || kr
  static constexpr size_t bytes = sizeof(bf16) * (Q + 2 * T);
};

// Issue the copy of the tile's rows of W bf16 elements (`stride` apart in
// device memory) into shared memory rows `pitch` apart; row r is slot t0 +
// r, and a row past the cache or not live is zero-filled without a read
// (K4's load_rows).
template <int W>
__device__ __forceinline__ void live_rows(bf16* dst, int pitch,
                                          const bf16* __restrict__ src,
                                          long stride, int t0,
                                          const LiveSlots& live) {
  constexpr int CPR = W / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = t0 + r < live.S && live.at(t0 + r);
    cp_async_16(dst + r * pitch + c, ok ? src + r * stride + c : src,
                ok ? 16 : 0);
  }
}

template <int R, int RR>
__global__ void __launch_bounds__(THREADS)
mla_split_bf16_kernel(const bf16* __restrict__ q_lat,
                      const bf16* __restrict__ q_rope,
                      const bf16* __restrict__ c, const bf16* __restrict__ kr,
                      const int* __restrict__ pos_vec, int pos_scalar, int S,
                      int window, int H, float scale_log2,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml) {
  using L = Tiles<R, RR>;
  constexpr int KSTEPS = L::KW / 16;  // k-steps of the scores
  constexpr int NS = BK / 8;          // n-tiles of the scores (slots)
  constexpr int CW = R / WARPS;       // output columns a warp
  constexpr int NO = CW / 8;          // n-tiles of a warp's output
  constexpr bool Q_IN_REGS = KSTEPS <= 18;
  static_assert(SPLIT == 2 * BK, "a split is the two stages' tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sT = sQ + L::Q;  // two stages

  const int h0 = blockIdx.x * HT;
  const int sp = blockIdx.y;
  const int b = blockIdx.z;
  const LiveSlots live = live_slots(pos_vec, pos_scalar, b, S, window);
  const int s0 = sp * SPLIT;
  const int s1 = min(s0 + SPLIT, S);
  // no live slot: nothing to read, nothing to write (the combine skips it)
  if (!live.any(s0, s1)) return;
  const int nh = min(HT, H - h0);  // heads of this block that exist
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  // the queries and both tiles in flight: group 0 = q + tile 0, group 1 =
  // tile 1 (empty when the tile has no live slot)
  cp_async_rows<R, THREADS>(sQ, L::KP, q_lat + ((long)b * H + h0) * R, R, HT,
                            nh);
  cp_async_rows<RR, THREADS>(sQ + R, L::KP, q_rope + ((long)b * H + h0) * RR,
                             RR, HT, nh);
  bool tile_live[2];
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int t0 = s0 + st * BK;
    tile_live[st] = t0 < s1 && live.any(t0, min(t0 + BK, s1));
    if (tile_live[st]) {
      live_rows<R>(sT + st * L::T, L::KP, c + ((long)b * S + t0) * R, R, t0,
                   live);
      live_rows<RR>(sT + st * L::T + R, L::KP, kr + ((long)b * S + t0) * RR,
                    RR, t0, live);
    }
    cp_async_commit();
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // heads g and g + 8 of the tile
  float l[2] = {0.f, 0.f};          // this lane's share of the denominator
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];

  // ldmatrix addresses: A rows (heads), score B rows (slots), output B rows
  const bf16* qa = sQ + (lane % 16) * L::KP + (lane / 16) * 8;
  const int kr_ = (lane % 8) + 8 * (lane / 16);
  const int kc = 8 * ((lane / 8) % 2);
  const int vr = (lane % 8) + 8 * ((lane / 8) % 2);
  const int vc = 8 * (lane / 16);
  const int col0 = warp * CW;

#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int t0 = s0 + st * BK;
    if (!tile_live[st]) continue;
    if (st == 0)
      cp_async_wait<1>();  // q and the first tile landed
    else
      cp_async_wait<0>();
    __syncthreads();  // tile st (and q) visible to every warp
    if constexpr (Q_IN_REGS) {
      if (st == 0 || !tile_live[0]) {  // the first tile this split computes
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
      }
    }
    const bf16* tile = sT + st * L::T;

    // S = [q_lat || q_rope] [c || kr]^T, 16 heads x 32 slots
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
        ldmatrix_x4(bk, tile + (nn * 16 + kr_) * L::KP + kk * 16 + kc);
        mma_bf16_16816(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // into the log2 domain; dead slots and slots past the cache are masked
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = t0 + 8 * j + 2 * t + (e % 2);
        s[j][e] = slot < s1 && live.at(slot) ? s[j][e] * scale_log2 : NEG_INF;
      }

    // online softmax on the fragments, rows g and g + 8
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - mx);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - mx);
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

    // O += P c over this warp's columns, P from the score registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      if constexpr (NO == 1) {
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, tile + (kk * 16 + lane % 16) * L::KP + col0);
        mma_bf16_16816(acc[0], a, bv[0], bv[1]);
      } else {
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, tile + (kk * 16 + vr) * L::KP + col0 +
                                    nn * 16 + vc);
          mma_bf16_16816(acc[2 * nn], a, bv[0], bv[1]);
          mma_bf16_16816(acc[2 * nn + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // this split's partial: (B, nsplit, H) x [acc[R]] and x [m, l]
  const long row0 = ((long)b * gridDim.y + sp) * H + h0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hh = g + 8 * r;
    if (hh < nh) {
      float* out = part_acc + (row0 + hh) * R + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      if (warp == 0 && t == 0)
        *reinterpret_cast<float2*>(part_ml + (row0 + hh) * 2) =
            make_float2(m[r], l[r]);
    }
  }
}

template <int R, int RR>
int launch(const void* q_lat, const void* q_rope, const void* c, const void* kr,
           void* o, const int* pos_vec, int pos_scalar, int window,
           float* part, int nsplit, int B, int S, int H, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Tiles<R, RR>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_bf16_kernel<R, RR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part_acc = part;
  float* part_ml = part + (long)B * nsplit * H * R;
  const dim3 grid((H + HT - 1) / HT, nsplit, B);
  mla_split_bf16_kernel<R, RR><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_rope),
      static_cast<const bf16*>(c), static_cast<const bf16*>(kr), pos_vec,
      pos_scalar, S, window, H, scale * LOG2E, part_acc, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_combine<bf16, SPLIT>(
      part_acc, part_ml, static_cast<bf16*>(o), pos_vec, pos_scalar, window, B,
      S, H, 1, R, nsplit, stream);
}

template <int R>
int dispatch_rr(int RR, const void* ql, const void* qr, const void* c,
                const void* kr, void* o, const int* pv, int ps, int win, float* part,
                int ns, int B, int S, int H, float scale, cudaStream_t st) {
  switch (RR) {
    case 16: return launch<R, 16>(ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    case 32: return launch<R, 32>(ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    case 64: return launch<R, 64>(ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_r(int R, int RR, const void* ql, const void* qr, const void* c,
               const void* kr, void* o, const int* pv, int ps, int win, float* part,
               int ns, int B, int S, int H, float scale, cudaStream_t st) {
  switch (R) {
    case 32: return dispatch_rr<32>(RR, ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    case 64: return dispatch_rr<64>(RR, ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    case 128: return dispatch_rr<128>(RR, ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    case 256: return dispatch_rr<256>(RR, ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    case 512: return dispatch_rr<512>(RR, ql, qr, c, kr, o, pv, ps, win, part, ns, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes; bfloat16 tensors only, the same arguments
// as mla_decode.cu's mla_decode_fwd: pos_vec is a (B,) int32 device pointer
// or null to use pos_scalar; window is 0 or the ring's window; part is fp32
// scratch of at least B * nsplit * H * (R + 2) floats, nsplit = ceil(S /
// SPLIT). Returns the CUDA error code of
// the launches (0 = launched).
extern "C" int mla_decode_bf16_fwd(const void* q_lat, const void* q_rope,
                                   const void* c, const void* kr, void* o,
                                   const int* pos_vec, int pos_scalar,
                                   int window, void* part, int nsplit, int B,
                                   int S, int H,
                                   int R, int RR, float scale, void* stream) {
  using namespace repro_torch;
  if (S < 1 || nsplit != (S + SPLIT - 1) / SPLIT || window < 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_r(R, RR, q_lat, q_rope, c, kr, o, pos_vec, pos_scalar, window,
                    static_cast<float*>(part), nsplit, B, S, H, scale,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* mla_decode_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
