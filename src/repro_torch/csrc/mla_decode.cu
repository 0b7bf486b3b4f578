// K5: absorbed (latent-space) MLA decode attention, for Hopper (sm_90a): the
// fp32 path, on the CUDA cores, as split-K.
//
// Replaces src/repro/kernels/mla_decode.py::mla_decode_attention_pallas
// (pl.pallas_call at :113). For the absorbed queries q_lat (B, H, R) (W_uk
// already folded in by the caller) and q_rope (B, H, Rr), the compressed
// cache c (B, S, R) and the shared roped keys kr (B, S, Rr), row b attends
// to the slots 0..pos_b:
//     s_k = (q_lat . c_k + q_rope . kr_k) * scale,   k <= pos_b
//     out = sum_k softmax(s)_k c_k                   (B, H, R)
// with an fp32 online softmax. The caller applies W_uv to the latent output.
// The TPU kernel takes one scalar pos; this one also takes a per-row (B,)
// int32 pos, which the serving engine decodes with. pos >= S reads all S
// slots (the ring cache); a row whose pos is negative sees no slot and gets
// zeros. A window w > 0, which the TPU kernel does not take (an extension,
// as K4's), keeps the ring's slots of age < min(w, pos + 1)
// (split_combine.cuh's LiveSlots).
//
// What bounds it on the H100: every cached latent element is used by all H
// heads twice, about H flops a byte in fp32, so the bytes of the filled
// cache set the least time; on the CUDA cores (67 TFLOP/s in fp32) the
// operations bound it in practice. The serving paths run K5 in bf16, on the
// tensor cores (mla_decode_bf16.cu); this fp32 path serves the card-vs-CPU
// parity checks.
// What the design does about it: it keeps the first design's CUDA-core body
// on the bf16 design's grid:
// - split-K over slots: a grid of (ceil(H / 8), ceil(S / SPLIT), B) blocks,
//   each over SPLIT = 64 slots of one row for 8 heads (a warp a head). The
//   grid follows the capacity S; a block whose split holds no live slot
//   exits, so pos never goes to the host; a tile with no live slot is
//   skipped, and a dead slot's row is zero-filled without a read and its
//   score masked (its weight is 0);
// - within a split, tiles of 32 slots of (c || kr) are staged once into
//   shared memory as fp32 and serve both passes of every head of the block:
//   lane j scores slot j, the online softmax stays in the warp's registers
//   (in the log2 domain), and lane l accumulates columns l, l + 32, ... of R;
// - each split writes its (m, l, acc[R]) to scratch, and split_combine.cuh's
//   kernel (K4's) merges them in split order, with no atomics: a row's bits
//   do not depend on the batch or on the other rows' positions.

#include "split_combine.cuh"
#include "tile.cuh"

namespace repro_torch {
namespace {

constexpr int HB = 8;              // heads per block, one warp each
constexpr int BK = 32;             // slots per tile, one a lane
constexpr int SPLIT = 64;          // slots a block: the split boundaries
constexpr int THREADS = HB * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int R, int RR>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((HB + BK) * (R + RR + PAD) + HB * BK);
}

// Stage the tile's rows of W floats (`stride` apart in device memory) into
// `dst`, rows `pitch` apart; row r is slot t0 + r, and a row past the cache
// or not live is zero-filled without a read (K4's load_rows, synchronous:
// the pitch is odd, so each float is stored alone).
template <int W>
__device__ __forceinline__ void live_rows(float* __restrict__ dst, int pitch,
                                          const float* __restrict__ src,
                                          long stride, int t0,
                                          const LiveSlots& live) {
  constexpr int VPR = W / 4;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < BK * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < live.S && live.at(t0 + r))
      u = *reinterpret_cast<const float4*>(src + r * stride + c);
    float* out = dst + r * pitch + c;
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
}

template <int R, int RR>
__global__ void __launch_bounds__(THREADS)
mla_split_kernel(const float* __restrict__ q_lat,
                 const float* __restrict__ q_rope, const float* __restrict__ c,
                 const float* __restrict__ kr, const int* __restrict__ pos_vec,
                 int pos_scalar, int S, int window, int H, float scale_log2,
                 float* __restrict__ part_acc, float* __restrict__ part_ml) {
  constexpr int W = R + RR + PAD;  // odd: R, RR are multiples of 16
  constexpr int RPL = R / 32;  // latent columns a lane accumulates
  extern __shared__ float smem[];
  float* sQ = smem;         // HB x W: q_lat || q_rope
  float* sC = sQ + HB * W;  // BK x W: c || kr of this tile's slots
  float* sP = sC + BK * W;  // HB x BK: this tile's probabilities

  const int h0 = blockIdx.x * HB;
  const int sp = blockIdx.y;
  const int b = blockIdx.z;
  const LiveSlots live = live_slots(pos_vec, pos_scalar, b, S, window);
  const int s0 = sp * SPLIT;
  const int s1 = min(s0 + SPLIT, S);
  // no live slot: nothing to read, nothing to write (the combine skips it)
  if (!live.any(s0, s1)) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nh = min(HB, H - h0);  // heads of this block that exist

  stage_rows_pitch<float, R>(sQ, W, q_lat + ((long)b * H + h0) * R, R, HB, nh,
                             1.f);
  stage_rows_pitch<float, RR>(sQ + R, W, q_rope + ((long)b * H + h0) * RR, RR,
                              HB, nh, 1.f);

  float m = NEG_INF, l = 0.f;
  float acc[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) acc[i] = 0.f;

  const float* cb = c + (long)b * S * R;
  const float* kb = kr + (long)b * S * RR;
  const float* qrow = sQ + warp * W;
  for (int k0 = s0; k0 < s1; k0 += BK) {
    const int valid = min(BK, s1 - k0);  // the tile's slots in the cache
    if (!live.any(k0, k0 + valid)) continue;
    __syncthreads();  // sQ staged; the previous tile's reads of sC, sP done
    live_rows<R>(sC, W, cb + (long)k0 * R, R, k0, live);
    live_rows<RR>(sC + R, W, kb + (long)k0 * RR, RR, k0, live);
    __syncthreads();

    // score of head `warp` against slot k0 + lane, in the log2 domain
    const float* crow = sC + lane * W;
    float sl = 0.f, sr = 0.f;
#pragma unroll 8
    for (int r = 0; r < R; ++r) sl = fmaf(qrow[r], crow[r], sl);
#pragma unroll
    for (int r = R; r < R + RR; ++r) sr = fmaf(qrow[r], crow[r], sr);
    const float s =
        lane < valid && live.at(k0 + lane) ? (sl + sr) * scale_log2 : NEG_INF;

    // online softmax over the warp's 32 scores
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float p = exp2f(s - m_new);
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float corr = exp2f(m - m_new);
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

  // this split's partial: (B, nsplit, H) x [acc[R]] and x [m, l]
  if (warp < nh) {
    const long row = ((long)b * gridDim.y + sp) * H + h0 + warp;
#pragma unroll
    for (int i = 0; i < RPL; ++i) part_acc[row * R + lane + 32 * i] = acc[i];
    if (lane == 0)
      *reinterpret_cast<float2*>(part_ml + row * 2) = make_float2(m, l);
  }
}

template <int R, int RR>
int launch(const void* q_lat, const void* q_rope, const void* c, const void* kr,
           void* o, const int* pos_vec, int pos_scalar, int window,
           float* part, int nsplit, int B, int S, int H, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<R, RR>();
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_kernel<R, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part_acc = part;
  float* part_ml = part + (long)B * nsplit * H * R;
  const dim3 grid((H + HB - 1) / HB, nsplit, B);
  mla_split_kernel<R, RR><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const float*>(c), static_cast<const float*>(kr), pos_vec,
      pos_scalar, S, window, H, scale * LOG2E, part_acc, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_combine<float, SPLIT>(
      part_acc, part_ml, static_cast<float*>(o), pos_vec, pos_scalar, window,
      B, S, H, 1, R, nsplit, stream);
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

// C interface, bound with ctypes; float32 tensors only. pos_vec is a (B,)
// int32 device pointer, or null to use pos_scalar for every row; window is
// 0 (slots 0..pos) or the ring's window (> 0). part is
// fp32 scratch on the card of at least B * nsplit * H * (R + 2) floats,
// nsplit = ceil(S / SPLIT); a caller whose nsplit differs (another SPLIT) is
// refused. Returns the CUDA error code of the launches (0 = launched).
extern "C" int mla_decode_fwd(const void* q_lat, const void* q_rope,
                              const void* c, const void* kr, void* o,
                              const int* pos_vec, int pos_scalar, int window,
                              void* part, int nsplit, int B, int S, int H,
                              int R, int RR,
                              float scale, void* stream) {
  using namespace repro_torch;
  if (S < 1 || nsplit != (S + SPLIT - 1) / SPLIT || window < 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_r(R, RR, q_lat, q_rope, c, kr, o, pos_vec, pos_scalar, window,
                    static_cast<float*>(part), nsplit, B, S, H, scale,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* mla_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
