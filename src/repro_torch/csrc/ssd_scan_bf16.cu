// K6: chunked Mamba2 SSD scan, forward, for Hopper (sm_90a): the bf16 path,
// chunk-parallel on the tensor cores.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_pallas (pl.pallas_call
// at :86), for bf16 x (B, S, H, P) and B, C (B, S, N) (shared across heads),
// dt (B, S, H) fp32 post-softplus, A_log and D (H,) fp32: what ssd_scan.cu
// (the fp32 path) computes, chunk by chunk of Q steps, with cum the
// inclusive cumsum of a = -exp(A_log) dt inside the chunk,
//     y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//           + exp(cum_i) C_i . state_in + D x_i
//     state <- exp(cum_Q) state + sum_j exp(cum_Q - cum_j) (dt_j x_j) B_j^T
// y (B, S, H, P) in bf16 and the final state (B, H, P, N) in fp32, which
// prefill puts in the decode cache. S must be a multiple of Q <= 128.
//
// What bounds it on the H100: per chunk and head four products of ~1 M
// multiply-adds each (Q = N = 128, P = 64) over ~50 KB of inputs, far above
// the card's ridge: the least time is set by operations, about 2 us on the
// tensor cores at mamba2-370m's 512-token prefill. What held the first
// design back was its serial walk: a block a (row, head) over the chunks in
// order, 32 blocks at B = 1, all products in fp32 FMA.
// What the design does about it (the three-phase form of Mamba2's own GPU
// scan), three launches, each chunk-parallel but the short second one:
// 1. ssd_chunk_kernel, a block per (head, chunk, row) plus one per (chunk,
//    row) for C.B^T: each computes the chunk's decay cumsum as a block scan
//    and its local state sum_j exp(cum_Q - cum_j) (dt_j x_j) B_j^T, P x N on
//    the tensor cores; the extra block computes C.B^T (Q x Q) once for all
//    heads of the chunk into scratch;
// 2. ssd_state_kernel, a thread a state element: the recurrence over the
//    chunks, state_c = exp(total_c) state_{c-1} + local_c, writing each
//    chunk's entering state over its local one, and the final state;
// 3. ssd_out_kernel, a block per (head, chunk, row): y = (C.B^T o L dt) x
//    + exp(cum_i) C . state_in + D x, both products on the tensor cores.
// Every product is mma.sync m16n8k16 with fp32 accumulators. An operand
// that is an fp32 value (w dt x in the local state, C.B^T o L dt in y,
// state_in in C . state) is split into bf16 high and low parts and issued
// twice, so it keeps ~16 bits; the other operand (B, x, C) is exact in bf16.
// Rounding such an operand to bf16 once would cost ~2^-9 relative, over the
// final state's 1e-4 tolerance.
// Scratch from the wrapper, fp32: the local and entering states (B, nc, H,
// P, N), C.B^T (B, nc, 128, 128) and the chunk totals (B, nc, H).

#include "mma.cuh"
#include "tile.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int P = 64;          // head width (every Mamba2 config)
constexpr int QMAX = 128;      // longest chunk
constexpr int WARPS = 8;       // a 16-row tile of the chunk each
constexpr int THREADS = 32 * WARPS;
constexpr int SPAD = 8;        // bf16 row pad (16 bytes)
constexpr int XP = P + SPAD;   // pitch of x (bf16)
constexpr int WP = P + 4;      // pitch of w dt x (fp32): conflict-free reads

template <int N>
struct Smem {
  static constexpr int BP = N + SPAD;  // pitch of B, C and the state halves
  static constexpr size_t B_BYTES = sizeof(bf16) * QMAX * BP;
  // ssd_chunk_kernel: B, then w dt x (fp32) or C, then dt, cum, w, scan
  static constexpr size_t UNION_BYTES = sizeof(float) * QMAX * WP > B_BYTES
                                            ? sizeof(float) * QMAX * WP
                                            : B_BYTES;
  static constexpr size_t chunk_bytes =
      B_BYTES + UNION_BYTES + sizeof(float) * (3 * QMAX + WARPS);
  // ssd_out_kernel: x, C, the entering state's two halves, dt, cum, exp(cum)
  static constexpr size_t out_bytes =
      sizeof(bf16) * (QMAX * XP + QMAX * BP + 2 * P * BP) +
      sizeof(float) * (3 * QMAX + WARPS);
};

// dt of head h for the chunk's Q steps into sDt (0 past Q), then the
// inclusive cumsum of neg_a dt into sCum as a block scan (a warp scan of 32
// steps by shuffles, plus the sums of the warps before). Every thread calls
// it; both kernels that need cum call it, so they see the same bits.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             long row0, int H, int h, int Q,
                                             float neg_a, float* sDt,
                                             float* sCum, float* sWarp) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  float v = 0.f;
  if (tid < QMAX) {  // whole warps: 0..3
    const float d = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
    sDt[tid] = d;
    v = neg_a * d;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) sWarp[warp] = v;
  }
  __syncthreads();
  if (tid < QMAX) {
    for (int w = 0; w < warp; ++w) v += sWarp[w];
    sCum[tid] = v;
  }
  __syncthreads();
}

template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const bf16* __restrict__ bm,
                 const bf16* __restrict__ cm, int S, int H, int Q,
                 float* __restrict__ g_state, float* __restrict__ g_cb,
                 float* __restrict__ g_total) {
  using L = Smem<N>;
  constexpr int BP = L::BP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);        // QMAX x BP
  unsigned char* u = smem_raw + L::B_BYTES;
  float* sXW = reinterpret_cast<float*>(u);            // QMAX x WP, or
  bf16* sC = reinterpret_cast<bf16*>(u);               // QMAX x BP
  float* sDt = reinterpret_cast<float*>(u + L::UNION_BYTES);
  float* sCum = sDt + QMAX;
  float* sW = sCum + QMAX;
  float* sWarp = sW + QMAX;

  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const long row0 = (long)b * S + (long)c * Q;
  const int QR = (Q + 15) & ~15;  // rows in whole m16/k16 tiles
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  cp_async_rows<N, THREADS>(sB, BP, bm + row0 * N, N, QR, Q);
  if (h == H) {
    // C.B^T of the chunk, once for all heads: warp w computes rows
    // 16w..16w + 15 against the keys up to its diagonal
    cp_async_rows<N, THREADS>(sC, BP, cm + row0 * N, N, QR, Q);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int i0 = 16 * warp;
    if (i0 >= QR) return;
    float* gg = g_cb + ((long)b * nc + c) * QMAX * QMAX;
    const bf16* ca = sC + (i0 + lane % 16) * BP + (lane / 16) * 8;
    const int kr = (lane % 8) + 8 * (lane / 16);
    const int kc = 8 * ((lane / 8) % 2);
    for (int jn = 0; jn <= warp; ++jn) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldmatrix_x4(a, ca + kk * 16);
        ldmatrix_x4(bk, sB + (jn * 16 + kr) * BP + kk * 16 + kc);
        mma_bf16_16816(acc[0], a, bk[0], bk[1]);
        mma_bf16_16816(acc[1], a, bk[2], bk[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = jn * 16 + half * 8 + 2 * t;
        *reinterpret_cast<float2*>(gg + (i0 + g) * QMAX + j) =
            make_float2(acc[half][0], acc[half][1]);
        *reinterpret_cast<float2*>(gg + (i0 + g + 8) * QMAX + j) =
            make_float2(acc[half][2], acc[half][3]);
      }
    }
    return;
  }
  cp_async_commit();

  // the chunk's decay for head h, and w_j dt_j = exp(total - cum_j) dt_j
  const float neg_a = -expf(a_log[h]);
  chunk_cumsum(dt, row0, H, h, Q, neg_a, sDt, sCum, sWarp);
  const float total = sCum[Q - 1];
  for (int i = threadIdx.x; i < QMAX; i += THREADS)
    sW[i] = i < Q ? expf(total - sCum[i]) * sDt[i] : 0.f;
  __syncthreads();
  const long x_stride = (long)H * P;
  for (int e = threadIdx.x; e < QR * P / 8; e += THREADS) {  // 16 bytes a load
    const int j = e / (P / 8), p = (e % (P / 8)) * 8;
    float* dst = sXW + j * WP + p;
    if (j < Q) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          x + (row0 + j) * x_stride + (long)h * P + p);
      const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k] = sW[j] * __bfloat162float(v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // local state (P x N) = (w dt x)^T (P x Q) . B (Q x N): warp w takes the
  // p rows 16 (w % 4).. and half of the n columns; A split in hi/lo
  constexpr int NT = N / 16;  // n-tiles of 8 a warp
  const int p0 = 16 * (warp % 4);
  const int n0 = (warp / 4) * (N / 2);
  const int vr = (lane % 8) + 8 * ((lane / 8) % 2);
  const int vc = 8 * (lane / 16);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < QR / 16; ++kk) {
    const int j0 = 16 * kk;
    uint32_t ahi[4], alo[4];
    // A fragment q holds (p, j) = (g + 8 (q % 2), 2t + 8 (q / 2)) and j + 1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + g + 8 * (q % 2);
      const int j = j0 + 2 * t + 8 * (q / 2);
      split_bf16x2(sXW[j * WP + p], sXW[(j + 1) * WP + p], ahi[q], alo[q]);
    }
    if constexpr (NT == 1) {
      uint32_t bv[2];
      ldmatrix_x2_trans(bv, sB + (j0 + lane % 16) * BP + n0);
      mma_bf16_16816(acc[0], ahi, bv[0], bv[1]);
      mma_bf16_16816(acc[0], alo, bv[0], bv[1]);
    } else {
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sB + (j0 + vr) * BP + n0 + nn * 16 + vc);
        mma_bf16_16816(acc[2 * nn], ahi, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * nn], alo, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * nn + 1], ahi, bv[2], bv[3]);
        mma_bf16_16816(acc[2 * nn + 1], alo, bv[2], bv[3]);
      }
    }
  }
  float* gs = g_state + (((long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(gs + (p0 + g) * N + n) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(gs + (p0 + g + 8) * N + n) =
        make_float2(acc[j][2], acc[j][3]);
  }
  if (threadIdx.x == 0) g_total[((long)b * nc + c) * H + h] = total;
}

// The carry over the chunks, a thread a state element of one (row, head):
// each chunk's local state is replaced by the state entering it, and the
// state after the last chunk is the final state.
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(float* __restrict__ g_state,
                 const float* __restrict__ g_total,
                 float* __restrict__ state_out, int nc, int H, int PN) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  float run = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long i = (((long)b * nc + c) * H + h) * PN + e;
    const float local = g_state[i];
    g_state[i] = run;
    run = fmaf(run, expf(g_total[((long)b * nc + c) * H + h]), local);
  }
  state_out[((long)b * H + h) * PN + e] = run;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ cm,
               const float* __restrict__ d_vec, bf16* __restrict__ y, int S,
               int H, int Q, const float* __restrict__ g_state,
               const float* __restrict__ g_cb) {
  using L = Smem<N>;
  constexpr int BP = L::BP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // QMAX x XP
  bf16* sC = sX + QMAX * XP;                     // QMAX x BP
  bf16* sSh = sC + QMAX * BP;                    // P x BP: state_in, high
  bf16* sSl = sSh + P * BP;                      // P x BP: state_in, low
  float* sDt = reinterpret_cast<float*>(sSl + P * BP);
  float* sCum = sDt + QMAX;
  float* sE = sCum + QMAX;
  float* sWarp = sE + QMAX;

  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.y;
  const long row0 = (long)b * S + (long)c * Q;
  const long x_stride = (long)H * P;
  const int QR = (Q + 15) & ~15;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  cp_async_rows<P, THREADS>(sX, XP, x + row0 * x_stride + (long)h * P,
                            x_stride, QR, Q);
  cp_async_rows<N, THREADS>(sC, BP, cm + row0 * N, N, QR, Q);
  cp_async_commit();
  const float neg_a = -expf(a_log[h]);
  chunk_cumsum(dt, row0, H, h, Q, neg_a, sDt, sCum, sWarp);
  for (int i = threadIdx.x; i < QMAX; i += THREADS)
    sE[i] = i < Q ? expf(sCum[i]) : 0.f;
  if (c > 0) {  // the state entering the chunk, split into bf16 halves
    const float* gs = g_state + (((long)b * nc + c) * H + h) * P * N;
    for (int e = 4 * threadIdx.x; e < P * N; e += 4 * THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(gs + e);
      const int o = (e / N) * BP + e % N;  // 4 | N: the same row
      uint32_t hi[2], lo[2];
      split_bf16x2(v.x, v.y, hi[0], lo[0]);
      split_bf16x2(v.z, v.w, hi[1], lo[1]);
      *reinterpret_cast<uint2*>(sSh + o) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(sSl + o) = make_uint2(lo[0], lo[1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int i0 = 16 * warp;  // this warp's 16 rows of y
  if (i0 >= QR) return;
  const int kr = (lane % 8) + 8 * (lane / 16);
  const int kc = 8 * ((lane / 8) % 2);
  const int vr = (lane % 8) + 8 * ((lane / 8) % 2);
  const int vc = 8 * (lane / 16);
  float acc[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // y_inter = exp(cum_i) C_i . state_in: A = C rows, B = state_in^T (k = n,
  // n = p) from its rows p, in two halves
  if (c > 0) {
    const bf16* ca = sC + (i0 + lane % 16) * BP + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ca + kk * 16);
#pragma unroll
      for (int pn = 0; pn < P / 16; ++pn) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, sSh + (pn * 16 + kr) * BP + kk * 16 + kc);
        ldmatrix_x4(bl, sSl + (pn * 16 + kr) * BP + kk * 16 + kc);
        mma_bf16_16816(acc[2 * pn], a, bh[0], bh[1]);
        mma_bf16_16816(acc[2 * pn], a, bl[0], bl[1]);
        mma_bf16_16816(acc[2 * pn + 1], a, bh[2], bh[3]);
        mma_bf16_16816(acc[2 * pn + 1], a, bl[2], bl[3]);
      }
    }
    const float e0 = sE[i0 + g], e1 = sE[i0 + g + 8];
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
  }

  // y_intra = (C.B^T o L dt) x over the key tiles up to the diagonal: A from
  // C.B^T in scratch, times exp(cum_i - cum_j) dt_j, masked to j <= i < Q
  // and split in hi/lo; B = x (k = j, n = p)
  const float* gg = g_cb + ((long)b * nc + c) * QMAX * QMAX;
  for (int kk = 0; kk <= warp; ++kk) {
    const int j0 = 16 * kk;
    uint32_t ahi[4], alo[4];
    // A fragment q holds (i, j) = (g + 8 (q % 2), 2t + 8 (q / 2)) and j + 1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + g + 8 * (q % 2);
      const int j = j0 + 2 * t + 8 * (q / 2);
      const float2 cb = *reinterpret_cast<const float2*>(gg + i * QMAX + j);
      const bool row_ok = i < Q;
      const float v0 = row_ok && j <= i
                           ? cb.x * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
      const float v1 = row_ok && j + 1 <= i
                           ? cb.y * expf(sCum[i] - sCum[j + 1]) * sDt[j + 1]
                           : 0.f;
      split_bf16x2(v0, v1, ahi[q], alo[q]);
    }
#pragma unroll
    for (int pn = 0; pn < P / 16; ++pn) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, sX + (j0 + vr) * XP + pn * 16 + vc);
      mma_bf16_16816(acc[2 * pn], ahi, bv[0], bv[1]);
      mma_bf16_16816(acc[2 * pn], alo, bv[0], bv[1]);
      mma_bf16_16816(acc[2 * pn + 1], ahi, bv[2], bv[3]);
      mma_bf16_16816(acc[2 * pn + 1], alo, bv[2], bv[3]);
    }
  }

  // y = y_intra + y_inter + D x
  const float dh = d_vec[h];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i < Q) {
      bf16* yo = y + (row0 + i) * x_stride + (long)h * P;
      const bf16* xi = sX + i * XP;
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        const int p = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(yo + p) = pack_bf16x2(
            fmaf(dh, __bfloat162float(xi[p]), acc[j][2 * r]),
            fmaf(dh, __bfloat162float(xi[p + 1]), acc[j][2 * r + 1]));
      }
    }
  }
}

template <int N>
int launch(const void* x, const float* dt, const float* a_log, const void* bm,
           const void* cm, const float* d_vec, void* y, float* state,
           float* work, int B, int S, int H, int Q, cudaStream_t stream) {
  using L = Smem<N>;
  const int nc = S / Q;
  float* g_state = work;                                // (B, nc, H, P, N)
  float* g_cb = g_state + (long)B * nc * H * P * N;     // (B, nc, 128, 128)
  float* g_total = g_cb + (long)B * nc * QMAX * QMAX;   // (B, nc, H)
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::chunk_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_out_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::out_bytes);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);
  ssd_chunk_kernel<N><<<dim3(H + 1, nc, B), THREADS, L::chunk_bytes, stream>>>(
      xb, dt, a_log, bb, cb, S, H, Q, g_state, g_cb, g_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3((P * N + THREADS - 1) / THREADS, H, B), THREADS, 0,
                     stream>>>(g_state, g_total, state, nc, H, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_out_kernel<N><<<dim3(H, nc, B), THREADS, L::out_bytes, stream>>>(
      xb, dt, a_log, cb, d_vec, static_cast<bf16*>(y), S, H, Q, g_state, g_cb);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes; x, B, C and y bfloat16, dt, A_log, D, the
// state and the scratch float32. work is fp32 scratch on the card of at
// least B * nc * (H * P * N + 128 * 128 + H) floats, nc = S / Q. P must be
// 64, 1 <= Q <= 128 and S % Q == 0 (the wrapper checks). Returns the CUDA
// error code of the launches (0 = launched).
extern "C" int ssd_scan_bf16_fwd(const void* x, const float* dt,
                                 const float* a_log, const void* bm,
                                 const void* cm, const float* d_vec, void* y,
                                 float* state, float* work, int B, int S,
                                 int H, int P_, int N, int Q, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P_ != P || Q < 1 || Q > QMAX || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch<16>(x, dt, a_log, bm, cm, d_vec, y, state, work, B, S, H, Q, st);
    case 32: return launch<32>(x, dt, a_log, bm, cm, d_vec, y, state, work, B, S, H, Q, st);
    case 64: return launch<64>(x, dt, a_log, bm, cm, d_vec, y, state, work, B, S, H, Q, st);
    case 128: return launch<128>(x, dt, a_log, bm, cm, d_vec, y, state, work, B, S, H, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
