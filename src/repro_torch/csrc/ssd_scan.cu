// K6: chunked Mamba2 SSD scan, forward, for Hopper (sm_90a): the fp32 path,
// which serves the card-vs-CPU parity checks; the serving paths run K6 in
// bf16, chunk-parallel on the tensor cores (ssd_scan_bf16.cu).
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_pallas (pl.pallas_call
// at :86). For x (B, S, H, P), dt (B, S, H) fp32 post-softplus, A_log and
// D (H,) fp32, and B, C (B, S, N) shared across heads, it computes per
// (row, head), chunk by chunk of Q steps, with cum the inclusive cumsum of
// a = -exp(A_log) dt inside the chunk and the state carried across chunks:
//     y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//           + exp(cum_i) C_i . state + D x_i
//     state <- exp(cum_Q) state + sum_j exp(cum_Q - cum_j) (dt_j x_j) B_j^T
// y is (B, S, H, P) fp32. Unlike the TPU kernel, which leaves the
// final state in scratch, it also writes the final state (B, H, P, N) fp32:
// that is what prefill puts in the decode cache. S must be a multiple of Q.
//
// What bounds it on the H100: per chunk and head the work is three
// Q x Q x N / Q x P x N products (~4 M FMA at Q = N = 128, P = 64) over
// ~50 KB of inputs, far above the card's ridge: the least time is set by
// operations. This path multiplies on the CUDA cores in fp32 FMA
// (67 TFLOP/s, not the tensor cores' 989).
// What the design does about it: one block per (row, head) loops over the
// chunks in order, as the TPU grid's innermost axis did, and keeps the
// (P, N) fp32 state in shared memory across them, so the state never goes
// through device memory. Per chunk it stages x*dt, B and C once as fp32
// (B and C are the same for every head and come from L2 for all but the
// first), computes C.state and the state update from them, and walks the
// causal Q x Q score matrix in row tiles of 32, skipping the tiles above
// the diagonal, so shared memory holds one 32 x Q tile of C.B^T (216 KB in
// all at Q = N = 128, under the 227 KB a block may use). Each thread keeps
// an 8 x 4 register tile of y across the chunk. B*H blocks (32 at B = 1 and
// mamba2-370m's 32 heads) leave most of the card idle; ssd_scan_bf16.cu
// runs the chunks in parallel on the tensor cores and computes C.B^T once
// for all heads.

#include "tile.cuh"

namespace repro_torch {
namespace {

constexpr int P = 64;         // head width (every Mamba2 config)
constexpr int QMAX = 128;     // longest chunk
constexpr int GT = 32;        // rows of a C.B^T tile
constexpr int TY = 16;        // thread grid for y and the state: TY x TX
constexpr int TX = 16;
constexpr int THREADS = TY * TX;
constexpr int YR = QMAX / TY;  // y rows a thread: ty + TY * r
constexpr int YC = P / TX;     // y columns a thread: tx + TX * c
constexpr int GR = GT / (THREADS / 32);  // C.B^T rows a thread: warp + 8 * r

template <int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (QMAX * (P + PAD) + 2 * QMAX * (N + PAD) +
                          P * (N + PAD) + GT * (QMAX + PAD) + 4 * QMAX);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ d_vec,
                T* __restrict__ y, float* __restrict__ state_out, int S, int H,
                int Q) {
  constexpr int SN = N / TX;  // state columns a thread: tx + TX * c
  constexpr int SP = P / TY;  // state rows a thread: ty + TY * r
  extern __shared__ float smem[];
  float* sX = smem;                      // QMAX x (P + PAD): dt * x
  float* sB = sX + QMAX * (P + PAD);     // QMAX x (N + PAD)
  float* sC = sB + QMAX * (N + PAD);     // QMAX x (N + PAD)
  float* sS = sC + QMAX * (N + PAD);     // P x (N + PAD): the carried state
  float* sG = sS + P * (N + PAD);        // GT x (QMAX + PAD): a C.B^T tile
  float* sDt = sG + GT * (QMAX + PAD);   // QMAX: dt
  float* sCum = sDt + QMAX;              // QMAX: inclusive cumsum of a
  float* sE = sCum + QMAX;               // QMAX: exp(cum_i)
  float* sW = sE + QMAX;                 // QMAX: exp(cum_Q - cum_j)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int warp = tid / 32, lane = tid % 32;
  const float neg_a = -expf(a_log[h]);
  const float dh = d_vec[h];
  const long x_stride = (long)H * P;

  for (int i = tid; i < P * (N + PAD); i += THREADS) sS[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk's reads of shared memory are done
    const long row0 = (long)b * S + s0;
    stage_rows<T, P>(sX, x + row0 * x_stride + (long)h * P, x_stride, QMAX, Q,
                     1.f);
    stage_rows<T, N>(sB, bm + row0 * N, N, QMAX, Q, 1.f);
    stage_rows<T, N>(sC, cm + row0 * N, N, QMAX, Q, 1.f);
    for (int i = tid; i < QMAX; i += THREADS)
      sDt[i] = i < Q ? dt[(row0 + i) * H + h] : 0.f;
    __syncthreads();

    if (tid == 0) {  // the chunk's decay, in the order of a plain cumsum
      float acc = 0.f;
      for (int i = 0; i < Q; ++i) {
        acc += neg_a * sDt[i];
        sCum[i] = acc;
      }
    }
    for (int i = tid; i < QMAX * P; i += THREADS) {
      const int r = i / P, c = i % P;
      sX[r * (P + PAD) + c] *= sDt[r];
    }
    __syncthreads();
    const float total = sCum[Q - 1];
    for (int i = tid; i < QMAX; i += THREADS) {
      sE[i] = i < Q ? expf(sCum[i]) : 0.f;
      sW[i] = i < Q ? expf(total - sCum[i]) : 0.f;
    }
    __syncthreads();

    // y_inter = exp(cum_i) C_i . state, from the state entering the chunk
    float yacc[YR][YC];
#pragma unroll
    for (int r = 0; r < YR; ++r)
#pragma unroll
      for (int c = 0; c < YC; ++c) yacc[r][c] = 0.f;
    if (s0 > 0) {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[YR], sv[YC];
#pragma unroll
        for (int r = 0; r < YR; ++r) cv[r] = sC[(ty + TY * r) * (N + PAD) + n];
#pragma unroll
        for (int c = 0; c < YC; ++c) sv[c] = sS[(tx + TX * c) * (N + PAD) + n];
#pragma unroll
        for (int r = 0; r < YR; ++r)
#pragma unroll
          for (int c = 0; c < YC; ++c) yacc[r][c] = fmaf(cv[r], sv[c], yacc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int c = 0; c < YC; ++c) yacc[r][c] *= sE[ty + TY * r];
    }
    __syncthreads();  // every read of the entering state is done

    // state <- exp(total) state + sum_j exp(total - cum_j) (dt x)_j B_j^T;
    // each thread updates its own SP x SN elements
    {
      float upd[SP][SN];
#pragma unroll
      for (int r = 0; r < SP; ++r)
#pragma unroll
        for (int c = 0; c < SN; ++c) upd[r][c] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float w = sW[j];
        float xv[SP], bv[SN];
#pragma unroll
        for (int r = 0; r < SP; ++r) xv[r] = w * sX[j * (P + PAD) + ty + TY * r];
#pragma unroll
        for (int c = 0; c < SN; ++c) bv[c] = sB[j * (N + PAD) + tx + TX * c];
#pragma unroll
        for (int r = 0; r < SP; ++r)
#pragma unroll
          for (int c = 0; c < SN; ++c) upd[r][c] = fmaf(xv[r], bv[c], upd[r][c]);
      }
      const float decay = expf(total);
#pragma unroll
      for (int r = 0; r < SP; ++r)
#pragma unroll
        for (int c = 0; c < SN; ++c) {
          float* e = sS + (ty + TY * r) * (N + PAD) + tx + TX * c;
          *e = fmaf(*e, decay, upd[r][c]);
        }
    }

    // y_intra: the causal C.B^T walk, in row tiles of GT
#pragma unroll
    for (int t = 0; t < QMAX / GT; ++t) {
      const int i0 = t * GT;
      if (i0 < Q) {
        const int jmax = min(i0 + GT, Q);  // keys a row of this tile may see
        __syncthreads();  // the previous tile's reads of sG are done
        float g[GR][QMAX / 32];
#pragma unroll
        for (int r = 0; r < GR; ++r)
#pragma unroll
          for (int c = 0; c < QMAX / 32; ++c) g[r][c] = 0.f;
#pragma unroll 2
        for (int n = 0; n < N; ++n) {
          float cv[GR];
#pragma unroll
          for (int r = 0; r < GR; ++r)
            cv[r] = sC[(i0 + warp + 8 * r) * (N + PAD) + n];
#pragma unroll
          for (int c = 0; c < QMAX / 32; ++c) {
            if (32 * c < jmax) {
              const float bv = sB[(lane + 32 * c) * (N + PAD) + n];
#pragma unroll
              for (int r = 0; r < GR; ++r) g[r][c] = fmaf(cv[r], bv, g[r][c]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const int ii = warp + 8 * r;
          const int i = i0 + ii;
#pragma unroll
          for (int c = 0; c < QMAX / 32; ++c) {
            const int j = lane + 32 * c;
            if (32 * c < jmax) {
              const bool keep = j <= i && i < Q;
              sG[ii * (QMAX + PAD) + j] =
                  keep ? g[r][c] * expf(sCum[i] - sCum[j]) : 0.f;
            }
          }
        }
        __syncthreads();
        // rows ty and ty + 16 of the tile are this thread's y rows 2t, 2t+1
#pragma unroll 4
        for (int j = 0; j < jmax; ++j) {
          const float g0 = sG[ty * (QMAX + PAD) + j];
          const float g1 = sG[(ty + TY) * (QMAX + PAD) + j];
#pragma unroll
          for (int c = 0; c < YC; ++c) {
            const float xv = sX[j * (P + PAD) + tx + TX * c];
            yacc[2 * t][c] = fmaf(g0, xv, yacc[2 * t][c]);
            yacc[2 * t + 1][c] = fmaf(g1, xv, yacc[2 * t + 1][c]);
          }
        }
      }
    }

    // y = y_intra + y_inter + D x
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const int i = ty + TY * r;
      if (i < Q) {
        const long off = (row0 + i) * x_stride + (long)h * P;
#pragma unroll
        for (int c = 0; c < YC; ++c) {
          const int p = tx + TX * c;
          store(y + off + p, fmaf(dh, to_float(x[off + p]), yacc[r][c]));
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + ((long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    so[i] = sS[(i / N) * (N + PAD) + i % N];
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* a_log, const void* bm,
           const void* cm, const float* d_vec, void* y, float* state, int B,
           int S, int H, int Q, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  ssd_scan_kernel<T, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(bm),
      static_cast<const T*>(cm), d_vec, static_cast<T*>(y), state, S, H, Q);
  return (int)cudaGetLastError();
}

int dispatch_n(int N, const void* x, const float* dt, const float* a_log,
               const void* bm, const void* cm, const float* d_vec, void* y,
               float* state, int B, int S, int H, int Q, cudaStream_t st) {
  switch (N) {
    case 16: return launch<float, 16>(x, dt, a_log, bm, cm, d_vec, y, state, B, S, H, Q, st);
    case 32: return launch<float, 32>(x, dt, a_log, bm, cm, d_vec, y, state, B, S, H, Q, st);
    case 64: return launch<float, 64>(x, dt, a_log, bm, cm, d_vec, y, state, B, S, H, Q, st);
    case 128: return launch<float, 128>(x, dt, a_log, bm, cm, d_vec, y, state, B, S, H, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes; float32 tensors only. P must be 64,
// 1 <= Q <= 128 and S % Q == 0 (the wrapper checks). Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                            const void* bm, const void* cm, const float* d_vec,
                            void* y, float* state, int B, int S, int H, int P_,
                            int N, int Q, void* stream) {
  using namespace repro_torch;
  if (P_ != P || Q < 1 || Q > QMAX || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_n(N, x, dt, a_log, bm, cm, d_vec, y, state, B, S, H, Q,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
