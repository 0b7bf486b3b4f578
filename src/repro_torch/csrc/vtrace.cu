// K2: batched V-trace targets (Espeholt et al. 2018, eqs. 1-4), for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/vtrace.py::vtrace_returns_pallas
// (pl.pallas_call at :92). For every env row e, with rc = min(rho_bar, rho),
// c = min(c_bar, rho) and nd = 1 - done, walking t = T-1 .. 0 from
// A_T = 0 and V_T = vs_T = bootstrap[e]:
//
//     delta_t  = rc_t * (r_t + gamma * nd_t * V_{t+1} - V_t)
//     A_t      = delta_t + gamma * nd_t * c_t * A_{t+1}
//     vs_t     = V_t + A_t
//     pg_adv_t = rc_t * (r_t + gamma * nd_t * vs_{t+1} - V_t)
//
// The TPU kernel takes (E, T) rows; this one takes the trajectory
// time-major, as the rollout stores it: rewards, values and rho (T, E)
// float32, dones (T, E) as bytes (a torch.bool tensor, 0 or 1), bootstrap
// (E,) float32, and writes vs and pg_adv (T, E) float32.
//
// What bounds it on the H100: each input element is read once and each
// output written once with ~15 flops between, so it is bound by bytes:
// T*E*(4 + 1 + 4 + 4) read + 2*T*E*4 written + 4*E. At the paper's
// n_e = 32, t_max = 5 that is ~3.4 KB, so its time is the launch itself.
// What the design does about it: one thread per env row carries A_{t+1},
// V_{t+1} and vs_{t+1} in registers down the time axis, so both outputs
// come out of one pass; at each step t the 32 threads of a warp read and
// write 32 neighbouring addresses, so every access is coalesced and nothing
// is staged. Blocks of 256 rows, ceil(E / 256) of them. Every product and
// sum is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn) in the plain
// PyTorch version's order, so no FMA contraction changes the last bit, and
// the clips are fminf, so a clip of inf or 1e9 leaves rho as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
vtrace_kernel(const float* __restrict__ rewards,
              const uint8_t* __restrict__ dones,
              const float* __restrict__ values,
              const float* __restrict__ rho,
              const float* __restrict__ bootstrap,
              float* __restrict__ vs_out, float* __restrict__ adv_out,
              int T, int E, float gamma, float rho_bar, float c_bar) {
  const long e = (long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;                // A_{t+1}
  float v_next = bootstrap[e];    // V_{t+1}
  float vs_next = v_next;         // vs_{t+1}
  for (int t = T - 1; t >= 0; --t) {
    const long i = (long)t * E + e;
    const float r = rewards[i];
    const float v = values[i];
    const float w = rho[i];
    const float disc = __fmul_rn(gamma, dones[i] ? 0.f : 1.f);
    const float rc = fminf(w, rho_bar);
    const float c = fminf(w, c_bar);
    const float delta =
        __fmul_rn(rc, __fsub_rn(__fadd_rn(r, __fmul_rn(disc, v_next)), v));
    acc = __fadd_rn(delta, __fmul_rn(__fmul_rn(disc, c), acc));
    const float vs = __fadd_rn(v, acc);
    vs_out[i] = vs;
    adv_out[i] =
        __fmul_rn(rc, __fsub_rn(__fadd_rn(r, __fmul_rn(disc, vs_next)), v));
    v_next = v;
    vs_next = vs;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes. All pointers are device pointers on the
// stream's device. Returns the CUDA error code of the launch (0 = launched).
extern "C" int vtrace_fwd(const void* rewards, const void* dones,
                          const void* values, const void* rho,
                          const void* bootstrap, void* vs, void* pg_adv, int T,
                          int E, float gamma, float rho_bar, float c_bar,
                          void* stream) {
  using namespace repro_torch;
  if (T < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (E - 1) / THREADS + 1;
  vtrace_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const uint8_t*>(dones),
      static_cast<const float*>(values), static_cast<const float*>(rho),
      static_cast<const float*>(bootstrap), static_cast<float*>(vs),
      static_cast<float*>(pg_adv), T, E, gamma, rho_bar, c_bar);
  return (int)cudaGetLastError();
}

extern "C" const char* vtrace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
