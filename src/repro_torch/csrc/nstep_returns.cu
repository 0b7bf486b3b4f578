// K1: batched n-step discounted returns (Algorithm 1, lines 11-15), for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/nstep_returns.py::nstep_returns_pallas
// (pl.pallas_call at :54). For every env row e, walking t = T-1 .. 0 from
// R_T = bootstrap[e]:
//
//     R_t = r_t + gamma * (1 - done_t) * R_{t+1}
//
// The TPU kernel takes (E, T) rows; this one takes the trajectory
// time-major, as the rollout stores it: rewards (T, E) float32, dones (T, E)
// as bytes (a torch.bool tensor, 0 or 1), bootstrap (E,) float32, and
// writes R (T, E) float32. The function is the same; only the layout moved.
//
// What bounds it on the H100: each element is read once and written once
// with two flops between, so it is bound by bytes: T*E*(4 + 1 + 4) + 4*E.
// At the paper's n_e = 32, t_max = 5 that is ~1.6 KB, so its time is the
// launch itself.
// What the design does about it: one thread per env row carries R in a
// register down the time axis; at each step t the 32 threads of a warp read
// and write 32 neighbouring addresses, so every access is coalesced and
// nothing is staged. Blocks of 256 rows, ceil(E / 256) of them. The product
// and the sum are rounded separately (__fmul_rn, __fadd_rn), as the plain
// PyTorch version rounds them, so no FMA contraction changes the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
nstep_kernel(const float* __restrict__ rewards,
             const uint8_t* __restrict__ dones,
             const float* __restrict__ bootstrap, float* __restrict__ out,
             int T, int E, float gamma) {
  const long e = (long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= E) return;
  float carry = bootstrap[e];
  for (int t = T - 1; t >= 0; --t) {
    const long i = (long)t * E + e;
    const float not_done = dones[i] ? 0.f : 1.f;
    carry = __fadd_rn(rewards[i], __fmul_rn(__fmul_rn(gamma, not_done), carry));
    out[i] = carry;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes. All pointers are device pointers on the
// stream's device. Returns the CUDA error code of the launch (0 = launched).
extern "C" int nstep_returns_fwd(const void* rewards, const void* dones,
                                 const void* bootstrap, void* out, int T,
                                 int E, float gamma, void* stream) {
  using namespace repro_torch;
  if (T < 1 || E < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (E - 1) / THREADS + 1;
  nstep_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const uint8_t*>(dones),
      static_cast<const float*>(bootstrap), static_cast<float*>(out), T, E,
      gamma);
  return (int)cudaGetLastError();
}

extern "C" const char* nstep_returns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
