// K1: batched n-step discounted returns (Algorithm 1, lines 11-15), for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/nstep_returns.py::nstep_returns_pallas
// (pl.pallas_call at :54). For every env column e, walking t = T-1 .. 0 from
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
// launch and one trip to device memory; over a long T it is the walk itself,
// one dependent multiply and add a step.
// What the design does about it: the two walks of column_scan.cuh. Up to
// T = 16 (the training path's t_max = 5) a warp owns 32 columns and holds
// each column's steps in registers, every load issued before the first
// step. Beyond, a block of eight warps owns 32 columns: TMA brings each
// chunk (128 steps at most) three chunks ahead; seven helper warps turn a
// chunk's dones into discounts a chunk ahead of the walker warp, which
// carries R in a register (a load of r, a load of the discount, a multiply
// and an add a step) and writes each R_t to shared memory; a TMA store
// writes the chunk out a chunk behind. Shared memory: up to 128 + 5 * 128
// * 32 * 5 + 7 * 128 * 32 * 4 + 256 = 217,472 bytes a block. The product
// and the sum are rounded separately (__fmul_rn, __fadd_rn), as the plain
// PyTorch version rounds them, so no FMA contraction changes the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column_scan.cuh"

namespace repro_torch {
namespace {

constexpr int CHUNK = 128;  // steps a chunk at most
const size_t MAX_SMEM = scan::smem_bytes(1, 1, scan::STAGES * CHUNK, CHUNK);

__global__ void __launch_bounds__(scan::THREADS)
nstep_kernel(const float* __restrict__ rewards,
             const uint8_t* __restrict__ dones,
             const float* __restrict__ bootstrap, float* __restrict__ out,
             int T, int E, float gamma, int chunk, int nbuf,
             scan::Routes<1> routes, bool out_tma,
             const __grid_constant__ scan::Maps<1, 1> maps) {
  using Chunk = scan::Chunk<1>;
  constexpr int TILE = scan::TILE;
  const int e = blockIdx.x * TILE + threadIdx.x % TILE;
  const bool live = e < E;
  // gamma * (1 - done) for done = 0 and 1, rounded as the plain version's
  // product
  const float g1 = __fmul_rn(gamma, 1.f), g0 = __fmul_rn(gamma, 0.f);
  const float* const src[1] = {rewards};
  // R_t = r_t + (gamma (1 - done_t)) R_{t+1}: a = the discount, b = r
  scan::walk<1, 1>(
      src, dones, T, E, chunk, nbuf, routes, maps, out_tma,
      live ? bootstrap[e] : 0.f,
      [&](const Chunk& c, const Chunk*, float* a, float* b, int r, int) {
        a[r * TILE] = c.done(r) ? g0 : g1;
        b[r * TILE] = c.x(0, r);
      },
      [&](const Chunk& c, const float* y, float*, float*, float*, float*,
          int r, int) {  // without TMA stores
        if (live) out[(long)(c.t0 + r) * E + e] = y[r * TILE];
      });
}

// T <= SHORT_T: one warp a 32-column tile, each column in registers.
__global__ void __launch_bounds__(scan::TILE)
nstep_short_kernel(const float* __restrict__ rewards,
                   const uint8_t* __restrict__ dones,
                   const float* __restrict__ bootstrap,
                   float* __restrict__ out, int T, int E, float gamma) {
  const int e = blockIdx.x * scan::TILE + threadIdx.x;
  const bool live = e < E;
  float carry = live ? bootstrap[e] : 0.f;
  const float g1 = __fmul_rn(gamma, 1.f), g0 = __fmul_rn(gamma, 0.f);
  const float* const src[1] = {rewards};
  scan::walk_short<1>(src, dones, T, E, e,
                      [&](const float* x, uint32_t done, int t) {
                        carry = __fadd_rn(x[0],
                                          __fmul_rn(done ? g0 : g1, carry));
                        if (live) out[(long)t * E + e] = carry;
                      });
}

// Check the shape, size the shared memory and, once a device, let both
// kernels take up to MAX_SMEM bytes of it.
int prepare(int T, int E, int tile, int chunk, size_t* smem) {
  static bool opted_in[2][64] = {};
  if (!scan::valid_shape(T, E, tile, chunk, CHUNK))
    return (int)cudaErrorInvalidValue;
  *smem = T <= scan::SHORT_T ? 0 : scan::smem_bytes(1, 1, T, chunk);
  if (int rc = scan::opt_in(nstep_kernel, MAX_SMEM, opted_in[0])) return rc;
  return scan::opt_in(scan::floor_kernel, MAX_SMEM, opted_in[1]);
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes. All pointers are device pointers on the
// stream's device; tile and chunk come from the wrapper's launch_shape.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int nstep_returns_fwd(const void* rewards, const void* dones,
                                 const void* bootstrap, void* out, int T,
                                 int E, float gamma, int tile, int chunk,
                                 void* stream) {
  using namespace repro_torch;
  size_t smem;
  if (int rc = prepare(T, E, tile, chunk, &smem)) return rc;
  const int blocks = (E - 1) / tile + 1;
  if (T <= scan::SHORT_T) {
    nstep_short_kernel<<<blocks, scan::TILE, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rewards),
        static_cast<const uint8_t*>(dones),
        static_cast<const float*>(bootstrap), static_cast<float*>(out), T, E,
        gamma);
    return (int)cudaGetLastError();
  }
  scan::Routes<1> routes;
  scan::Maps<1, 1> maps = {};
  bool out_tma = false;
  const void* const floats[1] = {rewards};
  const void* const outs[1] = {out};
  if (int rc = scan::plan_routes(floats, dones, outs, T, E, chunk, &routes,
                                 &maps, &out_tma))
    return rc;
  const int nck = (T + chunk - 1) / chunk;
  const int nbuf = nck < scan::STAGES ? nck : scan::STAGES;
  nstep_kernel<<<blocks, scan::THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const uint8_t*>(dones),
      static_cast<const float*>(bootstrap), static_cast<float*>(out), T, E,
      gamma, chunk, nbuf, routes, out_tma, maps);
  return (int)cudaGetLastError();
}

// An empty kernel at the same grid, block and shared memory as
// nstep_returns_fwd's launch: the launch floor of a measurement.
extern "C" int nstep_returns_floor(int T, int E, int tile, int chunk,
                                   void* stream) {
  using namespace repro_torch;
  size_t smem;
  if (int rc = prepare(T, E, tile, chunk, &smem)) return rc;
  scan::floor_kernel<<<(E - 1) / tile + 1,
                       T <= scan::SHORT_T ? scan::TILE : scan::THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* nstep_returns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
