// K2: batched V-trace targets (Espeholt et al. 2018, eqs. 1-4), for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/vtrace.py::vtrace_returns_pallas
// (pl.pallas_call at :92). For every env column e, with rc = min(rho_bar,
// rho), c = min(c_bar, rho) and nd = 1 - done, walking t = T-1 .. 0 from
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
// n_e = 32, t_max = 5 that is ~3.4 KB, so its time is the launch and one
// trip to device memory; over a long T it is the walk itself (~20
// instructions a step, two of them on the dependent chain of A).
// What the design does about it: the two walks of column_scan.cuh. Up to
// T = 16 (the pipeline's t_max = 5) a warp owns 32 columns and holds each
// column's steps in registers, every load issued before the first step,
// and one pass carries A_{t+1}, V_{t+1} and vs_{t+1} in registers. Beyond,
// a block of eight warps owns 32 columns: TMA brings each chunk (64 steps
// at most) three chunks ahead. The recurrence of A is the only serial
// part: seven helper warps compute delta_t and gamma nd_t c_t of a chunk
// (every row at once) a chunk ahead of the walker warp, which carries A in
// a register (two loads, a multiply and an add a step); a chunk behind, the
// helpers compute vs and pg_adv (every row at once: vs_{t+1} is V_{t+1} +
// A_{t+1} again, bit for bit) into shared memory, and TMA stores write them
// out. Shared memory: up to 128 + 5 * 64 * 32 * 13 + 8 * 64 * 32 * 4 + 256 =
// 199,040 bytes a block, so the kernel opts in to more than 48 KB of
// dynamic shared memory. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn) in the plain PyTorch version's order,
// so no FMA contraction changes the last bit, and the clips are fminf, so a
// clip of inf or 1e9 leaves rho as it is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "column_scan.cuh"

namespace repro_torch {
namespace {

constexpr int CHUNK = 64;  // steps a chunk at most
const size_t MAX_SMEM = scan::smem_bytes(3, 2, scan::STAGES * CHUNK, CHUNK);

__global__ void __launch_bounds__(scan::THREADS)
vtrace_kernel(const float* __restrict__ rewards,
              const uint8_t* __restrict__ dones,
              const float* __restrict__ values,
              const float* __restrict__ rho,
              const float* __restrict__ bootstrap,
              float* __restrict__ vs_out, float* __restrict__ adv_out,
              int T, int E, float gamma, float rho_bar, float c_bar,
              int chunk, int nbuf, scan::Routes<3> routes, bool out_tma,
              const __grid_constant__ scan::Maps<3, 2> maps) {
  using Chunk = scan::Chunk<3>;  // x(0, r) = r_t, x(1, r) = V_t, x(2, r) = rho_t
  constexpr int TILE = scan::TILE;
  const int e = blockIdx.x * TILE + threadIdx.x % TILE;
  const bool live = e < E;
  const float boot = live ? bootstrap[e] : 0.f;  // V_T = vs_T
  // gamma * (1 - done) for done = 0 and 1, rounded as the plain version's
  // product
  const float g1 = __fmul_rn(gamma, 1.f), g0 = __fmul_rn(gamma, 0.f);
  const float* const src[3] = {rewards, values, rho};
  // A_t = delta_t + (disc_t c_t) A_{t+1} from A_T = 0: a = disc c, b = delta
  scan::walk<3, 2>(
      src, dones, T, E, chunk, nbuf, routes, maps, out_tma, 0.f,
      [&](const Chunk& c, const Chunk* up, float* a, float* b, int r, int) {
        const float v_next =
            r + 1 < c.n ? c.x(1, r + 1) : (up ? up->x(1, 0) : boot);
        const float disc = c.done(r) ? g0 : g1;
        const float rc = fminf(c.x(2, r), rho_bar);
        b[r * TILE] = __fmul_rn(
            rc, __fsub_rn(__fadd_rn(c.x(0, r), __fmul_rn(disc, v_next)),
                          c.x(1, r)));
        a[r * TILE] = __fmul_rn(disc, fminf(c.x(2, r), c_bar));
      },
      [&](const Chunk& c, const float* y, float* out0, float* out1,
          const float* edge_in, float* edge_out, int r, int k) {
        // vs_t = V_t + A_t; vs_{t+1} the same from row r + 1, or from row 0
        // of the chunk before (its edge), or bootstrap at t = T - 1
        const float vs = __fadd_rn(c.x(1, r), y[r * TILE]);
        const float vs_next =
            r + 1 < c.n ? __fadd_rn(c.x(1, r + 1), y[(r + 1) * TILE])
                        : (k > 0 ? *edge_in : boot);
        if (r == 0) *edge_out = vs;
        const float disc = c.done(r) ? g0 : g1;
        const float rc = fminf(c.x(2, r), rho_bar);
        const float adv = __fmul_rn(
            rc, __fsub_rn(__fadd_rn(c.x(0, r), __fmul_rn(disc, vs_next)),
                          c.x(1, r)));
        if (out_tma) {
          out0[r * TILE] = vs;
          out1[r * TILE] = adv;
        } else if (live) {
          const long i = (long)(c.t0 + r) * E + e;
          vs_out[i] = vs;
          adv_out[i] = adv;
        }
      });
}

// T <= SHORT_T: one warp a 32-column tile, each column in registers.
__global__ void __launch_bounds__(scan::TILE)
vtrace_short_kernel(const float* __restrict__ rewards,
                    const uint8_t* __restrict__ dones,
                    const float* __restrict__ values,
                    const float* __restrict__ rho,
                    const float* __restrict__ bootstrap,
                    float* __restrict__ vs_out, float* __restrict__ adv_out,
                    int T, int E, float gamma, float rho_bar, float c_bar) {
  const int e = blockIdx.x * scan::TILE + threadIdx.x;
  const bool live = e < E;
  float acc = 0.f;                           // A_{t+1}
  float v_next = live ? bootstrap[e] : 0.f;  // V_{t+1}
  float vs_next = v_next;                    // vs_{t+1}
  const float g1 = __fmul_rn(gamma, 1.f), g0 = __fmul_rn(gamma, 0.f);
  const float* const src[3] = {rewards, values, rho};
  scan::walk_short<3>(
      src, dones, T, E, e, [&](const float* x, uint32_t done, int t) {
        const float disc = done ? g0 : g1;
        const float rc = fminf(x[2], rho_bar);
        const float c = fminf(x[2], c_bar);
        const float delta = __fmul_rn(
            rc, __fsub_rn(__fadd_rn(x[0], __fmul_rn(disc, v_next)), x[1]));
        acc = __fadd_rn(delta, __fmul_rn(__fmul_rn(disc, c), acc));
        const float vs = __fadd_rn(x[1], acc);
        const float adv = __fmul_rn(
            rc, __fsub_rn(__fadd_rn(x[0], __fmul_rn(disc, vs_next)), x[1]));
        if (live) {
          vs_out[(long)t * E + e] = vs;
          adv_out[(long)t * E + e] = adv;
        }
        v_next = x[1];
        vs_next = vs;
      });
}

// Check the shape, size the shared memory and, once a device, let both
// kernels take up to MAX_SMEM bytes of it.
int prepare(int T, int E, int tile, int chunk, size_t* smem) {
  static bool opted_in[2][64] = {};
  if (!scan::valid_shape(T, E, tile, chunk, CHUNK))
    return (int)cudaErrorInvalidValue;
  *smem = T <= scan::SHORT_T ? 0 : scan::smem_bytes(3, 2, T, chunk);
  if (int rc = scan::opt_in(vtrace_kernel, MAX_SMEM, opted_in[0])) return rc;
  return scan::opt_in(scan::floor_kernel, MAX_SMEM, opted_in[1]);
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes. All pointers are device pointers on the
// stream's device; tile and chunk come from the wrapper's launch_shape.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int vtrace_fwd(const void* rewards, const void* dones,
                          const void* values, const void* rho,
                          const void* bootstrap, void* vs, void* pg_adv, int T,
                          int E, float gamma, float rho_bar, float c_bar,
                          int tile, int chunk, void* stream) {
  using namespace repro_torch;
  size_t smem;
  if (int rc = prepare(T, E, tile, chunk, &smem)) return rc;
  const int blocks = (E - 1) / tile + 1;
  if (T <= scan::SHORT_T) {
    vtrace_short_kernel<<<blocks, scan::TILE, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rewards),
        static_cast<const uint8_t*>(dones),
        static_cast<const float*>(values), static_cast<const float*>(rho),
        static_cast<const float*>(bootstrap), static_cast<float*>(vs),
        static_cast<float*>(pg_adv), T, E, gamma, rho_bar, c_bar);
    return (int)cudaGetLastError();
  }
  scan::Routes<3> routes;
  scan::Maps<3, 2> maps = {};
  bool out_tma = false;
  const void* const floats[3] = {rewards, values, rho};
  const void* const outs[2] = {vs, pg_adv};
  if (int rc = scan::plan_routes(floats, dones, outs, T, E, chunk, &routes,
                                 &maps, &out_tma))
    return rc;
  const int nck = (T + chunk - 1) / chunk;
  const int nbuf = nck < scan::STAGES ? nck : scan::STAGES;
  vtrace_kernel<<<blocks, scan::THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const uint8_t*>(dones),
      static_cast<const float*>(values), static_cast<const float*>(rho),
      static_cast<const float*>(bootstrap), static_cast<float*>(vs),
      static_cast<float*>(pg_adv), T, E, gamma, rho_bar, c_bar, chunk, nbuf,
      routes, out_tma, maps);
  return (int)cudaGetLastError();
}

// An empty kernel at the same grid, block and shared memory as vtrace_fwd's
// launch: the launch floor of a measurement.
extern "C" int vtrace_floor(int T, int E, int tile, int chunk, void* stream) {
  using namespace repro_torch;
  size_t smem;
  if (int rc = prepare(T, E, tile, chunk, &smem)) return rc;
  scan::floor_kernel<<<(E - 1) / tile + 1,
                       T <= scan::SHORT_T ? scan::TILE : scan::THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* vtrace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
