// The staging and the backward walk that K1 (nstep_returns.cu) and K2
// (vtrace.cu) share, for Hopper (sm_90a). Each supplies only its
// recurrence and its outputs.
//
// Layout: every input is time-major (T, E), row stride E; a block owns a
// tile of TILE = 32 neighbouring columns and walks the time axis from
// t = T-1 down to 0, in chunks of `chunk` = min(T, CHUNK) steps. Chunk k
// covers t in [max(0, T - (k+1) chunk), T - k chunk), so the last chunk is
// the ragged one.
//
// What bounded the earlier design: a thread read its column
// step by step from device memory, so the walk paid one memory latency
// every few steps (~1 us each after the L2 is flushed). Measured on the
// H100 while this design was built (scripts/returns_profile.py and
// ablations of this header): with every load of the slab in flight the
// next limits were, in turn, an SM's own loads and stores (about 13 GB/s
// an SM through cp.async and STG with one warp a block), the shared-memory
// latency of the walk's loads, and the walk's own instructions a step.
// The design answers each:
//
// - T <= SHORT_T (the training and pipeline paths' t_max = 5): walk_short.
//   One warp a tile, no shared memory: a thread issues every load of its
//   column (T steps of every input) into registers before the first step,
//   so the kernel pays the launch and one trip to device memory.
// - T > SHORT_T: walk. Eight warps a tile. The inputs come by TMA, one 2D
//   tensor copy an array a chunk (32 columns by `chunk` rows; columns past
//   E and rows past T are zero-filled), STAGES - 2 chunks ahead, into a
//   ring of nbuf = min(STAGES, ceil(T / chunk)) buffers, completing on the
//   buffer's mbarrier: a copy holds no thread, register or load slot of the
//   SM while it flies. The recurrence is written as y_t = b_t + a_t y_{t+1}
//   and the walker warp runs only that: two loads from shared memory, a
//   multiply, an add and a store a step, in groups of U steps whose loads
//   are issued before the group before them is computed. Seven helper
//   warps compute a and b of a chunk (all rows at once) a chunk ahead, and
//   the outputs of a chunk a chunk behind, into shared memory; TMA stores
//   write them out, a chunk at a time.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn) in the plain PyTorch version's order on both paths, so the
// outputs are the plain versions' bit for bit; the discount gamma (1 -
// done) is a select between gamma * 1 and gamma * 0, the same bits.
//
// How each array of the long path reaches shared memory (the host picks
// its route once a launch, from the pointer and E; a tile starts on a
// multiple of 32 columns, so it keeps the row's alignment):
// - TMA where the array's pointer is 16-byte aligned and its rows are a
//   multiple of 16 bytes apart (E % 4 == 0 for floats, E % 16 == 0 for
//   the one-byte dones); the outputs go by TMA stores where all of them
//   are so;
// - otherwise floats take a 4-byte cp.async.ca an element (float32
//   tensors are always 4-byte aligned), and dones a 4-byte cp.async.ca
//   where the pointer is 4-byte aligned and E % 4 == 0, else plain byte
//   loads, 32 rows at a time, each batch issued before the first of its
//   stores into shared memory (the only route on which a copy waits in the
//   issuing thread). These complete on warp 1's cp.async groups; outputs
//   not on the TMA route are stored by the helpers from registers.
//
// Shared memory a block of the long path: 128 bytes of mbarriers, the
// ring of nbuf buffers (NF float planes of chunk * TILE * 4 bytes, then
// the dones plane rounded up to 128 bytes, so every TMA destination is
// 128-byte aligned), then planes of chunk * TILE floats for the walker's
// coefficients (twice), its carry (twice) and each output, and 256 bytes
// that pass a value from chunk to chunk: K1 (NF = 1, one output, CHUNK =
// 128) at most 217,472 bytes, K2 (NF = 3, two outputs, CHUNK = 64) at most
// 199,040; both opt in to more than the default 48 KB of dynamic shared
// memory.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace repro_torch {
namespace scan {

constexpr int STAGES = 5;   // buffers of the ring; STAGES - 2 chunks in flight
constexpr int TILE = 32;    // columns a block, one thread of each warp a column
constexpr int HELPERS = 7;  // warps beside the walker
constexpr int THREADS = (HELPERS + 1) * TILE;
constexpr int U = 8;       // steps a group of the walk
constexpr int BYTE_BATCH = 32;  // plain byte loads in flight a thread
constexpr int SHORT_T = 16;     // T up to which a column stays in registers

enum Route : int { BYTE = 1, TMA = 2, WORD = 4 };

// Route of each input array, and the tensor maps of those on the TMA route.
template <int NF>
struct Routes {
  int f[NF];
  int d;
};

template <int NF, int NO>
struct Maps {
  CUtensorMap f[NF];     // inputs on the TMA route
  CUtensorMap d;         // dones, on the TMA route
  CUtensorMap o[NO];     // outputs, a chunk of rows a store
  CUtensorMap last[NO];  // outputs, the last chunk's rows a store
};

constexpr int BARS = 128;  // bytes of mbarriers at the start of shared memory

__host__ __device__ inline size_t dones_plane(int chunk) {
  return ((size_t)chunk * TILE + 127) / 128 * 128;
}

__host__ __device__ inline size_t stage_bytes(int nf, int chunk) {
  return (size_t)nf * chunk * TILE * 4 + dones_plane(chunk);
}

// The mbarriers, the ring's buffers, then planes of chunk * TILE floats:
// the walker's a and b twice, its y twice, and an output plane an output;
// then two rows of TILE floats that hand a value from chunk to chunk.
__host__ __device__ inline size_t smem_bytes(int nf, int no, int T,
                                             int chunk) {
  const int nck = (T + chunk - 1) / chunk;
  return BARS + (nck < STAGES ? nck : STAGES) * stage_bytes(nf, chunk) +
         (size_t)(6 + no) * chunk * TILE * 4 + 2 * TILE * 4;
}

inline int float_route(const void* p, int E) {
  return ((uintptr_t)p % 16 == 0 && E % 4 == 0) ? TMA : WORD;
}

inline int byte_route(const void* p, int E) {
  if ((uintptr_t)p % 16 == 0 && E % 16 == 0) return TMA;
  if ((uintptr_t)p % 4 == 0 && E % 4 == 0) return WORD;
  return BYTE;
}

// cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPoint), so the library links against nothing else.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (T, E) array of `elem`-byte elements, copied 32 columns by
// `chunk` rows at a time. Returns a CUDA error code (0 = encoded).
inline int tensor_map(CUtensorMap* map, const void* base, int T, int E,
                      int elem, int chunk) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)E, (cuuint64_t)T};
  const cuuint64_t strides[1] = {(cuuint64_t)E * elem};
  const cuuint32_t box[2] = {(cuuint32_t)TILE, (cuuint32_t)chunk};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult rc = encode(
      map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Routes and maps of a launch: TMA where the array allows it; the outputs
// go by TMA stores where all of them allow it (*out_tma).
template <int NF, int NO>
int plan_routes(const void* const (&f)[NF], const void* d,
                const void* const (&o)[NO], int T, int E, int chunk,
                Routes<NF>* routes, Maps<NF, NO>* maps, bool* out_tma) {
  for (int a = 0; a < NF; ++a) {
    routes->f[a] = float_route(f[a], E);
    if (routes->f[a] == TMA)
      if (int rc = tensor_map(&maps->f[a], f[a], T, E, 4, chunk)) return rc;
  }
  routes->d = byte_route(d, E);
  if (routes->d == TMA)
    if (int rc = tensor_map(&maps->d, d, T, E, 1, chunk)) return rc;
  *out_tma = true;
  for (int a = 0; a < NO; ++a) *out_tma = *out_tma && float_route(o[a], E) == TMA;
  const int last_rows = T - (T - 1) / chunk * chunk;
  for (int a = 0; *out_tma && a < NO; ++a) {
    if (int rc = tensor_map(&maps->o[a], o[a], T, E, 4, chunk)) return rc;
    if (int rc = tensor_map(&maps->last[a], o[a], T, E, 4, last_rows))
      return rc;
  }
  return 0;
}

// The launch arguments the C entry points take: a 32-wide tile and the
// chunk min(T, CHUNK).
inline bool valid_shape(int T, int E, int tile, int chunk, int CHUNK) {
  return T >= 1 && E >= 1 && tile == TILE && chunk == (T < CHUNK ? T : CHUNK);
}

// Let `kernel` take up to `bytes` of dynamic shared memory, once a device.
template <typename K>
int opt_in(K* kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) done[dev] = true;
  return 0;
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` at column x, row y into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// How one thread takes part in copying `row_bytes` bytes a row, 4 bytes a
// copy, the 32 threads of the writer together: its first row, its byte
// offset in a row, and the rows a pass of the warp covers. Worked out once
// a launch, not once a chunk.
struct CopyPlan {
  int r0, c, per_pass;
};

__device__ __forceinline__ CopyPlan copy_plan(int lane, int row_bytes) {
  const int per_row = max(1, row_bytes / 4);
  const int r0 = lane / per_row;
  return {r0, (lane - r0 * per_row) * 4, TILE / per_row};
}

// Issue the 4-byte copies of `rows` rows (`src_pitch` bytes apart in device
// memory) into shared-memory rows `dst_pitch` bytes apart.
__device__ __forceinline__ void copy_rows(const CopyPlan& p,
                                          unsigned char* dst, int dst_pitch,
                                          const unsigned char* src,
                                          long src_pitch, int rows) {
  if (p.r0 >= p.per_pass) return;  // a thread past the last whole row
  for (int r = p.r0; r < rows; r += p.per_pass)
    cp_async_4(dst + r * dst_pitch + p.c, src + r * src_pitch + p.c);
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}

// Make this thread's writes to shared memory visible to TMA stores.
__device__ __forceinline__ void fence_to_tma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A chunk as a thread sees it in shared memory: its column of the NF float
// planes (`plane` floats apart) and of the dones plane, rows 0 .. n-1 for
// t = t0 .. t0 + n - 1.
template <int NF>
struct Chunk {
  const float* f;
  const uint8_t* d;
  int plane, n, t0;
  __device__ __forceinline__ float x(int a, int r) const {
    return f[a * plane + r * TILE];
  }
  __device__ __forceinline__ bool done(int r) const { return d[r * TILE] != 0; }
};

// The walker's pass over a chunk: y_r = b_r + a_r * y_{r+1} for rows n-1 .. 0,
// y carried in a register, a and b read from their planes, y written to its
// plane; the product and the sum rounded on their own. Whole pairs of
// U-row groups first, each group's loads issued before the group before it
// is computed, every address a register plus an immediate; then the n % 2U
// earliest rows one at a time.
__device__ __forceinline__ void chain(const float* ca, const float* cb,
                                      float* cy, int n, float& y) {
  auto load = [&](float (&a)[U], float (&b)[U], int top) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = ca[(top - u) * TILE];
      b[u] = cb[(top - u) * TILE];
    }
  };
  auto run = [&](const float (&a)[U], const float (&b)[U], int top) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      y = __fadd_rn(b[u], __fmul_rn(a[u], y));
      cy[(top - u) * TILE] = y;
    }
  };
  const int rem = n % (2 * U);
  int top = n - 1;
  if (top >= rem + 2 * U - 1) {
    float aa[U], ba[U], ab[U], bb[U];
    load(aa, ba, top);
#pragma unroll 1
    for (; top >= rem + 2 * U - 1; top -= 2 * U) {
      load(ab, bb, top - U);
      run(aa, ba, top);
      if (top >= rem + 4 * U - 1) load(aa, ba, top - 2 * U);
      run(ab, bb, top - U);
    }
  }
  for (; top >= 0; --top) {
    y = __fadd_rn(cb[top * TILE], __fmul_rn(ca[top * TILE], y));
    cy[top * TILE] = y;
  }
}

// Walk the block's 32 columns from t = T-1 down to 0 with HELPERS + 1 warps,
// for a recurrence y_t = b_t + a_t * y_{t+1} from y_T = y_init.
//
// The walker (warp 0) runs only that chain (chain() above): two loads from
// shared memory, a multiply, an add and a store a step. The helpers (warps
// 1 .. HELPERS) do the rest, one chunk ahead and one chunk behind, rows
// spread over them: prep(c, up, a, b, r, k) writes a_r and b_r of row r of
// chunk k (c; `up` is chunk k - 1, whose row 0 is t + 1 of c's last row,
// or null for k = 0); emit(c, y, out0, out1, r, k) computes the outputs of
// row r of chunk k from its inputs and the walker's y plane, and either
// writes them to the output planes out0 (the first output) and out1 (the
// second, if NO == 2), which TMA stores write out a chunk at a time
// (`out_tma`), or stores them itself. With `out_tma` and NO == 1 the y
// plane is the output and emit is not called. emit(c, y, out0, out1,
// edge_in, edge_out, r, k) may hand a float of row 0 to row n-1 of the
// next chunk: what row 0 of chunk k - 1 wrote to its edge_out, row n-1 of
// chunk k reads from edge_in.
//
// Copies: warp 1 issues them. Chunk j lives in buffer j % nbuf; its TMA
// copies complete on that buffer's mbarrier, in phase j / nbuf; its other
// copies on warp 1's cp.async groups. Iteration j: the walker walks chunk
// j; the helpers issue chunk j + STAGES - 2 (into the buffer of chunk
// j - 2, whose last use, its write-out, was iteration j - 1), prepare chunk
// j + 1, write out chunk j - 1; one barrier ends it.
template <int NF, int NO, typename Prep, typename Emit>
__device__ __forceinline__ void walk(const float* const (&src)[NF],
                                     const uint8_t* __restrict__ dones, int T,
                                     int E, int chunk, int nbuf,
                                     const Routes<NF>& routes,
                                     const Maps<NF, NO>& maps, bool out_tma,
                                     float y_init, Prep&& prep, Emit&& emit) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + BARS;
  const int lane = threadIdx.x % TILE;
  const int warp = threadIdx.x / TILE;
  const int e0 = blockIdx.x * TILE;
  const int cols = min(TILE, E - e0);
  const int nck = (T + chunk - 1) / chunk;
  const int plane = chunk * TILE;  // elements of one array in one buffer
  const size_t sbytes = stage_bytes(NF, chunk);
  // after the ring: a and b planes twice, y planes twice, NO output planes
  float* coef = reinterpret_cast<float*>(ring + nbuf * sbytes);
  float* ys = coef + 4 * plane;
  float* outs = ys + 2 * plane;
  float* edges = outs + NO * plane;  // two rows of TILE floats
  uint32_t tma_bytes = 0;  // expected on a buffer's mbarrier a chunk
#pragma unroll
  for (int a = 0; a < NF; ++a)
    if (routes.f[a] == TMA) tma_bytes += plane * 4;
  if (routes.d == TMA) tma_bytes += plane;
  const CopyPlan fplan = copy_plan(lane, cols * 4);
  const CopyPlan dplan = copy_plan(lane, cols);  // the dones' WORD route

  auto rows_of = [&](int k, int* t0) {
    const int t1 = T - k * chunk;
    *t0 = max(0, t1 - chunk);
    return t1 - *t0;
  };
  auto issue = [&](int k) {  // warp 1
    int t0;
    const int n = rows_of(k, &t0);
    const int b = k % nbuf;
    unsigned char* st = ring + b * sbytes;
    unsigned char* sd = st + NF * plane * 4;
    if (lane == 0) {  // the TMA copies, rows t0 .. t0 + chunk - 1
      mbar_expect(&bars[b], tma_bytes);
#pragma unroll
      for (int a = 0; a < NF; ++a)
        if (routes.f[a] == TMA)
          tma_load(st + a * plane * 4, &maps.f[a], e0, t0, &bars[b]);
      if (routes.d == TMA) tma_load(sd, &maps.d, e0, t0, &bars[b]);
    }
#pragma unroll
    for (int a = 0; a < NF; ++a)
      if (routes.f[a] == WORD)
        copy_rows(fplan, st + a * plane * 4, TILE * 4,
                  reinterpret_cast<const unsigned char*>(src[a] +
                                                         (long)t0 * E + e0),
                  (long)E * 4, n);
    const uint8_t* gd = dones + (long)t0 * E + e0;
    if (routes.d == WORD) {
      copy_rows(dplan, sd, TILE, gd, E, n);
    } else if (routes.d == BYTE && lane < cols) {
      for (int r0 = 0; r0 < n; r0 += BYTE_BATCH) {
        uint8_t v[BYTE_BATCH];
#pragma unroll
        for (int r = 0; r < BYTE_BATCH; ++r)
          if (r0 + r < n) v[r] = __ldg(gd + (long)(r0 + r) * E + lane);
#pragma unroll
        for (int r = 0; r < BYTE_BATCH; ++r)
          if (r0 + r < n) sd[(r0 + r) * TILE + lane] = v[r];
      }
    }
  };
  auto view = [&](int k) {  // chunk k, once its TMA copies have landed
    const int b = k % nbuf;
    mbar_wait(&bars[b], (k / nbuf) & 1);
    const unsigned char* st = ring + b * sbytes;
    Chunk<NF> c;
    c.f = reinterpret_cast<const float*>(st) + lane;
    c.d = st + NF * plane * 4 + lane;
    c.plane = plane;
    c.n = rows_of(k, &c.t0);
    return c;
  };
  const int h = warp - 1;  // the helper's index
  auto prepare = [&](int k) {  // helpers
    const Chunk<NF> c = view(k);
    Chunk<NF> up = c;
    if (k > 0) up = view(k - 1);
    float* a = coef + (k & 1) * 2 * plane + lane;
#pragma unroll 4
    for (int r = h; r < c.n; r += HELPERS)
      prep(c, k > 0 ? &up : nullptr, a, a + plane, r, k);
  };
  auto write_out = [&](int k) {  // helpers
    const Chunk<NF> c = view(k);
    const float* y = ys + (k & 1) * plane + lane;
    if (NO == 2 || !out_tma)
#pragma unroll 4
      for (int r = h; r < c.n; r += HELPERS)
        emit(c, y, outs + lane, outs + plane + lane,
             edges + ((k + 1) & 1) * TILE + lane, edges + (k & 1) * TILE + lane,
             r, k);
    if (!out_tma) return;
    fence_to_tma();
    asm volatile("bar.sync 1, %0;\n" ::"n"(HELPERS * TILE) : "memory");
    if (warp == 1 && lane == 0) {  // the chunk's outputs to device memory
      const bool last = c.n < chunk;
      const float* first = NO == 2 ? outs : ys + (k & 1) * plane;
      tma_store(last ? &maps.last[0] : &maps.o[0], first, e0, c.t0);
      if (NO == 2)
        tma_store(last ? &maps.last[NO - 1] : &maps.o[NO - 1], outs + plane,
                  e0, c.t0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // shared memory read: the planes may be written again
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  };

  if (warp == 1) {
    if (lane == 0) {
      for (int b = 0; b < nbuf; ++b) mbar_init(&bars[b]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int k = 0; k < STAGES - 2; ++k) {
      if (k < nck) issue(k);
      cp_async_commit();  // one group a chunk, empty past the last
    }
    cp_async_wait<STAGES - 3>();  // chunk 0's cp.async copies landed
  }
  __syncthreads();
  if (warp > 0) prepare(0);
  __syncthreads();
  float y = y_init;
  for (int j = 0; j <= nck; ++j) {
    if (warp == 0) {
      if (j < nck) {
        int t0;
        const int n = rows_of(j, &t0);
        const float* a = coef + (j & 1) * 2 * plane + lane;
        chain(a, a + plane, ys + (j & 1) * plane + lane, n, y);
        if (out_tma && NO == 1) fence_to_tma();
      }
    } else {
      if (warp == 1) {
        if (j + STAGES - 2 < nck) issue(j + STAGES - 2);
        cp_async_commit();
        cp_async_wait<STAGES - 3>();  // chunk j + 1's cp.async copies landed
      }
      if (j + 1 < nck) {
        // warp 1's cp.async copies, seen by every helper
        asm volatile("bar.sync 1, %0;\n" ::"n"(HELPERS * TILE) : "memory");
        prepare(j + 1);
      }
      if (j >= 1) write_out(j - 1);
    }
    __syncthreads();
  }
}

// The walk of a short trajectory (T <= SHORT_T, a single chunk), with no
// shared memory: each thread loads its column's T steps of every input
// into registers, every load issued before the first step, then calls
// step(x, done, t) for t = T-1 .. 0. Threads past the last column read the
// last column and must not store.
template <int NF, typename Step>
__device__ __forceinline__ void walk_short(const float* const (&src)[NF],
                                           const uint8_t* __restrict__ dones,
                                           int T, int E, int e, Step&& step) {
  const int col = min(e, E - 1);
  float x[SHORT_T][NF];
  uint32_t d[SHORT_T];
#pragma unroll
  for (int t = 0; t < SHORT_T; ++t) {
    if (t < T) {
#pragma unroll
      for (int a = 0; a < NF; ++a) x[t][a] = __ldg(src[a] + (long)t * E + col);
      d[t] = __ldg(dones + (long)t * E + col);
    }
  }
#pragma unroll
  for (int t = SHORT_T - 1; t >= 0; --t)
    if (t < T) step(x[t], d[t], t);
}

__global__ void floor_kernel() {}

}  // namespace scan
}  // namespace repro_torch
