"""Launch shape of K1 and K2, the two kernels built on
``csrc/column_scan.cuh``. Up to T = SHORT_T a block is one warp that
keeps its ``TILE`` = 32 columns in registers. Beyond, a block of eight
warps (a walker and seven helpers) owns 32 columns and walks the time axis
backwards in chunks of ``chunk`` steps, through a ring of at most
``STAGES`` chunk buffers in shared memory (``STAGES - 2`` chunks in flight
ahead of the walker), with planes between the warps and for the outputs.

The shape is a plain function of (T, E), so the CPU tests reach it; the C
entry points take the tile and chunk it gives and check them again.
"""
from __future__ import annotations

import functools

STAGES = 5               # csrc/column_scan.cuh: scan::STAGES
TILE = 32                # columns a block: scan::TILE
BARS = 128               # bytes of mbarriers: scan::BARS
SHORT_T = 16             # T up to which a column stays in registers


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def launch_shape(T: int, E: int, n_float: int, n_out: int, max_chunk: int):
    """``(tile, chunk, blocks, smem_bytes)`` for a (T, E) trajectory with
    ``n_float`` float32 inputs beside the dones, ``n_out`` float32 outputs
    and chunks of at most ``max_chunk`` steps.

    One block a 32-column tile, so ceil(E / 32) blocks: every SM gets one
    from E = 132 * 32 on, and below that every tile has its own SM. The
    chunk is all of T up to ``max_chunk``. Up to T = SHORT_T a block is one
    warp that keeps its columns in registers, with no shared memory.
    Beyond, shared memory holds 128 bytes
    of mbarriers; min(STAGES, ceil(T / chunk)) buffers, each of
    ``n_float`` float planes of chunk * 32 * 4 bytes and a dones plane of
    chunk * 32 bytes rounded up to 128; planes of chunk * 32 floats for
    the walker's two coefficients (twice), its carry (twice) and each
    output; and two rows of 32 floats that pass a value between chunks."""
    chunk = min(T, max_chunk)
    if T <= SHORT_T:  # one warp a tile, the columns in registers
        return TILE, chunk, cdiv(E, TILE), 0
    nbuf = min(STAGES, cdiv(T, chunk))
    buffer = n_float * chunk * TILE * 4 + cdiv(chunk * TILE, 128) * 128
    smem = BARS + nbuf * buffer + (6 + n_out) * chunk * TILE * 4 + 2 * TILE * 4
    return TILE, chunk, cdiv(E, TILE), smem
