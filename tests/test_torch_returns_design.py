"""K1's and K2's launch shape and their tiled, chunked backward walk (CPU).

The kernels (``csrc/nstep_returns.cu``, ``csrc/vtrace.cu``) share the
staging and the walks of ``csrc/column_scan.cuh``. Up to T = SHORT_T a
warp owns 32 env columns and holds them in registers. Beyond, a block of
eight warps owns ``tile`` = 32 columns and copies the time axis into a ring
of ``min(STAGES, ceil(T / chunk))`` shared-memory buffers, ``STAGES - 2``
chunks ahead of the walk; seven helper warps turn each chunk into the
coefficients of y_t = b_t + a_t y_{t+1} a chunk ahead, one walker warp runs
that recurrence with the carry in a register, and the helpers compute and
store the outputs a chunk behind. Here:

- ``launch_shape`` covers every column exactly once, gives at least
  min(132, ceil(E / 32)) blocks and keeps shared memory within 227 KB
  (none up to SHORT_T), for E in {1, 8, 31, 32, 33, 256, 4096, 4097};
- a plain-torch emulation of that walk (the same issue order into the same
  ring of buffers and planes, the ragged tile's spare lanes fed NaN, the
  carry across chunk and tile edges, each column's operations split
  between the warps in the kernel's order; one chunk up to SHORT_T) is
  ``torch.equal`` to ``repro_torch.kernels.ref`` and within 1e-5 of
  ``repro.core.returns`` on the same numpy inputs (for V-trace 1e-5
  relative to the sum of the absolute values of the terms that form each
  output: with c unclipped those grow with the products of c along T, and
  the outputs cancel them), over those E and T in {1, 5, SHORT_T,
  SHORT_T + 1} and the chunk edges {TC - 1, TC, TC + 1, 2 TC + 3} (TC the
  longest chunk: 128 for K1, 64 for K2), and T = 4096 at E = 256; V-trace
  over (rho_bar, c_bar) in {(1, 1), (2, 1), (1e9, 1e9), (inf, inf)}, where
  the unclipped rho = 50 column overflows float32 in every version alike.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core.returns import n_step_returns as jax_n_step  # noqa: E402
from repro.core.returns import vtrace_returns as jax_vtrace  # noqa: E402
from repro_torch.kernels import column_scan  # noqa: E402
from repro_torch.kernels import nstep_returns as nr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import vtrace as vt  # noqa: E402

TOL = 1e-5
INF = float("inf")
E_SWEEP = (1, 8, 31, 32, 33, 256, 4096, 4097)
CLIPS = [(1.0, 1.0), (2.0, 1.0), (1e9, 1e9), (INF, INF)]
KERNELS = {"nstep_returns": (nr, 1, 1), "vtrace": (vt, 3, 2)}
CSRC = Path(nr.__file__).resolve().parents[1] / "csrc"
SMS = 132  # streaming multiprocessors of an H100 (and an H200)
SMEM_LIMIT = 232_448  # shared memory a block may take on Hopper (227 KB)


def _chunk_edges(mod):
    """The short path's T (1, 5, SHORT_T) and the first T past it, the chunk
    edges and the TPU kernel's design point."""
    tc, st = mod.MAX_CHUNK, column_scan.SHORT_T
    return [(E, T) for E in E_SWEEP for T in (1, 5, st, st + 1, tc - 1, tc,
                                              tc + 1, 2 * tc + 3)
            ] + [(256, 4096)]


# --------------------------------------------------------------------------
# launch shape
# --------------------------------------------------------------------------


@pytest.mark.parametrize("E", E_SWEEP)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_launch_shape_covers_every_column_exactly_once(kernel, E):
    mod = KERNELS[kernel][0]
    for T in (1, 5, 64, 4096):
        tile, chunk, blocks, _ = mod.launch_shape(T, E)
        assert tile == 32 and chunk == min(T, mod.MAX_CHUNK)
        owners = torch.zeros(E, dtype=torch.int64)
        for b in range(blocks):
            owners[b * tile:min(E, (b + 1) * tile)] += 1
        assert bool((owners == 1).all())
        assert (blocks - 1) * tile < E <= blocks * tile  # no empty block


@pytest.mark.parametrize("E", E_SWEEP + (8448, 20000))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_launch_shape_gives_every_sm_a_block_where_e_allows(kernel, E):
    mod = KERNELS[kernel][0]
    for T in (1, 5, 64, 4096):
        _, _, blocks, _ = mod.launch_shape(T, E)
        assert blocks >= min(SMS, -(-E // 32))


@pytest.mark.parametrize("E", E_SWEEP + (8448, 20000))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_launch_shape_keeps_shared_memory_within_the_block_limit(kernel, E):
    mod, nf, no = KERNELS[kernel]
    for T in (1, 5, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 259, 4096):
        tile, chunk, _, smem = mod.launch_shape(T, E)
        if T <= column_scan.SHORT_T:  # the columns in registers
            assert smem == 0
            continue
        nbuf = min(column_scan.STAGES, -(-T // chunk))
        # mbarriers, the ring's buffers (a TMA destination starts on 128
        # bytes), the walker's coefficient and carry planes (twice each), an
        # output plane an output, and two edge rows
        dones_plane = -(-chunk * tile // 128) * 128
        assert smem == 128 + nbuf * (nf * chunk * tile * 4 + dones_plane) + (
            (6 + no) * chunk * tile * 4) + 2 * tile * 4
        assert (nf * chunk * tile * 4) % 128 == 0
        assert smem <= SMEM_LIMIT  # 227 KB


def test_launch_shape_constants_match_the_sources():
    header = (CSRC / "column_scan.cuh").read_text()
    assert re.search(rf"constexpr int STAGES = {column_scan.STAGES};", header)
    assert re.search(rf"constexpr int TILE = {column_scan.TILE};", header)
    assert re.search(rf"constexpr int BARS = {column_scan.BARS};", header)
    assert re.search(rf"constexpr int SHORT_T = {column_scan.SHORT_T};", header)
    for name, (mod, _, _) in KERNELS.items():
        src = (CSRC / f"{name}.cu").read_text()
        assert re.search(rf"constexpr int CHUNK = {mod.MAX_CHUNK};", src), name


# --------------------------------------------------------------------------
# the walk, emulated
# --------------------------------------------------------------------------


def emulate_walk(mod, floats, dones, prep, y_init, emit, outputs):
    """Run the kernel's walk over time-major (T, E) ``floats`` and
    ``dones`` in plain torch, every block at once, as its warps do: chunks
    0 .. STAGES - 3 are copied, then in iteration j chunk j + STAGES - 2,
    into buffer chunk % nbuf; the helpers prepare chunk j + 1's
    coefficients (``prep(c, up, r, k)`` -> (a_r, b_r), ``up`` the chunk
    before or None) into plane set (j + 1) % 2; the walker runs y_r = b_r +
    a_r * y_{r+1} over chunk j into y plane j % 2; the helpers write out
    chunk j - 1 (``emit(c, y, edge_in, edge_out, r, k)`` -> one (blocks,
    tile) tensor an output), passing a value from row 0 of one chunk to the
    last row of the next through two edge rows. Within an iteration the
    steps run in an order that would show a buffer shared by mistake. Spare
    lanes of a ragged tile read NaN and never store."""
    T, E = dones.shape
    tile, chunk, blocks, smem = mod.launch_shape(T, E)
    assert smem > 0 or chunk == T  # T <= SHORT_T: one chunk, in registers
    stages = column_scan.STAGES
    nck = -(-T // chunk)
    nbuf = min(stages, nck)
    col = torch.arange(blocks)[:, None] * tile + torch.arange(tile)[None, :]
    live = col < E
    safe = col.clamp(max=E - 1)

    def planes(n):
        return [torch.full((blocks, chunk, tile), float("nan"))
                for _ in range(n)]

    bufs = [planes(len(floats)) + [torch.ones(blocks, chunk, tile,
                                              dtype=torch.bool)]
            for _ in range(nbuf)]
    coef, ys = [planes(2) for _ in range(2)], planes(2)
    edges = [torch.full((blocks, tile), float("nan")) for _ in range(2)]

    def rows(k):
        t1 = T - k * chunk
        return max(0, t1 - chunk), t1

    def issue(k):
        t0, t1 = rows(k)
        for a, x in enumerate(list(floats) + [dones]):
            part = x[t0:t1][:, safe].permute(1, 0, 2)
            fill = torch.ones((), dtype=torch.bool) if x is dones else \
                torch.tensor(float("nan"))
            bufs[k % nbuf][a][:, :t1 - t0] = torch.where(live[:, None, :],
                                                         part, fill)

    def view(k):
        t0, t1 = rows(k)
        buf = bufs[k % nbuf]
        return {"x": [b.clone() for b in buf[:-1]], "d": buf[-1].clone(),
                "n": t1 - t0, "t0": t0}

    def prepare(k):
        c, up = view(k), (view(k - 1) if k > 0 else None)
        for r in range(c["n"]):
            a, b = prep(c, up, r, k)
            coef[k % 2][0][:, r], coef[k % 2][1][:, r] = a, b

    outs = [torch.full((T, E), float("nan")) for _ in range(outputs)]
    written = torch.zeros(T, E, dtype=torch.int64)

    def write_out(k):
        c, y = view(k), ys[k % 2].clone()
        for r in range(c["n"]):
            vals = emit(c, y, edges[(k + 1) % 2], edges[k % 2], r, k)
            for out, val in zip(outs, vals):
                out[c["t0"] + r, col[live]] = val[live]
            written[c["t0"] + r, col[live]] += 1

    y = y_init(safe, live)
    for k in range(min(stages - 2, nck)):
        issue(k)
    prepare(0)
    for j in range(nck + 1):
        if j + stages - 2 < nck:
            issue(j + stages - 2)
        if j + 1 < nck:
            prepare(j + 1)
        if j < nck:  # the walker
            t0, t1 = rows(j)
            a, b = (p.clone() for p in coef[j % 2])
            for r in range(t1 - t0 - 1, -1, -1):
                y = b[:, r] + a[:, r] * y
                ys[j % 2][:, r] = y
        if j >= 1:
            write_out(j - 1)
    assert bool((written == 1).all())  # every (t, e) stored exactly once
    return outs


def _boot(b, col, live):
    return torch.where(live, b[col], torch.tensor(float("nan")))


def emulate_nstep(r, d, b, gamma):
    def prep(c, up, row, k):
        nd = torch.where(c["d"][:, row], 0.0, 1.0)
        return gamma * nd, c["x"][0][:, row]

    def emit(c, y, edge_in, edge_out, row, k):
        return [y[:, row]]

    return emulate_walk(nr, [r], d, prep, lambda col, live: _boot(b, col, live),
                        emit, 1)[0]


def emulate_vtrace(r, d, v, b, rho, gamma, rho_bar, c_bar):
    boot = {}

    def y_init(col, live):
        boot["b"] = _boot(b, col, live)
        return torch.zeros_like(boot["b"])

    def prep(c, up, row, k):
        rt, vt_, w = (x[:, row] for x in c["x"])
        if row + 1 < c["n"]:
            v_next = c["x"][1][:, row + 1]
        else:
            v_next = up["x"][1][:, 0] if up is not None else boot["b"]
        nd = torch.where(c["d"][:, row], 0.0, 1.0)
        rc = torch.clamp(w, max=rho_bar)
        delta = rc * (rt + gamma * nd * v_next - vt_)
        return gamma * nd * torch.clamp(w, max=c_bar), delta

    def emit(c, y, edge_in, edge_out, row, k):
        rt, vt_, w = (x[:, row] for x in c["x"])
        vs = vt_ + y[:, row]
        if row + 1 < c["n"]:
            vs_next = c["x"][1][:, row + 1] + y[:, row + 1]
        else:
            vs_next = edge_in.clone() if k > 0 else boot["b"]
        if row == 0:
            edge_out.copy_(vs)
        nd = torch.where(c["d"][:, row], 0.0, 1.0)
        rc = torch.clamp(w, max=rho_bar)
        return [vs, rc * (rt + gamma * nd * vs_next - vt_)]

    return tuple(emulate_walk(vt, [r, v, rho], d, prep, y_init, emit, 2))


def trajectory(E: int, T: int, seed: int):
    """Time-major rewards, values (T, E) float32 normal; dones at 10% with
    column 0 always and column 1 never done; rho exp(N(0, 0.5)) with
    column 2 at 50; bootstrap (E,)."""
    rng = np.random.default_rng(seed)
    rewards = rng.standard_normal((T, E)).astype(np.float32)
    dones = rng.random((T, E)) < 0.1
    values = rng.standard_normal((T, E)).astype(np.float32)
    rho = np.exp(0.5 * rng.standard_normal((T, E))).astype(np.float32)
    if E >= 3:
        dones[:, 0], dones[:, 1] = True, False
        rho[:, 2] = 50.0
    bootstrap = rng.standard_normal(E).astype(np.float32)
    return rewards, dones, values, bootstrap, rho


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def term_sizes(r, d, v, b, rho, gamma, rho_bar, c_bar):
    """For vs and pg_adv, the sum of the absolute values of the terms that
    form each output, in float64: a sum that cancels keeps only its terms'
    rounding, and A_t sums delta_k over k >= t weighted by the products of
    gamma nd_j c_j, which grow past 1 where c is unclipped."""
    r, v, rho, b = (x.astype(np.float64) for x in (r, v, rho, b))
    disc = gamma * (1.0 - d)
    rc, c = np.minimum(rho, rho_bar), np.minimum(rho, c_bar)
    v_next = np.abs(np.concatenate([v[1:], b[None]]))
    with np.errstate(invalid="ignore", over="ignore"):
        delta = rc * (np.abs(r) + disc * v_next + np.abs(v))
        chain, h = np.zeros_like(v), np.zeros_like(b)
        for t in range(r.shape[0] - 1, -1, -1):
            h = delta[t] + disc[t] * c[t] * h
            chain[t] = h
        vs = np.abs(v) + chain
        vs_next = np.concatenate([vs[1:], np.abs(b)[None]])
        return vs, rc * (np.abs(r) + disc * vs_next + np.abs(v))


def _close_to_terms(out, want, terms):
    """|out - want| <= 1e-5 + 1e-5 * max(|want|, terms), inf and NaN in the
    same places (``terms`` from ``term_sizes``)."""
    out, want = np.asarray(out, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(out))
    assert np.array_equal(out[~fin], want[~fin], equal_nan=True)
    with np.errstate(invalid="ignore"):
        bound = TOL + TOL * np.fmax(np.abs(want), terms)
    assert bool((np.abs(out - want)[fin] <= bound[fin]).all())


def _same(a, b):
    """Bitwise equal, with NaN in the same places."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(
        torch.equal(a[~nan], b[~nan]))


@pytest.mark.parametrize("E,T", _chunk_edges(nr))
def test_k1_walk_is_the_plain_version_bitwise(E, T):
    r, d, _, b, _ = trajectory(E, T, seed=E * 7 + T)
    tr, td, tb = torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(b)
    gamma = 0.99
    got = emulate_nstep(tr, td, tb, gamma)
    assert torch.equal(got, ref.nstep_returns_ref(tr, td, tb, gamma))
    _close(got.numpy().T, jax_n_step(jnp.asarray(r.T), jnp.asarray(d.T),
                                     jnp.asarray(b), gamma))


@pytest.mark.parametrize("rho_bar,c_bar", CLIPS)
@pytest.mark.parametrize("E,T", _chunk_edges(vt))
def test_k2_walk_is_the_plain_version_bitwise(E, T, rho_bar, c_bar):
    r, d, v, b, rho = trajectory(E, T, seed=E * 7 + T)
    args = tuple(torch.from_numpy(x) for x in (r, d, v, b, rho)) + (
        0.97, rho_bar, c_bar)
    got = emulate_vtrace(*args)
    for out, plain in zip(got, ref.vtrace_returns_ref(*args)):
        assert _same(out, plain)
    want = jax_vtrace(jnp.asarray(r.T), jnp.asarray(d.T), jnp.asarray(v.T),
                      jnp.asarray(b), jnp.asarray(rho.T), 0.97, rho_bar, c_bar)
    terms = term_sizes(r, d, v, b, rho, 0.97, rho_bar, c_bar)
    for out, jax_out, size in zip(got, want, terms):
        _close_to_terms(out.numpy(), np.asarray(jax_out).T, size)
