"""K6's gradient: ``ops.ssd_scan`` through ``ops.SSDScan`` (the forward
the plain version on the CPU, the backward ``ref.ssd_scan_bwd``, a recompute
with its exponents in float64) against the JAX package's autodiff (CPU, fp32).

* All six input gradients, with cotangents on y and on the final state,
  against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked`` (what the
  reference differentiates, F4) within 1e-5 of each gradient's largest
  value: one chunk, three chunks, and two heads of state 32 at chunk 16.
* F21: at mamba2-370m's 32 heads and chunk 128 with dt up to 0.1 a
  chunk's decay passes e^88, and ``ssd_chunked``'s gradient of dt and
  A_log is NaN (0 * inf where its ``where`` drops exp's inf). The port
  masks the decay before ``exp``; its gradient is finite there and matches
  ``jax.vjp`` of the reference's exact sequential recurrence
  (``repro.kernels.ref.ssd_scan_ref``).
* The mask leaves the forward bitwise as the ``where`` form gives it; the
  forward with a gradient is bitwise the forward without one; a cotangent
  on y alone; ``backward_calls["ssd_scan"]`` counts each backward and the
  CPU route launches nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_scan_ref as jax_sequential  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GRAD_TOL = 1e-5  # of each gradient's largest value
NAMES = ("x", "dt", "A_log", "B", "C", "D")


def _inputs(seed, Bsz, S, H, P, N, dt_max=0.1):
    """Numpy inputs as a Mamba2 layer feeds the scan: dt post-softplus in
    [1e-3, dt_max), A_log = log(1..H) as ``init_mamba2`` sets it, and the
    two cotangents."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "x": rng.standard_normal((Bsz, S, H, P)).astype(f32),
        "dt": rng.uniform(1e-3, dt_max, (Bsz, S, H)).astype(f32),
        "A_log": np.log(np.arange(1, H + 1)).astype(f32),
        "B": (rng.standard_normal((Bsz, S, N)) / np.sqrt(N)).astype(f32),
        "C": (rng.standard_normal((Bsz, S, N)) / np.sqrt(N)).astype(f32),
        "D": rng.standard_normal(H).astype(f32),
        "d_y": rng.standard_normal((Bsz, S, H, P)).astype(f32),
        "d_state": rng.standard_normal((Bsz, H, P, N)).astype(f32),
    }


def _jax_grads(fn, a, chunk):
    args = [jnp.asarray(a[k]) for k in NAMES]
    (y, state), vjp = jax.vjp(lambda *t: fn(*t, chunk=chunk), *args)
    grads = vjp((jnp.asarray(a["d_y"]), jnp.asarray(a["d_state"])))
    return [np.asarray(g) for g in grads]


def _port_grads(a, chunk, d_state=True):
    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in NAMES]
    y, state = ops.ssd_scan(*leaves, chunk=chunk)
    outs, cots = [y], [torch.from_numpy(a["d_y"])]
    if d_state:
        outs.append(state)
        cots.append(torch.from_numpy(a["d_state"]))
    torch.autograd.backward(outs, cots)
    return [t.grad.numpy() for t in leaves]


def _close(port, want):
    for name, a, b in zip(NAMES, port, want):
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


CHUNKED = {  # (B, S, H, P, N, chunk)
    "one-chunk": (2, 32, 4, 8, 16, 32),
    "three-chunks": (2, 96, 8, 8, 16, 32),
    "two-heads-state-32": (1, 48, 2, 4, 32, 16),
}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_the_gradient_matches_ssd_chunked(case):
    Bsz, S, H, P, N, chunk = CHUNKED[case]
    a = _inputs(0, Bsz, S, H, P, N)
    _close(_port_grads(a, chunk), _jax_grads(ssd_chunked, a, chunk))


def test_f21_ssd_chunked_is_nan_where_the_port_matches_the_sequential_ref():
    """mamba2-370m's heads and chunk: exp(A_log) dt summed over a chunk
    reaches ~32 * 0.05 * 128 = 205 > 88 for the widest heads."""
    a = _inputs(1, 1, 128, 32, 4, 8)
    chunked = _jax_grads(ssd_chunked, a, 128)
    assert np.isnan(chunked[1]).any() and np.isnan(chunked[2]).any()
    _close(_port_grads(a, 128), _jax_grads(jax_sequential, a, 128))


def _ssd_where_form(x, dt, A_log, B_mat, C_mat, D_vec, *, chunk):
    """``ref.ssd_scan_ref`` as it stood before the mask: the decay is
    ``where(tril, exp(dec), 0)``, as ``ssd_chunked`` builds it."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    nc = S // chunk
    a = -torch.exp(A_log)[None, None, :] * dt
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = B_mat.reshape(Bsz, nc, chunk, N)
    Cc = C_mat.reshape(Bsz, nc, chunk, N)
    cum = torch.cumsum(a.reshape(Bsz, nc, chunk, H), dim=2)
    total = cum[:, :, -1, :]
    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    L = torch.where(tril[None, None, :, :, None], torch.exp(dec),
                    torch.zeros(()))
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xdt)
    w_state = torch.exp(total[:, :, None, :] - cum)
    s_chunk = torch.einsum("bcjh,bcjs,bcjhp->bchps", w_state, Bc, xdt)
    state = torch.zeros((Bsz, H, P, N))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = (state * torch.exp(total[:, c])[:, :, None, None]
                 + s_chunk[:, c])
    y_inter = torch.einsum("bcih,bcis,bchps->bcihp", torch.exp(cum), Cc,
                           torch.stack(s_in, dim=1))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y + D_vec[None, None, :, None] * x, state


@pytest.mark.parametrize("dt_max", [0.1, 1.0], ids=["small", "past-e88"])
def test_the_mask_leaves_the_forward_bitwise_as_it_was(dt_max):
    a = _inputs(2, 2, 64, 8, 4, 16, dt_max=dt_max)
    args = [torch.from_numpy(a[k]) for k in NAMES]
    y, state = ref.ssd_scan_ref(*args, chunk=32)
    y0, s0 = _ssd_where_form(*args, chunk=32)
    assert torch.equal(y, y0) and torch.equal(state, s0)


def test_the_forward_with_a_gradient_is_bitwise_the_forward_without():
    a = _inputs(3, 2, 64, 4, 8, 16)
    args = [torch.from_numpy(a[k]).to(torch.bfloat16)
            if k in ("x", "B", "C") else torch.from_numpy(a[k])
            for k in NAMES]
    with torch.no_grad():
        y0, s0 = ops.ssd_scan(*args, chunk=32)
    leaves = [t.clone().requires_grad_(True) for t in args]
    y, state = ops.ssd_scan(*leaves, chunk=32)
    assert y.grad_fn is not None and y0.grad_fn is None
    assert y.dtype == torch.bfloat16
    assert torch.equal(y.detach(), y0) and torch.equal(state.detach(), s0)
    y.float().sum().backward()
    assert [t.grad.dtype for t in leaves] == [t.dtype for t in args]


def test_a_cotangent_on_y_alone_matches_autograd_through_the_plain_version():
    a = _inputs(4, 2, 64, 4, 8, 16)
    port = _port_grads(a, 32, d_state=False)
    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in NAMES]
    y, _ = ref.ssd_scan_ref(*leaves, chunk=32)
    y.backward(torch.from_numpy(a["d_y"]))
    _close(port, [t.grad.numpy() for t in leaves])


def test_backward_calls_count_and_the_cpu_route_launches_nothing():
    a = _inputs(5, 1, 32, 2, 4, 8)
    ops.reset_launches()
    _port_grads(a, 32)
    _port_grads(a, 32, d_state=False)
    assert ops.backward_calls["ssd_scan"] == 2
    assert ops.launches["ssd_scan"] == 0
    with torch.no_grad():
        ops.ssd_scan(*[torch.from_numpy(a[k]).requires_grad_(True)
                       for k in NAMES], chunk=32)
    assert ops.backward_calls["ssd_scan"] == 2
