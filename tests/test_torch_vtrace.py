"""The port's V-trace against the reference's (CPU).

K2's plain version (``repro_torch.kernels.ref.vtrace_returns_ref``) and
``repro_torch.core.returns.vtrace_returns`` are held against
``repro.kernels.ref.vtrace_returns_ref`` and
``repro.core.returns.vtrace_returns`` on the same numpy inputs, over the
reference's kernel sweep (``tests/test_vtrace.py``: (E, T) in (1, 1),
(5, 9), (32, 33), (17, 8) × (ρ̄, c̄) in (1, 1), (2, 1), (1e9, 1e9)) plus
(inf, inf), γ = 0.97, with an all-done, a never-done and a ρ = 50 row;
tolerance 1e-5. The port takes the trajectory time-major (T, E), so the
reference gets the transposes. The Pallas twin does not run under this jax
(ROADMAP F1), so it is not an oracle here. K2 itself runs only on the card
(``tests/test_torch_cuda.py``); here its wrapper is held to refusing every
input it does not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core.returns import vtrace_returns as jax_vtrace  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.returns import n_step_returns, vtrace_returns  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.vtrace import (check_inputs,  # noqa: E402
                                        vtrace_returns_cuda)

TOL = 1e-5
INF = float("inf")
GAMMA = 0.97
SHAPES = [(1, 1), (5, 9), (32, 33), (17, 8)]
CLIPS = [(1.0, 1.0), (2.0, 1.0), (1e9, 1e9), (INF, INF)]


def trajectory(E: int, T: int, seed: int):
    """Time-major rewards, values (T, E) float32 normal; dones (T, E) bool
    at a 25% rate with row 0 always done and row 1 never done; rho
    exp(N(0, 0.5)) with row 2 at 50; bootstrap (E,)."""
    rng = np.random.default_rng(seed)
    rewards = rng.standard_normal((T, E)).astype(np.float32)
    dones = rng.random((T, E)) < 0.25
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


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("rho_bar,c_bar", CLIPS)
@pytest.mark.parametrize("E,T", SHAPES)
def test_plain_k2_and_vtrace_returns_match_the_reference(E, T, rho_bar,
                                                         c_bar):
    r, d, v, b, rho = trajectory(E, T, seed=E * 131 + T)
    jargs = (jnp.asarray(r.T), jnp.asarray(d.T), jnp.asarray(v.T),
             jnp.asarray(b), jnp.asarray(rho.T), GAMMA, rho_bar, c_bar)
    want_ref = jref.vtrace_returns_ref(*jargs)
    want_scan = jax_vtrace(*jargs)
    args = _torch(r, d, v, b, rho) + (GAMMA, rho_bar, c_bar)
    for got in (tref.vtrace_returns_ref(*args), vtrace_returns(*args)):
        assert len(got) == 2
        for out, ref, scan in zip(got, want_ref, want_scan):
            assert out.shape == (T, E) and out.dtype == torch.float32
            _close(out.numpy().T, ref)
            _close(out.numpy().T, scan)


@pytest.mark.parametrize("gamma", [0.0, 0.99, 1.0])
def test_on_policy_with_infinite_clips_is_the_n_step_return(gamma):
    """rho == 1: the recursion telescopes into n-step returns, and the
    policy-gradient advantage is the n-step return minus V."""
    r, d, v, b, _ = trajectory(33, 5, seed=9)
    tr, td, tv, tb = _torch(r, d, v, b)
    vs, adv = vtrace_returns(tr, td, tv, tb, torch.ones(5, 33), gamma, INF,
                             INF)
    ns = n_step_returns(tr, td, tb, gamma)
    _close(vs, ns)
    _close(adv, ns - tv)


def test_clips_of_inf_and_1e9_leave_rho_as_it_is():
    """min(ρ̄, ρ) with ρ̄ = inf or 1e9 is ρ itself, even at ρ = 50: the two
    settings give the same targets bit for bit."""
    args = _torch(*trajectory(17, 8, seed=4))
    a = tref.vtrace_returns_ref(*args, GAMMA, INF, INF)
    b = tref.vtrace_returns_ref(*args, GAMMA, 1e9, 1e9)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_vtrace_returns_casts_like_the_reference():
    """The reference casts every float input to float32 and reads any
    dones as bools; the port's core function does the same before K2."""
    r, d, v, b, rho = trajectory(5, 4, seed=3)
    got = vtrace_returns(torch.from_numpy(r).double(),
                         torch.from_numpy(d).to(torch.uint8),
                         torch.from_numpy(v).half(),
                         torch.from_numpy(b).double(),
                         torch.from_numpy(rho).double(), 0.9)
    want = jax_vtrace(jnp.asarray(r.T), jnp.asarray(d.T),
                      jnp.asarray(v.T, jnp.float16), jnp.asarray(b),
                      jnp.asarray(rho.T), 0.9)
    for out, ref in zip(got, want):
        _close(out.numpy().T, ref)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args = _torch(*trajectory(33, 5, seed=1))
    ops.reset_launches()
    got = ops.vtrace_returns(*args, 0.99, 1.0, 1.0)
    want = tref.vtrace_returns_ref(*args, 0.99, 1.0, 1.0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert ops.launches["vtrace_returns"] == 0


def _bad_inputs(bad):
    r, d, v, b, rho = _torch(*trajectory(8, 5, seed=2))
    if bad == "rewards_float64":
        r = r.double()
    elif bad == "dones_uint8":
        d = d.to(torch.uint8)
    elif bad == "dones_float":
        d = d.float()
    elif bad == "values_float16":
        v = v.half()
    elif bad == "bootstrap_float64":
        b = b.double()
    elif bad == "rho_float64":
        rho = rho.double()
    elif bad == "rewards_1d":
        r = r[0].contiguous()
    elif bad == "dones_shape":
        d = d[:4].contiguous()
    elif bad == "values_shape":
        v = v[:, :7].contiguous()
    elif bad == "rho_shape":
        rho = rho[:3].contiguous()
    elif bad == "bootstrap_shape":
        b = b[:7].contiguous()
    elif bad == "empty":
        r, d, v, rho = r[:0], d[:0], v[:0], rho[:0]
    elif bad == "values_strided":
        v = torch.from_numpy(v.numpy().T.copy()).t()
    elif bad == "rho_strided":
        rho = torch.from_numpy(rho.numpy().T.copy()).t()
    elif bad == "mixed_devices":
        v = torch.empty(5, 8, device="meta")
    elif bad == "values_requires_grad":
        v.requires_grad_(True)
    elif bad == "rho_requires_grad":
        rho.requires_grad_(True)
    elif bad == "bootstrap_requires_grad":
        b.requires_grad_(True)
    elif bad == "not_a_tensor":
        rho = rho.numpy()
    return r, d, v, b, rho


BAD = ["rewards_float64", "dones_uint8", "dones_float", "values_float16",
       "bootstrap_float64", "rho_float64", "rewards_1d", "dones_shape",
       "values_shape", "rho_shape", "bootstrap_shape", "empty",
       "values_strided", "rho_strided", "mixed_devices",
       "values_requires_grad", "rho_requires_grad", "bootstrap_requires_grad",
       "not_a_tensor"]


@pytest.mark.parametrize("bad", BAD)
def test_k2_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper checks before it looks for a card, so CPU tensors
    show every refusal; the CPU route of ``ops`` refuses the same."""
    args = _bad_inputs(bad)
    with pytest.raises(ValueError):
        check_inputs(*args)
    with pytest.raises(ValueError):
        vtrace_returns_cuda(*args, 0.99)
    with pytest.raises(ValueError):
        ops.vtrace_returns(*args, 0.99)


def test_k2_wrapper_refuses_cpu_tensors_it_would_otherwise_take():
    args = _bad_inputs("none")
    check_inputs(*args)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        vtrace_returns_cuda(*args, 0.99, INF, INF)


def test_a_missing_detach_shows_in_the_core_function():
    r, d, v, b, rho = _torch(*trajectory(4, 3, seed=4))
    with pytest.raises(ValueError, match="requires grad"):
        vtrace_returns(r, d, v.requires_grad_(True), b, rho, 0.99)
