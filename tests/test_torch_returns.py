"""The port's n-step returns against the reference's (CPU).

K1's plain version (``repro_torch.kernels.ref.nstep_returns_ref``) and
``repro_torch.core.returns.n_step_returns`` are held against
``repro.kernels.ref.nstep_returns_ref`` and
``repro.core.returns.n_step_returns`` on the same numpy inputs, over
E ∈ {1, 32, 33, 256, 4096} × T ∈ {1, 5, 64} × γ ∈ {0, 0.99, 1}, with dones
at a 10% rate plus an all-done and a never-done row; tolerance 1e-5. The
port takes the trajectory time-major (T, E), so its outputs are
transposed before the comparison. The Pallas twin does not run under this
jax (ROADMAP F1), so it is not an oracle here. K1 itself runs only on the
card (``tests/test_torch_cuda.py``); here its wrapper is held to refusing
every input it does not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core.returns import n_step_returns as jax_n_step  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.returns import n_step_returns  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.nstep_returns import (  # noqa: E402
    check_inputs, nstep_returns_cuda)

TOL = 1e-5
E_SWEEP = (1, 32, 33, 256, 4096)
T_SWEEP = (1, 5, 64)
GAMMAS = (0.0, 0.99, 1.0)


def trajectory(E: int, T: int, seed: int):
    """Time-major rewards (T, E) float32, dones (T, E) bool at a 10% rate
    with row 0 always done and row 1 never done, bootstrap (E,)."""
    rng = np.random.default_rng(seed)
    rewards = rng.standard_normal((T, E)).astype(np.float32)
    dones = rng.random((T, E)) < 0.1
    if E >= 2:
        dones[:, 0], dones[:, 1] = True, False
    bootstrap = rng.standard_normal(E).astype(np.float32)
    return rewards, dones, bootstrap


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("T", T_SWEEP)
@pytest.mark.parametrize("E", E_SWEEP)
def test_plain_k1_and_n_step_returns_match_the_reference(E, T, gamma):
    r, d, b = trajectory(E, T, seed=E * 131 + T)
    want_ref = jref.nstep_returns_ref(jnp.asarray(r.T), jnp.asarray(d.T),
                                      jnp.asarray(b), gamma)
    want_scan = jax_n_step(jnp.asarray(r.T), jnp.asarray(d.T),
                           jnp.asarray(b), gamma)
    tr, td, tb = torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(b)
    plain = tref.nstep_returns_ref(tr, td, tb, gamma)
    core = n_step_returns(tr, td, tb, gamma)
    assert plain.shape == (T, E) and plain.dtype == torch.float32
    assert core.shape == (T, E) and core.dtype == torch.float32
    for got in (plain, core):
        _close(got.numpy().T, want_ref)
        _close(got.numpy().T, want_scan)
    # the all-done row is its own rewards; the never-done row discounts
    # the bootstrap all the way back
    if E >= 2:
        _close(plain[:, 0], r[:, 0])
        _close(plain[0, 1], sum(gamma ** t * r[t, 1] for t in range(T))
               + gamma ** T * b[1])


def test_n_step_returns_casts_like_the_reference():
    """The reference casts rewards and bootstrap to float32 and reads any
    dones as bools; the port's core function does the same before K1."""
    r, d, b = trajectory(5, 4, seed=3)
    got = n_step_returns(torch.from_numpy(r).double(),
                         torch.from_numpy(d).to(torch.uint8),
                         torch.from_numpy(b).half(), 0.9)
    want = jax_n_step(jnp.asarray(r.T), jnp.asarray(d.T),
                      jnp.asarray(b, jnp.float16), 0.9)
    _close(got.numpy().T, want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    r, d, b = trajectory(33, 5, seed=1)
    tr, td, tb = torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(b)
    ops.reset_launches()
    _close(ops.nstep_returns(tr, td, tb, 0.99),
           tref.nstep_returns_ref(tr, td, tb, 0.99))
    assert ops.launches["nstep_returns"] == 0


def _bad_inputs(bad):
    r, d, b = (torch.from_numpy(x) for x in trajectory(8, 5, seed=2))
    if bad == "rewards_float64":
        r = r.double()
    elif bad == "dones_uint8":
        d = d.to(torch.uint8)
    elif bad == "dones_float":
        d = d.float()
    elif bad == "bootstrap_float16":
        b = b.half()
    elif bad == "rewards_1d":
        r = r[0].contiguous()
    elif bad == "dones_shape":
        d = d[:4].contiguous()
    elif bad == "bootstrap_shape":
        b = b[:7].contiguous()
    elif bad == "empty":
        r, d = r[:0], d[:0]
    elif bad == "rewards_strided":
        r = torch.from_numpy(r.numpy().T.copy()).t()
    elif bad == "dones_strided":
        d = torch.from_numpy(d.numpy().T.copy()).t()
    elif bad == "bootstrap_strided":
        b = torch.zeros(16)[::2]
    elif bad == "mixed_devices":
        b = torch.empty(8, device="meta")
    elif bad == "rewards_requires_grad":
        r.requires_grad_(True)
    elif bad == "bootstrap_requires_grad":
        b.requires_grad_(True)
    elif bad == "not_a_tensor":
        b = b.numpy()
    return r, d, b


BAD = ["rewards_float64", "dones_uint8", "dones_float", "bootstrap_float16",
       "rewards_1d", "dones_shape", "bootstrap_shape", "empty",
       "rewards_strided", "dones_strided", "bootstrap_strided",
       "mixed_devices", "rewards_requires_grad", "bootstrap_requires_grad",
       "not_a_tensor"]


@pytest.mark.parametrize("bad", BAD)
def test_k1_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The CUDA wrapper checks before it looks for a card, so CPU tensors
    show every refusal; the CPU route of ``ops`` refuses the same."""
    r, d, b = _bad_inputs(bad)
    with pytest.raises(ValueError):
        check_inputs(r, d, b)
    with pytest.raises(ValueError):
        nstep_returns_cuda(r, d, b, 0.99)
    with pytest.raises(ValueError):
        ops.nstep_returns(r, d, b, 0.99)


def test_k1_wrapper_refuses_cpu_tensors_it_would_otherwise_take():
    r, d, b = _bad_inputs("none")
    check_inputs(r, d, b)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        nstep_returns_cuda(r, d, b, 0.99)


def test_a_missing_detach_shows_in_the_core_function():
    r, d, b = (torch.from_numpy(x) for x in trajectory(4, 3, seed=4))
    with pytest.raises(ValueError, match="requires grad"):
        n_step_returns(r, d, b.requires_grad_(True), 0.99)
