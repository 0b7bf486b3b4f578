"""Python-bound emulator stand-ins — GIL-holding external envs (a copy of
``repro.envs.pyemu``).

``HostEnvPool``'s worker threads only buy parallelism when the env's
``step`` releases the GIL (C++ emulators, syscalls, sleeps). Real
Python-bound emulators — ALE through old-style Python wrappers, gym envs
with Python-side frame processing, pure-Python simulators — execute
*bytecode* per step, hold the GIL, and serialize every thread in the
process. ``PyBoundEnv`` models exactly that regime: each ``step`` spins a
pure-Python loop for ``spin`` iterations, so thread-backed actor replicas
cannot scale it.

The dynamics and the numpy ``RandomState`` are the reference's, so the
same seeds and actions give the same observations, rewards and dones in
both packages. Everything here is module-level on purpose: a
``HostEnvSpec`` names its constructor by import path, so it pickles
(``repro_torch.envs.pyemu.make_py_bound_env``), never a closure.
``py_bound_spec`` packages a whole pool as a ``HostEnvSpec``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.envs.host_env import HostEnvSpec

__all__ = ["PyBoundEnv", "make_py_bound_env", "py_bound_spec"]


class PyBoundEnv:
    """Gym-style counter env whose step cost is pure-Python bytecode.

    Reward 1 when ``action == state % 3``, an episode ends every 10 steps,
    the observation is a small float vector derived from the state, plus a
    deliberate GIL-holding workload: ``spin`` iterations of Python
    arithmetic per ``step``. ``spin=0`` makes it a plain fast toy env.
    """

    def __init__(self, seed: int, obs_dim: int = 8, spin: int = 0):
        self.rng = np.random.RandomState(seed)
        self.obs_dim = obs_dim
        self.spin = spin
        self.state = 0

    def _obs(self) -> np.ndarray:
        return np.full((self.obs_dim,), self.state % 7, np.float32)

    def reset(self) -> np.ndarray:
        self.state = int(self.rng.randint(0, 100))
        return self._obs()

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        # the emulator: pure-Python work that never releases the GIL
        acc = 0
        for i in range(self.spin):
            acc += i * i % 7
        reward = 1.0 if int(action) == self.state % 3 else 0.0
        self.state += 1
        return self._obs(), reward, self.state % 10 == 0, {"spin": acc}


def make_py_bound_env(seed: int, obs_dim: int, spin: int) -> PyBoundEnv:
    """Module-level constructor (the spec contract: picklable by import
    reference)."""
    return PyBoundEnv(seed, obs_dim, spin)


def py_bound_spec(n_envs: int, obs_dim: int = 8, spin: int = 0,
                  n_workers: int = 4, base_seed: int = 0,
                  device="cuda") -> HostEnvSpec:
    """A ready-to-build ``HostEnvSpec`` for a pool of ``PyBoundEnv``s whose
    tensors land on ``device``."""
    return HostEnvSpec(
        env_fn=make_py_bound_env,
        env_args=tuple((base_seed + i, obs_dim, spin) for i in range(n_envs)),
        n_workers=n_workers,
        obs_shape=(obs_dim,),
        obs_dtype=np.float32,
        device=str(device),
    )
