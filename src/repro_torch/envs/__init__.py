"""Environments of the port: batched tensor envs on the device, and the
paper's host env plane (``HostEnvPool``: external gym-style envs stepped
by n_w worker threads; ``PyBoundEnv``, an emulator that holds the GIL)."""
from repro_torch.envs.atari_like import AtariLike
from repro_torch.envs.base import VectorEnv, narrow_vector_env
from repro_torch.envs.cartpole import CartPole
from repro_torch.envs.catch import Catch
from repro_torch.envs.gridworld import GridWorld
from repro_torch.envs.host_env import HostEnvPool, HostEnvShard, HostEnvSpec
from repro_torch.envs.pyemu import PyBoundEnv, py_bound_spec
from repro_torch.envs.token_env import TokenEnv
from repro_torch.envs.wrappers import FrameStack

__all__ = [
    "VectorEnv",
    "AtariLike",
    "CartPole",
    "Catch",
    "GridWorld",
    "HostEnvPool",
    "HostEnvShard",
    "HostEnvSpec",
    "PyBoundEnv",
    "narrow_vector_env",
    "py_bound_spec",
    "TokenEnv",
    "FrameStack",
]
