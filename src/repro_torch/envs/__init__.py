"""Environments of the port: batched tensor envs on the device. The
reference's ``CartPole``, ``TokenEnv``, ``HostEnvPool`` and ``PyBoundEnv``
wait for later slices (ROADMAP Queue 1 items 4, 8 and 11)."""
from repro_torch.envs.atari_like import AtariLike
from repro_torch.envs.base import VectorEnv, narrow_vector_env
from repro_torch.envs.catch import Catch
from repro_torch.envs.gridworld import GridWorld
from repro_torch.envs.wrappers import FrameStack

__all__ = [
    "VectorEnv",
    "AtariLike",
    "Catch",
    "GridWorld",
    "narrow_vector_env",
    "FrameStack",
]
