"""Environments of the port: batched tensor envs on the device. The
reference's ``HostEnvPool`` and ``PyBoundEnv`` wait for a later slice
(ROADMAP Queue 1 item 8)."""
from repro_torch.envs.atari_like import AtariLike
from repro_torch.envs.base import VectorEnv, narrow_vector_env
from repro_torch.envs.cartpole import CartPole
from repro_torch.envs.catch import Catch
from repro_torch.envs.gridworld import GridWorld
from repro_torch.envs.token_env import TokenEnv
from repro_torch.envs.wrappers import FrameStack

__all__ = [
    "VectorEnv",
    "AtariLike",
    "CartPole",
    "Catch",
    "GridWorld",
    "narrow_vector_env",
    "TokenEnv",
    "FrameStack",
]
