from repro_torch.core.agents.base import Agent
from repro_torch.core.agents.baselines import LaggedConfig, LaggedPAACAgent
from repro_torch.core.agents.dqn import DQNAgent, DQNConfig
from repro_torch.core.agents.paac import PAACAgent, PAACConfig, paac_losses
from repro_torch.core.agents.ppo import PPOAgent, PPOConfig

__all__ = [
    "Agent",
    "PAACAgent",
    "PAACConfig",
    "paac_losses",
    "DQNAgent",
    "DQNConfig",
    "LaggedPAACAgent",
    "LaggedConfig",
    "PPOAgent",
    "PPOConfig",
]
