from repro_torch.core.agents.base import Agent
from repro_torch.core.agents.paac import PAACAgent, PAACConfig, paac_losses

__all__ = ["Agent", "PAACAgent", "PAACConfig", "paac_losses"]
