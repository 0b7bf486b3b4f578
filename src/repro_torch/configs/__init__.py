"""Architecture registry of the port — importing this package registers the
configs ported so far (the serving slice: qwen2-7b)."""
from repro_torch.configs.base import ArchConfig, get_config, list_archs

# registration side-effects
from repro_torch.configs import qwen2_7b  # noqa: F401

__all__ = ["ArchConfig", "get_config", "list_archs"]
