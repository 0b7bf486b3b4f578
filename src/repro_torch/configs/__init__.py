"""Architecture registry of the port — importing this package registers the
configs ported so far: qwen2-7b (serving) and the paper's networks
(training). ``PipelineConfig`` holds the pipeline's knobs."""
from repro_torch.configs.base import (ArchConfig, PipelineConfig, get_config,
                                      list_archs)

# registration side-effects
from repro_torch.configs import paac_cnn, qwen2_7b  # noqa: F401

__all__ = ["ArchConfig", "PipelineConfig", "get_config", "list_archs"]
