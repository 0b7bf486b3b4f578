"""Architecture registry of the port — importing this package registers the
configs ported so far: qwen2-7b, minicpm3-4b and mamba2-370m (serving)
and the paper's networks (training). ``PipelineConfig`` holds the
pipeline's knobs."""
from repro_torch.configs.base import (ArchConfig, PipelineConfig, get_config,
                                      list_archs)

# registration side-effects
from repro_torch.configs import (mamba2_370m, minicpm3_4b,  # noqa: F401
                                 paac_cnn, qwen2_7b)

__all__ = ["ArchConfig", "PipelineConfig", "get_config", "list_archs"]
