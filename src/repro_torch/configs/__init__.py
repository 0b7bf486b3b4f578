"""Architecture registry of the port — importing this package registers the
configs ported so far: qwen2-7b, glm4-9b, deepseek-coder-33b (dense GQA),
minicpm3-4b (dense MLA), dbrx-132b (MoE, GQA), deepseek-v2-236b (MoE,
MLA), mamba2-370m (SSM) and zamba2-7b (hybrid: Mamba2 groups and one
shared GQA block) for serving, and the paper's networks (training).
``PipelineConfig`` holds the pipeline's knobs."""
from repro_torch.configs.base import (ArchConfig, PipelineConfig, get_config,
                                      list_archs)

# registration side-effects
from repro_torch.configs import (dbrx_132b, deepseek_coder_33b,  # noqa: F401
                                 deepseek_v2_236b, glm4_9b, mamba2_370m,
                                 minicpm3_4b, paac_cnn, qwen2_7b,
                                 zamba2_7b)

__all__ = ["ArchConfig", "PipelineConfig", "get_config", "list_archs"]
