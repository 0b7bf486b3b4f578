"""Architecture registry of the port — importing this package registers the
configs: qwen2-7b, glm4-9b, deepseek-coder-33b (dense GQA), minicpm3-4b
(dense MLA), dbrx-132b (MoE, GQA), deepseek-v2-236b (MoE, MLA),
mamba2-370m (SSM), zamba2-7b (hybrid: Mamba2 groups and one shared GQA
block), pixtral-12b (vision: a dense GQA decoder after a prefix of patch
embeddings) and seamless-m4t-large-v2 (audio encoder-decoder) for
serving, and the paper's networks (training). ``ASSIGNED_ARCHS`` lists
the ten token architectures in the reference's order; ``INPUT_SHAPES``
the dry-run's four global input shapes. ``PipelineConfig`` holds the
pipeline's knobs."""
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      PipelineConfig, get_config, list_archs)

# registration side-effects
from repro_torch.configs import (dbrx_132b, deepseek_coder_33b,  # noqa: F401
                                 deepseek_v2_236b, glm4_9b, mamba2_370m,
                                 minicpm3_4b, paac_cnn, pixtral_12b,
                                 qwen2_7b, seamless_m4t_large_v2,
                                 zamba2_7b)

ASSIGNED_ARCHS = [
    "minicpm3-4b",
    "glm4-9b",
    "deepseek-v2-236b",
    "seamless-m4t-large-v2",
    "deepseek-coder-33b",
    "dbrx-132b",
    "qwen2-7b",
    "zamba2-7b",
    "pixtral-12b",
    "mamba2-370m",
]

__all__ = ["ASSIGNED_ARCHS", "ArchConfig", "INPUT_SHAPES", "InputShape",
           "PipelineConfig", "get_config", "list_archs"]
