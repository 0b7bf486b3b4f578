"""The paper's own policy/value networks (§5.1).

``paac_nips``   — A3C-FF network (Mnih et al. 2013 adapted to actor-critic).
``paac_nature`` — Mnih et al. 2015 (Nature DQN) adaptation.
Both consume (84, 84, 4) stacked frames and emit softmax policy + value.
``paac_vector`` — tiny MLP trunk for vector-observation envs (tests/examples).
"""
from repro_torch.configs.base import ArchConfig, register


@register("paac_nips")
def paac_nips() -> ArchConfig:
    return ArchConfig(
        name="paac_nips",
        family="cnn",
        source="paper §5.1 (Mnih et al. 2013 arch, actor-critic heads)",
        cnn_spec=((16, 8, 4), (32, 4, 2)),
        cnn_dense=256,
        d_model=256,
        obs_shape=(84, 84, 4),
        num_actions=6,
        num_layers=2,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )


@register("paac_nature")
def paac_nature() -> ArchConfig:
    return ArchConfig(
        name="paac_nature",
        family="cnn",
        source="paper §5.1 (Mnih et al. 2015 arch, actor-critic heads)",
        cnn_spec=((32, 8, 4), (64, 4, 2), (64, 3, 1)),
        cnn_dense=512,
        d_model=512,
        obs_shape=(84, 84, 4),
        num_actions=6,
        num_layers=3,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )


@register("paac_vector")
def paac_vector() -> ArchConfig:
    return ArchConfig(
        name="paac_vector",
        family="cnn",
        source="framework-native MLP policy for vector envs",
        cnn_spec=(),
        cnn_dense=128,
        d_model=128,
        obs_shape=(8,),
        num_actions=4,
        num_layers=1,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
