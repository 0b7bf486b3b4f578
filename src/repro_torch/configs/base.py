"""Architecture configuration of the port (a copy of ``repro``'s).

Every selectable architecture (``--arch <id>``) is an ``ArchConfig``,
registered by one file under ``repro_torch/configs``. Each config also
exposes a ``reduced()`` variant (<=2 layers, d_model<=256, fp32) used by
the CPU tests. ``PipelineConfig`` holds the knobs of the asynchronous
actor/learner pipeline (``repro_torch.pipeline``). The port keeps its own
copy rather than importing ``repro``; the input-shape table waits for the
slice that uses it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

@dataclass(frozen=True)
class ArchConfig:
    """Configuration for one policy/value backbone.

    The PAAC framework is model agnostic (paper §3): every architecture gets
    the two-headed output of paper §4 — a softmax policy head and a linear
    value head — attached by ``repro_torch.models.heads``.
    """

    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio | cnn
    source: str = ""  # citation (hf:... / arXiv:...)

    # trunk
    num_layers: int = 2
    d_model: int = 256
    vocab_size: int = 1024

    # attention
    attention: str = "gqa"  # "gqa" | "mla" | "none"
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # MLA (DeepSeek-V2 / MiniCPM3 style multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False  # matmul-absorption decode path (perf variant)

    # feed-forward
    d_ff: int = 1024
    mlp: str = "swiglu"  # "swiglu" | "gelu" | "none"

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 -> use d_ff)
    first_dense_layers: int = 0  # leading layers that use a dense FFN
    dense_d_ff: int = 0  # hidden dim of those dense layers
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 4096  # routing group (sequence chunk) length

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # hybrid (Zamba2-style: shared attention block applied periodically)
    shared_attn_every: int = 0  # 0 -> no shared attention

    # encoder-decoder (Seamless-style)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1024  # stub front-end frames/patches

    # modality front-end stub
    modality: str = "text"  # text | audio | vision
    prefix_len: int = 0  # patch/frame embedding prefix length (vlm)
    frontend_dim: int = 0  # raw front-end embedding dim (0 -> d_model, no proj)

    # long-context variant
    sliding_window: int = 0  # 0 -> full causal attention
    supports_long_context: bool = False  # may run long_500k

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = ""  # "" -> compute_dtype
    norm_eps: float = 1e-5

    # heads / RL
    num_actions: int = 0  # 0 -> action space == vocab (token actions)
    tie_policy_head: bool = False

    # cnn (paper's arch_nips / arch_nature)
    cnn_spec: Tuple[Tuple[int, int, int], ...] = ()  # (features, kernel, stride)
    cnn_dense: int = 0
    obs_shape: Tuple[int, ...] = ()

    # remat policy for the scanned trunk: "none"|"full"|"dots"
    remat: str = "dots"
    # sequence-shard attention over "model" when heads don't divide the axis
    # ("auto"), or never ("off" — the pre-optimization baseline)
    attn_seq_shard: str = "auto"

    def actions(self) -> int:
        return self.num_actions if self.num_actions > 0 else self.vocab_size

    def expert_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- reduced variant for CPU smoke tests ---------------------------------
    def reduced(self) -> "ArchConfig":
        """Same family, tiny: <=2 layers, d_model<=512, <=4 experts."""
        kw = dict(
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 512),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=min(self.head_dim, 64) if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
        if self.attention == "mla":
            kw.update(
                q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
                kv_lora_rank=min(self.kv_lora_rank, 32),
                qk_nope_dim=min(self.qk_nope_dim, 32),
                qk_rope_dim=min(self.qk_rope_dim, 16),
                v_head_dim=min(self.v_head_dim, 32),
            )
        if self.num_experts:
            kw.update(
                num_experts=min(self.num_experts, 4),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=min(self.expert_ff(), 128),
                first_dense_layers=min(self.first_dense_layers, 1),
                dense_d_ff=min(self.dense_d_ff, 256) if self.dense_d_ff else 0,
            )
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_chunk=32)
        if self.shared_attn_every:
            kw.update(shared_attn_every=2, num_layers=2)
        if self.is_encoder_decoder:
            kw.update(encoder_layers=min(self.encoder_layers, 2), encoder_seq_len=16)
        if self.prefix_len:
            kw.update(prefix_len=8)
        if self.frontend_dim:
            kw.update(frontend_dim=min(self.frontend_dim, 64))
        if self.sliding_window:
            kw.update(sliding_window=64)
        if self.family == "cnn":
            dense = min(self.cnn_dense, 64)
            kw.update(cnn_spec=self.cnn_spec[:2], cnn_dense=dense, d_model=dense)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Pipeline (asynchronous actor/learner) config — repro_torch.pipeline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelineConfig:
    """Knobs for the asynchronous actor/learner pipeline
    (``repro_torch.pipeline``), a copy of ``repro``'s: every field, its
    default and the validation of ``__post_init__``.

    ``num_actors`` actor replicas feed the learner; a single env handed to
    ``PipelinedRL`` is split along the env axis into ``num_actors`` equal
    shards, or a list of envs gives each replica its own. ``queue_depth``
    bounds the shared trajectory ring: the actors collectively run at most
    that many rollouts ahead. ``rho_bar`` and ``c_bar`` are the V-trace
    clips (Espeholt et al. 2018) on the importance ratio
    ρ_t = π_learner(a|s)/π_behaviour(a|s); ``float("inf")`` for both turns
    the correction off exactly (the synchronous PAAC update, bit for bit).
    ``lockstep`` makes the (single) actor wait for the learner's newest
    params before each rollout: synchronous semantics through the
    pipelined code path.

    The port runs the device, host, mesh and replay rollout planes with
    thread or process actors, elastic recovery, fault plans and
    checkpoints; the mesh settings are validated here as in ``repro``
    (``mesh_shape`` lanes, one a device; on the CPU, lanes that share
    it). ``trace_path`` writes a Chrome trace of the
    run's spans, ``metrics_jsonl`` a JSONL heartbeat every
    ``heartbeat_s``, and ``stall_timeout_s`` > 0 arms the stall watchdog.
    """

    queue_depth: int = 2
    rho_bar: float = 1.0
    c_bar: float = 1.0
    num_actors: int = 1
    lockstep: bool = False
    rollout_plane: str = "auto"  # "auto" | "device" | "host" | "mesh"
    actor_backend: str = "thread"  # "thread" | "process"
    mesh_shape: int = 1  # devices on the ("data",) rollout mesh
    # off-policy replay plane (sampled ReplayRing instead of the FIFO ring)
    replay_plane: bool = False
    replay_capacity: int = 64  # resident rollouts before FIFO eviction
    replay_batch: int = 1  # rollouts sampled per learner update
    prioritized: bool = False  # TD-error-weighted sampling (else uniform)
    # observability (repro_torch.telemetry)
    trace_path: str = ""  # "" -> no Chrome trace written at run end
    metrics_jsonl: str = ""  # "" -> no JSONL heartbeat stream
    heartbeat_s: float = 1.0  # heartbeat tick interval
    stall_timeout_s: float = 0.0  # 0 -> stall watchdog off
    # fault tolerance
    elastic: bool = False  # False -> fail-fast
    restart_budget: int = 1  # respawns per actor slot before degrading
    restart_backoff_s: float = 0.05  # base of the exponential respawn backoff
    lease_timeout_s: float = 60.0  # param-slot reserve/publish deadline
    fault_plan: Optional[object] = None  # a FaultPlan, where ported
    checkpoint_dir: str = ""  # "" -> periodic checkpointing off
    checkpoint_every: int = 0  # learner iterations between snapshots (0=off)

    def __post_init__(self):
        if self.mesh_shape < 1:
            raise ValueError(f"mesh_shape must be >= 1, got {self.mesh_shape}")
        if self.heartbeat_s <= 0:
            raise ValueError(
                f"heartbeat_s must be > 0, got {self.heartbeat_s}")
        if self.stall_timeout_s < 0:
            raise ValueError(
                f"stall_timeout_s must be >= 0 (0 = off), got "
                f"{self.stall_timeout_s}")
        if self.mesh_shape > 1:
            if self.actor_backend == "process":
                raise ValueError(
                    "mesh_shape > 1 requires actor_backend='thread': process"
                    " rollouts are born in host shared memory and cannot ride"
                    " the device-resident mesh plane"
                )
            if self.rollout_plane in ("host", "device"):
                raise ValueError(
                    f"mesh_shape={self.mesh_shape} requires rollout_plane="
                    "'auto' or 'mesh': the host TrajectoryQueue cannot carry"
                    " a sharded rollout, and the flat single-device ring"
                    " cannot carry more than one lane"
                )
            if self.num_actors not in (1, self.mesh_shape):
                raise ValueError(
                    "the mesh plane runs exactly one actor lane per mesh"
                    f" device: num_actors must be 1 (auto) or mesh_shape"
                    f"={self.mesh_shape}, got {self.num_actors}"
                )
        if self.actor_backend == "process" and self.rollout_plane in (
                "device", "mesh"):
            raise ValueError(
                "actor_backend='process' forces the host rollout plane"
                " (worker rollouts are born in shared memory); rollout_plane"
                f"={self.rollout_plane!r} is a contradiction"
            )
        if self.replay_capacity < 1:
            raise ValueError(
                f"replay_capacity must be >= 1, got {self.replay_capacity}")
        if self.replay_batch < 1:
            raise ValueError(
                f"replay_batch must be >= 1, got {self.replay_batch}")
        if self.replay_plane:
            if self.actor_backend == "process":
                raise ValueError(
                    "replay_plane requires actor_backend='thread': replay"
                    " payloads are device-resident whole rollouts and cannot"
                    " ride the process backend's shared-memory staging"
                )
            if self.mesh_shape > 1 or self.rollout_plane == "mesh":
                raise ValueError(
                    "replay_plane does not compose with the mesh plane yet:"
                    " a sampled batch would have to draw one sub-rollout per"
                    " lane coherently; use mesh_shape=1"
                )
            if self.rollout_plane == "host":
                raise ValueError(
                    "replay_plane requires the device plane (rollout_plane"
                    " 'auto' or 'device'): the ReplayRing retains sampled"
                    " slots on the accelerator, which the host TrajectoryQueue"
                    " staging buffers cannot do"
                )
        elif self.prioritized:
            raise ValueError(
                "prioritized=True requires replay_plane=True: FIFO rings"
                " consume each rollout exactly once, so sampling priorities"
                " have no meaning there"
            )
        if self.restart_budget < 0:
            raise ValueError(
                f"restart_budget must be >= 0, got {self.restart_budget}")
        if self.restart_backoff_s < 0:
            raise ValueError(
                f"restart_backoff_s must be >= 0, got "
                f"{self.restart_backoff_s}")
        if self.lease_timeout_s <= 0:
            raise ValueError(
                f"lease_timeout_s must be > 0, got {self.lease_timeout_s}")
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0 (0 = off), got "
                f"{self.checkpoint_every}")
        if self.checkpoint_every > 0 and not self.checkpoint_dir:
            raise ValueError(
                "checkpoint_every > 0 requires checkpoint_dir: periodic"
                " snapshots need somewhere to land")
        if self.elastic and (self.mesh_shape > 1
                             or self.rollout_plane == "mesh"):
            raise ValueError(
                "elastic=True does not compose with the mesh plane: a dead"
                " lane leaves every subsequent sharded batch unassemblable,"
                " so the mesh plane stays fail-fast (see"
                " docs/fault_tolerance.md)"
            )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ArchConfig:
    # import side-effect registration
    import repro_torch.configs  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
