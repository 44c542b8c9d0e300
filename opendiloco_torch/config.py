"""Configuration: the fields of ``opendiloco_tpu.config`` this port reads.

Copies of ``CkptConfig``, ``DilocoConfig``, ``Config`` and the geometry
part of ``ServeConfig`` (same names, defaults and validation), as
dataclasses so the port needs no pydantic. Nested sections may be given
as dicts. Fields for hot swap, speculative decode, prefix reuse, the KV
tier and the HTTP front end arrive with the slices that use them; options
that ``train()`` reads but the port does not run yet raise there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

WEIGHT_FORMATS = ("fp32", "w4")


def _one_of(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


@dataclasses.dataclass
class ServeConfig:
    enabled: bool = False  # the in-process serving plane of a training run
    # continuous-batching geometry
    max_batch: int = 8  # decode slots (concurrent sequences)
    max_context: int = 1024  # per-slot ring KV page; longer sequences slide
    # prefill buckets (prompts pad up to the smallest fit; prompts beyond
    # the largest bucket are rejected, not truncated)
    prefill_buckets: Union[list, str] = dataclasses.field(
        default_factory=lambda: [64, 256, 1024]
    )
    max_queue: int = 1024  # backpressure: submits beyond this are rejected
    # replica weight residency: "fp32", or "w4" (stacked matmul weights
    # blockwise-4-bit packed at rest; norms/embeddings/lm head stay fp32)
    weight_format: str = "fp32"

    def __post_init__(self):
        if isinstance(self.prefill_buckets, str):
            self.prefill_buckets = [
                int(x) for x in self.prefill_buckets.split(",") if x.strip()
            ]
        self.prefill_buckets = [int(b) for b in self.prefill_buckets]
        if self.weight_format not in WEIGHT_FORMATS:
            raise ValueError(
                f"serve.weight_format must be one of {WEIGHT_FORMATS}, "
                f"got {self.weight_format!r}"
            )
        if self.max_batch < 1:
            raise ValueError("serve.max_batch must be >= 1")
        if not self.prefill_buckets:
            raise ValueError("serve.prefill_buckets must be non-empty")
        if min(self.prefill_buckets) < 1:
            raise ValueError("serve.prefill_buckets must be positive")
        if max(self.prefill_buckets) > self.max_context:
            raise ValueError(
                "largest prefill bucket exceeds serve.max_context "
                "(a prompt must fit its slot's KV page)"
            )


@dataclasses.dataclass
class CkptConfig:
    """Checkpoint cadence and paths."""

    interval: Optional[int] = None
    # True: the latest checkpoint; str: a directory; None or False: a
    # fresh start
    resume: Optional[Union[str, bool]] = None

    def __post_init__(self):
        if self.interval is False:
            self.interval = None


COMPRESSIONS = (
    "none", "fp16", "scaled-fp16", "uniform8bit", "quantile8bit",
    "blockwise8bit", "blockwise4bit", "topk",
)


@dataclasses.dataclass
class DilocoConfig:
    """Outer-loop (DiLoCo) configuration: the JAX package's fields and
    defaults. The port runs the host-placement blocking path over an
    in-process loopback backend; the other options raise where they are
    read (``diloco/optimizer.py``, ``train.py``)."""

    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    outer_nesterov: bool = True
    local_steps: int = 500

    # identity
    world_rank: int = 0
    galaxy_size: int = 1

    # straggler / failure policy
    all_reduce_strategy: str = "wait_for_all"
    timeout_waiting_for_peers: float = 600.0
    averaging_timeout: float = 300.0
    fail_rank_drop: bool = False

    compression: str = "none"
    error_feedback: bool = False
    skip_load_from_peers: bool = False
    backend: str = "tcp"
    average_state_every: int = 0
    outer_mode: str = "allreduce"
    overlap_comm: str = "none"
    streaming_fragments: int = 0
    outer_placement: str = "auto"

    def __post_init__(self):
        _one_of("diloco.all_reduce_strategy", self.all_reduce_strategy, ("wait_for_all", "no_wait"))
        _one_of("diloco.compression", self.compression, COMPRESSIONS)
        _one_of("diloco.backend", self.backend, ("loopback", "tcp"))
        _one_of("diloco.outer_mode", self.outer_mode, ("allreduce", "gossip"))
        _one_of("diloco.overlap_comm", self.overlap_comm, ("none", "delayed", "eager"))
        _one_of("diloco.outer_placement", self.outer_placement, ("auto", "host", "device"))
        if self.streaming_fragments > 1 and self.average_state_every:
            raise ValueError(
                "streaming_fragments makes average_state_every unnecessary AND "
                "destructive (see the JAX package's DilocoConfig)"
            )
        if self.error_feedback and self.compression == "none":
            raise ValueError(
                "error_feedback carries the codec's encode/decode residual; "
                "with compression='none' there is none -- pick a lossy codec"
            )


def _section(cls, value):
    return cls(**value) if isinstance(value, dict) else value


@dataclasses.dataclass
class Config:
    """Top-level training config: the fields ``train()`` reads.

    ``attn_implementation`` keeps the JAX names so a config carries over:
    "auto" resolves to the hand-written kernels on the card and the plain
    attention on the CPU, "pallas" means the hand-written kernels (their
    plain versions on the CPU), "xla" the plain attention. ``scan_unroll``
    is kept for the same reason and has no effect in eager PyTorch, where
    the layers are a Python loop."""

    # model
    attn_implementation: str = "auto"
    path_model: str = "configs/config_150m.json"
    remat: Union[bool, str] = True
    fused_loss: Optional[bool] = None
    scan_unroll: Optional[int] = None

    # data
    dataset_name_or_paths: str = "allenai/c4"
    dataset_streaming: bool = True
    fake_data: bool = False
    fake_data_mode: str = "random"
    tokenizer_name: str = "mistralai/Mistral-7B-v0.1"
    seq_length: int = 1024

    # optimization
    lr: float = 4e-4
    weight_decay: float = 0.1
    adam_betas: Union[tuple, str] = (0.9, 0.95)
    warmup_steps: int = 1000
    total_steps: int = 88_000
    max_grad_norm: float = 1.0
    per_device_train_batch_size: int = 32
    total_batch_size: int = 512
    precision: str = "bf16-mixed"

    # in-worker parallelism
    sharding_strategy: str = "NO_SHARD"
    dp_size: Optional[int] = None
    fsdp_size: Optional[int] = None
    tp_size: int = 1
    sp_size: int = 1
    pp_size: int = 1
    ep_size: int = 1

    # observability
    project: str = "opendiloco_torch"
    metric_logger_type: str = "wandb"
    log_activations_steps: Optional[int] = None
    eval_interval: Optional[int] = None
    eval_batches: int = 16
    profile_dir: Optional[str] = None

    # multi-host inner loop
    multihost: bool = False

    ckpt: Any = dataclasses.field(default_factory=CkptConfig)
    diloco: Any = None  # None -> plain data-parallel mode
    serve: Any = None
    fleet: Any = None

    def __post_init__(self):
        if isinstance(self.adam_betas, str):
            self.adam_betas = tuple(float(x) for x in self.adam_betas.split(","))
        self.adam_betas = tuple(self.adam_betas)
        self.ckpt = _section(CkptConfig, self.ckpt)
        self.diloco = _section(DilocoConfig, self.diloco)
        self.serve = _section(ServeConfig, self.serve)
        _one_of("attn_implementation", self.attn_implementation, ("auto", "xla", "pallas", "ring"))
        _one_of("precision", self.precision, ("bf16-mixed", "fp16-mixed", "fp32"))
        _one_of("metric_logger_type", self.metric_logger_type, ("wandb", "dummy", "jsonl"))
        _one_of("fake_data_mode", self.fake_data_mode, ("random", "ramp"))
        _one_of(
            "sharding_strategy", self.sharding_strategy,
            ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD", "HYBRID_SHARD", "HYBRID_SHARD_ZERO2"),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
