"""Configuration: the fields of ``opendiloco_tpu.config`` this port reads.

Copies of ``CkptConfig``, ``DilocoConfig``, ``Config`` and of
``ServeConfig`` without its KV-tier and decode-kernel fields (same
names, defaults and validation), as dataclasses so the port needs no
pydantic. Nested sections may be given as dicts, and values as the
strings of a command line (:func:`parse_argv`, the JAX package's copy),
which each field converts to its type. The KV tier's fields arrive with
its slice; options that ``train()`` reads but the port does not run yet
raise there.
"""
from __future__ import annotations

import dataclasses
import sys
import typing
from typing import Any, Optional, Union

WEIGHT_FORMATS = ("fp32", "w4")
KV_TIER_CODECS = ("none", "blockwise4bit")  # ServeConfig.kv_tier_codec


_TRUE = ("true", "1", "yes", "on", "t", "y")
_FALSE = ("false", "0", "no", "off", "f", "n")


def _to_bool(name: str, value: str) -> bool:
    if value.lower() in _TRUE:
        return True
    if value.lower() in _FALSE:
        return False
    raise ValueError(f"{name} must be a boolean, got {value!r}")


def _coerce_strings(obj) -> None:
    """Convert string values (as :func:`parse_argv` gives every flag's
    value) to the declared type of their field: bool, int, float, or the
    optional form of one of them. A field whose type admits ``str`` keeps
    its string, as the JAX package's pydantic config does."""
    hints = typing.get_type_hints(type(obj))
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if not isinstance(value, str):
            continue
        kinds = [a for a in typing.get_args(hints[f.name]) if a is not type(None)] or [hints[f.name]]
        if str in kinds or len(kinds) != 1 or kinds[0] not in (bool, int, float):
            continue
        kind = kinds[0]
        setattr(obj, f.name, _to_bool(f.name, value) if kind is bool else kind(value))


def _one_of(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


@dataclasses.dataclass
class ServeConfig:
    enabled: bool = False  # the in-process serving plane of a training run
    host: str = "127.0.0.1"
    port: int = 0  # 0: an ephemeral port; a port in use falls back to one
    # continuous-batching geometry
    max_batch: int = 8  # decode slots (concurrent sequences)
    max_context: int = 1024  # per-slot ring KV page; longer sequences slide
    # prefill buckets (prompts pad up to the smallest fit; prompts beyond
    # the largest bucket are rejected, not truncated)
    prefill_buckets: Union[list, str] = dataclasses.field(
        default_factory=lambda: [64, 256, 1024]
    )
    max_queue: int = 1024  # backpressure: submits beyond this are rejected
    # weight hot swap: check every N decode steps (and when idle); swap when
    # the served weights lag the trainer's masters by MORE than
    # max_stale_rounds outer rounds (0: adopt every new round)
    swap_every_steps: int = 16
    max_stale_rounds: int = 0
    # replica weight residency: "fp32", or "w4" (stacked matmul weights
    # blockwise-4-bit packed at rest; norms/embeddings/lm head stay fp32)
    weight_format: str = "fp32"
    # self-speculative decode: draft k tokens per slot per round from the
    # first draft_layers of the same weights, verify at full depth, keep the
    # longest agreeing greedy prefix (token-exact against the one-token
    # loop); 0 disables
    spec_decode_k: int = 0
    # draft depth; 0 = half the stack (at least 1); must stay < num layers
    draft_layers: int = 0
    # shared-prefix KV reuse: copy a live slot's prompt-prefix K/V into a
    # joining slot and prefill only the suffix
    prefix_cache: bool = False
    # host-memory cold KV tier: evicted slot pages wait in host memory
    # between decode steps, so the batcher time-slices more live sequences
    # than the ring holds; off keeps every sequence resident
    kv_tier: bool = False
    # the tier's codec: "none" stores f32 (evict and restore are exact),
    # "blockwise4bit" about 8x fewer bytes with a bounded restore error
    kv_tier_codec: str = "none"
    # the tier's budget: paused pages and prefix entries it holds at once
    kv_host_slots: int = 32

    def __post_init__(self):
        _coerce_strings(self)
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
        if self.spec_decode_k < 0:
            raise ValueError("serve.spec_decode_k must be >= 0")
        if self.draft_layers < 0:
            raise ValueError("serve.draft_layers must be >= 0")
        if self.spec_decode_k + 1 > self.max_context:
            raise ValueError(
                "serve.spec_decode_k + 1 exceeds serve.max_context "
                "(a speculative tail must fit the ring)"
            )
        _one_of("serve.kv_tier_codec", self.kv_tier_codec, KV_TIER_CODECS)
        if self.kv_host_slots < 1:
            raise ValueError("serve.kv_host_slots must be >= 1")


@dataclasses.dataclass
class CkptConfig:
    """Checkpoint cadence and paths."""

    path: str = "outputs"
    interval: Optional[int] = None
    topk: Optional[int] = None
    # True: the latest checkpoint under ``path``; str: a checkpoint
    # directory; None or False: a fresh start
    resume: Optional[Union[str, bool]] = None

    def __post_init__(self):
        _coerce_strings(self)
        # ``--no-ckpt.interval`` parses to False: disabled
        if self.interval is False:
            self.interval = None
        if self.topk is False:
            self.topk = None


COMPRESSIONS = (
    "none", "fp16", "scaled-fp16", "uniform8bit", "quantile8bit",
    "blockwise8bit", "blockwise4bit", "topk",
)


@dataclasses.dataclass
class DilocoConfig:
    """Outer-loop (DiLoCo) configuration: the JAX package's fields and
    defaults. ``backend="tcp"`` (the default) joins a galaxy over TCP at
    the rendezvous daemons of ``initial_peers`` (``train.make_backend``);
    gossip rounds raise where they are read (``diloco/optimizer.py``)."""

    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    outer_nesterov: bool = True
    local_steps: int = 500

    # peer bootstrap / identity: rendezvous daemons as "host:port" (a
    # comma-separated string is split), this worker's bind address
    initial_peers: list[str] = dataclasses.field(default_factory=list)
    host: str = "0.0.0.0"
    port: int = 0  # 0 -> ephemeral
    world_rank: int = 0
    galaxy_size: int = 1

    # straggler / failure policy
    all_reduce_strategy: str = "wait_for_all"
    timeout_waiting_for_peers: float = 600.0
    averaging_timeout: float = 300.0
    # matchmaking window of an outer round; the rendezvous closes it early
    # once every live peer (or ODTP_EXPECT_PEERS of them) has joined
    matchmaking_time: float = 60.0
    fail_rank_drop: bool = False

    compression: str = "none"
    error_feedback: bool = False
    skip_load_from_peers: bool = False
    backend: str = "tcp"
    average_state_every: int = 0
    outer_mode: str = "allreduce"
    overlap_comm: str = "none"
    streaming_fragments: int = 0
    # streaming x overlap: fragment k launches after inner step
    # min(H, int(k * stagger * H / N) + 1); 1.0 spreads the launches over
    # the phase, smaller values front-load them
    stream_stagger: float = 1.0
    outer_placement: str = "auto"
    # adaptive outer transport (diloco/linkstate.py): True forces it on,
    # False defers to the ODTP_LINK_ADAPT switch
    link_adapt: bool = False

    def __post_init__(self):
        _coerce_strings(self)
        if isinstance(self.initial_peers, str):
            self.initial_peers = [x.strip() for x in self.initial_peers.split(",") if x.strip()]
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
        if not 0.0 < self.stream_stagger <= 1.0:
            raise ValueError(f"stream_stagger must be in (0, 1], got {self.stream_stagger}")
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
    is kept for the same reason; in eager PyTorch, where the layers are a
    Python loop, it only decides ``fused_loss``'s default (see
    ``trainer._resolve_perf_defaults``)."""

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
    # torch.profiler trace of steps [profile_start, profile_start +
    # profile_steps), counted from the first step this run takes
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 5

    # a worker of several processes, one device each (torch.distributed):
    # the group from these fields, or, where one is None, from the
    # launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR/MASTER_PORT);
    # coordinator "host:port", or an init_method URL such as file://...
    multihost: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    ckpt: Any = dataclasses.field(default_factory=CkptConfig)
    diloco: Any = None  # None -> plain data-parallel mode
    serve: Any = None
    fleet: Any = None

    def __post_init__(self):
        _coerce_strings(self)
        if isinstance(self.adam_betas, str):
            self.adam_betas = tuple(float(x) for x in self.adam_betas.split(","))
        self.adam_betas = tuple(self.adam_betas)
        if isinstance(self.remat, str) and self.remat.lower() in _TRUE + _FALSE:
            self.remat = _to_bool("remat", self.remat)
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


# ---------------------------------------------------------------------------
# argv parsing: nested dotted flags + --no-x booleans
# ---------------------------------------------------------------------------


def _set_nested(tree: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"flag {dotted!r} conflicts with earlier scalar flag")
    leaf = keys[-1]
    node[leaf] = value  # repeated flags: last one wins


def parse_argv(argv: Optional[list[str]] = None) -> dict:
    """Parse ``--a.b value`` / ``--no-a.b`` style flags into a nested dict,
    as the JAX package's ``parse_argv``: dashes in key names become
    underscores, ``--no-flag`` sets False, a bare ``--flag`` followed by
    another flag (or the end) sets True, a repeated flag keeps its last
    value, and values stay strings (``Config`` converts them)."""
    if argv is None:
        argv = sys.argv[1:]
    tree: dict = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected positional argument {tok!r}")
        key = tok[2:]
        value: Any
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        elif key.startswith("no-") or key.startswith("no_"):
            key, value = key[3:], False
            i += 1
        elif i + 1 >= len(argv) or argv[i + 1].startswith("--"):
            value = True
            i += 1
        else:
            value = argv[i + 1]
            i += 2
        key = ".".join(part.replace("-", "_") for part in key.split("."))
        _set_nested(tree, key, value)
    return tree
