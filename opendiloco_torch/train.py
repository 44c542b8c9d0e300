"""Training entry point: one DiLoCo worker's inner loop and outer steps.

The port's ``train()`` (``opendiloco_tpu/train.py`` :68): config ->
model -> dataloader -> trainer -> (DiLoCo optimizer | plain inner loop)
-> train loop with metric rows, activation probes and evaluation. One
process drives one device, the card unless ``device`` names another.

The DiLoCo backend comes from the caller: workers in one process share a
:class:`~opendiloco_torch.diloco.LoopbackWorld`, one thread each::

    world = LoopbackWorld(2)
    for rank, backend in enumerate(world.make_backends()):
        threading.Thread(target=train, args=(config_for(rank), backend)).start()

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP.md
items: the TCP backend (A12), outer compression (A3), checkpoints and
resume (A9), the serving plane and fleet of a training run (A3, A13),
multihost (A10), the profiler window (A15) and non-fake data (A9).

Text log lines carry the worker's rank, per thread (:func:`log_rank`).
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from opendiloco_torch.config import Config, DilocoConfig
from opendiloco_torch.data.dataloader import get_dataloader
from opendiloco_torch.device import DeviceLike
from opendiloco_torch.diloco.backend import OuterBackend
from opendiloco_torch.diloco.optimizer import DiLoCoOptimizer, PeerDropError
from opendiloco_torch.models import hf_io
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from opendiloco_torch.utils.logger import get_logger, get_text_logger, log_rank

log = get_text_logger(__name__)

INIT_SEED = 42  # every worker draws the same initial weights


def make_backend(cfg: DilocoConfig) -> OuterBackend:
    if cfg.backend == "tcp":
        raise NotImplementedError(
            "the TCP outer backend is not ported yet (ROADMAP.md A12); pass a "
            "loopback backend to train()"
        )
    raise ValueError(
        f"backend {cfg.backend!r} has no factory (loopback backends are "
        "constructed from a shared LoopbackWorld in-process)"
    )


def _check_ported(config: Config) -> None:
    unported = [
        (bool(config.ckpt.interval), "checkpointing (ckpt.interval)", "A9"),
        (bool(config.ckpt.resume), "resume (ckpt.resume)", "A9"),
        (config.serve is not None and config.serve.enabled, "the serving plane of a training run", "A3"),
        (config.fleet is not None, "the serving fleet", "A13"),
        (config.multihost, "the multihost inner loop", "A10"),
        (config.profile_dir is not None, "the profiler window (profile_dir)", "A15"),
        (
            config.diloco is not None and config.diloco.compression != "none",
            "outer compression other than 'none' (diloco.compression)",
            "A3",
        ),
        (
            config.sharding_strategy != "NO_SHARD"
            or max(config.dp_size or 1, config.fsdp_size or 1, config.tp_size, config.sp_size,
                   config.pp_size, config.ep_size) > 1,
            "intra-worker sharding (one process drives one device)",
            "A10",
        ),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def train(config: Config, backend: Optional[OuterBackend] = None, device: DeviceLike = None) -> dict:
    """Returns a summary dict (final step and loss) for programmatic
    callers."""
    _check_ported(config)
    world_rank = config.diloco.world_rank if config.diloco else 0
    with log_rank(world_rank):
        return _train(config, backend, device, world_rank)


def _train(config: Config, backend: Optional[OuterBackend], device: DeviceLike, world_rank: int) -> dict:
    model_cfg, params = hf_io.get_model(config.path_model)
    tc = TrainerConfig(
        lr=config.lr,
        weight_decay=config.weight_decay,
        adam_betas=tuple(config.adam_betas),
        warmup_steps=config.warmup_steps,
        total_steps=config.total_steps,
        max_grad_norm=config.max_grad_norm,
        precision=config.precision,
        attn_impl=config.attn_implementation,
        remat=config.remat,
        fused_loss=config.fused_loss,
        scan_unroll=config.scan_unroll,
    )
    trainer = InnerTrainer(model_cfg, tc, device)

    # batch/accumulation accounting (one device: dp = 1, one process)
    global_micro = config.per_device_train_batch_size
    accum = max(1, config.total_batch_size // global_micro)
    if config.total_batch_size % global_micro:
        raise ValueError(
            f"total_batch_size {config.total_batch_size} not divisible by "
            f"per_device_train_batch_size*dp = {global_micro}"
        )
    loader = get_dataloader(
        fake_data=config.fake_data,
        fake_data_mode=config.fake_data_mode,
        dataset_name_or_paths=config.dataset_name_or_paths,
        tokenizer_name=config.tokenizer_name,
        seq_length=config.seq_length,
        batch_size=config.total_batch_size,
        vocab_size=model_cfg.vocab_size,
        world_rank=world_rank,
        galaxy_size=config.diloco.galaxy_size if config.diloco else 1,
        streaming=config.dataset_streaming,
    )

    state = trainer.init_state(INIT_SEED, params)

    diloco_opt: Optional[DiLoCoOptimizer] = None
    owns_backend = False
    if config.diloco is not None:
        if backend is None:
            backend = make_backend(config.diloco)
            owns_backend = True
        diloco_opt = DiLoCoOptimizer(trainer, backend, config.diloco, state,
                                     batch_size=config.total_batch_size)
        log.info("outer data plane: placement=%s (requested %s)", diloco_opt.placement,
                 config.diloco.outer_placement)
        if not config.diloco.skip_load_from_peers:
            updated = diloco_opt.load_state_from_peers(state)
            if updated is not None:
                state = updated
                log.info("loaded state from peers (epoch %d)", diloco_opt.epoch)

    metric_logger = get_logger(config.metric_logger_type, config.project, config.to_dict())

    eval_iter = None
    if config.eval_interval:
        eval_loader = get_dataloader(
            fake_data=config.fake_data,
            fake_data_mode=config.fake_data_mode,
            dataset_name_or_paths=config.dataset_name_or_paths,
            tokenizer_name=config.tokenizer_name,
            seq_length=config.seq_length,
            batch_size=global_micro,
            vocab_size=model_cfg.vocab_size,
            world_rank=world_rank,
            galaxy_size=config.diloco.galaxy_size if config.diloco else 1,
            split="validation",
            streaming=config.dataset_streaming,
        )
        eval_iter = iter(eval_loader)

    tokens_per_step = config.total_batch_size * config.seq_length
    summary = {"step": 0, "loss": float("nan")}
    data_iter = iter(loader)
    pending = None  # (real_step, metrics, dt, extras) of the prior step

    def flush(p) -> None:
        """Materialize a step's metrics row, one step behind, so reading
        the loss does not wait on the step just launched."""
        nonlocal summary
        real_step, metrics, dt, extras = p
        loss = float(metrics["loss"])
        row = {
            "Loss": loss,
            "Perplexity": math.exp(min(loss, 30.0)),
            "step": real_step,
            "lr": trainer.current_lr(real_step),
            "effective_step": real_step * (config.diloco.galaxy_size if config.diloco else 1),
            "total_samples": real_step * config.total_batch_size,
            "time_taken": dt,
            "tokens_per_second": tokens_per_step / dt,
            "grad_norm": float(metrics["grad_norm"]),
        }
        if diloco_opt is not None:
            row["num_peers"] = diloco_opt.max_num_peers
            row["outer_epoch"] = diloco_opt.epoch
            for k in ("outer_step_s", "outer_allreduce_s", "outer_wait_s", "outer_d2h_s", "outer_pseudo_grad_s",
                      "outer_nesterov_s", "outer_h2d_s", "elastic", "expected_peers", "round_retries"):
                if k in metrics:
                    row[k] = metrics[k]
        row.update(extras)
        metric_logger.log(row)
        if real_step % 10 == 0 or real_step == 1:
            log.info("step %d loss %.4f lr %.2e %.0f tok/s", real_step, loss, row["lr"],
                     row["tokens_per_second"])
        summary = {"step": real_step, "loss": loss}

    try:
        for step in range(config.total_steps):
            t0 = time.perf_counter()
            host_batch = next(data_iter)
            batch = trainer.shard_batch(host_batch["input_ids"], host_batch["labels"], accum)
            data_wait_s = time.perf_counter() - t0
            if diloco_opt is not None:
                state, metrics = diloco_opt.step(state, batch)
            else:
                state, metrics = trainer.train_step(state, batch)
            if pending is not None:
                flush(pending)
            real_step = step + 1
            dt = time.perf_counter() - t0
            extras: dict = {"data_wait_s": round(data_wait_s, 6)}
            if config.log_activations_steps and real_step % config.log_activations_steps == 0:
                extras.update(trainer.probe_norms(state["params"], host_batch["input_ids"]))
            if eval_iter is not None and real_step % config.eval_interval == 0:
                losses = []
                for _ in range(config.eval_batches):
                    eb = next(eval_iter)
                    losses.append(trainer.eval_loss(state["params"], eb["input_ids"], eb["labels"]))
                extras["eval_loss"] = float(np.mean(losses))
                extras["eval_perplexity"] = math.exp(min(extras["eval_loss"], 30.0))
                log.info("eval at %d: loss %.4f", real_step, extras["eval_loss"])
            pending = (real_step, metrics, dt, extras)
        if pending is not None:
            flush(pending)
            pending = None
    except PeerDropError:
        log.error("a DiLoCo worker dropped and fail_rank_drop is set; exiting")
        raise
    finally:
        loader.stop()
        metric_logger.finish()
        if owns_backend and backend is not None:
            backend.close()
    return summary
