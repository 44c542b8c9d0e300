"""Training entry point: one DiLoCo worker's inner loop and outer steps.

The port's ``train()`` (``opendiloco_tpu/train.py`` :68): config ->
model -> dataloader -> trainer -> (DiLoCo optimizer | plain inner loop)
-> train loop with metric rows, activation probes, evaluation, a
profiler window and the checkpoint cadence with resume. One process
drives one device, the card unless ``device`` names another.

A worker may be several processes, one device each, cut by
``sharding_strategy`` with ``dp_size``/``fsdp_size``
(:mod:`~opendiloco_torch.parallel`). Launch one process per card with
``torchrun`` (``python -m torch.distributed.run --nproc-per-node 8 -m
opendiloco_torch.train --sharding-strategy FULL_SHARD ...``: the group
comes from ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``),
or with ``--multihost --coordinator-address HOST:PORT --num-processes N
--process-id I`` on each (an address with a scheme, such as
``file:///shared/store``, is passed to ``init_process_group`` as it is).
The group runs over NCCL on the card (``cuda:LOCAL_RANK``) and over gloo
on the CPU. Each process loads its rows of the global batch; only rank
0, the world messenger, holds the DiLoCo backend and writes metric rows
and the checkpoint's shared files.

From the command line, with the JAX package's flags::

    python -m opendiloco_torch.train --path-model 150m --fake-data \\
        --per-device-train-batch-size 8 --total-batch-size 16 \\
        --ckpt.path outputs --ckpt.interval 500 --metric-logger-type jsonl

runs on the card; ``OPENDILOCO_TORCH_DEVICE=cpu`` runs it on the CPU.

With ``diloco.backend="tcp"`` (the default) and no backend handed in, the
worker joins a galaxy over TCP (:func:`make_backend`,
:class:`~opendiloco_torch.diloco.tcp.TcpBackend`) at the rendezvous
daemons of ``diloco.initial_peers``; port and JAX workers share one::

    python -m opendiloco_torch.diloco.rendezvous --port 29400
    python -m opendiloco_torch.train ... --diloco.initial-peers HOST:29400 \
        --diloco.world-rank 1

Workers in one process may instead share a
:class:`~opendiloco_torch.diloco.LoopbackWorld`, one thread each::

    world = LoopbackWorld(2)
    for rank, backend in enumerate(world.make_backends()):
        threading.Thread(target=train, args=(config_for(rank), backend)).start()

With ``serve.enabled`` the worker also serves: ``build_serving`` starts an
engine on the same card, its batcher thread and the HTTP/JSONL front end
on ``serve.host``/``serve.port``, and the engine hot-swaps its weights
from this worker's DiLoCo masters (``max_stale_rounds``). A loopback
world's codec (``LoopbackWorld(n, compression=...)``) carries the outer
all-reduce; ``diloco.compression`` picks the serving snapshots' codec
(``state_codec``, which ``ODTP_STATE_CODEC`` overrides).

The DiLoCo options run as the JAX package runs them: the outer plane on
the host or the device (``outer_placement``), blocking, overlapped and
streaming rounds, error feedback. A round in flight lands before each
checkpoint and at the end of the run (``flush``), and is dropped when the
run fails (``drop_pending``).

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP.md
items: gossip rounds (A12b), the serving fleet (A13),
tp, sp, pp and ep above 1 (A14), a serving plane on a worker of several
processes (A10) and non-fake data (A9).

Text log lines carry the worker's rank, per thread (:func:`log_rank`),
and after it the process's rank when the worker has several.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np

from opendiloco_torch import ckpt as ckpt_lib
from opendiloco_torch.config import Config, DilocoConfig, parse_argv
from opendiloco_torch.data.dataloader import get_dataloader
from opendiloco_torch.device import DeviceLike, pin_cpu_gemm_bits, pin_cpu_threads, resolve_device
from opendiloco_torch.diloco.backend import OuterBackend
from opendiloco_torch.diloco.optimizer import DiLoCoOptimizer, PeerDropError
from opendiloco_torch.models import hf_io
from opendiloco_torch.parallel.mesh import build_mesh
from opendiloco_torch.parallel.world import make_world
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from opendiloco_torch.utils.logger import get_logger, get_text_logger, log_rank

log = get_text_logger(__name__)

INIT_SEED = 42  # every worker draws the same initial weights


def make_backend(cfg: DilocoConfig) -> OuterBackend:
    if cfg.backend == "tcp":
        from opendiloco_torch.diloco.tcp import TcpBackend

        return TcpBackend(
            cfg.initial_peers,
            host=cfg.host if cfg.host != "0.0.0.0" else "127.0.0.1",
            port=cfg.port,
            peer_id=f"worker-{cfg.world_rank}",
            compression=cfg.compression,
            matchmaking_time=cfg.matchmaking_time,
            # config True forces adaptive transport on; False defers to the
            # ODTP_LINK_ADAPT env switch (None = backend reads env per round)
            link_adapt=cfg.link_adapt or None,
        )
    raise ValueError(
        f"backend {cfg.backend!r} has no factory (loopback backends are "
        "constructed from a shared LoopbackWorld in-process)"
    )


def _check_ported(config: Config) -> None:
    unported = [
        (config.fleet is not None, "the serving fleet", "A13"),
        *((getattr(config, f"{axis}_size") > 1, f"{axis}_size > 1", "A14") for axis in ("tp", "sp", "pp", "ep")),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _init_process_group(config: Config, device):
    """Join this worker's process group: the one already initialized, or a
    new one from ``multihost`` and the three fields, or from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``); no group when there is neither.
    Returns (the device this process drives, whether it made the group).
    NCCL on the card, on ``cuda:LOCAL_RANK``; gloo on the CPU."""
    import torch
    import torch.distributed as dist

    env = os.environ
    if dist.is_available() and dist.is_initialized():
        return device, False
    if not (config.multihost or ("RANK" in env and "WORLD_SIZE" in env)):
        return device, False
    world = config.num_processes if config.num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = config.process_id if config.process_id is not None else int(env.get("RANK", 0))
    if config.coordinator_address:
        addr = config.coordinator_address
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif "MASTER_ADDR" in env:
        init_method = "env://"
    else:
        raise ValueError("a multihost worker needs coordinator_address (--coordinator-address host:port) or "
                         "the launcher's MASTER_ADDR and MASTER_PORT")
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method, rank=rank,
                            world_size=world)
    log.info("process %d of %d (%s over %s)", rank, world, device, dist.get_backend())
    return device, True


def train(config: Config, backend: Optional[OuterBackend] = None, device: DeviceLike = None) -> dict:
    """Returns a summary dict for programmatic callers: the final step and
    loss, the seconds each checkpoint save took (``ckpt_save_s``) and, on a
    resume, the seconds the load took (``ckpt_load_s``). Under a process
    group every process of the worker calls it (see the module docstring)."""
    import torch.distributed as dist

    _check_ported(config)
    world_rank = config.diloco.world_rank if config.diloco else 0
    device, owns_group = _init_process_group(config, resolve_device(device))
    try:
        process = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        nproc = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        with log_rank(world_rank if nproc == 1 else f"{world_rank}.{process}"):
            return _train(config, backend, device, world_rank, process, nproc)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(config: Config, backend: Optional[OuterBackend], device, world_rank: int, process: int,
           nproc: int) -> dict:
    if nproc > 1 and config.serve is not None and config.serve.enabled:
        raise NotImplementedError("a serving plane on a worker of several processes is not ported yet "
                                  "(ROADMAP.md A10)")
    model_cfg, params = hf_io.get_model(config.path_model)
    plan = build_mesh(config.sharding_strategy, dp_size=config.dp_size, fsdp_size=config.fsdp_size,
                      tp_size=config.tp_size, sp_size=config.sp_size, pp_size=config.pp_size,
                      ep_size=config.ep_size)
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
    trainer = InnerTrainer(model_cfg, tc, device, plan)

    if config.ckpt.interval:
        ckpt_lib.check_checkpoint_path_access(config.ckpt.path, world_rank)

    # batch/accumulation accounting (train_fsdp.py:189-190)
    global_micro = config.per_device_train_batch_size * plan.data_parallel_size
    accum = max(1, config.total_batch_size // global_micro)
    if config.total_batch_size % global_micro:
        raise ValueError(
            f"total_batch_size {config.total_batch_size} not divisible by "
            f"per_device_train_batch_size*dp = {global_micro}"
        )
    # each process loads its rows of the global batch (the fake stream
    # strides by rank, so a micro-batch holds the same samples at any
    # process count)
    if config.total_batch_size % nproc:
        raise ValueError(
            f"total_batch_size {config.total_batch_size} not divisible by "
            f"process_count {nproc}"
        )
    local_batch_size = config.total_batch_size // nproc
    if local_batch_size % accum:
        raise ValueError(
            f"per-process batch {local_batch_size} not divisible by the "
            f"accumulation factor {accum} (= total_batch_size / "
            f"(per_device_train_batch_size * dp)); adjust batch sizes"
        )
    if config.eval_interval and (global_micro % nproc):
        raise ValueError(
            f"eval batch per_device_train_batch_size*dp = {global_micro} "
            f"not divisible by process_count {nproc}"
        )
    loader = get_dataloader(
        fake_data=config.fake_data,
        fake_data_mode=config.fake_data_mode,
        dataset_name_or_paths=config.dataset_name_or_paths,
        tokenizer_name=config.tokenizer_name,
        seq_length=config.seq_length,
        batch_size=local_batch_size,
        vocab_size=model_cfg.vocab_size,
        world_rank=world_rank,
        galaxy_size=config.diloco.galaxy_size if config.diloco else 1,
        streaming=config.dataset_streaming,
    )

    state = trainer.init_state(INIT_SEED, params)

    diloco_opt: Optional[DiLoCoOptimizer] = None
    owns_backend = False
    if config.diloco is not None:
        # the world-messenger split (train_fsdp.py:183, 205-212): only rank
        # 0 joins the outer fabric; the other ranks meet it at collectives
        world = make_world(trainer.device)
        if backend is None and world.is_messenger:
            backend = make_backend(config.diloco)
            owns_backend = True
        diloco_opt = DiLoCoOptimizer(trainer, backend, config.diloco, state,
                                     batch_size=config.total_batch_size, world=world)
        log.info("outer data plane: placement=%s (requested %s)", diloco_opt.placement,
                 config.diloco.outer_placement)

    # resume from a checkpoint; only a worker that resumes none adopts its
    # peers' state
    start_step = 0
    ckpt_times: dict = {"ckpt_save_s": []}
    resume, resume_dir, resume_step = ckpt_lib.get_resume_info(
        config.ckpt.resume, config.ckpt.path, diloco_rank=world_rank if config.diloco else None
    )
    if resume:
        log.info("resuming from %s (step %d)", resume_dir, resume_step)
        t_load = time.perf_counter()
        # the checkpoint holds whole leaves: load them, then keep this rank's blocks
        full, diloco_state, loader_state, _ = ckpt_lib.load_checkpoint(resume_dir, trainer.gather_state(state))
        state = trainer.scatter_state(full)
        del full
        if diloco_opt is not None and diloco_state is not None:
            diloco_opt.load_state_dict(diloco_state)
        if loader_state is not None:
            loader.load_state_dict(loader_state)
        ckpt_times["ckpt_load_s"] = time.perf_counter() - t_load
        start_step = resume_step
    elif diloco_opt is not None and not config.diloco.skip_load_from_peers:
        updated = diloco_opt.load_state_from_peers(state)
        if updated is not None:
            state = updated
            log.info("loaded state from peers (epoch %d)", diloco_opt.epoch)

    # metric rows from the messenger alone
    metric_logger = get_logger(config.metric_logger_type if process == 0 else "dummy", config.project,
                               config.to_dict(), resume=bool(resume))

    eval_iter = None
    if config.eval_interval:
        eval_loader = get_dataloader(
            fake_data=config.fake_data,
            fake_data_mode=config.fake_data_mode,
            dataset_name_or_paths=config.dataset_name_or_paths,
            tokenizer_name=config.tokenizer_name,
            seq_length=config.seq_length,
            batch_size=global_micro // nproc,
            vocab_size=model_cfg.vocab_size,
            world_rank=world_rank,
            galaxy_size=config.diloco.galaxy_size if config.diloco else 1,
            split="validation",
            streaming=config.dataset_streaming,
        )
        eval_iter = iter(eval_loader)

    # the in-process serving plane: engine, batcher and front end share this
    # process and card with the inner loop, and hot-swap from the masters
    serving = None
    if config.serve is not None and config.serve.enabled:
        from opendiloco_torch.serve import build_serving

        serving = build_serving(config.serve, model_cfg, state["params"], diloco_opt,
                                compute_dtype=tc.compute_dtype, device=trainer.device)
        log.info("serving plane up on %s:%d (%d slots, ctx %d)", config.serve.host, serving.port,
                 config.serve.max_batch, config.serve.max_context)

    tokens_per_step = config.total_batch_size * config.seq_length
    trace_rank = world_rank if nproc == 1 else f"{world_rank}.{process}"
    summary = {"step": start_step, "loss": float("nan")}
    data_iter = iter(loader)
    pending = None  # (real_step, metrics, dt, extras) of the prior step
    profiler = None

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
        for step in range(start_step, config.total_steps):
            if config.profile_dir and step == start_step + config.profile_start:
                profiler = _start_profiler(trainer.device)
            if profiler is not None and step == start_step + config.profile_start + config.profile_steps:
                _stop_profiler(profiler, config.profile_dir, trace_rank, step)
                profiler = None
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

            if config.ckpt.interval and real_step % config.ckpt.interval == 0:
                flush(pending)
                pending = None
                if diloco_opt is not None:
                    # the saved master holds every launched outer round
                    state = diloco_opt.flush(state)
                t_save = time.perf_counter()
                ckpt_lib.save_checkpoint(
                    config.ckpt.path,
                    real_step,
                    trainer.gather_state(state),
                    diloco_rank=world_rank if config.diloco else None,
                    diloco_state=diloco_opt.state_dict() if diloco_opt else None,
                    dataloader_state=loader.state_dict(),
                    extra={"loss": summary["loss"], "step": real_step},
                )
                ckpt_times["ckpt_save_s"].append(time.perf_counter() - t_save)
                if process == 0:
                    ckpt_lib.delete_old_checkpoints(config.ckpt.path, config.ckpt.topk)
        if pending is not None:
            flush(pending)
            pending = None
        if diloco_opt is not None:
            state = diloco_opt.flush(state)
    except PeerDropError:
        log.error("a DiLoCo worker dropped and fail_rank_drop is set; exiting")
        raise
    finally:
        if serving is not None:
            # before the backend goes away: the batcher may be mid-swap,
            # pulling a master snapshot through diloco_opt
            serving.stop()
        if diloco_opt is not None:
            # a failed run leaves no outer round holding the backend
            diloco_opt.drop_pending()
        if profiler is not None:
            # a window that reaches past total_steps still writes its trace;
            # a failure to write it must not hide the real error
            try:
                _stop_profiler(profiler, config.profile_dir, trace_rank, config.total_steps)
            except Exception:
                log.exception("failed to write the profiler trace")
        loader.stop()
        metric_logger.finish()
        if owns_backend and backend is not None:
            backend.close()
    return {**summary, **ckpt_times}


def _start_profiler(device):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities, record_shapes=False)
    profiler.__enter__()
    return profiler


def _stop_profiler(profiler, profile_dir: str, rank, step: int) -> None:
    """End the window and write its Chrome trace under ``profile_dir``."""
    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_rank{rank}_step{step}.json")
    profiler.export_chrome_trace(path)
    log.info("wrote profiler trace to %s", path)


def main() -> None:
    """``python -m opendiloco_torch.train --flag value ...``: the JAX
    package's flags (:func:`~opendiloco_torch.config.parse_argv`). Runs on
    the card, or on the device ``OPENDILOCO_TORCH_DEVICE`` names (``cpu``);
    with neither it raises. CPU runs repeat bit for bit whatever thread
    settings the environment gives: they run on one thread, with MKL in its
    strict reproducible mode (:func:`~opendiloco_torch.device.pin_cpu_threads`,
    :func:`~opendiloco_torch.device.pin_cpu_gemm_bits`)."""
    pin_cpu_gemm_bits()
    try:
        device = resolve_device(os.environ.get("OPENDILOCO_TORCH_DEVICE") or None)
    except RuntimeError as e:
        raise SystemExit(f"{e} (from the command line: OPENDILOCO_TORCH_DEVICE=cpu)") from None
    pin_cpu_threads(device)
    config = Config(**parse_argv())
    log.info("starting training on %s: %s", device, config.to_dict())
    train(config, device=device)


if __name__ == "__main__":
    main()
