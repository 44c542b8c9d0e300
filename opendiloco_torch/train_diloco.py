"""Normative DiLoCo driver: the algorithm with no backend machinery.

The port's counterpart of ``opendiloco_tpu/train_diloco.py`` (the
reference's ``train_diloco_torch.py``, the convergence oracle): N
simulated workers in one process, each an ``InnerTrainer`` (``NO_SHARD``,
inner AdamW, no gradient accumulation); every ``--local-steps`` their
pseudo-gradients are averaged exactly with numpy and an outer Nesterov
step updates the masters, on the host (``OuterSGD``) or on the device
(``DeviceOuterPlane``), after which every worker's params are reset to
the master. The eval loop is ``evaluate_model`` (the reference's), and it
draws from worker 0's training iterator, as the JAX driver does.

    python -m opendiloco_torch.train_diloco --path-model 2m --fake-data \\
        --num-workers 4 --local-steps 50 --total-steps 500 --eval-interval 100

runs on the card; ``OPENDILOCO_TORCH_DEVICE=cpu`` runs it on the CPU.
``--outer-placement auto`` resolves as ``train()``'s does (host). Without
``--fake-data`` it raises, as ``train()`` does (ROADMAP.md A9). The fake
stream is the JAX driver's uniform tokens unless ``--fake-data-mode
ramp`` (a flag of the port's) asks for learnable ramps, on which a short
run's loss falls. :func:`run` returns the trajectory for callers that
read it.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.data.dataloader import get_dataloader
from opendiloco_torch.device import DeviceLike, pin_cpu_gemm_bits, pin_cpu_threads, resolve_device
from opendiloco_torch.diloco.optimizer import resolve_outer_placement
from opendiloco_torch.diloco.outer_device import DeviceOuterPlane
from opendiloco_torch.diloco.outer_optimizer import OuterSGD
from opendiloco_torch.models import hf_io
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.parallel.mesh import build_mesh
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)


def evaluate_model(trainer: InnerTrainer, params, loader_iter, num_batches: int) -> float:
    """Mean eval loss over ``num_batches`` batches of ``loader_iter``."""
    losses = []
    for _ in range(num_batches):
        batch = next(loader_iter)
        losses.append(trainer.eval_loss(params, batch["input_ids"], batch["labels"]))
    return float(np.mean(losses))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--path-model", default="150m")
    ap.add_argument("--fake-data", action="store_true")
    ap.add_argument("--fake-data-mode", choices=["random", "ramp"], default="random",
                    help="the fake stream: uniform tokens (the JAX driver's) or learnable ramps")
    ap.add_argument("--dataset", default="allenai/c4")
    ap.add_argument("--tokenizer", default="mistralai/Mistral-7B-v0.1")
    ap.add_argument("--num-workers", type=int, default=2, help="simulated DiLoCo workers")
    ap.add_argument("--local-steps", type=int, default=50)
    ap.add_argument("--total-steps", type=int, default=500)
    ap.add_argument("--warmup-steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=64, help="per-worker batch")
    ap.add_argument("--seq-length", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--outer-momentum", type=float, default=0.9)
    ap.add_argument(
        "--outer-placement",
        choices=["auto", "host", "device"],
        default="auto",
        help="where the master and outer momentum live: host numpy (the reference's semantics) or the "
        "trainer's device (auto = host, as train() resolves it)",
    )
    ap.add_argument("--precision", default="bf16-mixed")
    ap.add_argument("--eval-interval", type=int, default=0)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    return ap


def run(args: argparse.Namespace, device: DeviceLike = None) -> dict:
    """The driver's loop on ``device`` (default: the card). Returns
    ``losses`` (each step's mean over the workers), ``eval_losses``
    ({step: loss}), ``placement`` and ``master`` (the final master leaves,
    f32 host arrays in ``flatten_params`` order)."""
    device = resolve_device(device)
    model_cfg, params = hf_io.get_model(args.path_model)
    tc = TrainerConfig(lr=args.lr, warmup_steps=args.warmup_steps, total_steps=args.total_steps,
                       precision=args.precision)
    trainer = InnerTrainer(model_cfg, tc, device, build_mesh("NO_SHARD"))
    n = args.num_workers

    # every worker starts from the same weights (the reference's rank-0
    # broadcast): the directory's, or the same draws from one seed
    states = [trainer.init_state(args.seed, params) for _ in range(n)]
    loaders = [
        get_dataloader(
            fake_data=args.fake_data,
            fake_data_mode=args.fake_data_mode,
            dataset_name_or_paths=args.dataset,
            tokenizer_name=args.tokenizer,
            seq_length=args.seq_length,
            batch_size=args.batch_size,
            vocab_size=model_cfg.vocab_size,
            world_rank=r,
            galaxy_size=n,
            seed=args.seed,
        )
        for r in range(n)
    ]
    iters = [iter(loader) for loader in loaders]
    eval_iter = iters[0]  # the reference evaluates on worker 0's training stream

    placement = resolve_outer_placement(DilocoConfig(outer_placement=args.outer_placement))
    log.info("outer data plane: placement=%s", placement)
    plane: Optional[DeviceOuterPlane] = None
    master: list[np.ndarray] = []
    outer = OuterSGD(args.outer_lr, args.outer_momentum, nesterov=True)
    if placement == "device":
        plane = DeviceOuterPlane(flatten_params(states[0]["params"]), lr=args.outer_lr,
                                 momentum=args.outer_momentum, nesterov=True)
    else:
        master = trainer.host_params(flatten_params(states[0]["params"]))

    mean_losses: list[float] = []
    eval_losses: dict[int, float] = {}
    try:
        for step in range(1, args.total_steps + 1):
            t0 = time.perf_counter()
            losses = []
            for r in range(n):
                batch = next(iters[r])
                dev = trainer.shard_batch(batch["input_ids"], batch["labels"], accum=1)
                states[r], m = trainer.train_step(states[r], dev)
                losses.append(float(m["loss"]))
            if step % args.local_steps == 0:
                # pseudo-gradient = master - worker params, averaged exactly
                # over the workers, then one outer step on the master
                grads = None
                for r in range(n):
                    leaves = flatten_params(states[r]["params"])
                    if plane is not None:
                        g, _, _ = plane.pseudo_grad(leaves)
                    else:
                        g = [m_ - f for m_, f in zip(master, trainer.host_params(leaves))]
                    grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                grads = [g / n for g in grads]
                if plane is not None:
                    plane.apply_average(grads)
                    for r in range(n):
                        plane.sync_params(flatten_params(states[r]["params"]))
                else:
                    outer.step(master, grads)
                    with torch.no_grad():
                        for r in range(n):
                            for p, m_ in zip(flatten_params(states[r]["params"]), master):
                                p.copy_(torch.from_numpy(m_))
                log.info("outer step at %d (epoch %d)", step, step // args.local_steps)
            mean_losses.append(float(np.mean(losses)))
            if step % 10 == 0 or step == 1:
                log.info("step %d loss %.4f ppl %.1f (%.2fs)", step, mean_losses[-1],
                         math.exp(min(mean_losses[-1], 30)), time.perf_counter() - t0)
            if args.eval_interval and step % args.eval_interval == 0:
                eval_losses[step] = evaluate_model(trainer, states[0]["params"], eval_iter, args.eval_batches)
                log.info("eval at %d: loss %.4f ppl %.1f", step, eval_losses[step],
                         math.exp(eval_losses[step]))
    finally:
        for loader in loaders:
            loader.stop()
    final = plane.host_masters() if plane is not None else [np.array(m_) for m_ in master]
    return {"losses": mean_losses, "eval_losses": eval_losses, "placement": placement, "master": final}


def main(argv=None) -> None:
    """``python -m opendiloco_torch.train_diloco --flag value ...``: on the
    card, or on the device ``OPENDILOCO_TORCH_DEVICE`` names (``cpu``;
    there on one thread, MKL in its strict reproducible mode, as the
    training CLI runs)."""
    pin_cpu_gemm_bits()
    try:
        device = resolve_device(os.environ.get("OPENDILOCO_TORCH_DEVICE") or None)
    except RuntimeError as e:
        raise SystemExit(f"{e} (from the command line: OPENDILOCO_TORCH_DEVICE=cpu)") from None
    pin_cpu_threads(device)
    run(build_parser().parse_args(argv), device)


if __name__ == "__main__":
    main()
