"""The config_1b inner step with the fused loss and without it, in turns, on
one CUDA card: the question of which ``fused_loss`` default the card
supports.

    python -m opendiloco_torch.inner_step_turns

Builds an :class:`~opendiloco_torch.trainer.InnerTrainer` at config_1b,
full width and depth (micro-batch 8 x accum 2 x seq 1024, bf16-mixed,
remat per layer, fake "ramp" data), once with ``fused_loss`` at its
default (on at 1b) and once with ``fused_loss=False``, in turns (fused,
unfused, unfused, fused), each turn on a trainer of its own: one warm-up
step, then 3 steps timed by the host clock around a sync and by CUDA
events a step. Python's collector is frozen for the turns (a collection
of the oldest generation once held a 1b step up by 171 ms). Prints one
JSON object: per turn the step ms, the card ms by step, the last loss
and the peak device memory.

It calls only what every version of the port since config_1b training has
(``InnerTrainer``, ``FakeTokenizedDataset``, ``load_config``), so two
checkouts can be compared on one card, each run from its own root.
"""
from __future__ import annotations

import gc
import json
import subprocess
import time

import numpy as np

MB, ACCUM, SEQ = 8, 2, 1024


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: n/a"


def main() -> int:
    import torch

    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    if not torch.cuda.is_available():
        raise SystemExit("inner_step_turns needs a CUDA card")
    dev = torch.device("cuda")
    cfg = load_config("1b")
    ds = iter(FakeTokenizedDataset(SEQ, cfg.vocab_size, seed=7, mode="ramp"))
    ids = np.stack([next(ds)["input_ids"] for _ in range(MB * ACCUM)])
    variants = {"fused": {}, "unfused": dict(fused_loss=False)}
    turns = []
    gc.collect()
    gc.freeze()
    try:
        for label in ("fused", "unfused", "unfused", "fused"):
            tr = InnerTrainer(cfg, TrainerConfig(precision="bf16-mixed", remat=True, warmup_steps=2,
                                                 total_steps=100, **variants[label]), device=dev)
            state = tr.init_state(3)
            batch = tr.shard_batch(ids, ids.copy(), accum=ACCUM)
            state, m = tr.train_step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t1 = time.perf_counter()
            ev[0].record()
            for i in range(3):
                state, m = tr.train_step(state, batch)
                ev[i + 1].record()
            loss = float(m["loss"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            turns.append({"variant": label, "fused_loss": tr.tc.fused_loss, "step_ms": (t2 - t1) / 3 * 1e3,
                          "card_ms": [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], "loss": loss,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            del tr, state, batch, m
            torch.cuda.empty_cache()
    finally:
        gc.unfreeze()
    print(json.dumps({"card": card_line(), "torch": torch.__version__, "turns": turns}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
