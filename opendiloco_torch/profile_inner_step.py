"""Where one inner step's time goes on the card: a ``torch.profiler`` trace.

Builds an :class:`~opendiloco_torch.trainer.InnerTrainer` at the training
shape of ``chip_smoke.py`` (``--config`` 150m or 1b at full width and
depth, micro-batch 8 x accum 2 x seq 1024, bf16-mixed, remat per layer,
the TrainerConfig defaults for the card: the hand-written flash-attention
kernels, and at 1b the fused cross-entropy kernels; fake "ramp" data),
times ``--steps`` inner steps
untraced, then traces as many with CPU and CUDA activities. Every device
event of the trace (kernels, copies, fills) goes into one group by its
name. Prints one JSON object as its last line: per inner step, the untraced
and traced wall ms, the device's busy ms (the union of its event
intervals) and idle share, each group's ms, share, event count and
longest kernels by function name, and the longest kernels overall; ``--out`` also keeps the Chrome trace::

    python -m opendiloco_torch.profile_inner_step [--config 1b] [--steps 3] [--out DIR]

Needs a CUDA card: a trace without device events raises.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np

# (group, pattern over the lower-cased kernel name); the first match wins
GROUPS = (
    ("fused cross-entropy (B3, B4a, B4b, dlog)", r"xent_"),
    # B1 and B2 on both routes, and the backward's delta pass
    ("flash attention (B1, B2a, B2b, delta)", r"(^|[\s:])(fwd|dq|dkv|delta)(_sm90)?_kernel<"),
    ("matmul (cuBLAS)", r"gemm|nvjet|xmma|cutlass|sm90_"),
    ("softmax and cross-entropy", r"softmax|nll_loss|cross_entropy"),
    ("optimizer (_foreach)", r"multi_tensor_apply|foreach"),
    ("reductions", r"reduce"),
    ("elementwise and copies", r"elementwise|copy|cat_|catarray|index|fill|scatter|gather|where"),
)
OTHER = "other kernels"
MEMCPY = "memcpy and memset"


def group_of(name: str, cat: str = "kernel") -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return MEMCPY
    low = name.lower()
    for group, pattern in GROUPS:
        if re.search(pattern, low):
            return group
    return OTHER


def short_name(name: str) -> str:
    """A kernel's function name without its namespace wrapper, template
    arguments or parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(events: list, steps: int, step_ms: float) -> dict:
    """Per-step breakdown of the device events of a Chrome trace."""
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        raise RuntimeError("the trace holds no device events: CUPTI tracing did not record the card")
    groups: dict = {}
    kernels: dict = {}
    for e in dev:
        g = groups.setdefault(group_of(e["name"], e["cat"]), {"us": 0.0, "events": 0, "kernels": {}})
        g["us"] += e["dur"]
        g["events"] += 1
        gk = g["kernels"].setdefault(short_name(e["name"]), [0.0, 0])
        gk[0] += e["dur"]
        gk[1] += 1
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += e["dur"]
        k[1] += 1
    busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / steps / 1e3
    window = (max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)) / steps / 1e3
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", ""))
    return {
        "device_busy_ms": busy,
        "device_window_ms": window,
        "idle_share_of_untraced_step": 1.0 - busy / step_ms,
        "idle_share_of_traced_window": 1.0 - busy / window,
        "kernel_launch_calls": launches / steps,
        "groups": {
            name: {"ms": g["us"] / steps / 1e3, "share_of_busy": g["us"] / steps / 1e3 / busy,
                   "events": g["events"] / steps,
                   # the group's longest kernels by function name
                   "kernels": [{"name": n, "ms": us / steps / 1e3, "calls": c / steps}
                               for n, (us, c) in sorted(g["kernels"].items(), key=lambda kv: -kv[1][0])[:6]]}
            for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["us"])
        },
        "top_kernels": [
            {"name": n[:120], "ms": us / steps / 1e3, "calls": c / steps, "group": group_of(n)}
            for n, (us, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
        ],
    }


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: n/a"


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opendiloco_torch.data.dataloader import FakeTokenizedDataset
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="150m", choices=("150m", "1b"), help="model configuration")
    ap.add_argument("--steps", type=int, default=3, help="inner steps timed, and as many traced")
    ap.add_argument("--out", default=None, help="directory for the gzipped Chrome trace and the summary")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    mb, accum, seq = 8, 2, 1024
    tr = InnerTrainer(cfg, TrainerConfig(precision="bf16-mixed", remat=True, warmup_steps=2, total_steps=100))
    ds = iter(FakeTokenizedDataset(seq, cfg.vocab_size, seed=7, mode="ramp"))
    ids = np.stack([next(ds)["input_ids"] for _ in range(mb * accum)])
    state = tr.init_state(3)
    batch = tr.shard_batch(ids, ids.copy(), accum=accum)

    def steps(n: int) -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = tr.train_step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    steps(2)  # warm-up: kernel build and load, cuBLAS plans, allocator
    step_ms = steps(args.steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = steps(args.steps)
    out_dir = args.out or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "inner_step_trace.json.gz")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    with (gzip.open if gz else open)(trace, "rt") as f:
        events = json.load(f)["traceEvents"]
    res = {
        "card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
        "config": args.config, "fused_loss": tr.tc.fused_loss,
        "micro_batch": mb, "accum": accum, "seq": seq, "steps": args.steps,
        "step_ms_untraced": step_ms, "step_ms_traced": traced_ms,
        **summarize(events, args.steps, step_ms),
    }
    if args.out is None:
        os.remove(trace)
        os.rmdir(out_dir)
    else:
        with open(os.path.join(out_dir, "inner_step_profile.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
