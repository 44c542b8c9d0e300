"""Host and card time of paged decode attention (B6), and of the config_1b
decode step that runs it, on one CUDA card.

    python -m opendiloco_torch.decode_step_time [--steps 40]

1. B6's wrapper at the config_1b decode shape (S 8, T 1024, Kh 4, rep 8,
   D 64, bf16, lens [0, 1, 255, 256, 700, 1023, 1500, 511], K/V copies
   cycled past L2): host microseconds per call (200 calls with no sync
   between them) and card milliseconds per call (calls captured in a CUDA
   graph and replayed between two events), each measured twice in turns.
2. A :class:`~opendiloco_torch.serve.engine.ServeEngine` at config_1b with
   the ServeConfig defaults and random weights from seed 0: per decode
   step (one greedy token for each of 8 slots, the lens above), the host
   milliseconds to issue ``decode_forward`` and the wall milliseconds of
   ``ServeEngine.decode_step``, which waits for the tokens on the host;
   the launches a step makes, by kernel.

It calls only what every version of the port since the first slice has
(``paged_decode_attention(q, k, v, lens)``, ``ServeEngine``,
``decode_forward``), so two checkouts can be compared on one card, each
run from its own root. Prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np

LENS = [0, 1, 255, 256, 700, 1023, 1500, 511]
L2_BYTES = 50 * 2**20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: n/a"


def host_us(torch, fn, arg_sets, calls: int = 200) -> float:
    """Host microseconds per call, after a warm-up call of each set."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(torch, fn, arg_sets, launches: int = 64, replays: int = 5) -> float:
    """Card milliseconds per call: ``launches`` calls captured in one CUDA
    graph, replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def b6_times(torch, tdk, cfg, S: int, T: int, dev) -> dict:
    Kh, H, D = cfg.kv_heads, cfg.num_attention_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(1)
    lens = torch.tensor(LENS[:S], dtype=torch.int32, device=dev)
    q = torch.randn(S, H, D, generator=g, device=dev).to(torch.bfloat16)
    copies = max(1, math.ceil(2 * L2_BYTES / (S * T * Kh * D * 2 * 2)))
    sets = [(q, *(torch.randn(S, T, Kh, D, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)), lens)
            for _ in range(copies)]
    fn = tdk.paged_decode_attention
    n0 = tdk.LAUNCHES.snapshot()
    fn(*sets[0])
    torch.cuda.synchronize()
    per_call = {k: v - n0.get(k, 0) for k, v in tdk.LAUNCHES.snapshot().items() if v != n0.get(k, 0)}
    host = [host_us(torch, fn, sets) for _ in range(2)]
    card = [device_ms(torch, fn, sets) for _ in range(2)]
    return {"shape": {"S": S, "T": T, "Kh": Kh, "rep": H // Kh, "D": D, "lens": LENS[:S], "dtype": "bfloat16"},
            "launches_per_call": per_call, "host_us_runs": host, "card_ms_runs": card}


def step_times(torch, tdk, cfg, steps: int, dev) -> dict:
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.models.llama import decode_forward, init_params
    from opendiloco_torch.serve.engine import ServeEngine

    sc = ServeConfig()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = ServeEngine(cfg, params, num_slots=sc.max_batch, max_context=sc.max_context,
                         prefill_buckets=sc.prefill_buckets, weight_format=sc.weight_format, device=dev)
    del params
    S = engine.num_slots
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    lens = np.asarray(LENS[:S], np.int32)
    tok = torch.as_tensor(tokens.astype(np.int64)).to(dev)
    ln = torch.as_tensor(lens).to(dev)
    for _ in range(3):  # warm-up: kernel loads, cuBLAS plans, allocator
        engine.decode_step(tokens, lens)
    torch.cuda.synchronize()
    n0 = tdk.LAUNCHES.snapshot()
    issue, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        decode_forward(engine.params, tok, ln, engine.cache_k, engine.cache_v, cfg,
                       compute_dtype=engine.compute_dtype)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    launches = {k: (v - n0.get(k, 0)) / steps for k, v in tdk.LAUNCHES.snapshot().items() if v != n0.get(k, 0)}
    for _ in range(steps):
        t0 = time.perf_counter()
        engine.decode_step(tokens, lens)
        wall.append((time.perf_counter() - t0) * 1e3)
    return {"steps": steps, "slots": S, "compute_dtype": str(engine.compute_dtype).removeprefix("torch."),
            "weight_format": sc.weight_format, "launches_per_step": launches,
            "issue_ms_median": float(np.median(issue)), "issue_ms_mean": float(np.mean(issue)),
            "step_wall_ms_median": float(np.median(wall)), "step_wall_ms_mean": float(np.mean(wall))}


def main(argv=None) -> int:
    import torch

    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.ops import decode_kernels as tdk

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40, help="decode steps timed, for the issue and the wall time each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_step_time needs a CUDA card")
    dev = torch.device("cuda")
    cfg = load_config("1b")
    sc = ServeConfig()
    res = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "b6": b6_times(torch, tdk, cfg, sc.max_batch, sc.max_context, dev),
           "decode_step": step_times(torch, tdk, cfg, args.steps, dev)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
