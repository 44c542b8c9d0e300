"""Host and card time of the decode step's kernels, paged decode attention
(B6) and the W4 dequant-matmul (B8), and of the config_1b decode step that
runs them, on one CUDA card.

    python -m opendiloco_torch.decode_step_time [--steps 200]

1. B6's wrapper at the config_1b decode shape (S 8, T 1024, Kh 4, rep 8,
   D 64, bf16, lens [0, 1, 255, 256, 700, 1023, 1500, 511], K/V copies
   cycled past L2): host microseconds per call (20 runs of 50 calls with
   no sync in a run; the runs' means sorted, and their quartiles) and card
   milliseconds per call (calls captured in a CUDA graph and replayed
   between two events, twice).
2. B8's wrapper at each config_1b weight shape and M 8 (x bf16, packed
   weights from seed 2, copies cycled past L2), measured the same way;
   the seven matmuls of a layer add up to its per-layer times (the
   median host µs, the faster card ms).
3. Two :class:`~opendiloco_torch.serve.engine.ServeEngine` at config_1b
   with the ServeConfig defaults and random weights from seed 0, one with
   fp32 weights and one with w4, in rounds (each engine once a round, the
   order swapped every round): per decode step (one greedy token for each
   of 8 slots, the lens above), the host milliseconds to issue
   ``decode_forward`` and the wall milliseconds of
   ``ServeEngine.decode_step``, which waits for the tokens on the host
   (quartiles over the rounds); each round's w4 less fp32 (quartiles: the
   host's slow spells hit both engines of a round alike); the launches a
   step makes, by kernel; and the card's busy milliseconds a step (the
   union of its kernels' intervals in a ``torch.profiler`` trace of 5
   steps).

It calls only what every version of the port since the first slice has
(``paged_decode_attention(q, k, v, lens)``, ``w4_matmul(x, q, s, shape,
dtype)``, ``pack_blockwise4_stacked``, ``ServeEngine``,
``decode_forward``, ``profile_inner_step.busy_us``), so two checkouts can
be compared on one card, each run from its own root. Prints one JSON
object as its last line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np

LENS = [0, 1, 255, 256, 700, 1023, 1500, 511]
L2_BYTES = 50 * 2**20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: n/a"


def host_us(torch, fn, arg_sets, calls: int = 50, batches: int = 20) -> list:
    """Host microseconds per call, after a warm-up call of each set: the
    mean of each of ``batches`` runs of ``calls`` calls with no sync in a
    run (a sync between runs), sorted. Their median is the reading; the
    spread between them shows the host's noise."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    out = []
    for b in range(batches):
        t0 = time.perf_counter()
        for i in range(calls):
            fn(*arg_sets[(b * calls + i) % len(arg_sets)])
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(out)


def quartiles(xs) -> list:
    """[25th, 50th, 75th] percentiles of ``xs``."""
    return [float(v) for v in np.percentile(np.asarray(xs, dtype=float), [25, 50, 75])]


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
    with torch.cuda.graph(graph, stream=side):  # the warmed stream (the sm90 B8 keeps its scratch a stream)
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
    host = host_us(torch, fn, sets)
    card = [device_ms(torch, fn, sets) for _ in range(2)]
    return {"shape": {"S": S, "T": T, "Kh": Kh, "rep": H // Kh, "D": D, "lens": LENS[:S], "dtype": "bfloat16"},
            "launches_per_call": per_call, "host_us_batches": host, "host_us_quartiles": quartiles(host),
            "card_ms_runs": card}


def layer_shapes(cfg) -> dict:
    """A decoder layer's matmul weight shapes [in, out] and their count."""
    D, F_, Hd, KVd = (cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads * cfg.head_dim,
                      cfg.kv_heads * cfg.head_dim)
    shapes: dict = {}
    for shape in ((D, Hd), (D, KVd), (D, KVd), (Hd, D), (D, F_), (D, F_), (F_, D)):
        shapes[shape] = shapes.get(shape, 0) + 1
    return shapes


def b8_times(torch, tdk, cfg, M: int, dev) -> dict:
    from opendiloco_torch import quant

    g = torch.Generator(device=dev).manual_seed(2)
    rows, layer = [], {"host_us": 0.0, "card_ms": 0.0}
    for (K, N), count in layer_shapes(cfg).items():
        nbytes = K * N // 2 + 2 * -(-K * N // 4096)
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        sets = []
        for _ in range(copies):
            q, sc = quant.pack_blockwise4_stacked(torch.randn(1, K, N, generator=g, device=dev))
            sets.append((x, q[0], sc[0], (K, N), torch.bfloat16))
        fn = tdk.w4_matmul
        n0 = tdk.LAUNCHES.snapshot()
        fn(*sets[0])
        torch.cuda.synchronize()
        per_call = {k: v - n0.get(k, 0) for k, v in tdk.LAUNCHES.snapshot().items() if v != n0.get(k, 0)}
        host = host_us(torch, fn, sets)
        card = [device_ms(torch, fn, sets, launches=max(64, min(len(sets), 256))) for _ in range(2)]
        rows.append({"K": K, "N": N, "per_layer": count, "launches_per_call": per_call, "host_us_batches": host,
                     "host_us_quartiles": quartiles(host), "card_ms_runs": card})
        layer["host_us"] += count * quartiles(host)[1]
        layer["card_ms"] += count * min(card)
        del sets
    return {"M": M, "dtype": "bfloat16", "shapes": rows, "layer": layer}


def card_busy_ms(torch, fn, steps: int) -> float:
    """The card's busy ms per call of ``fn``: the union of the device
    events' intervals in a ``torch.profiler`` trace of ``steps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from opendiloco_torch.profile_inner_step import busy_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        raise RuntimeError("the trace holds no device events")
    return busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / steps / 1e3


def step_times(torch, tdk, cfg, steps: int, dev) -> dict:
    """The decode step with fp32 and with w4 weights in ``steps`` rounds
    (each engine's issue, then its wall, once a round; fp32 first in even
    rounds), then the card's busy ms per step of each from a short trace."""
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.models.llama import decode_forward, init_params
    from opendiloco_torch.serve.engine import ServeEngine

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    engines = {}
    for fmt in ("fp32", "w4"):
        sc = ServeConfig(weight_format=fmt)
        engines[fmt] = ServeEngine(cfg, params, num_slots=sc.max_batch, max_context=sc.max_context,
                                   prefill_buckets=sc.prefill_buckets, weight_format=fmt, device=dev)
    del params
    S = engines["fp32"].num_slots
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    lens = np.asarray(LENS[:S], np.int32)
    tok = torch.as_tensor(tokens.astype(np.int64)).to(dev)
    ln = torch.as_tensor(lens).to(dev)

    def forward(engine):
        return decode_forward(engine.params, tok, ln, engine.cache_k, engine.cache_v, cfg,
                              compute_dtype=engine.compute_dtype)

    for engine in engines.values():
        for _ in range(3):  # warm-up: kernel loads, cuBLAS plans, allocator
            engine.decode_step(tokens, lens)
    torch.cuda.synchronize()
    res = {fmt: {"issue_ms": [], "wall_ms": []} for fmt in engines}
    launches = {fmt: {} for fmt in engines}
    for i in range(steps):  # a round: both engines, in turns (fp32 first in even rounds, w4 first in odd)
        for fmt in (("fp32", "w4") if i % 2 == 0 else ("w4", "fp32")):
            engine = engines[fmt]
            n0 = tdk.LAUNCHES.snapshot()
            t0 = time.perf_counter()
            forward(engine)
            res[fmt]["issue_ms"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            for k, v in tdk.LAUNCHES.snapshot().items():
                if v != n0.get(k, 0):
                    launches[fmt][k] = launches[fmt].get(k, 0) + (v - n0.get(k, 0)) / steps
            t0 = time.perf_counter()
            engine.decode_step(tokens, lens)
            res[fmt]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for fmt, engine in engines.items():
        r = res[fmt]
        out["decode_step" if fmt == "fp32" else f"decode_step_{fmt}"] = {
            "steps": steps, "slots": S, "compute_dtype": str(engine.compute_dtype).removeprefix("torch."),
            "weight_format": fmt, "launches_per_step": launches[fmt],
            "issue_ms_quartiles": quartiles(r["issue_ms"]), "step_wall_ms_quartiles": quartiles(r["wall_ms"]),
            "issue_ms_median": quartiles(r["issue_ms"])[1], "step_wall_ms_median": quartiles(r["wall_ms"])[1],
            "card_busy_ms": card_busy_ms(torch, lambda: forward(engine), 5),
        }
    # the same round's w4 less fp32: the host's slow spells hit both alike
    out["w4_less_fp32"] = {
        "issue_ms_quartiles": quartiles(np.subtract(res["w4"]["issue_ms"], res["fp32"]["issue_ms"])),
        "step_wall_ms_quartiles": quartiles(np.subtract(res["w4"]["wall_ms"], res["fp32"]["wall_ms"])),
        "card_busy_ms": out["decode_step_w4"]["card_busy_ms"] - out["decode_step"]["card_busy_ms"],
    }
    return out


def main(argv=None) -> int:
    import torch

    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.ops import decode_kernels as tdk

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="rounds timed: each times a decode step's issue and wall with each engine")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_step_time needs a CUDA card")
    dev = torch.device("cuda")
    cfg = load_config("1b")
    sc = ServeConfig()
    res = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "b6": b6_times(torch, tdk, cfg, sc.max_batch, sc.max_context, dev),
           "b8": b8_times(torch, tdk, cfg, sc.max_batch, dev),
           **step_times(torch, tdk, cfg, args.steps, dev)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
