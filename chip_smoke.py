#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: serving and training.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one NVIDIA H100
(``sm_90a``), the CUDA toolkit under ``/usr/local/cuda`` and PyTorch built
for CUDA. It needs no network and no JAX. Where ``torch.cuda.is_available()``
is false, or the ``opendiloco_torch`` package is not beside it, it exits
non-zero and prints no result. Every phase runs unguarded: any failure
exits non-zero.

1. Card line: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, and the seconds the nvcc build of the four kernel sources
   took (one nvcc per source, started together). TF32 is off for matmuls
   and cuDNN, so every f32 product is full f32.
2. B6, paged decode attention, against its plain version at the
   config_1b decode shape (S 8, T 1024, Kh 4, rep 8, D 64) with ragged
   ``lens`` that include an empty slot and a wrapped ring, in f32 and
   bf16; device times of kernel, plain version, one
   ``scaled_dot_product_attention`` call over the masked dense ring, and
   the bound.
3. B8, the W4 dequant-matmul, against its plain version at every distinct
   config_1b weight shape, M 8 (decode) and 1024 (prefill), in f32 and
   bf16, plus the identity probe bit for bit; device times and bounds.
4. Serving with fp32 weights: ``build_serving`` at config_1b width, random
   weights from ``torch.Generator("cuda").manual_seed(0)``, 16 requests
   over the three prefill buckets, 48 new tokens each. The launch counters
   are zeroed just before and read just after: B6 must have run 22 times
   per decode step. Then one ``decode_forward`` step's logits, kernel path
   against plain path, in f32 and bf16.
5. The same with ``weight_format="w4"``: B8 must have run 7 x 22 times per
   prefill and per decode step.
6. A small-input reference: config_2m through ``ServeEngine`` on the card
   (kernels) against the same engine on the CPU (plain versions).
7. B1, B2a and B2b (flash attention forward, dq, dk/dv) against their
   plain versions at the 150m training shape (mb 8, T 1024, 16 x 64
   heads), the config_1b head geometry (32 over 4 heads), an odd T
   (1000) and full attention, in f32 and bf16; device times of kernel,
   plain version, SDPA forward (B1's library yardstick) and SDPA's
   backward through autograd (B2a's and B2b's: one call computes dq, dk
   and dv; forward + backward less forward), and the bounds.
8. Training: two DiLoCo workers, one thread each, run ``train()`` at
   config_150m full width and depth (mb 8, accum 2, seq 1024, bf16,
   remat, fake "ramp" data, 8 steps, local_steps 4: 2 outer rounds). The
   launch counters are zeroed just before and read just after: B1 must
   have run 2 x 12 x accum times per inner step and worker, B2a and B2b
   12 x accum, the fused cross-entropy kernels never (150m resolves
   ``fused_loss=False``). Every loss finite, the last below the first,
   both masters bit-identical after each round. Then one inner step,
   kernel path against plain path, and one worker's inner-step time alone.
9. B3, the dlog kernel, B4a and B4b (fused lm-head + cross-entropy)
   against their plain versions at the 1b training shape (N 8184, D 2048,
   V 32000), the 150m width (D 1024) and an odd N and V (1000), about a
   seventh of the labels -100, in f32 and bf16; device times of kernel,
   plain version and the library pair (cuBLAS ``h @ w`` then
   ``F.cross_entropy``, and its backward through autograd), and the
   bounds.
10. Training at config_1b, full width and depth, as phase 8 (4 steps,
   local_steps 2: 2 outer rounds), with ``fused_loss`` left at its
   default, which resolves on. Per inner step and worker B1 must have run
   2 x 22 x accum times, B2a and B2b 22 x accum, B3 accum, and the dlog,
   B4a and B4b kernels accum x 4 (a backward walks 8184 rows in chunks of
   2048). Then one inner step with the fused loss against one with
   ``fused_loss=False`` on the same params and batch.
11. The kernels line, the card line, and last the result line.

Device times come from CUDA-graph replays of many launches that cycle
through enough copies of the inputs to exceed the 50 MB L2 cache, as the
main paths find their weights, KV pages and activations cold; host launch
cost is left out. Bounds take each input read once and each output
written once over 3.35 TB/s, or the operations over 989 TFLOP/s (bf16),
whichever is larger (the H100 SXM data sheet).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2**20
NEW_TOKENS = 48
N_REQUESTS = 16


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, arg_sets, launches: int = 64, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls cycling
    through ``arg_sets`` are captured into one CUDA graph, which is
    replayed ``replays`` times between two events."""
    # warm up (builds, loads, allocator pools) on a side stream, as graph
    # capture of an autograd backward requires
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
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def copies_for(nbytes: int) -> int:
    """Distinct input copies whose sum is at least twice the L2 cache."""
    return max(1, math.ceil(2 * L2_BYTES / max(1, nbytes)))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 2: B6 paged decode attention
# ---------------------------------------------------------------------------


def phase_b6(torch, tdk, cfg, serve_cfg, dev) -> dict:
    import torch.nn.functional as F

    S, T = serve_cfg.max_batch, serve_cfg.max_context
    Kh, H, D = cfg.kv_heads, cfg.num_attention_heads, cfg.head_dim
    # empty slot, one row, a tile edge, mid ring, the last row, a wrapped
    # ring, and one more mid-ring slot
    lens_list = [0, 1, 255, 256, 700, 1023, 1500, 511][:S]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(S, H, D, generator=g, device=dev).to(dtype)
        k = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
        v = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
        out = tdk.paged_decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        ref = tdk.paged_decode_attention_plain(q, k, v, lens)
        err = (out.float() - ref.float()).abs().amax(dim=(1, 2))
        if dtype == torch.float32:
            # only the order of f32 sums differs (outputs are averages of
            # N(0,1) values, at most about 1)
            tol = torch.full_like(err, 1e-5)
        else:
            # p is rounded to bf16 at each tile's running max where the plain
            # version rounds at the global max, and both outputs round to
            # bf16: 2**-6 of each slot's largest output, two to four bf16
            # ulps there. Per slot, because a long ring averages its rows to
            # outputs of about 0.1 while a one-row slot returns v itself
            tol = 2.0**-6 * ref.float().abs().amax(dim=(1, 2))
        worst = int((err / tol).argmax())
        check = {"dtype": str(dtype).removeprefix("torch."), "max_abs_err": float(err.max()),
                 "worst_slot": {"lens": lens_list[worst], "max_abs_err": float(err[worst]),
                                "tol": float(tol[worst])},
                 "per_slot_err": err.tolist(), "per_slot_tol": tol.tolist()}
        checks.append(check)
        log(f"B6 {dtype}: max |kernel - plain| = {check['max_abs_err']:.3e}; nearest its tolerance: "
            f"slot with lens {lens_list[worst]}, {float(err[worst]):.3e} (tol {float(tol[worst]):.3e})")
        if not bool((err <= tol).all()):
            raise AssertionError(f"B6 {dtype} disagrees with its plain version: {check}")

    # timing in the serving dtype, KV pages cycled to stay out of L2
    dtype, elt = torch.bfloat16, 2
    live = [min(n, T - 1) + 1 for n in lens_list]
    page_bytes = S * T * Kh * D * elt * 2
    sets = []
    q = torch.randn(S, H, D, generator=g, device=dev).to(dtype)
    for _ in range(copies_for(page_bytes)):
        k = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
        v = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
        sets.append((q, k, v, lens))
    kernel_ms = device_ms(torch, tdk.paged_decode_attention, sets)
    plain_ms = device_ms(torch, tdk.paged_decode_attention_plain, sets, launches=16)

    # library yardstick, timed here only: one SDPA call over the dense ring
    # with the live-row mask, GQA by enable_gqa
    idx = torch.arange(T, device=dev)[None, :]
    ln = lens.long()[:, None]
    mask = ((idx <= ln) | (ln >= T))[:, None, None, :]

    def sdpa(q, k, v, lens):
        return F.scaled_dot_product_attention(
            q.unsqueeze(2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True,
        )

    library_ms = device_ms(torch, sdpa, sets, launches=16)
    nbytes = sum(live) * Kh * D * elt * 2 + 2 * S * H * D * elt + S * 4
    flops = sum(live) * H * D * 4
    b_ms, b_by = bound_ms(nbytes, flops)
    log(
        f"B6 bf16 S{S} T{T} Kh{Kh} rep{H // Kh} D{D} live rows {sum(live)}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
    )
    return {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "opendiloco_torch/csrc/paged_decode_attention.cu",
        "replaces": "opendiloco_tpu/ops/decode_kernels.py:241 (paged_decode_attention, _decode_attn_kernel :112)",
        "shape": {"S": S, "T": T, "Kh": Kh, "rep": H // Kh, "D": D, "lens": lens_list, "dtype": "bfloat16"},
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "tol": "f32 1e-5; bf16 2**-6 of each slot's largest output",
        "checks": checks,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True) over the masked dense ring",
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


# ---------------------------------------------------------------------------
# phase 3: B8 W4 dequant-matmul
# ---------------------------------------------------------------------------


def layer_weight_shapes(cfg) -> dict:
    """The decoder's matmul weight shapes [in, out] and their count per layer."""
    D, F_, Hd, KVd = (
        cfg.hidden_size, cfg.intermediate_size,
        cfg.num_attention_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim,
    )
    shapes: dict = {}
    for shape in ((D, Hd), (D, KVd), (D, KVd), (Hd, D), (D, F_), (D, F_), (F_, D)):
        shapes[shape] = shapes.get(shape, 0) + 1
    return shapes


def phase_b8(torch, tdk, quant, cfg, dev) -> dict:
    from opendiloco_torch.quant import W4_BLOCK

    g = torch.Generator(device=dev).manual_seed(2)
    checks, timings = [], []
    for (K, N), count in layer_weight_shapes(cfg).items():
        qs, ss = quant.pack_blockwise4_stacked(torch.randn(1, K, N, generator=g, device=dev))
        q, s = qs[0], ss[0]
        # the identity probe: x = I in f32 gives dequant_w4 bit for bit
        eye = tdk.w4_matmul(torch.eye(K, device=dev), q, s, (K, N), torch.float32)
        if not torch.equal(eye, quant.dequant_w4(q, s, (K, N), torch.float32)):
            raise AssertionError(f"B8 identity probe at {(K, N)} is not bitwise dequant_w4")
        for M in (8, 1024):
            x = torch.randn(M, K, generator=g, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                out = tdk.w4_matmul(x, q, s, (K, N), dtype)
                ref = tdk.w4_matmul_plain(x, q, s, (K, N), dtype)
                scale = float(ref.float().abs().max())
                err = float((out.float() - ref.float()).abs().max())
                # f32: K-long f32 sums in another order, 1e-5 of the largest
                # output; bf16: both sum in f32 and round once to bf16, so
                # one bf16 ulp (2**-7 relative) apart at most
                tol = 1e-5 * scale if dtype == torch.float32 else 2**-7 * scale
                checks.append({"K": K, "N": N, "M": M, "dtype": str(dtype).removeprefix("torch."),
                               "max_abs_err": err, "tol": tol})
                if not err <= tol:
                    raise AssertionError(f"B8 {(M, K, N)} {dtype}: {err} > {tol}")
        log(f"B8 {(K, N)}: identity probe bitwise, f32/bf16 within tolerance at M 8 and 1024")

        packed_bytes = K * N // 2 + math.ceil(K * N / W4_BLOCK) * 2
        copies = copies_for(packed_bytes)
        w = []
        for _ in range(copies):  # distinct weights, so every call reads cold
            qc, sc = quant.pack_blockwise4_stacked(torch.randn(1, K, N, generator=g, device=dev))
            w.append((qc[0], sc[0]))
        for M in (8, 1024):
            x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
            sets = [(x, qc, sc, (K, N), torch.bfloat16) for qc, sc in w]
            kernel_ms = device_ms(torch, tdk.w4_matmul, sets, launches=max(64, min(len(sets), 256)))
            plain_ms = device_ms(torch, tdk.w4_matmul_plain, sets, launches=16)
            nbytes = packed_bytes + M * K * 2 + M * N * 2
            b_ms, b_by = bound_ms(nbytes, 2.0 * M * K * N)
            timings.append({"M": M, "K": K, "N": N, "per_layer": count, "kernel_ms": kernel_ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            log(f"B8 bf16 M{M} K{K} N{N}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.5f} ms ({b_by})")
        del w

    def per_layer(M, key):
        return sum(t[key] * t["per_layer"] for t in timings if t["M"] == M)

    worst = max(checks, key=lambda c: c["max_abs_err"] / c["tol"])
    b_ms = per_layer(8, "bound_ms")
    return {
        "name": "w4_matmul",
        "route": "cuda",
        "source": "opendiloco_torch/csrc/w4_matmul.cu",
        "replaces": "opendiloco_tpu/ops/decode_kernels.py:561 (w4_matmul, _w4_kernel :468)",
        "shape": "one decoder layer's 7 weight matmuls at M 8 (decode), bfloat16; per-shape times in 'shapes'",
        "max_abs_err": worst["max_abs_err"],
        "tol": worst["tol"],
        "checks": checks,
        "ms": per_layer(8, "kernel_ms"),
        "kernel_ms": per_layer(8, "kernel_ms"),
        "plain_ms": per_layer(8, "plain_ms"),
        "library_ms": None,
        "library": "none: no single PyTorch call dequantizes blockwise-4-bit and multiplies",
        "bound_ms": b_ms,
        "bound_by": "bytes" if all(t["bound_by"] == "bytes" for t in timings if t["M"] == 8) else "operations",
        "prefill_layer_ms": per_layer(1024, "kernel_ms"),
        "prefill_layer_plain_ms": per_layer(1024, "plain_ms"),
        "prefill_layer_bound_ms": per_layer(1024, "bound_ms"),
        "shapes": timings,
    }


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving main path
# ---------------------------------------------------------------------------


def prompts_over_buckets(serve_cfg, vocab: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    edges = [0, *serve_cfg.prefill_buckets]
    lengths = []
    for i in range(N_REQUESTS):
        b = i % len(serve_cfg.prefill_buckets)
        lengths.append(int(rng.integers(edges[b] + 1, edges[b + 1] + 1)))
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def phase_serve(torch, tdk, cfg, serve_cfg, params, dev) -> dict:
    from opendiloco_torch.models.llama import decode_forward
    from opendiloco_torch.serve import build_serving

    L = cfg.num_hidden_layers
    w4 = serve_cfg.weight_format == "w4"
    prompts = prompts_over_buckets(serve_cfg, cfg.vocab_size)
    plane = build_serving(serve_cfg, cfg, params, device=dev)
    try:
        engine, batcher = plane.engine, plane.batcher
        # warm-up: one prompt per bucket (first cuBLAS and allocator use)
        warm = [batcher.submit(p[:b], max_new_tokens=2) for p, b in
                zip(prompts, serve_cfg.prefill_buckets)]
        for r in warm:
            if not r.wait(600) or r.error is not None:
                raise AssertionError(f"warm-up request failed: {r.error}")
        base = batcher.stats()
        stages0 = dict(engine.stage_seconds)

        # the main path: counters zeroed just before, read just after
        tdk.LAUNCHES.reset()
        t0 = time.perf_counter()
        reqs = [batcher.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        for r in reqs:
            if not r.wait(1200):
                raise AssertionError("request timed out")
        wall = time.perf_counter() - t0
        launches = tdk.LAUNCHES.snapshot()
        st = batcher.stats()

        failed = [r.error for r in reqs if r.error is not None]
        if failed:
            raise AssertionError(f"{len(failed)} requests failed: {failed[:3]}")
        for r in reqs:
            if len(r.tokens) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"request {r.id}: bad tokens {r.tokens[:8]}...")
        steps = st["decode_steps"] - base["decode_steps"]
        prefills = st["completed"] - base["completed"]
        want = {name: 0 for name in launches}
        want.update({"paged_decode_attention": L * steps, "w4_matmul": 7 * L * (prefills + steps) if w4 else 0})
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want} ({steps} decode steps, {prefills} prefills)")
        decode_s = engine.stage_seconds["decode"] - stages0["decode"]
        prefill_s = engine.stage_seconds["prefill"] - stages0["prefill"]
        ttft = sorted(r.ttft_s for r in reqs)
        new_tokens = sum(len(r.tokens) for r in reqs)
        res = {
            "weight_format": serve_cfg.weight_format,
            "requests": len(reqs),
            "prompt_lengths": [len(p) for p in prompts],
            "new_tokens": new_tokens,
            "decode_steps": steps,
            "prefills": prefills,
            "launches": launches,
            "wall_s": wall,
            "tokens_per_s": new_tokens / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_max_ms": ttft[-1] * 1e3,
            "decode_step_ms": decode_s / steps * 1e3,
            "prefill_ms_mean": prefill_s / prefills * 1e3,
        }
        log(f"serve {serve_cfg.weight_format}: {json.dumps(res)}")

        # one decode step, kernel path against plain path, on the live
        # cache and weights (comparison launches, not counted above)
        S, T = serve_cfg.max_batch, serve_cfg.max_context
        g = torch.Generator(device=dev).manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (S,), generator=g, device=dev)
        lens = torch.tensor([0, 5, 63, 300, 700, 1023, 1100, 2000][:S], dtype=torch.int32, device=dev)
        res["decode_compare"] = []
        # f32: kernel and plain differ only in the order of f32 sums, over
        # 22 layers; bf16: the two paths round attention probabilities and
        # products to bf16 at different points in every layer
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 0.25)):
            outs = []
            for kernels in (True, False):
                ck, cv = engine.cache_k.to(dtype, copy=True), engine.cache_v.to(dtype, copy=True)
                logits, _, _ = decode_forward(engine.params, tokens, lens, ck, cv, cfg,
                                              compute_dtype=dtype, kernels=kernels)
                outs.append(logits)
                del ck, cv
            if not all(bool(torch.isfinite(o).all()) for o in outs):
                raise AssertionError("non-finite decode logits")
            err = float((outs[0] - outs[1]).abs().max())
            agree = int((outs[0].argmax(-1) == outs[1].argmax(-1)).sum())
            res["decode_compare"].append({"dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
                                          "tol": tol, "argmax_agree": f"{agree}/{S}",
                                          "logit_absmax": float(outs[1].abs().max())})
            log(f"decode_forward {dtype} kernel vs plain: max |d logits| = {err:.3e} (tol {tol}), "
                f"argmax agree {agree}/{S}")
            if not err <= tol:
                raise AssertionError(f"decode logits {dtype}: kernel vs plain {err} > {tol}")
        return res
    finally:
        plane.stop()


# ---------------------------------------------------------------------------
# phase 6: small-input reference, card against CPU
# ---------------------------------------------------------------------------


def np_params(tree, rng, name: str = ""):
    """Weights in the JAX layout drawn with numpy: N(0, 0.02), norms near 1."""
    if isinstance(tree, dict):
        return {k: np_params(v, rng, k) for k, v in tree.items()}
    base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
    return (base + scale * rng.standard_normal(tree)).astype(np.float32)


def phase_reference(torch, cfg, dev) -> list:
    """config_2m through ServeEngine on the card (kernels) and on the CPU
    (plain versions): the prefill logits and 4 teacher-forced decode steps'
    logits in f32, both weight formats (atol 1e-4: sums reassociate). The
    w4 packer must give the same bits on both devices."""
    from opendiloco_torch.models.llama import PackedW4, shapes
    from opendiloco_torch.serve import ServeEngine

    rng = np.random.default_rng(4)
    params = np_params(shapes(cfg), rng)
    prompt = rng.integers(1, cfg.vocab_size, 11).tolist()
    follow = rng.integers(1, cfg.vocab_size, 4).tolist()
    errs = []
    for fmt in ("fp32", "w4"):
        runs = []  # (logits, layer weights) on the card, then on the CPU
        for d in (dev, torch.device("cpu")):
            eng = ServeEngine(cfg, params, num_slots=2, max_context=32, prefill_buckets=(16,),
                              compute_dtype=torch.float32, weight_format=fmt, device=d)
            _, row = eng.admit(0, prompt)
            rows = [torch.as_tensor(row)]
            for i, tok in enumerate(follow):
                _, logits = eng.decode_step(np.asarray([tok, 0], np.int32),
                                            np.asarray([len(prompt) + i, 0], np.int32))
                rows.append(logits[0].cpu())
            runs.append((torch.stack(rows), eng.params["layers"]))
        (card_logits, card_layers), (cpu_logits, cpu_layers) = runs
        for name, w in cpu_layers.items():
            if isinstance(w, PackedW4) and not (
                torch.equal(w.q, card_layers[name].q.cpu()) and torch.equal(w.s, card_layers[name].s.cpu())
            ):
                raise AssertionError(f"w4 packing of {name} differs between card and CPU")
        err = float((card_logits - cpu_logits).abs().max())
        errs.append({"config": "2m", "weight_format": fmt, "max_abs_err": err, "tol": 1e-4})
        log(f"reference config_2m {fmt}: card vs CPU max |d logits| = {err:.3e} (tol 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"config_2m {fmt}: card vs CPU logits differ by {err}")
    return errs


# ---------------------------------------------------------------------------
# phase 7: B1, B2a, B2b flash attention
# ---------------------------------------------------------------------------

FLASH_NAMES = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
FLASH_REPLACES = {
    "flash_attention_fwd": "opendiloco_tpu/ops/flash_attention.py:136 (_fwd, _fwd_kernel :53)",
    "flash_attention_dq": "opendiloco_tpu/ops/flash_attention.py:320 (_bwd_impl, _dq_kernel :175)",
    "flash_attention_dkv": "opendiloco_tpu/ops/flash_attention.py:363 (_bwd_impl, _dkv_kernel :223)",
}


def flash_inputs(torch, dev, B, T, H, Hkv, D, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, H, D))
    return [torch.randn(*s, generator=g, device=dev).to(dtype) for s in shapes]


def flash_work(B, T, H, Hkv, D, elt, causal) -> dict:
    """(bytes, flops) each kernel must move and do on these inputs: every
    input read once and every output written once; score pairs counted as
    the mask leaves them (T (T + 1) / 2 per head when causal)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    qb, kvb, stat = B * T * H * D * elt, B * T * Hkv * D * elt, B * H * T * 4
    mm = 2.0 * B * H * D * pairs  # one [T x T] x [T x D] product over the pairs
    return {
        "flash_attention_fwd": (qb + 2 * kvb + qb + stat, 2 * mm),
        "flash_attention_dq": (2 * qb + 2 * kvb + 2 * stat + qb, 3 * mm),
        "flash_attention_dkv": (2 * qb + 2 * kvb + 2 * stat + 2 * kvb, 4 * mm),
    }


def phase_flash(torch, tfa, dev) -> list:
    """B1, B2a and B2b against their plain versions (the same lse and
    delta feed both backward paths), then device times at the training
    shape (mb 8, T 1024, 16 x 64 heads, causal, bf16)."""
    import torch.nn.functional as F

    geoms = [  # name, B, T, H, Hkv, D, causal
        ("150m", 8, 1024, 16, 16, 64, True),
        ("1b heads", 2, 1024, 32, 4, 64, True),
        ("odd T", 2, 1000, 16, 16, 64, True),
        ("150m full", 2, 1024, 16, 16, 64, False),
    ]
    checks = {name: [] for name in FLASH_NAMES}
    for gi, (label, B, T, H, Hkv, D, causal) in enumerate(geoms):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(torch, dev, B, T, H, Hkv, D, dtype, 10 + gi)
            ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
            delta = tfa.attention_delta(do, ref_out)
            out, lse = tfa.flash_attention_fwd(q, k, v, causal)
            dq = tfa.flash_attention_dq(q, k, v, do, ref_lse, delta, causal)
            dk, dv = tfa.flash_attention_dkv(q, k, v, do, ref_lse, delta, causal)
            torch.cuda.synchronize()
            refs = {"out": ref_out, "dq": tfa.flash_attention_dq_plain(q, k, v, do, ref_lse, delta, causal)}
            refs["dk"], refs["dv"] = tfa.flash_attention_dkv_plain(q, k, v, do, ref_lse, delta, causal)
            got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
            lse_err = float((lse - ref_lse).abs().max())
            if not lse_err <= 1e-4 * max(1.0, float(ref_lse.abs().max())):
                raise AssertionError(f"B1 lse {label} {dtype}: {lse_err}")
            for key, kernel in (("out", "flash_attention_fwd"), ("dq", "flash_attention_dq"),
                                ("dk", "flash_attention_dkv"), ("dv", "flash_attention_dkv")):
                ref = refs[key].float()
                err = (got[key].float() - ref).abs().amax(dim=(1, 3))  # per (batch, head)
                if dtype == torch.float32:
                    # only the order of f32 sums differs
                    tol = torch.full_like(err, 1e-5 * max(1.0, float(ref.abs().max())))
                else:
                    # p and ds round to bf16 at points that differ by f32
                    # rounding (p at each tile's running max in B1) and the
                    # outputs round to bf16: 2**-6 of each head's largest
                    tol = 2.0**-6 * ref.abs().amax(dim=(1, 3))
                worst = float((err / tol).max())
                checks[kernel].append({"shape": label, "B": B, "T": T, "H": H, "Hkv": Hkv, "D": D,
                                       "causal": causal, "dtype": str(dtype).removeprefix("torch."),
                                       "output": key, "max_abs_err": float(err.max()),
                                       "worst_err_over_tol": worst})
                if not bool((err <= tol).all()):
                    raise AssertionError(f"{kernel} {key} {label} {dtype}: error/tol {worst}")
            del q, k, v, do, out, lse, dq, dk, dv, refs, got, ref_out, ref_lse, delta
        log(f"B1/B2a/B2b {label} (B{B} T{T} H{H}/{Hkv} D{D} causal={causal}): f32 and bf16 within tolerance")
    torch.cuda.empty_cache()

    # times in the training dtype at the training shape, inputs cycled past L2
    B, T, H, Hkv, D, causal = 8, 1024, 16, 16, 64, True
    dtype = torch.bfloat16
    work = flash_work(B, T, H, Hkv, D, 2, causal)
    sets = []
    for i in range(copies_for(int(work["flash_attention_fwd"][0]))):
        q, k, v, do = flash_inputs(torch, dev, B, T, H, Hkv, D, dtype, 100 + i)
        out, lse = tfa.flash_attention_fwd(q, k, v, causal)
        sets.append((q, k, v, do, lse, tfa.attention_delta(do, out)))
    fwd = lambda q, k, v, do, lse, dl: tfa.flash_attention_fwd(q, k, v, causal)
    dqf = lambda q, k, v, do, lse, dl: tfa.flash_attention_dq(q, k, v, do, lse, dl, causal)
    dkvf = lambda q, k, v, do, lse, dl: tfa.flash_attention_dkv(q, k, v, do, lse, dl, causal)
    fwd_p = lambda q, k, v, do, lse, dl: tfa.flash_attention_fwd_plain(q, k, v, causal)
    dq_p = lambda q, k, v, do, lse, dl: tfa.flash_attention_dq_plain(q, k, v, do, lse, dl, causal)
    dkv_p = lambda q, k, v, do, lse, dl: tfa.flash_attention_dkv_plain(q, k, v, do, lse, dl, causal)
    times = {}
    for name, kern, plain in (("flash_attention_fwd", fwd, fwd_p), ("flash_attention_dq", dqf, dq_p),
                              ("flash_attention_dkv", dkvf, dkv_p)):
        times[name] = (device_ms(torch, kern, sets, launches=32),
                       device_ms(torch, plain, sets, launches=2, replays=3))
        torch.cuda.empty_cache()

    # library yardstick, timed here only: SDPA forward, and its backward
    # through autograd (one call computes dq, dk and dv; it stands in both
    # backward rows), taken as (forward + backward) - forward, both from
    # graph replays
    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                              is_causal=causal)

    def sdpa_fwd_bwd(q, k, v, do):
        return torch.autograd.grad(sdpa(q, k, v), (q, k, v), do.transpose(1, 2))

    sdpa_fwd_ms = device_ms(torch, lambda q, k, v, do, lse, dl: sdpa(q, k, v), sets, launches=32)
    leaves = [[t.detach().clone().requires_grad_(True) for t in st[:3]] + [st[3]] for st in sets]
    sdpa_bwd_ms = device_ms(torch, sdpa_fwd_bwd, leaves, launches=16) - sdpa_fwd_ms
    del leaves, sets
    torch.cuda.empty_cache()

    rows = []
    for name in FLASH_NAMES:
        nbytes, flops = work[name]
        b_ms, b_by = bound_ms(nbytes, flops)
        kernel_ms, plain_ms = times[name]
        worst = max(checks[name], key=lambda c: c["worst_err_over_tol"])
        log(f"{name} bf16 B{B} T{T} H{H} D{D} causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {'fwd' if name.endswith('fwd') else 'bwd'} "
            f"{sdpa_fwd_ms if name.endswith('fwd') else sdpa_bwd_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "opendiloco_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "shape": {"B": B, "T": T, "H": H, "Hkv": Hkv, "D": D, "causal": causal, "dtype": "bfloat16"},
            "max_abs_err": worst["max_abs_err"],
            "tol": "f32 1e-5 of the largest output; bf16 2**-6 of each (batch, head)'s largest output",
            "worst_check": worst,
            "checks": checks[name],
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "plain_ms": plain_ms,
            "library_ms": sdpa_fwd_ms if name.endswith("fwd") else sdpa_bwd_ms,
            "library": ("torch.nn.functional.scaled_dot_product_attention(is_causal=True) forward"
                        if name.endswith("fwd") else
                        "its backward through autograd (dq, dk and dv in one call)"),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    return rows


# ---------------------------------------------------------------------------
# phase 9: B3, B4a, B4b and the dlog kernel (fused lm-head + cross-entropy)
# ---------------------------------------------------------------------------

XENT_REPLACES = {
    "fused_xent_fwd": "opendiloco_tpu/ops/fused_xent.py:139 (_fwd, _fwd_kernel :85)",
    "fused_xent_dlog": "opendiloco_tpu/ops/fused_xent.py:174 (_recompute_dlog, inside _dh_kernel :195 and "
                       "_dw_kernel :219)",
    "fused_xent_dh": "opendiloco_tpu/ops/fused_xent.py:254 (_bwd_impl, _dh_kernel :195)",
    "fused_xent_dw": "opendiloco_tpu/ops/fused_xent.py:276 (_bwd_impl, _dw_kernel :219)",
}
# (label, N, D, V) of the checks, and the timed shape: the 1b training shape
XENT_GEOMS = [("1b", 8184, 2048, 32000), ("150m width", 8184, 1024, 32000), ("odd N and V", 1000, 1024, 1000)]
XENT_TIMED = (8184, 2048, 32000)
XENT_TOL = ("element by element, |got - ref| <= rtol |ref| + atol: nll and lse atol 1e-4 of the largest lse "
            "(logits exact in f32 on both sides, sums in another order); dlog rtol 2**-7 in bf16 (one ulp where "
            "the f32 value sits at a rounding boundary) and 1e-5 in f32, atol rtol/2 * max(g) / V (half of rtol "
            "of an average softmax entry, so a wrong non-target entry fails); dh in bf16 rtol 2**-7 and atol 1e-5 "
            "of the largest |dh| (f32 sum-order noise where an element nearly cancels); dh in f32 atol 1e-4 of "
            "the largest |dh| (V-long sums in another order, about 2**-24 * sqrt(V)); dw atol 1e-5 of the "
            "largest |dw| (f32 sums)")


def xent_inputs(torch, dev, N, D, V, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(N, D, generator=g, device=dev).to(dtype)
    w = (0.02 * torch.randn(D, V, generator=g, device=dev)).to(dtype)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::7] = -100  # about a seventh of the labels ignored
    mask = labels != -100
    return h, w, labels, mask.float() / max(1, int(mask.sum()))


def xent_work(N, D, V, elt) -> dict:
    """(bytes, flops) of one launch of each kernel at N rows: every input
    read once, every output written once (dw read and written when it
    accumulates); one product is 2 N D V operations."""
    mm = 2.0 * N * D * V
    h, w, dl = N * D * elt, D * V * elt, N * V * elt
    return {
        "fused_xent_fwd": (h + w + N * 8 + 2 * N * 4, mm),
        "fused_xent_dlog": (h + w + N * 8 + 2 * N * 4 + dl, mm),
        "fused_xent_dh": (dl + w + h, mm),
        "fused_xent_dw": (h + dl + 2 * D * V * 4, mm),
    }


def phase_xent(torch, tfx, dev) -> list:
    """Each kernel against its plain version on the same inputs (dh and dw
    take the plain dlog), then device times in bf16 at the 1b training
    shape: B3 over all N rows, the backward kernels per launch at one
    chunk of CHUNK_ROWS rows (a backward at N 8184 makes 4 of each)."""
    import torch.nn.functional as F

    checks = {name: [] for name in tfx.NAMES}
    for gi, (label, N, D, V) in enumerate(XENT_GEOMS):
        for dtype in (torch.float32, torch.bfloat16):
            h, w, labels, gup = xent_inputs(torch, dev, N, D, V, dtype, 20 + gi)
            nll, lse = tfx.fused_xent_fwd(h, w, labels)
            ref_nll, ref_lse = tfx.fused_xent_fwd_plain(h, w, labels)
            rows = slice(0, min(N, tfx.CHUNK_ROWS))
            args = (h[rows], w, labels[rows], ref_lse[rows], gup[rows])
            dlog = tfx.fused_xent_dlog(*args)
            ref_dlog = tfx.fused_xent_dlog_plain(*args)
            dh = tfx.fused_xent_dh(ref_dlog, w)
            dw = tfx.fused_xent_dw(h[rows], ref_dlog)
            torch.cuda.synchronize()
            scale = max(1.0, float(ref_lse.abs().max()))
            bf16 = dtype == torch.bfloat16
            ref_dh, ref_dw = tfx.fused_xent_dh_plain(ref_dlog, w), tfx.fused_xent_dw_plain(h[rows], ref_dlog)
            top = {"dh": float(ref_dh.float().abs().max()), "dw": float(ref_dw.abs().max())}
            r_dlog = 2.0**-7 if bf16 else 1e-5
            # (kernel, output, got, ref, rtol, atol): see XENT_TOL
            pairs = [("fused_xent_fwd", "lse", lse, ref_lse, 0.0, 1e-4 * scale),
                     ("fused_xent_fwd", "nll", nll, ref_nll, 0.0, 1e-4 * scale),
                     ("fused_xent_dlog", "dlog", dlog, ref_dlog, r_dlog, r_dlog / 2 * float(gup.max()) / V),
                     ("fused_xent_dh", "dh", dh, ref_dh, 2.0**-7 if bf16 else 0.0,
                      (1e-5 if bf16 else 1e-4) * top["dh"]),
                     ("fused_xent_dw", "dw", dw, ref_dw, 0.0, 1e-5 * top["dw"])]
            for kernel, out, got, ref, rtol, atol in pairs:
                diff = (got.float() - ref.float()).abs()
                ratio = float((diff / (rtol * ref.float().abs() + atol)).max())
                checks[kernel].append({"shape": label, "N": N, "D": D, "V": V,
                                       "dtype": str(dtype).removeprefix("torch."), "output": out,
                                       "max_abs_err": float(diff.max()), "rtol": rtol, "atol": atol,
                                       "worst_share_of_limit": ratio})
                if not ratio <= 1.0:
                    raise AssertionError(f"{kernel} {out} {label} {dtype}: an element is {ratio:.3g} times its "
                                         f"limit (rtol {rtol}, atol {atol:.3g})")
            if bool(nll[labels == -100].any()):
                raise AssertionError(f"fused_xent_fwd {label} {dtype}: an ignored row has a loss")
            del h, w, labels, gup, nll, lse, ref_nll, ref_lse, dlog, ref_dlog, dh, dw, ref_dh, ref_dw, diff
            torch.cuda.empty_cache()
        worst = {f"{c['output']} {c['dtype']}": round(c["worst_share_of_limit"], 4)
                 for k in checks.values() for c in k if c["shape"] == label}
        log(f"B3/B4 {label} (N{N} D{D} V{V}): f32 and bf16 within tolerance; worst element's share of its "
            f"limit: {worst}")
    log(f"B3/B4 tolerances: {XENT_TOL}")

    # times in bf16 at the 1b training shape
    (N, D, V), dtype = XENT_TIMED, torch.bfloat16
    C = min(N, tfx.CHUNK_ROWS)
    h, w, labels, gup = xent_inputs(torch, dev, N, D, V, dtype, 30)
    _, lse = tfx.fused_xent_fwd(h, w, labels)
    dlog = tfx.fused_xent_dlog(h[:C], w, labels[:C], lse[:C], gup[:C])
    acc = torch.zeros(D, V, device=dev)
    fwd_set, chunk_set = [(h, w, labels, lse, gup)], [(h[:C], w, labels[:C], lse[:C], gup[:C], dlog, acc)]
    runs = {
        "fused_xent_fwd": (lambda h, w, lb, ls, g: tfx.fused_xent_fwd(h, w, lb),
                           lambda h, w, lb, ls, g: tfx.fused_xent_fwd_plain(h, w, lb), fwd_set),
        "fused_xent_dlog": (lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dlog(h, w, lb, ls, g),
                            lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dlog_plain(h, w, lb, ls, g), chunk_set),
        "fused_xent_dh": (lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dh(dl, w),
                          lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dh_plain(dl, w), chunk_set),
        "fused_xent_dw": (lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dw(h, dl, a),
                          lambda h, w, lb, ls, g, dl, a: tfx.fused_xent_dw_plain(h, dl, a), chunk_set),
    }
    times = {}
    for name, (kern, plain, sets) in runs.items():
        times[name] = (device_ms(torch, kern, sets, launches=8, replays=3),
                       device_ms(torch, plain, sets, launches=2, replays=3))
        torch.cuda.empty_cache()
    bwd_ms = device_ms(torch, lambda h, w, lb, ls, g: tfx.fused_xent_bwd(h, w, lb, ls, g), fwd_set,
                       launches=2, replays=3)

    # library yardstick, timed here only: cuBLAS h @ w then F.cross_entropy,
    # and its backward through autograd as (forward + backward) - forward
    def lib_fwd(h, w, lb):
        return F.cross_entropy((h @ w).float(), lb, ignore_index=-100)

    def lib_fwd_bwd(h, w, lb):
        return torch.autograd.grad(lib_fwd(h, w, lb), (h, w))

    lib_fwd_ms = device_ms(torch, lambda h, w, lb, ls, g: lib_fwd(h, w, lb), fwd_set, launches=4, replays=3)
    leaves = [(h.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True), labels)]
    lib_bwd_ms = device_ms(torch, lib_fwd_bwd, leaves, launches=2, replays=3) - lib_fwd_ms
    # and cuBLAS at each backward kernel's own function, on the same chunk inputs
    lib_chunk_ms = {
        "fused_xent_dh": device_ms(torch, lambda h, w, lb, ls, g, dl, a: dl @ w.T, chunk_set, launches=8, replays=3),
        "fused_xent_dw": device_ms(torch, lambda h, w, lb, ls, g, dl, a: a.add_(h.T @ dl), chunk_set,
                                   launches=8, replays=3),
    }
    del leaves, fwd_set, chunk_set, h, w, labels, gup, lse, dlog, acc
    torch.cuda.empty_cache()

    n_chunks = -(-N // C)
    rows = []
    for name in tfx.NAMES:
        n = N if name == "fused_xent_fwd" else C
        nbytes, flops = xent_work(n, D, V, 2)[name]
        b_ms, b_by = bound_ms(nbytes, flops)
        kernel_ms, plain_ms = times[name]
        lib = lib_fwd_ms if name == "fused_xent_fwd" else lib_chunk_ms.get(name)
        worst = max(checks[name], key=lambda c: c["worst_share_of_limit"])
        log(f"{name} bf16 N{n} D{D} V{V}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.5f} ms ({b_by})")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "opendiloco_torch/csrc/fused_xent.cu",
            "replaces": XENT_REPLACES[name],
            "shape": {"N": n, "D": D, "V": V, "dtype": "bfloat16",
                      "per": "one launch over all rows" if n == N else f"one launch at one chunk of {C} rows "
                                                                      f"({n_chunks} per backward at N {N})"},
            "max_abs_err": worst["max_abs_err"],
            "tol": XENT_TOL,
            "worst_check": worst,
            "checks": checks[name],
            "ms": kernel_ms,
            "kernel_ms": kernel_ms,
            "plain_ms": plain_ms,
            "library_ms": lib,
            "library": ("cuBLAS h @ w, then F.cross_entropy over the f32 logits" if name == "fused_xent_fwd" else
                        "none: the logits' gradient has no call of its own" if name == "fused_xent_dlog" else
                        "cuBLAS dlog @ w.T on the same chunk" if name == "fused_xent_dh" else
                        "cuBLAS h.T @ dlog on the same chunk, added into the f32 dw"),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    log(f"fused cross-entropy backward (all {n_chunks} chunks, bf16 N{N} D{D} V{V}): {bwd_ms:.4f} ms; "
        f"library backward (autograd of the cuBLAS + F.cross_entropy pair, dh and dw over all rows) "
        f"{lib_bwd_ms:.4f} ms, library forward {lib_fwd_ms:.4f} ms")
    rows[0]["backward_ms_all_chunks"] = bwd_ms
    rows[0]["library_backward_ms_all_rows"] = lib_bwd_ms
    return rows


# ---------------------------------------------------------------------------
# phases 8 and 10: training, two loopback workers
# ---------------------------------------------------------------------------

# phase 8, config_150m: lr 1e-3 rather than the config default 4e-4, so that
# 8 steps from a random init move the loss well clear of step-to-step noise
TRAIN_150M = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=2,
                  total_steps=8, local_steps=4, lr=1e-3)
# phase 10, config_1b: 4 steps, 2 outer rounds (the host outer step moves
# 4.4 GB of f32 per worker); warmup 1 so that 3 of the 4 steps update
TRAIN_1B = dict(seq_length=1024, per_device_train_batch_size=8, total_batch_size=16, warmup_steps=1,
                total_steps=4, local_steps=2, lr=1e-3)


def phase_train(torch, tfa, dev, card: str, model: str, run: dict, compare: dict) -> dict:
    """Two DiLoCo workers, one thread each, run ``train()`` at ``model``'s
    full width and depth through the kernels (TrainerConfig defaults, so
    fused_loss resolves as a user gets it). The launch counters are
    zeroed just before and read just after. Masters are compared across
    workers after each outer round (at the next round's all-reduce, and at
    the end). Then one inner step under each of the two TrainerConfig
    variants in ``compare`` (the first is the path's own), on the same
    params and batch, each with one worker's steady inner-step time and
    peak device memory alone."""
    import hashlib
    import os
    import pickle
    import tempfile
    import threading

    from opendiloco_torch.config import Config
    from opendiloco_torch.diloco import LoopbackBackend, LoopbackWorld
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.ops import fused_xent as tfx
    from opendiloco_torch.train import train
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg = load_config(model)
    L, accum = cfg.num_hidden_layers, run["total_batch_size"] // run["per_device_train_batch_size"]

    def master_hash(master) -> str:
        h = hashlib.sha256()
        for m in master:
            h.update(memoryview(m).cast("B"))
        return h.hexdigest()

    class RecordingBackend(LoopbackBackend):
        """Loopback backend that hashes this worker's master as each round
        begins (the master the previous round left) and keeps its state
        provider for the final check."""

        def __init__(self, world, peer_id):
            super().__init__(world, peer_id)
            self.hashes: dict = {}
            self.provider = None

        def serve_state(self, get_state):
            self.provider = get_state
            super().serve_state(get_state)

        def all_reduce(self, arrays, *, epoch=None, **kw):
            if epoch:
                self.hashes[epoch - 1] = master_hash(self.provider()["master"])
            return super().all_reduce(arrays, epoch=epoch, **kw)

    world = LoopbackWorld(2)
    backends = [RecordingBackend(world, f"peer-{i}") for i in range(2)]
    tmp = tempfile.mkdtemp()
    summaries, errors = [None, None], []

    def config(rank):
        return Config(
            path_model=model, fake_data=True, fake_data_mode="ramp", precision="bf16-mixed", remat=True,
            seq_length=run["seq_length"], per_device_train_batch_size=run["per_device_train_batch_size"],
            total_batch_size=run["total_batch_size"], warmup_steps=run["warmup_steps"],
            total_steps=run["total_steps"], lr=run["lr"], metric_logger_type="dummy",
            project=os.path.join(tmp, f"metrics-{rank}.pkl"),
            diloco=dict(local_steps=run["local_steps"], backend="loopback", world_rank=rank,
                        timeout_waiting_for_peers=600.0),
        )

    def work(rank):
        try:
            summaries[rank] = train(config(rank), backends[rank], device=dev)
        except BaseException as e:
            errors.append(e)

    torch.cuda.reset_peak_memory_stats()
    tfa.LAUNCHES.reset()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    launches = tfa.LAUNCHES.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if errors:
        raise errors[0]
    steps = run["total_steps"]
    inner_steps = 2 * steps  # two workers
    want = {name: 0 for name in launches}
    want.update({"flash_attention_fwd": inner_steps * 2 * L * accum,
                 "flash_attention_dq": inner_steps * L * accum, "flash_attention_dkv": inner_steps * L * accum})
    fused = InnerTrainer(cfg, TrainerConfig(), device=dev).tc.fused_loss
    if fused:
        # per micro-batch one forward launch, and per backward chunk one
        # launch of each backward kernel
        chunks = -(-run["per_device_train_batch_size"] * (run["seq_length"] - 1) // tfx.CHUNK_ROWS)
        want["fused_xent_fwd"] = inner_steps * accum
        for name in ("fused_xent_dlog", "fused_xent_dh", "fused_xent_dw"):
            want[name] = inner_steps * accum * chunks
    if launches != want:
        raise AssertionError(f"training launch counts {launches} != {want}")

    rows = []
    for rank in range(2):
        with open(os.path.join(tmp, f"metrics-{rank}.pkl"), "rb") as f:
            rows.append(pickle.load(f))
        losses = [r["Loss"] for r in rows[rank]]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"worker {rank}: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"worker {rank}: last loss {losses[-1]} not below first {losses[0]}")
    rounds = steps // run["local_steps"]
    for b in backends:
        b.hashes[rounds - 1] = master_hash(b.provider()["master"])
    for r in range(rounds):
        if backends[0].hashes.get(r) is None or backends[0].hashes[r] != backends[1].hashes.get(r):
            raise AssertionError(f"masters differ after round {r}: {[b.hashes for b in backends]}")
    outer = {k: [r[k] for rr in rows for r in rr if "outer_step_s" in r]
             for k in ("outer_step_s", "outer_wait_s", "outer_allreduce_s")}
    outer_s = outer["outer_step_s"]
    if len(outer_s) != 2 * rounds:
        raise AssertionError(f"expected {2 * rounds} outer steps, got {outer_s}")
    hashes = [b.hashes for b in backends]
    del backends, world, summaries
    torch.cuda.empty_cache()

    # one inner step under each variant, same params and batch
    from opendiloco_torch.data.dataloader import FakeTokenizedDataset

    ds = iter(FakeTokenizedDataset(run["seq_length"], cfg.vocab_size, seed=7, mode="ramp"))
    ids = np.stack([next(ds)["input_ids"] for _ in range(run["total_batch_size"])])
    results, step_ms, peak_gib = {}, {}, {}
    for label, kw in compare.items():
        torch.cuda.reset_peak_memory_stats()
        tr = InnerTrainer(cfg, TrainerConfig(precision="bf16-mixed", remat=True, warmup_steps=2,
                                             total_steps=100, **kw), device=dev)
        state = tr.init_state(3)
        batch = tr.shard_batch(ids, ids.copy(), accum=accum)
        state, m = tr.train_step(state, batch)
        results[label] = (float(m["loss"]), float(m["grad_norm"]), tr.tc.fused_loss)
        # steady inner-step time of one worker alone (the first step above
        # carried the warm-up), and its peak device memory
        torch.cuda.synchronize()
        n = 3
        t1 = time.perf_counter()
        for _ in range(n):
            state, m = tr.train_step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms[label] = (time.perf_counter() - t1) / n * 1e3
        peak_gib[label] = torch.cuda.max_memory_allocated() / 2**30
        del tr, state, batch, m
        torch.cuda.empty_cache()
    step_s = next(iter(step_ms.values())) / 1e3
    (a, (kl, kg, kf)), (b, (pl_, pg, pf)) = results.items()
    # bf16: the two paths round attention probabilities and outputs, or the
    # logits' gradient, at different points; the loss (~10.6 at init)
    # agrees to 1e-3 and the gradient norm to 0.5% of itself
    if not (abs(kl - pl_) <= 1e-3 and abs(kg - pg) <= 5e-3 * pg):
        raise AssertionError(f"{a} vs {b} step: loss {kl} vs {pl_}, grad norm {kg} vs {pg}")
    tokens = run["total_batch_size"] * run["seq_length"]
    res = {
        "config": model, "layers": L, "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
        **run, "accum": accum, "workers": 2, "outer_rounds": rounds, "fused_loss": fused,
        "losses": [[r["Loss"] for r in rr] for rr in rows],
        "grad_norms": [[r["grad_norm"] for r in rr] for rr in rows],
        "launches": launches,
        "launches_per_inner_step": {k: v / inner_steps for k, v in launches.items()},
        "master_hashes": hashes,
        **outer,
        "train_wall_s": wall,
        "peak_memory_gib_two_workers": peak_gb,
        f"{a}_vs_{b}_step": {"loss": [kl, pl_], "grad_norm": [kg, pg], "fused_loss": [kf, pf],
                             "tol": "loss 1e-3 abs, grad norm 0.5% rel (bf16)"},
        "inner_step_ms_one_worker": step_s * 1e3,
        "tokens_per_s_one_worker": tokens / step_s,
        "inner_step_ms_one_worker_by_variant": step_ms,
        "peak_memory_gib_one_worker_by_variant": peak_gib,
    }
    log(f"train {model}: inner step {step_s * 1e3:.1f} ms (one worker alone, mb "
        f"{run['per_device_train_batch_size']} x accum {accum} x seq {run['seq_length']}) | {card}")
    log(f"train {model}: {tokens / step_s:.0f} training tokens/s (one worker alone) | {card}")
    log(f"train {model}: outer step {np.mean(outer_s):.3f} s mean over {len(outer_s)} (two workers; of it "
        f"waiting for the peer {np.mean(outer['outer_wait_s']):.3f} s, all-reduce "
        f"{np.mean(outer['outer_allreduce_s']):.3f} s) | {card}")
    log(f"train {model}: peak device memory {peak_gb:.2f} GiB (two workers on one card) | {card}")
    log(f"train {model}: one worker alone, {a} / {b}: inner step {step_ms[a]:.1f} / {step_ms[b]:.1f} ms, "
        f"peak device memory {peak_gib[a]:.2f} / {peak_gib[b]:.2f} GiB | {card}")
    log(f"train {model}: losses {res['losses']}; {a} vs {b} step loss {kl:.5f}/{pl_:.5f}, "
        f"grad norm {kg:.5f}/{pg:.5f}; launches {launches}")
    return res


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke runs on a CUDA card",
              file=sys.stderr)
        return 2
    from opendiloco_torch import quant
    from opendiloco_torch.config import ServeConfig
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.models.llama import init_params
    from opendiloco_torch.ops import build
    from opendiloco_torch.ops import decode_kernels as tdk
    from opendiloco_torch.ops import flash_attention as tfa
    from opendiloco_torch.ops import fused_xent as tfx

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    build_s = build.build(["paged_decode_attention", "w4_matmul", "flash_attention", "fused_xent"])
    log(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"kernel build {build_s:.2f} s | TF32 off for matmuls and cuDNN")

    cfg = load_config("1b")
    serve_cfg = ServeConfig()
    b6 = phase_b6(torch, tdk, cfg, serve_cfg, dev)
    b8 = phase_b8(torch, tdk, quant, cfg, dev)

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    serve = [phase_serve(torch, tdk, cfg, serve_cfg, params, dev)]
    serve.append(phase_serve(torch, tdk, cfg, ServeConfig(weight_format="w4"), params, dev))
    del params
    reference = phase_reference(torch, load_config("2m"), dev)
    torch.cuda.empty_cache()

    flash = phase_flash(torch, tfa, dev)
    train_150m = phase_train(torch, tfa, dev, card, "150m", TRAIN_150M,
                             {"kernels": dict(attn_impl="pallas"), "plain": dict(attn_impl="xla")})
    xent = phase_xent(torch, tfx, dev)
    train_1b = phase_train(torch, tfa, dev, card, "1b", TRAIN_1B, {"fused": {}, "unfused": dict(fused_loss=False)})

    for k in (b6, b8):
        k["launches"] = sum(s["launches"][k["name"]] for s in serve)
        k["launches_by_phase"] = {s["weight_format"]: s["launches"][k["name"]] for s in serve}
    # launches: this slice's path, the 1b training run; the 150m run's beside
    for k in (*flash, *xent):
        k["launches"] = train_1b["launches"][k["name"]]
        k["launches_per_inner_step"] = train_1b["launches_per_inner_step"][k["name"]]
        k["launches_by_phase"] = {"train 150m": train_150m["launches"][k["name"]],
                                  "train 1b": train_1b["launches"][k["name"]]}
    log(json.dumps({"serve": serve, "reference": reference, "train": [train_150m, train_1b],
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": [b6, b8, *flash, *xent]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
