"""The inner-step profile's bookkeeping (``opendiloco_torch.profile_inner_step``):
kernel names into groups, the union of busy intervals, the per-step
summary of a Chrome trace, and its device time by model-op span. The trace
of the card needs the card; these checks use hand-made events, and a CPU
trace of a tiny training step for the span names the code opens."""
import json

import numpy as np
import pytest
import torch

from opendiloco_torch.profile_inner_step import (
    MEMCPY, OTHER, busy_us, format_spans, group_of, short_name, span_table, summarize,
)
from opendiloco_torch.utils.spans import MODEL_SPANS, OUTER_SPANS, SPANS, TRAINER_SPANS, span

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "name,cat,group",
    [
        ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, true>(__nv_bfloat16 const*)", "kernel",
         "flash attention (B1, B2a, B2b, delta)"),
        ("void (anonymous namespace)::dkv_kernel<float, false>(float const*)", "kernel",
         "flash attention (B1, B2a, B2b, delta)"),
        ("void (anonymous namespace)::dq_sm90_kernel<64, __nv_bfloat16>(CUtensorMap_st, CUtensorMap_st)",
         "kernel", "flash attention (B1, B2a, B2b, delta)"),
        ("void (anonymous namespace)::dkv_sm90_kernel<128, float>(CUtensorMap_st, CUtensorMap_st)", "kernel",
         "flash attention (B1, B2a, B2b, delta)"),
        ("void (anonymous namespace)::fwd_sm90_kernel<64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "(anonymous namespace)::FwdArgs)", "kernel", "flash attention (B1, B2a, B2b, delta)"),
        ("void (anonymous namespace)::delta_kernel<__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
         "float*, int, int, int, long long, int)", "kernel", "flash attention (B1, B2a, B2b, delta)"),
        ("void (anonymous namespace)::delta_kernel<float>(float const*, float const*, float*, int, int, int, "
         "long long, int)", "kernel", "flash attention (B1, B2a, B2b, delta)"),
        ("void (anonymous namespace)::xent_fwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", "kernel",
         "fused cross-entropy (B3, B4a, B4b, dlog)"),
        ("void (anonymous namespace)::xent_gemm_kernel<__nv_bfloat16, float, false, false>(int)", "kernel",
         "fused cross-entropy (B3, B4a, B4b, dlog)"),
        ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>(Flash_fwd_params)", "kernel", OTHER),
        ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN", "kernel", "matmul (cuBLAS)"),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "kernel", "matmul (cuBLAS)"),
        ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "kernel",
         "softmax and cross-entropy"),
        ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<4>>", "kernel", "optimizer (_foreach)"),
        ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", "kernel", "reductions"),
        ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>", "kernel",
         "elementwise and copies"),
        ("void at::native::embedding_backward_feature_kernel<float>", "kernel", OTHER),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", MEMCPY),
    ],
)
def test_kernel_names_fall_into_their_groups(name, cat, group):
    assert group_of(name, cat) == group


@pytest.mark.parametrize(
    "name,short",
    [
        ("void (anonymous namespace)::delta_kernel<float>(float const*, float const*, float*, int)", "delta_kernel"),
        ("void (anonymous namespace)::fwd_sm90_kernel<64>(CUtensorMap_st, (anonymous namespace)::FwdArgs)",
         "fwd_sm90_kernel"),
        ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", "at::native::reduce_kernel"),
        ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN", "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN"),
        ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ],
)
def test_kernel_short_names_drop_namespaces_and_arguments(name, short):
    assert short_name(name) == short


def test_busy_time_is_the_union_of_intervals():
    # overlapping, nested, touching and disjoint intervals
    assert busy_us([(0, 10), (5, 15), (6, 7), (15, 20), (30, 35)]) == 25
    assert busy_us([]) == 0


def test_summary_is_per_step():
    events = [
        {"cat": "kernel", "name": "void (anonymous namespace)::fwd_kernel<float, true>", "ts": 0, "dur": 400},
        {"cat": "kernel", "name": "nvjet_tst_gemm", "ts": 500, "dur": 1000},
        {"cat": "gpu_memset", "name": "Memset (Device)", "ts": 1500, "dur": 100},
        {"cat": "kernel", "name": "nvjet_tst_gemm", "ts": 3000, "dur": 1000},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 5},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 400, "dur": 5},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50},
    ]
    s = summarize(events, steps=2, step_ms=2.0)
    assert s["device_busy_ms"] == pytest.approx(1.25)  # 2500 us over 2 steps
    assert s["device_window_ms"] == pytest.approx(2.0)  # 0 .. 4000 us over 2 steps
    assert s["idle_share_of_untraced_step"] == pytest.approx(1 - 1.25 / 2.0)
    assert s["kernel_launch_calls"] == 1
    mm = s["groups"]["matmul (cuBLAS)"]
    assert mm["ms"] == pytest.approx(1.0) and mm["events"] == 1 and mm["share_of_busy"] == pytest.approx(0.8)
    assert list(s["groups"])[0] == "matmul (cuBLAS)"  # longest group first
    assert s["top_kernels"][0] == {"name": "nvjet_tst_gemm", "ms": 1.0, "calls": 1.0,
                                   "group": "matmul (cuBLAS)"}
    # each group lists its kernels by function name, longest first
    assert mm["kernels"] == [{"name": "nvjet_tst_gemm", "ms": 1.0, "calls": 1.0}]
    flash = s["groups"]["flash attention (B1, B2a, B2b, delta)"]
    assert flash["kernels"] == [{"name": "fwd_kernel", "ms": 0.2, "calls": 0.5}]


def test_a_trace_without_device_events_raises():
    with pytest.raises(RuntimeError, match="no device events"):
        summarize([{"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5}], steps=1, step_ms=1.0)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


def test_span_table_ties_kernels_to_spans_and_backward_kernels_to_their_forward_op():
    gemm, add = "nvjet_tst_gemm", "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>"
    node = "autograd::engine::evaluate_function: "
    events = [
        # forward, thread 1: an op (sequence number 7) and a launch inside llama.qkv
        _x("user_annotation", "llama.qkv", 0, 100),
        _x("cpu_op", "aten::mm", 5, 15, **{"Sequence number": 7}),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _x("kernel", gemm, 1000, 50, correlation=1),
        # a launch outside every span
        _x("cuda_runtime", "cudaLaunchKernel", 400, 2, correlation=3),
        _x("kernel", add, 1100, 10, correlation=3),
        # backward, thread 2: the node of op 7 inside a wider span, and a
        # recompute span inside the node
        _x("user_annotation", "trainer.backward", 150, 400, tid=2),
        _x("cpu_op", node + "MmBackward0", 200, 100, tid=2, **{"Sequence number": 7}),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 2, tid=2, correlation=2),
        _x("kernel", gemm, 1200, 40, correlation=2),
        _x("user_annotation", "llama.rope", 220, 10, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 225, 2, tid=2, correlation=5),
        _x("kernel", add, 1300, 5, correlation=5),
        # a node whose forward op no span holds
        _x("cpu_op", node + "SumBackward0", 320, 20, tid=2, **{"Sequence number": 99}),
        _x("cpu_op", "aten::sum", 120, 5, **{"Sequence number": 99}),
        _x("cuda_runtime", "cudaLaunchKernel", 330, 2, tid=2, correlation=6),
        _x("gpu_memset", "Memset (Device)", 1400, 3, correlation=6),
    ]
    t = span_table(events, steps=1)
    assert t["llama.qkv"] == {"ms": 0.05, "groups": {"matmul (cuBLAS)": 0.05}}
    assert t["llama.qkv (backward)"] == {"ms": 0.04, "groups": {"matmul (cuBLAS)": 0.04}}
    assert t["llama.rope"]["groups"] == {"elementwise and copies": 0.005}
    assert t["(none)"]["ms"] == pytest.approx(0.01)
    assert t["SumBackward0 (backward, no span)"]["groups"] == {MEMCPY: 0.003}
    assert list(t)[0] == "llama.qkv"  # longest first
    assert span_table(events, steps=2)["llama.qkv"]["ms"] == pytest.approx(0.025)
    text = format_spans(t).splitlines()
    assert text[0].split()[:2] == ["span", "ms"] and text[1].startswith("llama.qkv ")
    # the summary carries the table
    assert summarize(events, steps=1, step_ms=1.0)["spans"] == t


def test_a_span_is_a_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    with span("llama.qkv") as a, span("llama.rope") as b:
        assert a is None and b is None
    assert len(set(SPANS)) == len(SPANS) == len(MODEL_SPANS) + len(TRAINER_SPANS) + len(OUTER_SPANS)


def test_a_cpu_trace_of_a_training_step_holds_every_span(tmp_path):
    """One DiLoCo step at tiny size on the CPU (one loopback worker, an
    outer step every step), with the fused loss and with the materialized
    one, under torch.profiler: the trace holds every span name of
    utils/spans.py, and the metric row the outer step's phase seconds."""
    from torch.profiler import ProfilerActivity, profile

    from opendiloco_torch.config import DilocoConfig
    from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
    from opendiloco_torch.models.llama import LlamaConfig
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
    ids = np.random.default_rng(0).integers(0, 256, (4, 33))
    names, outer = set(), []
    for fused in (True, False):
        tr = InnerTrainer(cfg, TrainerConfig(precision="bf16-mixed", remat=True, fused_loss=fused, warmup_steps=1,
                                             total_steps=10), device="cpu")
        state = tr.init_state(0)
        (backend,) = LoopbackWorld(1).make_backends()
        opt = DiLoCoOptimizer(tr, backend, DilocoConfig(local_steps=1, backend="loopback"), state, batch_size=4)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, m = opt.step(state, tr.shard_batch(ids, ids.copy(), accum=2))
        outer.append(m)
        trace = tmp_path / f"trace-{fused}.json"
        prof.export_chrome_trace(str(trace))
        names |= {e["name"] for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "user_annotation"}
    assert set(SPANS) <= names, sorted(set(SPANS) - names)
    for m in outer:
        phases = [m[k] for k in ("outer_d2h_s", "outer_pseudo_grad_s", "outer_allreduce_s", "outer_nesterov_s",
                                 "outer_h2d_s")]
        assert all(0.0 <= p <= m["outer_step_s"] for p in phases)
