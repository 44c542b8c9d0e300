"""The inner-step profile's bookkeeping (``opendiloco_torch.profile_inner_step``):
kernel names into groups, the union of busy intervals, and the per-step
summary of a Chrome trace. The trace itself needs the card; these checks
use hand-made events."""
import pytest

from opendiloco_torch.profile_inner_step import MEMCPY, OTHER, busy_us, group_of, summarize


@pytest.mark.parametrize(
    "name,cat,group",
    [
        ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, true>(__nv_bfloat16 const*)", "kernel",
         "flash attention (B1, B2a, B2b)"),
        ("void (anonymous namespace)::dkv_kernel<float, false>(float const*)", "kernel",
         "flash attention (B1, B2a, B2b)"),
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


def test_a_trace_without_device_events_raises():
    with pytest.raises(RuntimeError, match="no device events"):
        summarize([{"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5}], steps=1, step_ms=1.0)
