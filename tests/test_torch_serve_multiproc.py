"""Serving on a worker of several processes: ``train()`` with
``serve.enabled`` over two gloo ranks, under FULL_SHARD and under pp 2, on
the CPU.

Every rank builds its serving plane, as the JAX package's ``train()`` does
at any process count, from the whole params gathered on every rank, and
serves on a port of its own. Each rank's server answers a greedy request
before the first step with the tokens of the single-process port engine
and of the JAX engine on the same params (token for token: f32, the plain
paths). After each round the serving thread installs the new epoch, and
both ranks end on the same epoch with the same weights, each its own host
master bit for bit (snapshots raw f32). Every collective of the run is
issued by the main thread: the serving thread's snapshots read host
masters only (a collective from it could interleave with the training
thread's on the same group and hang).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
from opendiloco_tpu.models import hf_io as jhf_io
from opendiloco_torch.models import hf_io, llama as tllama
from opendiloco_torch.serve import ServeEngine
from torch_dist_child import spawn

torch.set_num_threads(2)

PROMPT = [5, 17, 3, 99, 42, 7, 300, 12, 8]
NEW_TOKENS = 8
GEOMETRY = dict(num_slots=2, max_context=64, prefill_buckets=(16, 32))
CASES = {"FULL_SHARD": ("FULL_SHARD", {}), "pp2": ("NO_SHARD", {"pp_size": 2})}


def _greedy(engine, prompt, n):
    tok, _ = engine.admit(0, prompt)
    toks, cache_len = [tok], len(prompt)
    while len(toks) < n:
        tokens = np.zeros((engine.num_slots,), np.int32)
        lens = np.zeros((engine.num_slots,), np.int32)
        tokens[0], lens[0] = toks[-1], cache_len
        nxt, _ = engine.decode_step(tokens, lens)
        toks.append(int(nxt[0]))
        cache_len += 1
    return toks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_multiproc")
    cfg = hf_io.load_config("2m")
    rng = np.random.default_rng(8)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.05)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    params = draw(tllama.shapes(cfg))
    model_dir = str(tmp / "2m")
    hf_io.save_params(params, cfg, model_dir)
    spec = dict(model_dir=model_dir, prompt=PROMPT, new_tokens=NEW_TOKENS, cases=CASES)
    return cfg, params, spawn("serve", 2, spec, tmp, timeout=300)


def test_each_rank_serves_the_single_process_tokens(ranks):
    cfg, params, got = ranks
    port = _greedy(ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **GEOMETRY), PROMPT,
                   NEW_TOKENS)
    jeng = JServeEngine(jhf_io.load_config("2m"), params, compute_dtype=jnp.float32, decode_kernel="xla",
                        **GEOMETRY)
    assert _greedy(jeng, PROMPT, NEW_TOKENS) == port
    for case in CASES:
        assert [r[case]["tokens"] for r in got] == [port, port], case
        assert got[0][case]["port"] != got[1][case]["port"]  # a server each


@pytest.mark.parametrize("case", list(CASES))
def test_both_ranks_install_each_round_from_host_masters(ranks, case):
    _, _, got = ranks
    for r in got:
        assert r[case]["swapped"] == [1, 2] and r[case]["epoch"] == r[case]["opt_epoch"] == 2
        for e, m in zip(r[case]["engine"], r[case]["master"]):
            np.testing.assert_array_equal(e, m)
    assert got[0][case]["digest"] == got[1][case]["digest"]
    for a, b in zip(got[0][case]["engine"], got[1][case]["engine"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_no_collective_leaves_the_main_thread(ranks, case):
    for r in ranks[2]:
        assert r[case]["threads"] == ["MainThread"], r[case]["threads"]
