"""Weight hot swap of the port's serving plane against the JAX package's.

The same numpy weights, drawn from a seed, go to both packages at
``tiny_cfg`` size, f32 on the CPU (the port's kernel wrappers take their
plain versions; the JAX engine runs ``decode_kernel="xla"``). The patterns
are those of ``tests/test_serve.py``: a swap between decode steps changes
no KV entry, a loaded batcher drops nothing across swaps, the optimizer's
wire snapshot is the JAX optimizer's byte for byte, and an installed
snapshot leaves the engine with the JAX engine's weights (dense leaves
exactly, the w4 fast path's packed bits bit for bit). A training run with
``serve.enabled`` answers HTTP while it trains, and its losses equal
those of the same run without serving, bit for bit. Loopback compression
holds the port's master trajectory to the JAX package's.
"""
import json
import pickle
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu import native as jnative
from opendiloco_torch import native as tnative
from opendiloco_tpu.config import DilocoConfig as JDilocoConfig
from opendiloco_tpu.diloco import DiLoCoOptimizer as JDiLoCoOptimizer
from opendiloco_tpu.diloco import LoopbackWorld as JLoopbackWorld
from opendiloco_tpu.diloco.compression import get_codec as jget_codec
from opendiloco_tpu.diloco.compression import pack_blockwise4_stacked as jax_pack
from opendiloco_tpu.diloco.outer_optimizer import OuterSGD as JOuterSGD
from opendiloco_tpu.parallel.mesh import build_mesh
from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch import serve as tserve
from opendiloco_torch.config import DilocoConfig, ServeConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld, OuterSGD
from opendiloco_torch.diloco.compression import split_blockwise4_stacked
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.serve import ContinuousBatcher, ServeEngine, build_serving
from opendiloco_torch.train import train
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from test_torch_serve_engine import GEOMETRY, _generate, _np_params
from test_torch_train import _torch_diloco_workers, _train_config

torch.set_num_threads(2)


@pytest.fixture
def cfg(tiny_cfg):
    return tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())


def _port(cfg, params, **kw):
    return ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **{**GEOMETRY, **kw})


def _jax(tiny_cfg, params, **kw):
    return JServeEngine(tiny_cfg, params, compute_dtype=jnp.float32, decode_kernel="xla", **{**GEOMETRY, **kw})


def _blobs(params, codec_name):
    """A wire snapshot of ``params`` in flatten_params order, encoded by the
    JAX package's codec (the port's gives the same bytes)."""
    codec = jget_codec(codec_name)
    out = []
    for leaf in tllama.flatten_params(params):
        payload, meta = codec.encode(np.asarray(leaf, np.float32).reshape(-1))
        out.append((bytes(payload), meta, tuple(np.shape(leaf))))
    return out


def _leaves(tree):
    """Engine weights as numpy, packed leaves as (q, s as uint16)."""
    out = []
    for x in tllama.flatten_params(tree) if isinstance(tree, dict) else tree:
        if isinstance(x, tllama.PackedW4):
            out.append((x.q.numpy(), x.s.numpy().view(np.uint16)))
        elif hasattr(x, "q"):
            out.append((np.asarray(x.q), np.asarray(x.s)))
        else:
            out.append(np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32))
    return out


def _jax_leaves(engine):
    return _leaves(jax.tree.leaves(engine.params, is_leaf=lambda x: hasattr(x, "q")))


def _assert_same_leaves(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, tuple):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        else:
            assert a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _step(engine, tokens, lens, spec):
    """One decode step (or spec round) for slot 0; returns (emitted tokens,
    fresh tokens/lens arrays for the next call)."""
    if spec:
        g, m = engine.spec_step(tokens, lens)
        out = [int(t) for t in g[0, : int(m[0]) + 1]]
    else:
        nxt, _ = engine.decode_step(tokens, lens)
        out = [int(nxt[0])]
    tokens, lens = tokens.copy(), lens.copy()
    tokens[0], lens[0] = out[-1], lens[0] + len(out)
    return out, tokens, lens


@pytest.mark.parametrize("spec_k", [0, 2], ids=["decode", "spec"])
def test_swap_mid_decode_changes_no_kv_entries(tiny_cfg, cfg, spec_k):
    """install_wire between decode steps leaves every KV byte as it was,
    the weights change, and decoding goes on under the new weights: token
    for token what the JAX engine emits through the same swap."""
    p1, p2 = _np_params(cfg, 0), _np_params(cfg, 123)
    blobs = _blobs(p2, "fp16")
    streams = []
    for make in (lambda: _port(cfg, p1, spec_k=spec_k), lambda: _jax(tiny_cfg, p1, spec_k=spec_k)):
        engine = make()
        tok, _ = engine.admit(0, [4, 8, 15, 16])
        S = engine.num_slots
        tokens, lens = np.zeros((S,), np.int32), np.zeros((S,), np.int32)
        tokens[0], lens[0] = tok, 4
        out, tokens, lens = _step(engine, tokens, lens, spec_k)
        stream = [tok, *out]
        if isinstance(engine, ServeEngine):
            ck, cv = engine.cache_k.clone(), engine.cache_v.clone()
            old = _leaves(engine.params)
        engine.install_wire(1, blobs, "fp16")
        assert (engine.weights_epoch, engine.swap_count) == (1, 1)
        if isinstance(engine, ServeEngine):
            assert torch.equal(engine.cache_k.view(torch.int32), ck.view(torch.int32))
            assert torch.equal(engine.cache_v.view(torch.int32), cv.view(torch.int32))
            assert any(not np.array_equal(a, b) for a, b in zip(old, _leaves(engine.params)))
        for _ in range(3):
            out, tokens, lens = _step(engine, tokens, lens, spec_k)
            stream += out
        streams.append(stream)
    assert streams[0] == streams[1]


def test_hot_swap_under_load_drops_nothing(cfg):
    """Swaps fire while requests are in flight: every request completes,
    the engine ends on the newest epoch, and the batcher's stats report
    the swaps and the staleness of every decode step."""
    params = _np_params(cfg, 0)
    engine = _port(cfg, params, num_slots=4, max_context=64, prefill_buckets=(8, 16, 32))
    box = {"epoch": 0}
    engine.epoch_fn = lambda: box["epoch"]
    engine.snapshot_fn = lambda: (box["epoch"], _blobs(params, "fp16"), "fp16")
    batcher = ContinuousBatcher(engine, swap_every_steps=2).start()
    try:
        rng = np.random.default_rng(3)
        reqs = []
        for i in range(8):
            reqs.append(batcher.submit(rng.integers(1, 256, 5).tolist(), max_new_tokens=6))
            if i in (2, 5):
                box["epoch"] += 1  # the trainer finishes an outer round
            time.sleep(0.01)
        for r in reqs:
            assert r.wait(60) and r.error is None
        deadline = time.monotonic() + 10
        while engine.weights_epoch != box["epoch"] and time.monotonic() < deadline:
            time.sleep(0.01)  # the idle loop catches up with the last round
    finally:
        batcher.stop()
    st = batcher.stats()
    assert batcher.failed == 0 and st["failed"] == 0
    assert engine.swap_count >= 1 and engine.weights_epoch == box["epoch"] == 2
    assert (st["weight_swaps"], st["weights_epoch"], st["staleness"]) == (engine.swap_count, 2, 0)
    assert sum(st["staleness_hist"].values()) == st["decode_steps"] > 0
    assert all(isinstance(k, int) for k in st["staleness_hist"])
    assert st["stages_s"]["swap"] > 0 and len(engine.swap_log) == engine.swap_count
    for swap in engine.swap_log:
        assert swap["codec"] == "fp16" and swap["total_s"] >= swap["encode_s"] + swap["decode_s"]
        assert set(swap) == {"epoch", "codec", "encode_s", "decode_s", "h2d_s", "pack_s", "total_s"}
    assert engine.swap_seconds == pytest.approx(sum(swap["total_s"] for swap in engine.swap_log))


# ---------------------------------------------------------------------------
# the optimizer's snapshot export
# ---------------------------------------------------------------------------


def _port_opt(cfg, params, local_steps=2, compression="none", world=None):
    tc = TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp32", remat=False)
    trainer = InnerTrainer(cfg, tc, device="cpu")
    state = trainer.init_state(params=params)
    dcfg = DilocoConfig(local_steps=local_steps, backend="loopback", compression=compression)
    backend = (world or LoopbackWorld(1)).make_backends()[0]
    return DiLoCoOptimizer(trainer, backend, dcfg, state, batch_size=8), trainer, state


def _jax_opt(tiny_cfg, params, compression="none"):
    tc = JTrainerConfig(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp32", remat=False)
    trainer = JInnerTrainer(tiny_cfg, tc, build_mesh("NO_SHARD", devices=[jax.devices()[0]]))
    state = trainer.init_state(jax.random.key(1), params)
    dcfg = JDilocoConfig(local_steps=2, backend="loopback", outer_placement="host", compression=compression)
    return JDiLoCoOptimizer(trainer, JLoopbackWorld(1).make_backends()[0], dcfg, state, batch_size=8)


def _assert_same_snapshots(got, want):
    (te, tblobs, tname), (je, jblobs, jname) = got, want
    assert (te, tname) == (je, jname) and len(tblobs) == len(jblobs)
    for (tp, tm, ts), (jp, jm, js) in zip(tblobs, jblobs):
        assert bytes(tp) == bytes(jp) and tm == jm and tuple(ts) == tuple(js)


@pytest.mark.parametrize("compression", ["none", "scaled-fp16", "blockwise8bit"])
def test_master_snapshot_wire_fp16(tiny_cfg, cfg, compression, monkeypatch):
    """The state codec of the configured compression (fp16 unless that is
    an fp16-family codec): half-width payloads equal to the JAX
    optimizer's for the same masters, and master_snapshot hands out the
    master's own arrays."""
    monkeypatch.delenv("ODTP_STATE_CODEC", raising=False)
    params = _np_params(cfg, 4)
    opt, _, _ = _port_opt(cfg, params, compression=compression)
    snap = opt.master_snapshot_wire()
    _assert_same_snapshots(snap, _jax_opt(tiny_cfg, params, compression).master_snapshot_wire())
    epoch, blobs, name = snap
    assert epoch == 0 and name == ("scaled-fp16" if compression == "scaled-fp16" else "fp16")
    _, masters = opt.master_snapshot()
    assert all(m is o for m, o in zip(masters, opt.master))
    for (payload, _, shape), m in zip(blobs, masters):
        assert len(payload) == 2 * m.size and tuple(shape) == m.shape


@pytest.mark.parametrize("codec", ["none", "blockwise4bit", "uniform8bit"])
def test_master_snapshot_wire_codec_override(tiny_cfg, cfg, codec, monkeypatch):
    monkeypatch.setenv("ODTP_STATE_CODEC", codec)
    # the JAX side on its fallback and the port on its plain bodies (the
    # two paths' uniform8bit metas differ: ROADMAP.md C4)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(tnative, "_plain", True)
    params = _np_params(cfg, 5)
    opt, _, _ = _port_opt(cfg, params)
    snap = opt.master_snapshot_wire()
    _assert_same_snapshots(snap, _jax_opt(tiny_cfg, params).master_snapshot_wire())
    assert snap[2] == codec
    if codec == "none":
        _, masters = opt.master_snapshot()
        for (payload, _, shape), m in zip(snap[1], masters):
            assert np.array_equal(np.frombuffer(payload, np.float32).reshape(shape), m)


def test_snapshot_feeds_engine_swap(tiny_cfg, cfg, monkeypatch):
    """The optimizer's wire snapshot installs into the engine, which then
    holds exactly the JAX engine's weights after the same install: both
    decode the same bytes to f32 on the host."""
    monkeypatch.delenv("ODTP_STATE_CODEC", raising=False)
    params = _np_params(cfg, 6)
    opt, _, _ = _port_opt(cfg, params)
    epoch, blobs, name = opt.master_snapshot_wire()
    port, jeng = _port(cfg, _np_params(cfg, 9)), _jax(tiny_cfg, _np_params(cfg, 9))
    port.install_wire(epoch + 1, blobs, name)
    jeng.install_wire(epoch + 1, blobs, name)
    got = _leaves(port.params)
    _assert_same_leaves(got, _jax_leaves(jeng))
    for g, m in zip(got, opt.master):
        assert np.array_equal(g, m.astype(np.float16).astype(np.float32))


def test_install_wire_checks_leaves_like_jax(cfg):
    engine = _port(cfg, _np_params(cfg))
    blobs = _blobs(_np_params(cfg, 1), "fp16")
    with pytest.raises(ValueError, match="leaves"):
        engine.install_wire(1, blobs[:-1], "fp16")
    payload, meta, shape = blobs[0]
    with pytest.raises(ValueError, match="shape"):
        engine.install_wire(1, [(payload, meta, shape[::-1] + (1,)), *blobs[1:]], "fp16")
    assert engine.weights_epoch == 0 and engine.swap_count == 0


def test_install_wire_w4_fast_path(tiny_cfg, cfg):
    """A blockwise4bit snapshot into a w4 engine: the packed leaves whose
    per-layer size is a whole number of codec blocks are re-sliced from
    the payload (the codec's own bits), the others repacked, and every
    packed q and s equals the JAX engine's bit for bit; the greedy tokens
    after the swap equal the JAX engine's."""
    p1, p2 = _np_params(cfg, 0), _np_params(cfg, 77)
    blobs = _blobs(p2, "blockwise4bit")
    port, jeng = _port(cfg, p1, weight_format="w4"), _jax(tiny_cfg, p1, weight_format="w4")
    times = port.install_wire(1, blobs, "blockwise4bit")
    jeng.install_wire(1, blobs, "blockwise4bit")
    assert set(times) == {"decode_s", "h2d_s", "pack_s"}
    got = _leaves(port.params)
    _assert_same_leaves(got, _jax_leaves(jeng))
    aligned = 0
    for leaf, (payload, meta, shape) in zip(got, blobs):
        if isinstance(leaf, tuple):
            res = split_blockwise4_stacked(payload, meta, shape[0], int(np.prod(shape[1:])))
            if res is not None:
                aligned += 1
                assert np.array_equal(leaf[0], res[0]) and np.array_equal(leaf[1], res[1])
    assert aligned  # the fast path ran on this geometry
    prompt = [1, 2, 3]
    assert _generate(port, prompt, 6) == _generate(jeng, prompt, 6)


def test_install_wire_fp16_into_w4_repacks_like_jax(tiny_cfg, cfg):
    """The slow path: an fp16 snapshot into a w4 engine decodes on the host
    and packs the f32 values, giving the JAX package's packing."""
    p1, p2 = _np_params(cfg, 0), _np_params(cfg, 31)
    blobs = _blobs(p2, "fp16")
    port, jeng = _port(cfg, p1, weight_format="w4"), _jax(tiny_cfg, p1, weight_format="w4")
    port.install_wire(2, blobs, "fp16")
    jeng.install_wire(2, blobs, "fp16")
    got = _leaves(port.params)
    _assert_same_leaves(got, _jax_leaves(jeng))
    for leaf, x in zip(got, tllama.flatten_params(p2)):
        if isinstance(leaf, tuple):
            q, s = jax_pack(x.astype(np.float16).astype(np.float32))
            assert np.array_equal(leaf[0], q) and np.array_equal(leaf[1], s)
    assert _generate(port, [9, 8, 7], 5) == _generate(jeng, [9, 8, 7], 5)


def test_build_serving_with_diloco_swaps_live(cfg, monkeypatch):
    """build_serving end to end on the port's optimizer, trainer and
    loopback world: training advances outer epochs in a thread while the
    plane completes requests and hot-swaps."""
    monkeypatch.delenv("ODTP_STATE_CODEC", raising=False)
    params = _np_params(cfg, 2)
    opt, trainer, state = _port_opt(cfg, params, local_steps=2)
    scfg = ServeConfig(enabled=True, max_batch=2, max_context=64, prefill_buckets=[16], swap_every_steps=1)
    plane = build_serving(scfg, cfg, state["params"], opt, compute_dtype=torch.float32, device="cpu",
                          start_server=False)
    try:
        assert plane.server is None and plane.port is None
        rng = np.random.default_rng(0)

        def train_loop():
            s = state
            for _ in range(4):  # 2 outer epochs
                ids = rng.integers(0, 256, (8, 16)).astype(np.int32)
                s, _ = opt.step(s, trainer.shard_batch(ids, ids.copy(), 1))

        t = threading.Thread(target=train_loop)
        t.start()
        reqs = [plane.batcher.submit(rng.integers(1, 256, 4).tolist(), max_new_tokens=5) for _ in range(6)]
        t.join(timeout=120)
        for r in reqs:
            assert r.wait(120) and r.error is None
        extra = plane.batcher.submit([1, 2, 3], max_new_tokens=3)
        assert extra.wait(60) and extra.error is None
        deadline = time.monotonic() + 10
        while plane.engine.weights_epoch != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        plane.stop()
    assert opt.epoch == 2 and plane.engine.weights_epoch == 2
    assert plane.engine.swap_count >= 1 and plane.batcher.failed == 0
    # the served weights are the last masters through the fp16 codec
    for g, m in zip(_leaves(plane.engine.params), opt.master):
        assert np.array_equal(g, m.astype(np.float16).astype(np.float32))


# ---------------------------------------------------------------------------
# train() with serve.enabled
# ---------------------------------------------------------------------------


def _post(port, payload, timeout=60.0) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def _run_two_workers(tmp_path, serve: bool, monkeypatch, serve_extra=None):
    """Two loopback workers through train() (2m, local_steps 2); with
    ``serve`` worker 0 serves (``serve_extra``: more ServeConfig fields) and
    a client posts /generate over HTTP until both workers return. Returns
    (losses by worker, client responses, polled /healthz and /stats
    bodies)."""
    planes = []
    if serve:
        real = tserve.build_serving

        def capture(*args, **kwargs):
            planes.append(real(*args, **kwargs))
            return planes[-1]

        monkeypatch.setattr(tserve, "build_serving", capture)
    world = LoopbackWorld(2)
    backends = world.make_backends()
    run = dict(total_steps=16, diloco=dict(local_steps=2, backend="loopback", timeout_waiting_for_peers=60.0))
    serve_cfg = dict(enabled=True, max_batch=2, max_context=64, prefill_buckets=[16, 32], swap_every_steps=1,
                     max_stale_rounds=0, port=0, **(serve_extra or {}))
    errors = []

    def work(rank):
        try:
            d = {**run["diloco"], "world_rank": rank}
            extra = {"serve": serve_cfg} if serve and rank == 0 else {}
            train(_train_config(tmp_path / ("serve" if serve else "plain"), rank, total_steps=run["total_steps"],
                                diloco=d, **extra), backends[rank], device="cpu")
        except Exception as e:  # pragma: no cover
            errors.append(e)

    (tmp_path / ("serve" if serve else "plain")).mkdir()
    threads = [threading.Thread(target=work, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    responses, polled = [], []
    if serve:
        rng = np.random.default_rng(8)
        deadline = time.monotonic() + 60
        while not planes and time.monotonic() < deadline:
            time.sleep(0.005)
        port = planes[0].port
        while any(t.is_alive() for t in threads):
            prompt = rng.integers(1, 1024, int(rng.integers(3, 30))).tolist()
            try:
                responses.append(_post(port, {"prompt": prompt, "max_new_tokens": 6}))
            except urllib.error.URLError:
                # refused only once the run has ended and stopped the server
                for t in threads:
                    t.join(timeout=300)
                assert planes[0].server._stop.is_set()
                break
            if len(responses) % 4 == 0:
                for path in ("/healthz", "/stats"):
                    try:
                        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                            polled.append(json.loads(r.read()))
                    except OSError:
                        pass  # the run ended and the server stopped
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    losses = []
    for rank in range(2):
        with open(tmp_path / ("serve" if serve else "plain") / f"metrics-{rank}.pkl", "rb") as f:
            losses.append([r["Loss"] for r in pickle.load(f)])
    return losses, responses, polled, planes


def test_train_serves_http_and_trains_bit_for_bit(tmp_path, monkeypatch):
    """Worker 0 of a two-worker run serves over HTTP while it trains: the
    responses come from at least two weight epochs, the only error a
    client may see is "server stopped" (requests in flight when the run
    ends), and both workers' losses equal those of the run without
    serving, bit for bit."""
    monkeypatch.delenv("ODTP_STATE_CODEC", raising=False)
    plain, _, _, _ = _run_two_workers(tmp_path, False, monkeypatch)
    served, responses, polled, planes = _run_two_workers(tmp_path, True, monkeypatch)
    assert served == plain and len(served[0]) == 16
    ok = [r for r in responses if "error" not in r]
    assert all(r["error"] == "server stopped" for r in responses if "error" in r)
    assert ok and all(len(r["tokens"]) == 6 for r in ok)
    assert len({r["epoch"] for r in ok}) >= 2, sorted({r["epoch"] for r in ok})
    (plane,) = planes
    assert plane.engine.swap_count >= 1 and plane.engine.device.type == "cpu"
    assert any("weights_epoch" in p and "free_slots" in p for p in polled)
    assert any("staleness_hist" in p for p in polled)


# ---------------------------------------------------------------------------
# loopback compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["blockwise4bit", "uniform8bit", "fp16"])
def test_loopback_codec_master_trajectory_matches_jax(codec, monkeypatch):
    """Two workers, three outer rounds, the same f32 pseudo-gradients in
    both packages: each round's all-reduce through the world's codec and
    the Nesterov step give the JAX package's masters bit for bit. The JAX
    side runs its numpy fallback: its native outer step is a fused kernel
    that rounds differently from the numpy body (both packages' tests
    hold that one to rtol 1e-6), and its native uniform8bit meta differs
    from its fallback's (ROADMAP.md C4), so the port runs its plain
    bodies."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(tnative, "_plain", True)
    shapes = [(64, 96), (4097,), (3, 5)]
    rng = np.random.default_rng(11)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[[(1e-3 * rng.standard_normal(s)).astype(np.float32) for s in shapes] for _ in range(2)]
             for _ in range(3)]

    def trajectory(world, sgd_cls):
        backends = world.make_backends()
        out, errors = [[] for _ in backends], []

        def worker(r):
            try:
                master, sgd = [m.copy() for m in init], sgd_cls()
                for k in range(3):
                    averaged, n = backends[r].all_reduce(grads[k][r], epoch=k, timeout=60)
                    assert n == 2
                    master = [m.copy() for m in master]
                    sgd.step(master, averaged)
                    out[r].append(master)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        return out

    got = trajectory(LoopbackWorld(2, compression=codec), OuterSGD)
    want = trajectory(JLoopbackWorld(2, compression=codec), JOuterSGD)
    assert LoopbackWorld(2, compression=codec).codec.name == codec
    for rank in range(2):
        for tm, jm in zip(got[rank], want[rank]):
            for a, b in zip(tm, jm):
                assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # the codec is lossy: the trajectory is not the uncompressed one
    plain = trajectory(LoopbackWorld(2), OuterSGD)
    assert not all(np.array_equal(a, b) for a, b in zip(got[0][-1], plain[0][-1]))


@pytest.mark.parametrize("codec", ["blockwise4bit", "uniform8bit"])
def test_two_worker_compressed_run_matches_jax_losses(tiny_cfg, codec):
    """train loops of two loopback workers with a lossy codec against the
    JAX package's from the same init: losses within the rtol 1e-5 of
    tests/test_torch_train.py::test_two_worker_diloco_matches_jax_loopback.
    Its params tolerance (atol 1e-5) does not carry over: the two
    trainers' f32 pseudo-gradients differ in their last bits, and where an
    element sits at a quantization boundary the two sides pick
    neighbouring codes, one quantization step apart (a few elements of
    the 107k: 3.8e-4 apart under blockwise4bit, 2.1e-5 under
    uniform8bit). The codec itself is held bit for bit on equal inputs by
    test_loopback_codec_master_trajectory_matches_jax."""
    from test_diloco import make_trainer, run_diloco_workers

    params = jax.device_get(make_trainer(tiny_cfg).init_state(jax.random.key(7))["params"])
    jres = run_diloco_workers(tiny_cfg, 2, 8, 4, compression=codec)
    tres, masters = _torch_diloco_workers(tiny_cfg, params, 2, 8, 4, compression=codec)
    for (jl, _), (tl, _) in zip(jres, tres):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # every round leaves both workers with the same master, bit for bit
    assert len(masters[0]) == len(masters[1]) == 2
    for m0, m1 in zip(*masters):
        assert all(np.array_equal(a, b) for a, b in zip(m0, m1))
