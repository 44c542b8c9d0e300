"""One rank of a CPU process group for the port's sharding tests.

``python tests/torch_dist_child.py JOB RANK WORLD STORE SPEC OUT`` joins a
gloo group of WORLD processes through the ``file://`` store STORE, runs
JOB with the pickled SPEC and pickles this rank's result to OUT. It
imports the port alone (no JAX), so a spawn of several ranks starts fast;
the tests hold the results against the JAX package in their own process.
"""
import os
import pickle
import sys


def _cfg(spec):
    from opendiloco_torch.models.llama import LlamaConfig

    return LlamaConfig(**spec["cfg"])


def rank_rows(plan, a, accum=None):
    """This rank's rows of a global [bs, T] batch, as the JAX batch spec
    cuts it: of each of ``accum`` micro-batches, or of the whole batch
    (``accum`` None). The batch itself at one rank."""
    import numpy as np

    from opendiloco_torch.parallel.sharding import local_block

    n, r = plan.data_parallel_size, plan.batch_index
    if accum is None:
        return np.ascontiguousarray(local_block(a, 0, n, r))
    bs, t = a.shape
    return np.ascontiguousarray(local_block(a.reshape(accum, bs // accum, t), 1, n, r)).reshape(-1, t)


def job_strategies(spec: dict) -> dict:
    """Every case of ``spec["cases"]`` (strategy, mesh kwargs and optionally
    TrainerConfig overrides): a fresh trainer on the same numpy params and
    global batches, each rank handed its rows; the losses and grad norms
    of each step, the whole params and moments after the last
    (``gather_state``, a checkpoint's layout), this rank's leaf shapes, the
    eval loss and probes of ``spec["eval"]``, and after each step a digest
    of every leaf this rank holds whole over tp and pp (``"whole"``: the
    same bits on every tp rank and pp stage)."""
    import hashlib

    from opendiloco_torch.models.llama import flatten_params
    from opendiloco_torch.parallel.mesh import build_mesh
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg = _cfg(spec)
    out = {}
    for name, (strategy, kw, *tc) in spec["cases"].items():
        plan = build_mesh(strategy, **kw)
        trainer = InnerTrainer(cfg, TrainerConfig(**{**spec["tc"], **(tc[0] if tc else {})}), device="cpu",
                               plan=plan)
        state = trainer.init_state(params=spec["params"])
        shapes = {"params": [tuple(p.shape) for p in flatten_params(state["params"])],
                  "mu": [tuple(m.shape) for m in state["opt_state"]["mu"]]}
        losses, norms, whole = [], [], []
        uncut = [i for i, dims in enumerate(zip(trainer.mp_dims["tp"], trainer.mp_dims["pp"]))
                 if dims == (None, None)]
        for ids, labels in spec["batches"]:
            rows = [rank_rows(plan, a, spec["accum"]) for a in (ids, labels)]
            state, m = trainer.train_step(state, trainer.shard_batch(*rows, accum=spec["accum"]))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            leaves = flatten_params(state["params"])
            whole.append({i: hashlib.sha1(leaves[i].detach().numpy().tobytes()).hexdigest() for i in uncut})
        full = trainer.gather_state(state)
        out[name] = {
            "losses": losses, "norms": norms, "shapes": shapes, "whole": whole,
            "params": [p.detach().numpy().copy() for p in flatten_params(full["params"])],
            "mu": [m.numpy().copy() for m in full["opt_state"]["mu"]],
            "nu": [v.numpy().copy() for v in full["opt_state"]["nu"]],
            "eval": trainer.eval_loss(state["params"], *(rank_rows(plan, a) for a in spec["eval"])),
            "probe": trainer.probe_norms(state["params"], rank_rows(plan, spec["eval"][0])),
        }
    return out


def job_moe_pp(spec: dict) -> dict:
    """Each case of ``spec["cases"]`` (strategy, mesh kwargs, TrainerConfig
    overrides) on one global batch ``spec["batch"]``, each rank handed its
    rows: the loss of the pipeline step (scale 1), the whole gradients
    summed over the ranks, and from the pipelined forward without
    gradients the MoE aux and the tokens dropped by capacity of each
    (micro-batch, layer of this stage), summed over the data group."""
    import torch

    from opendiloco_torch.models import llama
    from opendiloco_torch.models.llama import flatten_params
    from opendiloco_torch.parallel.comm import all_reduce_
    from opendiloco_torch.parallel.mesh import build_mesh
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    cfg = _cfg(spec)
    out = {}
    for name, (strategy, kw, tc) in spec["cases"].items():
        plan = build_mesh(strategy, **kw)
        trainer = InnerTrainer(cfg, TrainerConfig(**{**spec["tc"], **tc}), device="cpu", plan=plan)
        state = trainer.init_state(params=spec["params"])
        batch = trainer.shard_batch(*(rank_rows(plan, a, 1) for a in spec["batch"]), accum=1)
        ids, labels = batch["input_ids"][0], batch["labels"][0]
        params = state["params"]
        loss, grads = trainer._pp_loss_grads(params, flatten_params(params), ids, labels, 1.0)
        loss = trainer._pp.broadcast(loss.detach(), trainer._pp.size - 1)
        grads = trainer._reduce_grads(grads)
        whole = trainer.gather_state({**state, "opt_state": {**state["opt_state"], "mu": grads, "nu": grads}})
        stats = []
        with torch.no_grad():
            rows, _ = trainer._pp_rows(ids, labels)
            _, aux = llama.forward(params, rows, cfg, return_moe_aux=True, moe_stats=stats, remat=False,
                                   **trainer._forward_kw(rows))
        drops = [int(all_reduce_(d.clone(), trainer._batch_group)) for d in stats]
        out[name] = {"loss": float(loss), "aux": float(aux), "drops": drops, "pp_rank": trainer._pp.rank,
                     "grads": [g.detach().numpy().copy() for g in whole["opt_state"]["mu"]]}
    return out


def job_mesh(spec: dict) -> dict:
    """``build_mesh`` for each case of ``spec["cases"]`` (strategy, mesh
    kwargs, ``LOCAL_WORLD_SIZE`` or None): the axis sizes, or the
    ``ValueError`` text."""
    from opendiloco_torch.parallel.mesh import build_mesh

    out = {}
    for name, (strategy, kw, local) in spec["cases"].items():
        os.environ.pop("LOCAL_WORLD_SIZE", None)
        if local is not None:
            os.environ["LOCAL_WORLD_SIZE"] = str(local)
        try:
            out[name] = build_mesh(strategy, **kw).shape
        except ValueError as e:
            out[name] = str(e)
    return out


def job_fused(spec: dict) -> dict:
    """The sharded fused-loss entry on this rank's rows: the loss, this
    rank's rows' hidden gradient and its share of the head's gradient."""
    import torch

    from opendiloco_torch.ops.fused_xent import fused_linear_cross_entropy_sharded
    from opendiloco_torch.parallel.mesh import build_mesh

    plan = build_mesh("FULL_SHARD")
    h, w, labels = (torch.from_numpy(a) for a in spec["hwl"])
    h = torch.from_numpy(rank_rows(plan, h.numpy())).requires_grad_(True)
    w = w.clone().requires_grad_(True)
    labels = torch.from_numpy(rank_rows(plan, labels.numpy()))
    loss = fused_linear_cross_entropy_sharded(h, w, labels, mesh=plan, batch_axes=plan.batch_axes)
    loss.backward()
    return {"loss": float(loss), "dh": h.grad.numpy(), "dw": w.grad.numpy()}


def job_diloco(spec: dict) -> dict:
    """One DiLoCo worker of WORLD ranks in a one-worker loopback galaxy:
    the master after every step, whether this rank holds a backend."""
    from opendiloco_torch.config import DilocoConfig
    from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
    from opendiloco_torch.parallel.mesh import build_mesh
    from opendiloco_torch.parallel.world import make_world
    from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

    import torch.distributed as dist

    cfg = _cfg(spec)
    out = {}
    for name, (strategy, kw, dcfg) in spec["cases"].items():
        plan = build_mesh(strategy, **kw)
        trainer = InnerTrainer(cfg, TrainerConfig(**spec["tc"]), device="cpu", plan=plan)
        state = trainer.init_state(params=spec["params"])
        world = make_world(trainer.device)
        backend = LoopbackWorld(1).make_backends()[0] if dist.get_rank() == 0 else None
        opt = DiLoCoOptimizer(trainer, backend, DilocoConfig(**dcfg), state, batch_size=spec["batch_size"],
                              world=world)
        updated = opt.load_state_from_peers(state)
        state = updated if updated is not None else state
        masters, losses = [], []
        for ids, labels in spec["batches"]:
            rows = [rank_rows(plan, a, spec["accum"]) for a in (ids, labels)]
            state, m = opt.step(state, trainer.shard_batch(*rows, accum=spec["accum"]))
            losses.append(float(m["loss"]))
            if opt._pending is not None and opt._pending["future"] is not None:
                opt._pending["future"].result()  # land each round at the next poll
            masters.append([x.copy() for x in opt.master])
        state = opt.flush(state)
        out[name] = {"masters": masters, "losses": losses, "has_backend": opt.backend is not None,
                     "placement": opt.placement, "streams": opt._stream is not None,
                     "final": [x.copy() for x in opt.master]}
    return out


def job_ring(spec: dict) -> dict:
    """Both ring bodies over the world as one sp ring (``DistRing``), on
    this rank's chunks of ``spec["qkv"]`` (f32 numpy, cast to
    ``spec["dtype"]``): the output and the q, k, v gradients of
    sum(out * w) with w the rank's chunk of ``spec["w"]``. Rank 0 also
    runs both bodies on a loopback ring of as many threads, in this same
    process (``"loopback"``: every rank's chunks)."""
    import threading

    import torch
    import torch.distributed as dist

    from opendiloco_torch.ops import ring_attention as ra
    from opendiloco_torch.parallel.comm import LoopbackGroup

    dtype = getattr(torch, spec["dtype"])
    n = dist.get_world_size()
    tl = spec["qkv"][0].shape[1] // n

    def one(fn, ring, r):
        cut = slice(r * tl, (r + 1) * tl)
        q, k, v = (torch.from_numpy(a[:, cut].copy()).to(dtype).requires_grad_(True) for a in spec["qkv"])
        o = fn(q, k, v, ring)
        (o.float() * torch.from_numpy(spec["w"][:, cut].copy())).sum().backward()
        return [t.detach().float().numpy() for t in (o, q.grad, k.grad, v.grad)]

    bodies = (("flash", ra.ring_flash_attention), ("einsum", ra.ring_attention))
    out = {name: one(fn, ra.DistRing(dist.group.WORLD), dist.get_rank()) for name, fn in bodies}
    if dist.get_rank() == 0:
        out["loopback"] = {}
        for name, fn in bodies:
            ring, res = LoopbackGroup(n), [None] * n

            def run(r, fn=fn, ring=ring, res=res):
                res[r] = one(fn, ring.rank(r), r)

            threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out["loopback"][name] = res
    return out


# the torch.distributed calls that talk to the other ranks: each is
# recorded with the thread that issued it (job_serve)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "broadcast",
               "broadcast_object_list", "reduce_scatter", "reduce_scatter_tensor", "all_to_all_single", "barrier",
               "send", "recv", "isend", "irecv", "batch_isend_irecv", "gather", "scatter")


def job_serve(spec: dict) -> dict:
    """``train()`` on this rank of a worker of WORLD processes (each case
    of ``spec["cases"]``: strategy, mesh kwargs) with ``serve.enabled``,
    one loopback galaxy of one worker (the backend on rank 0), weights from
    ``spec["model_dir"]``, state snapshots raw f32 (``ODTP_STATE_CODEC``
    none). Right after its serving plane is built (before the first step)
    each rank posts ``spec["prompt"]`` to its own server and keeps the
    greedy tokens; after every step that ends a round, the training thread
    waits until the serving thread has installed that epoch. Returns per
    case the tokens, the server's port, the epochs the serving thread
    installed, the engine's final weights and this rank's host masters, and
    the threads that issued collectives."""
    import hashlib
    import json
    import threading
    import time
    import urllib.request

    import torch.distributed as dist

    import opendiloco_torch.serve as serve_mod
    from opendiloco_torch.config import Config
    from opendiloco_torch.diloco import LoopbackWorld
    from opendiloco_torch.models.llama import flatten_params
    from opendiloco_torch.train import train

    os.environ["ODTP_STATE_CODEC"] = "none"
    issued = []
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is not None:
            def recorded(*args, _fn=fn, _name=name, **kw):
                issued.append((_name, threading.current_thread().name))
                return _fn(*args, **kw)

            setattr(dist, name, recorded)
    build = serve_mod.build_serving
    out = {}
    for case, (strategy, kw) in spec["cases"].items():
        got = {}
        issued.clear()

        def build_and_ask(serve_cfg, model_cfg, params, diloco_opt, **bkw):
            plane = build(serve_cfg, model_cfg, params, diloco_opt, **bkw)
            got["plane"], got["opt"] = plane, diloco_opt
            body = json.dumps({"prompt": spec["prompt"], "max_new_tokens": spec["new_tokens"]}).encode()
            with urllib.request.urlopen(f"http://127.0.0.1:{plane.port}/generate", body, timeout=120) as r:
                got["tokens"] = json.loads(r.read())["tokens"]
            step = diloco_opt.step

            def step_then_wait_for_the_swap(state, batch):
                epoch = diloco_opt.epoch
                state, metrics = step(state, batch)
                deadline = time.monotonic() + 60
                while diloco_opt.epoch != epoch and plane.engine.weights_epoch != diloco_opt.epoch:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the serving thread did not install epoch {diloco_opt.epoch}")
                    time.sleep(0.01)
                return state, metrics

            diloco_opt.step = step_then_wait_for_the_swap
            return plane

        serve_mod.build_serving = build_and_ask
        try:
            cfg = Config(path_model=spec["model_dir"], fake_data=True, fake_data_mode="ramp", seq_length=32,
                         per_device_train_batch_size=4, total_batch_size=8, warmup_steps=1, total_steps=4, lr=3e-3,
                         metric_logger_type="dummy", precision="fp32", sharding_strategy=strategy,
                         project=os.path.join(os.path.dirname(spec["model_dir"]), f"rows-{case}.pkl"),
                         **kw, diloco=dict(local_steps=2, backend="loopback", timeout_waiting_for_peers=60.0),
                         serve=dict(enabled=True, port=0, max_batch=2, max_context=64, prefill_buckets=[16, 32],
                                    swap_every_steps=1, max_stale_rounds=0))
            backend = LoopbackWorld(1).make_backends()[0] if dist.get_rank() == 0 else None
            train(cfg, backend, device="cpu")
        finally:
            serve_mod.build_serving = build
        engine, opt = got["plane"].engine, got["opt"]
        out[case] = {
            "tokens": got["tokens"], "port": got["plane"].port,
            "swapped": [e["epoch"] for e in engine.swap_log], "epoch": engine.weights_epoch,
            "opt_epoch": opt.epoch,
            "engine": [p.numpy().copy() for p in flatten_params(engine.params)],
            "master": [m.copy() for m in opt.master],
            "threads": sorted({t for _, t in issued}),
            "digest": hashlib.sha1(b"".join(m.tobytes() for m in opt.master)).hexdigest(),
        }
    return out


def job_many(spec: dict) -> list:
    """Several jobs in one launch: ``spec["jobs"]`` holds (job name, its
    spec) pairs; returns their results in order."""
    return [globals()[f"job_{name}"](sub) for name, sub in spec["jobs"]]


def spawn(job: str, world: int, spec: dict, tmp, timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` ranks (one process each, a ``file://``
    store under ``tmp``); returns the ranks' results in rank order. Every
    process is waited for with ``timeout`` and killed if it is still
    running; a rank that fails fails the call with its output."""
    import subprocess

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, f"{job}-{world}.spec")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    store = os.path.join(tmp, f"{job}-{world}.store")
    outs = [os.path.join(tmp, f"{job}-{world}-{r}.out") for r in range(world)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_CBWR": "AUTO,STRICT"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r), str(world), store, spec_path,
                               outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    try:
        texts = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # never leak a wedged rank
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(f"rank {r}: {texts[r][-3000:]}" for r in failed)
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def main() -> None:
    job, rank, world, store, spec_path, out_path = sys.argv[1:7]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=int(rank), world_size=int(world))
    try:
        result = globals()[f"job_{job}"](spec)
    finally:
        dist.destroy_process_group()
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
