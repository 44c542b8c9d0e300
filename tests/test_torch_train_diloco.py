"""The port's normative DiLoCo driver (``opendiloco_torch/train_diloco.py``)
against the JAX package's ``train_diloco.main``, on the CPU.

Both drivers start from one model directory written with numpy weights
and read the same fake stream: two simulated workers, ``--local-steps``
2, 4 steps, an eval every 2 steps, fp32, the drivers' default learning
rates, on host and on device placement.
The JAX side's trajectory is read in the test by wrapping
``InnerTrainer.train_step`` (each worker's loss), ``OuterSGD.step`` (the
host master after each round) and ``evaluate_model`` (the eval loss and
worker 0's params, the master just after the round at every eval here);
its mesh is cut to one CPU device as the port's single-device plan, and
each simulated worker gets its own copy of the directory's arrays
(``InnerTrainer.init_state`` wrapped): the JAX driver hands one numpy tree
to every worker's ``device_put``, which on the CPU may share its memory,
and under device placement its second step then fails with "Buffer has
been deleted or donated" (the JAX driver alone, from a model directory).
The bounds are ``tests/test_torch_train.py``'s: losses rtol 1e-5 (f32 sums
re-associate between the frameworks), the master after two rounds atol
1e-5 (lr 0.7 and the momentum scale pseudo-gradient differences). The
port's two placements equal each other bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import opendiloco_tpu.train_diloco as jtd
from opendiloco_tpu.diloco.outer_optimizer import OuterSGD as JOuterSGD
from opendiloco_tpu.parallel.mesh import build_mesh as jbuild_mesh
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_torch import train_diloco
from opendiloco_torch.models import hf_io, llama as tllama

torch.set_num_threads(2)


def _argv(model_dir, placement):
    return ["--path-model", model_dir, "--fake-data", "--num-workers", "2", "--local-steps", "2",
            "--total-steps", "4", "--warmup-steps", "1", "--batch-size", "4", "--seq-length", "32",
            "--eval-interval", "2", "--eval-batches", "2", "--precision", "fp32", "--outer-placement", placement]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = hf_io.load_config("2m")
    rng = np.random.default_rng(3)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    path = str(tmp_path_factory.mktemp("diloco_model") / "2m")
    hf_io.save_params(draw(tllama.shapes(cfg)), cfg, path)
    return path


def _jax_run(monkeypatch, argv):
    losses, masters, evals = [], [], {}
    step = JInnerTrainer.train_step
    init_state = JInnerTrainer.init_state
    outer_step = JOuterSGD.step
    evaluate = jtd.evaluate_model

    def own_copy(self, rng, params=None):
        return init_state(self, rng, None if params is None else jax.tree.map(np.array, params))

    def train_step(self, state, batch):
        state, m = step(self, state, batch)
        losses.append(float(m["loss"]))
        return state, m

    def outer(self, params, grads):
        outer_step(self, params, grads)
        masters.append([np.array(p) for p in params])

    def evaluate_model(trainer, params, it, n):
        loss = evaluate(trainer, params, it, n)
        evals[len(losses) // 2] = (loss, [np.asarray(x) for x in jax.tree.leaves(jax.device_get(params))])
        return loss

    monkeypatch.setattr(JInnerTrainer, "train_step", train_step)
    monkeypatch.setattr(JInnerTrainer, "init_state", own_copy)
    monkeypatch.setattr(JOuterSGD, "step", outer)
    monkeypatch.setattr(jtd, "evaluate_model", evaluate_model)
    monkeypatch.setattr(jtd, "build_mesh", lambda s: jbuild_mesh(s, devices=[jax.devices()[0]]))
    jtd.main(argv)
    per_step = np.array(losses).reshape(-1, 2).mean(axis=1)
    return per_step, masters, evals


@pytest.fixture(scope="module")
def port_runs(model_dir):
    return {pl: train_diloco.run(train_diloco.build_parser().parse_args(_argv(model_dir, pl)), "cpu")
            for pl in ("host", "device")}


@pytest.mark.parametrize("placement", ["host", "device"])
def test_trajectory_matches_the_jax_driver(monkeypatch, model_dir, port_runs, placement):
    jlosses, jmasters, jevals = _jax_run(monkeypatch, _argv(model_dir, placement))
    got = port_runs[placement]
    assert got["placement"] == placement
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    assert sorted(got["eval_losses"]) == sorted(jevals) == [2, 4]
    for s, (loss, _) in jevals.items():
        np.testing.assert_allclose(got["eval_losses"][s], loss, rtol=1e-5)
    # worker 0's params at the last eval are the master just after round 2
    final = jevals[4][1]
    if placement == "host":
        assert len(jmasters) == 2
        for a, b in zip(jmasters[-1], final):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got["master"], final):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_the_two_placements_are_bit_for_bit_equal(port_runs):
    host, device = port_runs["host"], port_runs["device"]
    assert host["losses"] == device["losses"] and host["eval_losses"] == device["eval_losses"]
    for a, b in zip(host["master"], device["master"]):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(host["losses"]).all()


def test_without_fake_data_it_raises_as_train_does(model_dir):
    argv = [a for a in _argv(model_dir, "host") if a != "--fake-data"]
    with pytest.raises(NotImplementedError, match="A9"):
        train_diloco.run(train_diloco.build_parser().parse_args(argv), "cpu")

