"""The port's init-weights CLI (``python -m opendiloco_torch.models.init_weights``)
against the JAX package's, on the CPU.

Torch cannot reproduce ``jax.random`` draws, so the two directories hold
different numbers; what must agree is the layout: the safetensors key
names, shapes and dtypes, and ``config.json``, and each package loads the
other's directory. The port's draws are checked by their statistics:
norms are ones, and every other leaf of at least 10^4 elements has a mean
within 3 sigma of 0 (sigma = initializer_range / sqrt(n)) and a standard
deviation within 2% of ``initializer_range``. One seed writes the same
bytes twice. An MoE config raises in both, as HF llama has no experts.
"""
import json
import os

import numpy as np
import pytest

from opendiloco_tpu.models import hf_io as jhf_io
from opendiloco_tpu.models.init_weights import main as jmain
from opendiloco_torch.models import hf_io
from opendiloco_torch.models.init_weights import main
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.utils import safetensors_io


def _header(path):
    with open(os.path.join(path, "model.safetensors"), "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        head = json.loads(f.read(n))
    head.pop("__metadata__", None)
    return {k: (v["dtype"], v["shape"]) for k, v in head.items()}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("init_weights")
    out = {"jax": str(tmp / "jax"), "port": str(tmp / "port"), "again": str(tmp / "again")}
    jmain(["--config", "2m", "--output", out["jax"], "--seed", "7"])
    main(["--config", "2m", "--output", out["port"], "--seed", "7"])
    main(["--config", "2m", "--output", out["again"], "--seed", "7"])
    return out


def test_layout_and_config_equal_the_jax_clis(dirs):
    assert _header(dirs["port"]) == _header(dirs["jax"])
    with open(os.path.join(dirs["port"], "config.json")) as f, open(os.path.join(dirs["jax"], "config.json")) as g:
        assert json.load(f) == json.load(g)


def test_each_package_loads_the_others_directory(dirs):
    for load in (hf_io.get_model, jhf_io.get_model):
        for d in (dirs["jax"], dirs["port"]):
            cfg, params = load(d)
            assert cfg.num_hidden_layers == 2 and params is not None
    tp = flatten_params(hf_io.get_model(dirs["port"])[1])
    jp = flatten_params(jhf_io.get_model(dirs["port"])[1])
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_draws_have_the_initializer_statistics(dirs):
    cfg, params = hf_io.get_model(dirs["port"])
    sd = cfg.initializer_range
    checked = 0
    for name, x in safetensors_io.load_file(os.path.join(dirs["port"], "model.safetensors")).items():
        assert x.dtype == np.float32
        if "norm" in name:
            np.testing.assert_array_equal(x, np.ones_like(x))
            continue
        if x.size < 10_000:
            continue
        assert abs(float(x.mean())) <= 3 * sd / np.sqrt(x.size), name
        assert abs(float(x.std()) / sd - 1) <= 0.02, name
        checked += 1
    assert checked == 8  # config_2m: the embedding, the head, 2 layers' gate, up and down


def test_one_seed_writes_the_same_bytes(dirs):
    for name in ("model.safetensors", "config.json"):
        with open(os.path.join(dirs["port"], name), "rb") as f, open(os.path.join(dirs["again"], name), "rb") as g:
            assert f.read() == g.read()


def test_the_cli_line_and_moe_refusal_match_jax(tmp_path, capsys):
    main(["--config", "2m", "--output", str(tmp_path / "a")])
    jmain(["--config", "2m", "--output", str(tmp_path / "b")])
    port_line, jax_line = capsys.readouterr().out.strip().splitlines()
    assert port_line.replace(str(tmp_path / "a"), "D") == jax_line.replace(str(tmp_path / "b"), "D")
    for fn in (main, jmain):
        with pytest.raises(ValueError, match="MoE"):
            fn(["--config", "2m_4e", "--output", str(tmp_path / "moe")])
