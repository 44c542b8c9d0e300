"""The import boundary of the PyTorch port, and what ``chip_smoke.py`` does
where there is no card.

The port (``opendiloco_torch/``, ``chip_smoke.py`` and its tool
``phase_turns.py``) imports neither JAX
nor anything of the JAX package ``opendiloco_tpu``, not even its host-only
modules: the machine with the card has no JAX. Only tests import both.
Nor does it import ``safetensors``, ``orbax`` or ``datasets``, which that
machine lacks too; ``fsspec`` is imported only inside a function, on a
remote checkpoint path.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "opendiloco_tpu")
# packages the card machine does not have; fsspec only on remote paths
ABSENT = ("safetensors", "orbax", "datasets", "fsspec")
SOURCES = sorted((ROOT / "opendiloco_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "phase_turns.py"]


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED


def _imports(tree: ast.AST):
    """Every module name an import statement, ``importlib.import_module``
    or ``__import__`` call names with a constant."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({m for m in _imports(tree) if _banned(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _module_level_imports(tree: ast.AST):
    """The imports of ``_imports`` that sit outside every function."""
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside.update(map(id, ast.walk(node)))
    outer = ast.Module(body=[], type_ignores=[])
    outer.body = [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom, ast.Call))
                  and id(n) not in inside]
    return set(_imports(outer))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_package_the_card_machine_lacks(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set(_imports(tree))
    bad = sorted(m for m in names if m.split(".")[0] in ABSENT and m.split(".")[0] != "fsspec")
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    top = sorted(m for m in _module_level_imports(tree) if m.split(".")[0] == "fsspec")
    assert not top, f"{path.relative_to(ROOT)} imports fsspec outside a function"
    if any(m.split(".")[0] == "fsspec" for m in names):
        assert path.relative_to(ROOT).as_posix() == "opendiloco_torch/ckpt.py"


def test_import_walk_sees_every_kind_of_import():
    src = "import jax.numpy\nfrom opendiloco_tpu.ops import x\nimportlib.import_module('flax')\n"
    assert sorted(_imports(ast.parse(src))) == ["flax", "jax.numpy", "opendiloco_tpu.ops"]


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_port_imports_with_jax_blocked():
    # a None entry in sys.modules makes any import of that name raise
    code = (
        "import sys\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, opendiloco_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(opendiloco_torch.__path__, 'opendiloco_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import opendiloco_torch.serve, chip_smoke\n"
        f"loaded = sorted(m for m, v in sys.modules.items() if v is not None and m.split('.')[0] in {ABSENT!r})\n"
        "assert not loaded, f'importing the port loaded {loaded}'\n"
        "print(' '.join(names))\n"
    )
    res = _python(code, ROOT)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    # the training slice's modules are among those imported
    for mod in ("trainer", "train", "ops.flash_attention", "ops.launch", "diloco.optimizer",
                "diloco.loopback", "diloco.backend", "diloco.outer_optimizer", "data.dataloader",
                "utils.logger", "utils.debug", "ckpt", "diloco.state_io", "utils.safetensors_io",
                "native", "diloco.compression", "serve.server", "diloco.tcp", "diloco.bulk",
                "diloco.rendezvous", "diloco.wire", "diloco.schema", "diloco.chaos", "diloco.linkstate",
                "diloco.planner"):
        assert f"opendiloco_torch.{mod}" in names, mod


def _run_smoke(cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120,
    )


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
