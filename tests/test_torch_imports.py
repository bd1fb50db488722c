"""The port imports nothing of JAX and nothing of the JAX package: every
module of ilswiss_tpu_torch/ and chip_smoke.py, read as source (no module
is imported here), has no import of jax, jaxlib, flax, optax, orbax or
ilswiss_tpu (ilswiss_tpu_torch itself is allowed)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ilswiss_tpu"}
FILES = sorted((ROOT / "ilswiss_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [f"{path.name}:{line}: {name}" for line, name in _imported(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_walk_sees_every_module_and_every_form(tmp_path):
    assert len(FILES) > 40
    assert ROOT / "ilswiss_tpu_torch" / "launchers" / "experiments.py" in FILES
    probe = tmp_path / "probe.py"
    probe.write_text("import os, jax.numpy as jnp\n"
                     "def f():\n    from ilswiss_tpu.ops import x\n"
                     "import importlib\nimportlib.import_module('optax')\n"
                     "from ilswiss_tpu_torch.envs import make\n"
                     "from . import sibling\n")
    names = [name for _, name in _imported(probe)]
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == [
        "jax.numpy", "ilswiss_tpu.ops", "optax"]
