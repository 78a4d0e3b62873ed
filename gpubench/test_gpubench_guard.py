"""The import guard compares top-level names whole, and no module of the
benchmark imports JAX, optax, flax or the JAX package; the references
import nothing of the program."""

import ast
from pathlib import Path

from gpubench import guard
from gpubench.cells import HERE


def test_top_level_names_compared_whole():
    assert guard.forbidden(["distkeras_torch", "distkeras_torch.ops",
                            "jaxtyping", "flaxen", "optaxx"]) == []
    assert guard.forbidden(["jax.numpy", "jaxlib", "flax.linen", "optax",
                            "distkeras_tpu.models"]) == [
        "distkeras_tpu", "flax", "jax", "jaxlib", "optax"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert guard.forbidden(_imports(path)) == [], path


def test_references_import_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "distkeras_torch" not in tops, path
    for path in (HERE / "weights.py", HERE / "work.py", HERE / "compare.py"):
        assert "distkeras_torch" not in {m.split(".")[0]
                                         for m in _imports(path)}, path


def test_harness_loads_nothing_forbidden(tmp_path):
    import subprocess
    import sys

    code = ("import gpubench.run, gpubench.readings, "
            "gpubench.kinds.train, gpubench.kinds.serve_closed_loop, "
            "gpubench.programs\n"
            "import distkeras_torch.serving, distkeras_torch.models, "
            "distkeras_torch.parallel.spmd, distkeras_torch.workers\n"
            "from gpubench import guard; print(guard.loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
