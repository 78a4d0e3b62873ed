"""Import hygiene of the port: importing every ``distkeras_torch``
module (the serving, training, sequence-parallel, dist-keras and I/O
slices alike) loads no ``jax``, ``flax``, ``optax`` or ``distkeras_tpu``
module, nor ``keras``, which may load jax (checked in a fresh
interpreter, since this test process imports both packages),
and ``chip_smoke.py`` imports none of them either (checked on its
syntax tree), nor do ``ab_kernels.py`` and ``ab_engine.py``. Importing a module
builds no kernel and needs no card."""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "distkeras_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
import distkeras_torch
names = ["distkeras_torch"]
for m in pkgutil.walk_packages(distkeras_torch.__path__, "distkeras_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "distkeras_tpu", "keras"))
from distkeras_torch.kernels import build
print(json.dumps({"modules": names, "bad": bad,
                  "built": build._loaded is not None}))
"""


def test_port_modules_import_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert not res["built"]
    for must in ("distkeras_torch.serving.engine",
                 "distkeras_torch.models.transformer",
                 "distkeras_torch.ops.paged_attention",
                 "distkeras_torch.ops.splash_prefill",
                 "distkeras_torch.bridge",
                 "distkeras_torch.kernels.build",
                 "distkeras_torch.ops.pallas_attention",
                 "distkeras_torch.ops.flash_attention",
                 "distkeras_torch.ops.fused_ce",
                 "distkeras_torch.utils.losses",
                 "distkeras_torch.utils.history",
                 "distkeras_torch.data.dataset",
                 "distkeras_torch.parallel.spmd",
                 "distkeras_torch.parallel.mesh",
                 "distkeras_torch.parallel.collectives",
                 "distkeras_torch.ops.pallas_pair",
                 "distkeras_torch.ops.ring_attention",
                 "distkeras_torch.models.wrapper",
                 "distkeras_torch.trainers",
                 "distkeras_torch.bench",
                 "distkeras_torch.models.mlp",
                 "distkeras_torch.models.cnn",
                 "distkeras_torch.workers",
                 "distkeras_torch.transformers",
                 "distkeras_torch.predictors",
                 "distkeras_torch.evaluators",
                 "distkeras_torch.utils.initializers",
                 "distkeras_torch.utils.transfer",
                 "distkeras_torch.utils.profiling",
                 "distkeras_torch.utils.serde",
                 "distkeras_torch.ops.rules",
                 "distkeras_torch.parameter_servers",
                 "distkeras_torch.checkpoint",
                 "distkeras_torch.networking",
                 "distkeras_torch.serving.kvpool",
                 "distkeras_torch.serving.weights",
                 "distkeras_torch.data.shard_io",
                 "distkeras_torch.data.text",
                 "distkeras_torch.data.spark_adapter",
                 "distkeras_torch.streaming",
                 "distkeras_torch.runtime",
                 "distkeras_torch.job_deployment",
                 "distkeras_torch.utils.keras_import"):
        assert must in res["modules"]


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax():
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert "distkeras_torch" in roots
    assert not roots & set(FORBIDDEN)


@pytest.mark.parametrize("script", ["ab_kernels.py", "ab_engine.py"])
def test_ab_script_imports_no_jax(script):
    """The parent-against-change timing scripts load the port and
    chip_smoke.py, nothing of the reference package."""
    roots = _imported_roots(os.path.join(ROOT, script))
    assert "distkeras_torch" in roots
    assert not roots & set(FORBIDDEN)


def test_port_sources_import_no_jax():
    """The same check over every port source file, including imports
    inside functions that the probe above never runs."""
    pkg = os.path.join(ROOT, "distkeras_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                roots = _imported_roots(os.path.join(dirpath, f))
                assert not roots & set(FORBIDDEN), f
