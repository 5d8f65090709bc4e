"""`gptst_tpu_torch` and `chip_smoke.py` stand without JAX.

The port runs on a GPU host that has no JAX: neither it nor the chip
smoke script may import `jax`, `flax`, `optax`, `orbax` or anything of
the JAX package (not even its numpy-only modules).
"""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gptst_tpu"}

_PROBE = """
import importlib, pkgutil, sys
import numpy as np
import torch
import gptst_tpu_torch
for m in pkgutil.walk_packages(gptst_tpu_torch.__path__, "gptst_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
from gptst_tpu_torch.ops.graph_conv import make_support
sup = make_support(sym_adj(random_sensor_graph(40, seed=1)),
                   dense_threshold=0, tile=16, device="cpu")
net = TGCN(TGCNConfig(num_nodes=40, rnn_units=4), 1, 1, 12)
out = net(torch.zeros(2, 12, 40, 1), sup)
assert out.shape == (2, 12, 40, 1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN})
print("LOADED", bad)
"""


def test_importing_and_running_the_port_loads_no_jax():
    code = _PROBE.replace("{FORBIDDEN}", repr(FORBIDDEN))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "gptst_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
