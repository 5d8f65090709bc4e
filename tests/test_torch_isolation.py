"""`gptst_tpu_torch` and `chip_smoke.py` stand without JAX.

The port runs on a GPU host that has no JAX: neither it nor the chip
smoke script may import `jax`, `flax`, `optax`, `orbax` or anything of
the JAX package (not even its numpy-only modules).
"""

import ast
import os
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
from gptst_tpu_torch.models.build import msdr_adapt_pattern
from gptst_tpu_torch.models.predictors.msdr import (
    MSDR, MSDRConfig, dual_random_walk_supports)
from gptst_tpu_torch.kernels.sddmm import SDDMMPattern, adaptive_support
from gptst_tpu_torch.kernels.spmm import BlockCSR
mats = dual_random_walk_supports(random_sensor_graph(40, seed=1))
sups = tuple(make_support(m, dense_threshold=0, tile=16, device="cpu")
             for m in mats)
pat = SDDMMPattern.from_bcsr(BlockCSR.from_dense(mats[0], 16, device="cpu"))
adp = adaptive_support(pat, torch.randn(40, 3), torch.randn(3, 40))
assert adp.bcsr.block_vals.shape == pat.mask.shape
assert msdr_adapt_pattern(mats[0], 40, device="cpu").tile == 128
msdr = MSDR(MSDRConfig(num_nodes=40, rnn_units=4, adapt_rank=3), 1, 1)
out = msdr(torch.zeros(2, 12, 40, 1), sups, pat)
out.sum().backward()
assert out.shape == (2, 12, 40, 1)
from gptst_tpu_torch.kernels.halo_spmm import make_fused_ring_spmm
from gptst_tpu_torch.ops.graph_conv import ShardedSupport
from gptst_tpu_torch.parallel.mesh import make_mesh, shard_rows
mesh = make_mesh(devices=["cpu"] * 4, graph_axis_size=4)
adj = sym_adj(random_sensor_graph(42, seed=1))
sup = make_support(adj, mesh=mesh)
assert isinstance(sup, ShardedSupport) and sup.n_pad == 44
out = net(torch.zeros(2, 12, 42, 1), sup)
assert out.shape == (2, 12, 42, 1)
ring, n_pad = make_fused_ring_spmm(mesh, adj, 3)
assert len(ring(shard_rows(torch.zeros(n_pad, 3), mesh))) == 4
from gptst_tpu_torch.core import (
    global_mesh, initialize_distributed, is_coordinator)
from gptst_tpu_torch.parallel import collectives
initialize_distributed()
assert is_coordinator() and collectives.world() == (0, 1)
assert global_mesh(2, devices=["cpu"] * 4).shape == {"data": 2, "graph": 2}
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.models.build import build_model
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms
cfg = default_config("PEMS08", mode="pretrain", num_nodes=6, hidden_dim=8,
                     embed_dim=4, HS=3, HT=4, HT_Tem=2, change_epoch=1)
gpt = build_model(cfg, device="cpu")
loss_terms = make_loss_terms(gpt, build_loss("mask_mae", 0.0, 1.0, 0.0, True),
                             cfg)
x6 = torch.randn(2, 12, 6, 3)
total, flow = loss_terms(x6, x6, 1, epoch=2,
                         generator=torch.Generator().manual_seed(0))
total.backward()
assert total > flow and gpt(x6).pred.shape == (2, 12, 6, 8)
for name in ("TGCN", "STGCN", "GWN", "MTGNN"):
    ecfg = cfg.replace(mode="eval", model=name)
    enh = build_model(ecfg, device="cpu", pretrain_params=gpt.gptst)
    assert enh(x6).pred.shape == (2, 12, 6, 1)
gwn = build_model(cfg.replace(mode="ori", model="GWN", predictor_overrides=(
    ("aptonly", "False"),)), device="cpu")
assert gwn(x6).pred.shape == (2, 12, 6, 1)
ccfg = default_config("NYC_BIKE", mode="ori", model="CCRNN", num_nodes=6)
cc = build_model(ccfg, device="cpu")
x2 = torch.randn(2, 12, 6, 4)
assert cc(x2, y=x2, step=3, generator=torch.Generator()).pred.shape == (
    2, 12, 6, 2)
import ctypes
opened = []
_cdll = ctypes.CDLL.__init__
def _record(self, name, *a, **k):
    opened.append(str(name))
    return _cdll(self, name, *a, **k)
ctypes.CDLL.__init__ = _record
from gptst_tpu_torch.graph.dtw import stfgnn_dtw_graph, stgode_dtw_graph
from gptst_tpu_torch import native
series = np.random.default_rng(0).random((3 * 24, 5)).astype(np.float32)
assert stfgnn_dtw_graph(series, 24).shape == (5, 5)
assert stgode_dtw_graph(series, 24).shape == (5, 5)
assert native.load("dtw") is not None
assert opened and all("gptst_tpu_torch" in p and "/gptst_tpu/" not in p
                      for p in opened), opened
import os, tempfile
os.chdir(tempfile.mkdtemp())    # the DTW graphs' cache
for name, ds in (("STMGCN", "NYC_BIKE"), ("ASTGCN", "PEMS08"),
                 ("STSGCN", "PEMS08"), ("STFGNN", "PEMS08"),
                 ("STGODE", "PEMS08"), ("ST_WA", "PEMS08"),
                 ("DMVSTNET", "NYC_BIKE")):
    mcfg = default_config(ds, mode="ori", model=name, num_nodes=6)
    xin = torch.randn(2, 12, 6, mcfg.input_base_dim + 2)
    m = build_model(mcfg, device="cpu")
    assert m(xin).pred.shape == (2, 12, 6, mcfg.output_dim)
    if ds == "PEMS08":
        enh = build_model(cfg.replace(mode="eval", model=name), device="cpu",
                          pretrain_params=gpt.gptst)
        assert enh(x6).pred.shape == (2, 12, 6, 1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN})
print("LOADED", bad)
"""


def test_importing_and_running_the_port_loads_no_jax():
    code = _PROBE.replace("{FORBIDDEN}", repr(FORBIDDEN))
    # one intra-op thread, as in the other port test files (the
    # suite's workers share the cores)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
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
    files += [ROOT / "chip_smoke.py", ROOT / "chip_phases.py"]
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
