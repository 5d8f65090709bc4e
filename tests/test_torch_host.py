"""The port's copies of the JAX package's numpy modules give EQUAL arrays.

config, data pipeline and graph artifacts are host-side numpy in both
packages; `gptst_tpu_torch` keeps its own copies (it imports nothing of
`gptst_tpu`), so each copy is held to exact equality here. The
metrics, rewritten in torch, match within rtol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.eval.metrics import all_metrics as jax_all_metrics
from gptst_tpu.graph import artifacts as jax_art
from gptst_tpu.graph.partition import rcm_order_coo as jax_rcm_order_coo
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.eval.metrics import all_metrics
from gptst_tpu_torch.graph import artifacts
from gptst_tpu_torch.graph.partition import rcm_order, rcm_order_coo
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("dataset,mode,model", [
    ("PEMS08", "ori", "TGCN"), ("METR_LA", "pretrain", "STGCN"),
    ("NYC_BIKE", "eval", "GWN"),
])
def test_default_config_equal(dataset, mode, model):
    got = dataclasses.asdict(default_config(dataset, mode=mode, model=model))
    want = dataclasses.asdict(
        jax_default_config(dataset, mode=mode, model=model))
    assert got == want


def test_build_dataset_equal():
    kw = dict(mode="ori", model="TGCN", num_nodes=12)
    got = build_dataset(default_config("PEMS08", **kw), num_steps=300, seed=3)
    want = jax_build_dataset(jax_default_config("PEMS08", **kw),
                             num_steps=300, seed=3)
    for split in ("train", "val", "test"):
        for xy in ("x", "y"):
            np.testing.assert_array_equal(getattr(got, f"{xy}_{split}"),
                                          getattr(want, f"{xy}_{split}"))
    for s in ("scaler_data", "scaler_day", "scaler_week"):
        assert dataclasses.asdict(getattr(got, s)) == \
            dataclasses.asdict(getattr(want, s))
    assert got.scaler_zeros == want.scaler_zeros


def test_graph_artifacts_equal():
    a = artifacts.random_sensor_graph(90, avg_degree=5, seed=4)
    b = jax_art.random_sensor_graph(90, avg_degree=5, seed=4)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(artifacts.sym_adj(a), jax_art.sym_adj(b))
    rows, cols = np.nonzero(a)
    np.testing.assert_array_equal(rcm_order_coo(rows, cols, 90),
                                  jax_rcm_order_coo(rows, cols, 90))
    np.testing.assert_array_equal(rcm_order(a),
                                  jax_rcm_order_coo(rows, cols, 90))


@pytest.mark.parametrize("shape", [(6, 12, 9, 1), (6, 9, 1), (6, 9)])
@pytest.mark.parametrize("thresh", [None, 0.0, 0.5])
def test_metrics_match_jax(shape, thresh):
    """`eval/metrics.py`, rewritten in torch, against the JAX package's
    (rtol 1e-5: f32 reductions in another order)."""
    rng = np.random.default_rng(5)
    true = rng.uniform(-0.2, 2.0, shape).astype(np.float32)
    pred = (true + rng.normal(0, 0.3, shape)).astype(np.float32)
    got = all_metrics(torch.tensor(pred), torch.tensor(true), thresh, thresh)
    want = jax_all_metrics(jnp.asarray(pred), jnp.asarray(true), thresh,
                           thresh)
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-5)
