"""The port's STFGNN (`FusionLayer`, `construct_adj_fusion`, the
builder's fusion graph and `convert.py`) against the JAX package's, on
the CPU.

Weights: the JAX init with N(0, 0.1^2) noise on every leaf, carried over
by `convert.py`. The model tests feed the fusion graph divided by its
row sums (the raw graph grows the activations by its row sums in each
of the 9 sub-layers, as in STSGCN's tests).

  * `FusionLayer` (the gated dilated convs, kernel (2, 1) and dilation
    3, VALID, T - 3 steps, and the per-window GLU layers): values and
    input gradients rtol 1e-5, atol 1e-5 of the largest entry;
  * the whole model at published widths (3 x [64, 64, 64], strides 4,
    embedding 64, out_layer_dim 128) on N = 16, dim_in 1 and 64 (eval
    mode): the loss rtol 1e-5, the prediction and every gradient rtol
    1e-4 with an atol of 1e-5 of each tensor's largest entry;
    both packages also run in float64, where the port is held to JAX at
    rtol 1e-9 with an atol of 1e-9 of each tensor's largest entry, and
    each f32 atol adds twice JAX's own f32 distance from its float64
    run (`tests/torch_parity.py`);
  * the builder's (4N, 4N) graph equal to JAX's: from the prefab when
    its shape is strides * N, and from the DTW graph of the training
    days when the prefab is absent or of another shape;
  * `convert.py` round trips; the position embeddings' law N(0, 3e-4^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import stfgnn as jstfgnn
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors import stfgnn as tstfgnn
from torch_parity import (
    assert_model_matches, assert_round_trip, cli_cycle, closure_array,
    noisy, one_torch_thread,
)

N = 16
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _graphs(seed=0):
    rng = np.random.default_rng(seed)
    a, d = ((rng.random((N, N)) < 0.2).astype(np.float32) for _ in range(2))
    return np.maximum(a, a.T), np.maximum(d, d.T)


def _fusion(seed=0):
    adj = tstfgnn.construct_adj_fusion(*_graphs(seed), 4)
    return (adj / adj.sum(axis=1, keepdims=True)).astype(np.float32)


def test_fusion_layer_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, N, 6)).astype(np.float32)
    adj = _fusion()
    cfg = dict(num_nodes=N)
    jm = jstfgnn.FusionLayer(jstfgnn.STFGNNConfig(**cfg), (7, 7, 7), 12)
    p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x, adj))
    tm = tstfgnn.FusionLayer(tstfgnn.STFGNNConfig(**cfg), (7, 7, 7), 12, 6)
    sd = flax_to_state_dict({"params": {"FusionLayer_0": p["params"],
                                        "first_fc": {}}})
    tm.load_state_dict({k.removeprefix("fusion_layers.0."): v
                        for k, v in sd.items()})
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, torch.tensor(adj))
    g = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.tensor(g))

    @jax.jit
    def jvals(a, gg):
        jout, vjp = jax.vjp(lambda b: jm.apply(p, b, adj), a)
        return jout, vjp(gg)[0]

    jout, jg = jvals(jnp.asarray(x), jnp.asarray(g))
    assert out.shape == jout.shape == (2, 9, N, 7)
    for got, want in ((out.detach().numpy(), jout), (xt.grad.numpy(), jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dim_in", [1, 64])
def test_model_loss_and_grads_match_jax(dim_in):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 12, N, dim_in)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 1)).astype(np.float32)
    adj = _fusion()
    jm = jstfgnn.STFGNN(cfg=jstfgnn.STFGNNConfig(num_nodes=N),
                        dim_in=dim_in, dim_out=1, horizon=12, lag=12)
    net = tstfgnn.STFGNN(tstfgnn.STFGNNConfig(num_nodes=N), dim_in=dim_in,
                         dim_out=1, horizon=12, lag=12,
                         generator=torch.Generator().manual_seed(0))
    # the port's init carried to JAX (a JAX init is one more compile)
    params = noisy(state_dict_to_flax(net.state_dict()))
    assert_model_matches(jm, net, params, x, [adj], y, against64=True)


def test_convert_round_trips_and_embedding_law():
    jm = jstfgnn.STFGNN(cfg=jstfgnn.STFGNNConfig(num_nodes=N), dim_in=1,
                        dim_out=1, horizon=12, lag=12)
    net = tstfgnn.STFGNN(tstfgnn.STFGNNConfig(num_nodes=N), dim_in=1,
                         dim_out=1, horizon=12, lag=12,
                         generator=torch.Generator().manual_seed(0))
    assert_round_trip(net, jm, jnp.zeros((2, 12, N, 1)),
                      jnp.zeros((4 * N, 4 * N)))
    big = tstfgnn.FusionLayer(tstfgnn.STFGNNConfig(num_nodes=2000),
                              (64, 64, 64), 12, 64,
                              generator=torch.Generator().manual_seed(0))
    e = big.spatial_emb.detach().double()
    assert abs(float(e.mean())) < 3e-6
    assert abs(float(e.std()) / 3e-4 - 1) < 0.01


@pytest.mark.parametrize("prefab", ["absent", "fits", "other_shape"])
def test_builder_fusion_graph_equals_jax(tmp_path, monkeypatch, prefab):
    """`-data_root` holds `STFGNN/PEMS08/PEMS08_adj_mx.npy` of shape
    (4N, 4N) (used as it is), of another shape (ignored: the DTW graph
    of the default series' training days is built) or nothing. The DTW
    graph is cached under the working directory's `.gptst_cache`."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    if prefab != "absent":
        d = tmp_path / "data" / "STFGNN" / "PEMS08"
        d.mkdir(parents=True)
        n = 4 * N if prefab == "fits" else 4 * N + 4
        np.save(d / "PEMS08_adj_mx.npy", rng.random((n, n)))
    adj = _graphs(4)[0]
    kw = dict(mode="ori", model="STFGNN", num_nodes=N,
              data_root=str(tmp_path / "data"))
    _, apply_fn = jbuild._build_stfgnn(jax_default_config("PEMS08", **kw), 1,
                                       adj)
    want = closure_array(apply_fn, "fusion")
    pred = tbuild.build_predictor(default_config("PEMS08", **kw), adj=adj,
                                  device="cpu")
    assert want.shape == (4 * N, 4 * N)
    np.testing.assert_array_equal(pred.graph[0].numpy(), want)
    # the port's cached DTW graph is its own file beside the JAX one
    cached = sorted(p.name for p in (tmp_path / ".gptst_cache").glob("*"))
    if prefab == "fits":
        assert not cached
    else:
        assert len(cached) == 2 and cached[1] == "torch_" + cached[0]


def test_cli_ori_eval_test_on_cpu(tmp_path, monkeypatch):
    """`python -m gptst_tpu_torch.run -mode ori|pretrain|eval|test -model
    STFGNN -device cpu` at tiny widths; the test report equals eval's."""
    monkeypatch.chdir(tmp_path)
    cli_cycle(tmp_path, "PEMS08", "STFGNN", [
        '--hidden_dims', '[[4, 4, 4]]', '--first_layer_embedding_size', '4',
        '--out_layer_dim', '8'])
