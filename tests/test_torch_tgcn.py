"""The port's TGCN against the JAX package's, on transplanted weights.

`convert.py` carries the flax tree across; the forward and every
parameter gradient then match with the dense support and through the
sparse path (tile 16: block-CSR or DIA kernels' plain versions plus the
COO tail, against the JAX Pallas kernels in interpret mode).
Tolerance rtol 1e-4: the node-major cell's split gate matmul
reassociates the D+U contraction, and the sparse sums run in another
order. Remat "full" and "dots" recompute the same ops: equal to "none".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.models.predictors.tgcn import TGCN as JTGCN
from gptst_tpu.models.predictors.tgcn import TGCNConfig as JTGCNConfig
from gptst_tpu.ops.graph_conv import make_support as jmake_support
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
from gptst_tpu_torch.ops.graph_conv import make_support
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B, U = 48, 3, 8


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        jspmm.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _inputs():
    rng = np.random.default_rng(0)
    adj = sym_adj(random_sensor_graph(N, avg_degree=5, seed=2))
    x = rng.standard_normal((B, 12, N, 1)).astype(np.float32)
    g = rng.standard_normal((B, 12, N, 1)).astype(np.float32)
    return adj, x, g


def _jax_model_and_params(x, sup):
    model = JTGCN(cfg=JTGCNConfig(num_nodes=N, rnn_units=U), dim_in=1,
                  dim_out=1, horizon=12)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(x), sup)
    return model, jax.tree.map(np.asarray, params)


def _torch_model(params, remat="auto"):
    net = TGCN(TGCNConfig(num_nodes=N, rnn_units=U, remat=remat), dim_in=1,
               dim_out=1, horizon=12)
    net.load_state_dict(flax_to_state_dict(params))
    return net


def test_convert_round_trips():
    adj, x, _ = _inputs()
    _, params = _jax_model_and_params(x, jnp.asarray(adj))
    back = state_dict_to_flax(flax_to_state_dict(params))
    flat, tree = jax.tree_util.tree_flatten(params)
    flat2, tree2 = jax.tree_util.tree_flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        np.testing.assert_array_equal(a, b)
    net = TGCN(TGCNConfig(num_nodes=N, rnn_units=U), 1, 1, 12)
    assert set(net.state_dict()) == set(flax_to_state_dict(params))
    assert net.cell.weights_0.shape == params["params"][
        "ScanGraphGRUCell_0"]["weights_0"].shape


@pytest.mark.parametrize("sparse", [False, True])
def test_forward_and_grads_match(sparse):
    adj, x, g = _inputs()
    if sparse:
        jsup = jmake_support(adj, dense_threshold=0, tile=16)
        tsup = make_support(adj, dense_threshold=0, tile=16, device="cpu")
    else:
        jsup, tsup = jnp.asarray(adj), make_support(adj, device="cpu")
    model, params = _jax_model_and_params(x, jsup)

    def jloss(p):
        pred = model.apply(p, jnp.asarray(x), jsup)
        return jnp.sum(pred * jnp.asarray(g)), pred

    (_, jpred), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    net = _torch_model(params)
    pred = net(torch.tensor(x), tsup)
    (pred * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               rtol=1e-4, atol=1e-6)
    tgrads = state_dict_to_flax(
        {k: p.grad for k, p in net.named_parameters()})
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(jgrads),
            jax.tree_util.tree_leaves(tgrads)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_none(remat):
    adj, x, g = _inputs()
    tsup = make_support(adj, dense_threshold=0, tile=16, device="cpu")
    _, params = _jax_model_and_params(x, jnp.asarray(adj))
    out = {}
    for rm in ("none", remat):
        net = _torch_model(params, remat=rm)
        pred = net(torch.tensor(x), tsup)
        (pred * torch.tensor(g)).sum().backward()
        out[rm] = [pred.detach()] + [p.grad for p in net.parameters()]
    for a, b in zip(out["none"], out[remat]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_resolve_remat_auto_threshold():
    from gptst_tpu.ops.recurrent import resolve_remat as jresolve
    from gptst_tpu_torch.ops.recurrent import resolve_remat

    for n in (16384, 131072):
        for rm in ("auto", "none", "full", "dots"):
            assert resolve_remat(rm, n, 131072) == jresolve(rm, n, 131072)
    assert dataclasses.asdict(TGCNConfig(num_nodes=5)) == \
        dataclasses.asdict(JTGCNConfig(num_nodes=5))
