"""The port's MTGNN (and `mtgnn_graph`, `mixprop`, `NodeLayerNorm`,
`DilatedInception`) against the JAX package's, on the CPU.

Weights: the JAX init with N(0, 0.1^2) noise on every leaf (norm weights
and biases start at 1 and 0), carried over by `convert.py`; dropout 0.

  * `mtgnn_graph` with rows that have fewer than k positive entries and
    rows with ties at the k-th value (tanh saturated at exactly 1.0):
    values rtol 1e-5, atol 1e-5, the gradients to both embeddings rtol
    1e-5, atol 2e-5 (see the test for both);
  * `mixprop`, `NodeLayerNorm`, `DilatedInception` (dilation 1 and 2):
    values and input gradients rtol 1e-5, atol 1e-5;
  * the whole model at N = 24 (layers 3, published widths, top-k 6,
    the embeddings scaled so that no row ties at its k-th value; see
    the test): the loss rtol 1e-5, the prediction and every gradient
    rtol 1e-4 with an atol of 1e-5 of each tensor's largest entry;
  * the init laws by their moments, and `build_adj=False` with its
    predefined A - I.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.models.predictors import mtgnn as jmtgnn
from gptst_tpu.ops import graph_conv as jgc
from gptst_tpu.ops import temporal as jtemporal
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors.mtgnn import (
    MTGNN, MTGNNConfig, NodeLayerNorm,
)
from gptst_tpu_torch.ops import graph_conv as tgc
from gptst_tpu_torch.ops.temporal import DilatedInception

N = 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny torch ops: one intra-op thread, as in the other port
    test files (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(params, seed=7, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_mtgnn_graph_with_short_rows_and_ties():
    """Rows from 12 on see only the 12 nonzero v2 rows, and some of them
    have fewer than k positive entries (row 15 none): the threshold is
    then 0 and the whole row is kept. At alpha 20 on embeddings of
    magnitude 1 or more, tanh(alpha v) is exactly +-1, the scores are
    exact integers and every entry is exactly 0 or 1.0 in both
    packages: rows tie more than k times and every tie is kept. Values
    at both alphas; gradients at alpha 3 (at 20 none pass)."""
    rng = np.random.default_rng(0)
    v1 = rng.standard_normal((N, 8)).astype(np.float32)
    v2 = rng.standard_normal((N, 8)).astype(np.float32)
    v2[12:] = 0.0
    v1[15] = 0.0
    k = 6
    for alpha in (3.0, 20.0):
        if alpha == 20.0:
            v1, v2 = (np.sign(v) * (1 + np.abs(v)) for v in (v1, v2))
        jv, jvjp = jax.vjp(lambda a, b: jgc.mtgnn_graph(a, b, alpha, k),
                           jnp.asarray(v1), jnp.asarray(v2))
        want = np.asarray(jv)
        pos = (want > 0).sum(axis=1)
        assert pos[15] == 0 and ((pos > 0) & (pos < k)).any()
        if alpha == 20.0:
            assert ((want == 1.0).sum(axis=1) > k).sum() >= 5
        t1, t2 = (torch.tensor(a, requires_grad=True) for a in (v1, v2))
        got = tgc.mtgnn_graph(t1, t2, alpha, k)
        # a score is a difference of two dot products of up to 8 in
        # size, summed in another order: ~ulp(8) * alpha ~ 3e-6
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        if alpha == 3.0:
            g = rng.standard_normal((N, N)).astype(np.float32)
            got.backward(torch.tensor(g))
            # 1 - tanh^2 near saturation keeps only the digits that
            # 1 - 2^-24 leaves: each term's error is ~ulp(1) * alpha *
            # |g| ~ 1e-6 (up to 24 of them summed), hence atol 2e-5
            for t, w in zip((t1, t2), jvjp(jnp.asarray(g))):
                assert np.abs(np.asarray(w)).max() > 0
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=2e-5)
    # k at or above N: no sparsification
    np.testing.assert_allclose(
        tgc.mtgnn_graph(t1, t2, 3.0, N).detach().numpy(),
        np.asarray(jgc.mtgnn_graph(jnp.asarray(v1), jnp.asarray(v2),
                                   3.0, N)), rtol=1e-5, atol=1e-5)


def test_mixprop_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, N, 4)).astype(np.float32)
    adj = np.maximum(rng.standard_normal((N, N)), 0).astype(np.float32)
    w = rng.standard_normal((12, 6)).astype(np.float32)
    g = rng.standard_normal((2, 5, N, 6)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda a, b, c: jgc.mixprop(a, b, c, 2, 0.05),
                         *map(jnp.asarray, (x, adj, w)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, adj, w)]
    out = tgc.mixprop(*ts, 2, 0.05)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for t, want in zip(ts, jvjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_node_layer_norm_and_dilated_inception_match_jax():
    rng = np.random.default_rng(2)
    x = (2.0 + rng.standard_normal((3, 16, N, 8))).astype(np.float32)
    jm = jmtgnn.NodeLayerNorm((16, N, 8))
    p = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    m = NodeLayerNorm((16, N, 8))
    m.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()})
    np.testing.assert_allclose(m(torch.tensor(x)).detach().numpy(),
                               np.asarray(jm.apply(p, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    for dilation in (1, 2):
        jm = jtemporal.DilatedInception(c_out=8, dilation=dilation)
        p = _noisy(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
        m = DilatedInception(8, 8, dilation)
        # flax Conv kernels (kt, 1, in, out) -> (out, in, kt, 1)
        m.load_state_dict({
            f"conv.{j}.{leaf}": torch.tensor(
                np.transpose(v, (3, 2, 0, 1)) if leaf == "weight" else v)
            for j in range(4)
            for leaf, v in (("weight", p["params"][f"Conv_{j}"]["kernel"]),
                            ("bias", p["params"][f"Conv_{j}"]["bias"]))})
        xt = torch.tensor(x, requires_grad=True)
        out = m(xt)
        jout, jvjp = jax.vjp(lambda a: jm.apply(p, a), jnp.asarray(x))
        assert out.shape == jout.shape == (3, 16 - 6 * dilation, N, 8)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        g = rng.standard_normal(out.shape).astype(np.float32)
        out.backward(torch.tensor(g))
        np.testing.assert_allclose(xt.grad.numpy(),
                                   np.asarray(jvjp(jnp.asarray(g))[0]),
                                   rtol=1e-5, atol=1e-5)


def _model_pair(**kw):
    cfg = dict(num_nodes=N, subgraph_size=6, dropout=0.0, **kw)
    jm = jmtgnn.MTGNN(cfg=jmtgnn.MTGNNConfig(**cfg), dim_in=1, dim_out=1,
                      horizon=12, lag=12)
    net = MTGNN(MTGNNConfig(**cfg), dim_in=1, dim_out=1, horizon=12,
                lag=12, generator=torch.Generator().manual_seed(0))
    return jm, net


def test_convert_round_trips_and_matches_the_flax_tree():
    pre = jnp.eye(N)
    for kw in ({}, {"gcn_true": False}):
        jm, net = _model_pair(**kw)
        sd = net.state_dict()
        back = flax_to_state_dict(state_dict_to_flax(sd))
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, 12, N, 1)), pre)
        assert (jax.tree.map(np.shape, state_dict_to_flax(sd))
                == jax.tree.map(lambda a: a.shape, shapes))


def test_model_loss_and_grads_match_jax():
    """Published widths (layers 3, conv/residual 32, skip 64, end 128),
    N = 24 with top-k 6, batch 3; loss = mean |pred - y| as the masked
    MAE without a mask."""
    jm, net = _model_pair()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, N, 1)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 1)).astype(np.float32)
    # the port's init carried to JAX (a JAX init is one more compile)
    params = _noisy(state_dict_to_flax(net.state_dict()))
    # the learned graph's top-k is a threshold: where tanh saturates,
    # an entry that rounds to 1.0 in one package and to 1 - 2^-24 in
    # the other (the products sum in another order) lands on the other
    # side of a tie. Embeddings at 0.1 of their scale keep the graph
    # off saturation, with a clear gap at every row's k-th value (the
    # ties are held in `test_mtgnn_graph_with_short_rows_and_ties`).
    gc = params["params"]["gc"]
    gc["emb1"], gc["emb2"] = 0.1 * gc["emb1"], 0.1 * gc["emb2"]

    def jloss(p):
        pred = jm.apply(p, jnp.asarray(x))
        return jnp.abs(pred - jnp.asarray(y)).mean(), pred

    (jl, jpred), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    net.load_state_dict(flax_to_state_dict(params))
    srt = net.gc().detach().sort(dim=1, descending=True).values
    kth = srt[:, 5] > 0
    assert float((srt[kth, 5] - srt[kth, 6]).min()) > 1e-4
    pred = net(torch.tensor(x))
    loss = (pred - torch.tensor(y)).abs().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               rtol=1e-4, atol=1e-5 * np.abs(jpred).max())
    got = _leaves(state_dict_to_flax(
        {k: p.grad for k, p in net.named_parameters()}))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(got) == len(want)
    for path, w in want:
        w = np.asarray(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_predefined_adjacency_and_init_laws():
    """`build_adj=False` reads `_build_mtgnn`'s A - I (no `gc`); the init
    laws: embeddings N(0, 1), mixprop weights xavier uniform, convs and
    Dense lecun normal with zero biases, norms ones and zeros."""
    cfg = default_config("PEMS08", mode="ori", model="MTGNN", num_nodes=N,
                         predictor_overrides=(("build_adj", "False"),))
    adj = np.ones((N, N), np.float32)
    pred = tbuild.build_predictor(cfg, adj=adj, device="cpu")
    assert not hasattr(pred.net, "gc")
    torch.testing.assert_close(pred.graph[0], torch.ones(N, N)
                               - torch.eye(N))
    net = MTGNN(MTGNNConfig(num_nodes=3000, node_dim=40), dim_in=64,
                dim_out=1, horizon=12, lag=12,
                generator=torch.Generator().manual_seed(0)).requires_grad_(
                    False)
    for e in (net.gc.emb1, net.gc.emb2):
        assert abs(float(e.mean())) < 0.02 and abs(float(e.std()) - 1) < 0.02
    w = net.mixprop1_w_0
    lim = np.sqrt(6.0 / sum(w.shape))
    assert float(w.abs().max()) <= lim
    assert abs(float(w.std()) / (lim / np.sqrt(3.0)) - 1.0) < 0.05
    for t, fan in ((net.skip0.weight, 19 * 64), (net.skips[0].weight, 13 * 32),
                   (net.end_conv_1.weight, 64), (net.start_conv.weight, 64)):
        assert abs(float(t.std()) * np.sqrt(fan) - 1.0) < 0.06
    assert not net.skip0.bias.any() and not net.end_conv_2.bias.any()
    assert all(bool((m.weight == 1).all() and (m.bias == 0).all())
               for m in net.norm)
