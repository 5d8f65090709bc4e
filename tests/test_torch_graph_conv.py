"""`gptst_tpu_torch/ops/graph_conv.py` against the JAX package's.

`make_support` picks the same representation (dense vs sparse, RCM
permutation, DIA band vs block-CSR, COO tail) with equal arrays, and
`graph_matmul` / `.T` match forward and in dX. Tolerance rtol/atol 1e-5:
the port's plain kernel versions sum in another order than the JAX
Pallas kernels (interpret mode) and dense einsum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.ops import graph_conv as jgc
from gptst_tpu_torch.ops import graph_conv as tgc
from test_partition import scrambled_band_graph


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        jspmm.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _banded(n, band, seed):
    rng = np.random.default_rng(seed)
    i, j = np.indices((n, n))
    adj = (np.abs(i - j) <= band) * rng.uniform(0.2, 1.0, (n, n))
    return sym_adj(adj.astype(np.float32))


GRAPHS = {
    "random": lambda: sym_adj(random_sensor_graph(300, avg_degree=5, seed=1)),
    "banded": lambda: _banded(200, 14, seed=2),
    "scrambled_band": lambda: sym_adj(scrambled_band_graph(160, band=3,
                                                           seed=4)),
}


def _np(t):
    return None if t is None else np.asarray(
        t.float().cpu().numpy() if isinstance(t, torch.Tensor) else t,
        np.float64)


def _assert_same_support(t, j):
    assert isinstance(t, tgc.SparseSupport) and isinstance(j, jgc.SparseSupport)
    for f in ("perm", "inv_perm"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(a), _np(b))
    assert (t.dia is None) == (j.dia is None)
    if t.dia is not None:
        assert t.dia.w == j.dia.w
        np.testing.assert_array_equal(_np(t.dia.vals), _np(j.dia.vals))
        np.testing.assert_array_equal(_np(t.dia_t.vals), _np(j.dia_t.vals))
    for f in ("block_ptr", "block_cols", "block_vals"):
        np.testing.assert_array_equal(_np(getattr(t.bcsr, f)),
                                      _np(getattr(j.bcsr, f)))
    assert (t.coo is None) == (j.coo is None)
    if t.coo is not None:
        assert t.coo.nnz == j.coo.nnz
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(_np(getattr(t.coo_t, f)),
                                          _np(getattr(j.coo_t, f)))


@pytest.mark.parametrize("tile", [16, 64])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_make_support_same_representation(graph, tile):
    adj = GRAPHS[graph]()
    t = tgc.make_support(adj, dense_threshold=0, tile=tile, device="cpu")
    j = jgc.make_support(adj, dense_threshold=0, tile=tile)
    _assert_same_support(t, j)
    if graph == "scrambled_band" and tile == 16:
        assert t.perm is not None          # RCM kept
    if graph == "banded" and tile == 16:
        assert t.dia is not None           # DIA band
    if graph == "random" and tile == 16:
        assert t.dia is None               # block-CSR
    dense = tgc.make_support(adj, device="cpu")
    assert isinstance(dense, torch.Tensor)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(
        jgc.make_support(adj)))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_graph_matmul_matches(graph, transpose):
    adj = GRAPHS[graph]()
    t = tgc.make_support(adj, dense_threshold=0, tile=16, device="cpu")
    j = jgc.make_support(adj, dense_threshold=0, tile=16)
    if transpose:
        t, j = t.T, j.T
    n = adj.shape[0]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, n, 6)).astype(np.float32)
    g = rng.standard_normal((2, n, 6)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    yt = tgc.graph_matmul(t, xt)
    yt.backward(torch.tensor(g))
    yj, vjp = jax.vjp(lambda v: jgc.graph_matmul(j, v), jnp.asarray(x))
    (dj,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dj),
                               rtol=1e-5, atol=1e-5)
    # and the dense support gives the same product
    dense = torch.tensor(adj.T if transpose else adj)
    np.testing.assert_allclose(tgc.graph_matmul(dense, torch.tensor(x)),
                               yt.detach().numpy(), rtol=1e-5, atol=1e-5)
