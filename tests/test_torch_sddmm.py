"""The port's SDDMM, learned supports and d block_vals against the JAX
package's.

The same numpy inputs go through `gptst_tpu/kernels/sddmm.py` (its
Pallas kernels in interpret mode) and `gptst_tpu_torch/kernels/sddmm.py`
(the plain PyTorch versions, which the wrappers take for CPU tensors).
Tolerances: 1e-5 on the sampled products (f32 sums of d terms in
another order), 1e-4 where a softmax, a sparse sum or a gradient sums
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu.kernels import sddmm as jsddmm
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.ops.graph_conv import graph_matmul as jgraph_matmul
from gptst_tpu_torch.kernels import sddmm as tsddmm
from gptst_tpu_torch.kernels import spmm as tspmm
from gptst_tpu_torch.ops.graph_conv import graph_matmul
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    patched = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(jsddmm.pl, "pallas_call", patched)
    monkeypatch.setattr(jspmm.pl, "pallas_call", patched)


def _patterns(n, tile, seed=0):
    """The same pattern in both packages, from one sparse graph."""
    adj = sym_adj(random_sensor_graph(n, avg_degree=5, seed=seed))
    jp = jsddmm.SDDMMPattern.from_bcsr(jspmm.BlockCSR.from_dense(adj, tile))
    tp = tsddmm.SDDMMPattern.from_bcsr(
        tspmm.BlockCSR.from_dense(adj, tile, device="cpu"))
    return adj, jp, tp


def _emb(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((d, n)).astype(np.float32))


@pytest.mark.parametrize("n,tile", [(60, 16), (170, 128)])
def test_pattern_arrays_equal(n, tile):
    _, jp, tp = _patterns(n, tile)
    for name in ("row_ids", "cols", "ptr", "mask", "t_ptr", "t_cols",
                 "t_order"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    assert (tp.n, tp.n_pad, tp.tile) == (jp.n, jp.n_pad, jp.tile)
    assert tp.mask[-8:].abs().sum() == 0 and tp.nnzb == jp.nnzb


@pytest.mark.parametrize("n,tile,d", [(60, 16, 10), (170, 128, 10),
                                      (50, 16, 3)])
def test_sddmm_forward_matches(n, tile, d):
    _, jp, tp = _patterns(n, tile)
    e1, e2 = _emb(n, d, 1)
    want = np.asarray(jsddmm.sddmm(jp, jnp.asarray(e1), jnp.asarray(e2)))
    got = tsddmm.sddmm(tp, torch.tensor(e1), torch.tensor(e2))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tsddmm.sddmm_plain(tp, torch.tensor(e1), torch.tensor(e2)).numpy(),
        np.asarray(jsddmm.sddmm_reference(jp, e1, e2)), rtol=1e-5, atol=1e-5)


def test_sddmm_gradients_match():
    n, d = 60, 6
    _, jp, tp = _patterns(n, 16)
    e1, e2 = _emb(n, d, 2)
    w = np.random.default_rng(3).standard_normal(
        (jp.nnzb, 16, 16)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda a, b: jnp.sum(jsddmm.sddmm(jp, a, b) * w),
                          argnums=(0, 1)))(jnp.asarray(e1), jnp.asarray(e2))
    t1 = torch.tensor(e1, requires_grad=True)
    t2 = torch.tensor(e2, requires_grad=True)
    (tsddmm.sddmm(tp, t1, t2) * torch.tensor(w)).sum().backward()
    for got, want in zip((t1.grad, t2.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("n,tile", [(60, 16), (45, 16)])
def test_adaptive_support_forward_and_grads_match(n, tile):
    _, jp, tp = _patterns(n, tile, seed=4)
    e1, e2 = _emb(n, 10, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, n, 5)).astype(np.float32)
    g = rng.standard_normal((2, n, 5)).astype(np.float32)

    def jloss(a, b):
        y = jgraph_matmul(jsddmm.adaptive_support(jp, a, b), jnp.asarray(x))
        return jnp.sum(y * g), y

    (_, jy), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(e1),
                                               jnp.asarray(e2))
    t1 = torch.tensor(e1, requires_grad=True)
    t2 = torch.tensor(e2, requires_grad=True)
    y = graph_matmul(tsddmm.adaptive_support(tp, t1, t2), torch.tensor(x))
    (y * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    for got, want in zip((t1.grad, t2.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_mtgnn_support_forward_matches():
    n, d, alpha = 60, 10, 3.0
    _, jp, tp = _patterns(n, 16, seed=7)
    rng = np.random.default_rng(8)
    m1, m2, x = (rng.standard_normal(s).astype(np.float32)
                 for s in ((n, d), (n, d), (n, 5)))
    want = jgraph_matmul(jsddmm.mtgnn_support(jp, m1, m2, alpha),
                         jnp.asarray(x))
    got = graph_matmul(tsddmm.mtgnn_support(
        tp, torch.tensor(m1), torch.tensor(m2), alpha), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n,tile,shape", [(60, 16, (3, 60, 7)),
                                          (150, 64, (150, 130))])
def test_spmm_dvals_plain_matches(n, tile, shape):
    """Ragged F (21 and 130 columns), pad blocks zero."""
    adj = sym_adj(random_sensor_graph(n, avg_degree=5, seed=9))
    jb = jspmm.BlockCSR.from_dense(adj, tile)
    tb = tspmm.BlockCSR.from_dense(adj, tile, device="cpu")
    rng = np.random.default_rng(10)
    g = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jspmm._spmm_dvals(jb, jnp.asarray(g), jnp.asarray(x)))
    got = tspmm.spmm_dvals(tb, torch.tensor(g), torch.tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert got[tb.nnzb_logical:].abs().sum() == 0


def test_dvals_through_spmm_on_learned_values_match():
    n = 60
    _, jp, tp = _patterns(n, 16, seed=11)
    rng = np.random.default_rng(12)
    vals = rng.standard_normal((jp.nnzb, 16, 16)).astype(np.float32)
    vals *= np.asarray(jp.mask)
    x = rng.standard_normal((2, n, 4)).astype(np.float32)
    g = rng.standard_normal((2, n, 4)).astype(np.float32)

    def jloss(v):
        fwd = jspmm.BlockCSR(block_ptr=jp.ptr, block_cols=jp.cols,
                             block_vals=v, n=n, n_pad=jp.n_pad, tile=16)
        bwd = jspmm.BlockCSR(
            block_ptr=jp.t_ptr, block_cols=jp.t_cols,
            block_vals=jnp.take(v, jp.t_order, 0).transpose(0, 2, 1),
            n=n, n_pad=jp.n_pad, tile=16)
        return jnp.sum(jspmm.spmm(fwd, bwd, jnp.asarray(x)) * g)

    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(vals)))
    tv = torch.tensor(vals, requires_grad=True)
    sup = tsddmm._learned_support(tp, tv)
    (graph_matmul(sup, torch.tensor(x)) * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), jg, rtol=1e-5, atol=1e-5)
