"""`gptst_tpu_torch/kernels/spmm.py` against the JAX package's.

* Builders (numpy in both packages) give EQUAL arrays, including the 8
  zero pad blocks and `dia_pair_from_coo`'s transposed band.
* The device ops on the CPU take the kernels' plain PyTorch versions;
  they match the JAX ops (Pallas kernels in interpret mode) forward and
  in dX through autograd. Tolerance: f32 rtol/atol 1e-5 (the sums run
  in another order); with bf16 x the outputs are bf16 and may differ by
  one bf16 rounding (rtol 2^-7).
* A NaN in a stored block reaches its output row in both.
* d block_vals (CPU only) matches `_spmm_dvals` where asked for.

The CUDA kernels are held against the plain versions on the card in
`test_torch_cuda.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu_torch.kernels import spmm as tspmm

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        jspmm.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _graph(n, seed=0, density=0.08, band=None):
    rng = np.random.default_rng(seed)
    if band is None:
        adj = (rng.random((n, n)) < density) * rng.uniform(0.1, 1.0, (n, n))
    else:
        i, j = np.indices((n, n))
        adj = (np.abs(i - j) <= band) * rng.uniform(0.1, 1.0, (n, n))
    return adj.astype(np.float32)


def _edges(adj):
    rows, cols = np.nonzero(adj)
    return rows, cols, adj[rows, cols]


def _eq_bcsr(t, j):
    np.testing.assert_array_equal(t.block_ptr.numpy(), np.asarray(j.block_ptr))
    np.testing.assert_array_equal(t.block_cols.numpy(),
                                  np.asarray(j.block_cols))
    np.testing.assert_array_equal(t.block_vals.float().numpy(),
                                  np.asarray(j.block_vals, np.float32))
    assert (t.n, t.n_pad, t.tile) == (j.n, j.n_pad, j.tile)


@pytest.mark.parametrize("tile", [16, 64])
def test_block_csr_builders_equal(tile):
    adj = _graph(150, seed=1)
    rows, cols, vals = _edges(adj)
    kw = dict(device="cpu")
    _eq_bcsr(tspmm.BlockCSR.from_dense(adj, tile, **kw),
             jspmm.BlockCSR.from_dense(adj, tile))
    _eq_bcsr(tspmm.BlockCSR.from_coo(rows, cols, vals, 150, tile, **kw),
             jspmm.BlockCSR.from_coo(rows, cols, vals, 150, tile))
    for t, j in zip(tspmm.BlockCSR.pair_from_coo(rows, cols, vals, 150, tile,
                                                 **kw),
                    jspmm.BlockCSR.pair_from_coo(rows, cols, vals, 150, tile)):
        _eq_bcsr(t, j)
    for t, j in zip(tspmm.BlockCSR.pair_from_dense(adj, tile, **kw),
                    jspmm.BlockCSR.pair_from_dense(adj, tile)):
        _eq_bcsr(t, j)
    a = tspmm.BlockCSR.from_dense(adj, tile, **kw)
    _eq_bcsr(a.transpose(), jspmm.BlockCSR.from_dense(adj, tile).transpose())
    # the 8 zero pad blocks after the real ones
    assert a.block_vals.shape[0] == int(a.block_ptr[-1]) + 8
    assert not a.block_vals[-8:].any()


def test_hybrid_and_dia_builders_equal():
    n, tile = 200, 64
    adj = _graph(n, seed=2, band=12)
    far = np.random.default_rng(3).integers(0, n, (2, 30))
    adj[far[0], (far[0] + n // 2) % n] = 0.7
    rows, cols, vals = _edges(adj)
    np.testing.assert_array_equal(
        tspmm.coo_split_mask(rows, cols, n, tile),
        jspmm.coo_split_mask(rows, cols, n, tile))
    got = tspmm.split_coo_hybrid(rows, cols, vals, n, tile, device="cpu")
    want = jspmm.split_coo_hybrid(rows, cols, vals, n, tile)
    _eq_bcsr(got[0], want[0])
    _eq_bcsr(got[1], want[1])
    assert got[2] is not None and got[2].nnz == want[2].nnz > 0
    for t, j in zip(got[2:], want[2:]):
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    mask = tspmm.coo_split_mask(rows, cols, n, tile)
    tp = tspmm.dia_pair_from_coo(rows[mask], cols[mask], vals[mask], n, tile,
                                 device="cpu")
    jp = jspmm.dia_pair_from_coo(rows[mask], cols[mask], vals[mask], n, tile)
    assert tp is not None and jp is not None
    for t, j in zip(tp, jp):       # the band and its transpose
        assert (t.w, t.n, t.n_pad, t.tile) == (j.w, j.n, j.n_pad, j.tile)
        np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    # a wide graph is no band
    r2, c2, v2 = _edges(_graph(800, seed=4, density=0.01))
    assert tspmm.dia_pair_from_coo(r2, c2, v2, 800, tile,
                                   device="cpu") is None
    assert jspmm.dia_pair_from_coo(r2, c2, v2, 800, tile) is None


def _both(fn_t, fn_j, x, dtype):
    """Forward and dX of both packages on the same x (numpy f32) and the
    same cotangent; returns ((y_t, dx_t), (y_j, dx_j)) as f32 numpy."""
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    xt = torch.tensor(x).to(dtype).requires_grad_()
    yt = fn_t(xt)
    yt.backward(torch.tensor(g).to(dtype))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    yj, vjp = jax.vjp(fn_j, jnp.asarray(x, jd))
    (dxj,) = vjp(jnp.asarray(g, jd))
    assert yt.dtype == dtype and xt.grad.dtype == dtype
    return ((yt.detach().float().numpy(), xt.grad.float().numpy()),
            (np.asarray(yj, np.float32), np.asarray(dxj, np.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,n", [(16, 150), (64, 200)])
def test_spmm_forward_and_dx(tile, n, dtype):
    adj = _graph(n, seed=5)
    ta, tat = tspmm.BlockCSR.pair_from_dense(adj, tile, device="cpu")
    ja, jat = jspmm.BlockCSR.pair_from_dense(adj, tile)
    x = np.random.default_rng(6).standard_normal((3, n, 5)).astype(np.float32)
    (yt, dt), (yj, dj) = _both(lambda v: tspmm.spmm(ta, tat, v),
                               lambda v: jspmm.spmm(ja, jat, v), x, dtype)
    np.testing.assert_allclose(yt, yj, **TOL[dtype])
    np.testing.assert_allclose(dt, dj, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_matmul_forward_and_dx(dtype):
    n, tile = 200, 16
    adj = _graph(n, seed=8, band=20)
    rows, cols, vals = _edges(adj)
    td, tdt = tspmm.dia_pair_from_coo(rows, cols, vals, n, tile, device="cpu")
    jd, jdt = jspmm.dia_pair_from_coo(rows, cols, vals, n, tile)
    x = np.random.default_rng(9).standard_normal((n, 24)).astype(np.float32)
    (yt, dt), (yj, dj) = _both(lambda v: tspmm.dia_matmul(td, tdt, v),
                               lambda v: jspmm.dia_matmul(jd, jdt, v), x,
                               dtype)
    np.testing.assert_allclose(yt, yj, **TOL[dtype])
    np.testing.assert_allclose(dt, dj, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coo_matmul_forward_and_dx(dtype):
    n = 90
    rng = np.random.default_rng(10)
    rows = rng.integers(0, n, 300)
    cols = rng.integers(0, n, 300)
    vals = rng.uniform(0.1, 1.0, 300).astype(np.float32)
    mask = np.zeros(300, bool)          # everything rides the tail
    *_, tc, tct = tspmm.split_coo_hybrid(rows, cols, vals, n, 16, mask=mask,
                                         device="cpu")
    *_, jc, jct = jspmm.split_coo_hybrid(rows, cols, vals, n, 16, mask=mask)
    x = rng.standard_normal((2, n, 7)).astype(np.float32)
    (yt, dt), (yj, dj) = _both(lambda v: tspmm.coo_matmul(tc, tct, v),
                               lambda v: jspmm.coo_matmul(jc, jct, v), x,
                               dtype)
    np.testing.assert_allclose(yt, yj, **TOL[dtype])
    np.testing.assert_allclose(dt, dj, **TOL[dtype])


def test_nan_in_stored_block_propagates():
    n, tile = 100, 16
    adj = _graph(n, seed=11)
    ta, tat = tspmm.BlockCSR.pair_from_dense(adj, tile, device="cpu")
    ja, jat = jspmm.BlockCSR.pair_from_dense(adj, tile)
    row_tile = 2
    b = int(ta.block_ptr[row_tile])
    assert int(ta.block_ptr[row_tile + 1]) > b
    vals = ta.block_vals.clone()
    vals[b, 3, 0] = float("nan")
    ta = dataclasses.replace(ta, block_vals=vals)
    ja = dataclasses.replace(ja, block_vals=jnp.asarray(vals.numpy()))
    x = np.random.default_rng(12).standard_normal((n, 6)).astype(np.float32)
    yt = tspmm.spmm(ta, tat, torch.tensor(x)).numpy()
    yj = np.asarray(jspmm.spmm(ja, jat, jnp.asarray(x)))
    nan_rows = np.isnan(yt).any(axis=1)
    assert nan_rows.sum() == 1 and nan_rows[row_tile * tile + 3]
    assert np.isnan(yt[row_tile * tile + 3]).all()
    np.testing.assert_array_equal(np.isnan(yt), np.isnan(yj))
    np.testing.assert_allclose(yt[~nan_rows], yj[~nan_rows], rtol=1e-5,
                               atol=1e-5)


def test_block_vals_grad_matches_dvals():
    """d block_vals only where asked for; equal to `_spmm_dvals`."""
    n, tile = 120, 16
    adj = _graph(n, seed=13)
    ta, tat = tspmm.BlockCSR.pair_from_dense(adj, tile, device="cpu")
    ja, _ = jspmm.BlockCSR.pair_from_dense(adj, tile)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, n, 3)).astype(np.float32)
    g = rng.standard_normal((2, n, 3)).astype(np.float32)
    vals = ta.block_vals.clone().requires_grad_()
    y = tspmm.spmm(dataclasses.replace(ta, block_vals=vals), tat,
                   torch.tensor(x))
    y.backward(torch.tensor(g))
    want = np.asarray(jspmm._spmm_dvals(ja, jnp.asarray(g), jnp.asarray(x)))
    np.testing.assert_allclose(vals.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not vals.grad[-8:].any()
    # a constant support asks for no d block_vals
    xt = torch.tensor(x, requires_grad=True)
    tspmm.spmm(ta, tat, xt).sum().backward()
    assert ta.block_vals.grad is None


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = tspmm.BlockCSR.from_dense(_graph(40, seed=15), 16, device="cpu")
    with pytest.raises(ValueError):
        tspmm.bsr_spmm(a, torch.zeros(40, 3, device="meta"))
