"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without
one. The file imports neither JAX nor the JAX package, so it also runs
on a GPU host without JAX, where the suite's conftest (which imports
JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: f32 rtol/atol 1e-5 (the kernel sums the blocks in another
order than the plain version's batched products); a bf16 output may
differ by one bf16 rounding (rtol 2^-7).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gptst_tpu_torch.kernels import spmm as K
from gptst_tpu_torch.ops.graph_conv import graph_matmul, make_support

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _graph(n, seed, band=None, density=0.05):
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


@pytest.mark.parametrize("tile,n,f", [(16, 150, 7), (64, 200, 130),
                                      (128, 300, 64)])
def test_cuda_kernels_match_plain(card, tile, n, f):
    """Ragged rows and widths, both structures, f32 and bf16 x, f32 and
    bf16 values."""
    rows, cols, vals = _edges(_graph(n, seed=16, band=2 * tile))
    a, at = K.BlockCSR.pair_from_coo(rows, cols, vals, n, tile, device=card)
    d, dt = K.dia_pair_from_coo(rows, cols, vals, n, tile, device=card)
    x = torch.randn(n, f, device=card)
    for vdtype in (torch.float32, torch.bfloat16):
        structs = [
            (K.bsr_spmm, K.bsr_spmm_plain, dataclasses.replace(
                s, block_vals=s.block_vals.to(vdtype))) for s in (a, at)
        ] + [
            (K.dia_spmm, K.dia_spmm_plain, dataclasses.replace(
                s, vals=s.vals.to(vdtype))) for s in (d, dt)
        ]
        for xdtype in (torch.float32, torch.bfloat16):
            xd = x.to(xdtype)
            for kernel, plain, s in structs:
                got = kernel(s, xd)
                assert got.dtype == xdtype
                torch.testing.assert_close(got, plain(s, xd), **TOL[xdtype])


def _scrambled_band(n, seed):
    """A band graph plus a few far edges, its nodes shuffled: RCM
    restores the band (DIA) and the far edges ride the COO tail."""
    adj = _graph(n, seed, band=20)
    far = np.random.default_rng(seed + 2).integers(0, n, 12)
    adj[far, (far + n // 2) % n] = 0.7
    p = np.random.default_rng(seed + 3).permutation(n)
    return adj[p][:, p]


@pytest.mark.parametrize("graph,kernel", [("random", "bsr_spmm"),
                                          ("scrambled_band", "dia_spmm")])
def test_cuda_graph_matmul_matches_cpu(card, graph, kernel):
    """Forward and dX through autograd, behind the RCM permutation and
    with the COO tail, on the card against the CPU."""
    n = 600
    adj = (_graph(n, seed=3, density=0.01) if graph == "random"
           else _scrambled_band(n, seed=3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, n, 5)).astype(np.float32)
    g = rng.standard_normal((2, n, 5)).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        sup = make_support(adj, dense_threshold=0, tile=32, device=dev)
        assert sup.perm is not None and sup.coo is not None
        assert (sup.dia is not None) == (kernel == "dia_spmm")
        xt = torch.tensor(x, device=dev, requires_grad=True)
        before = K.LAUNCHES[kernel]
        y = graph_matmul(sup, xt)
        y.backward(torch.tensor(g, device=dev))
        out[str(dev)] = (y.detach().cpu(), xt.grad.cpu())
        assert K.LAUNCHES[kernel] - before == (2 if dev == card else 0)
    for got, want in zip(out[str(card)], out["cpu"]):
        torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_cuda_nan_in_stored_block_propagates(card):
    n, tile = 100, 16
    a = K.BlockCSR.from_dense(_graph(n, seed=11, density=0.1), tile,
                              device=card)
    b = int(a.block_ptr[2])
    assert int(a.block_ptr[3]) > b
    vals = a.block_vals.clone()
    vals[b, 3, 0] = float("nan")
    y = K.bsr_spmm(dataclasses.replace(a, block_vals=vals),
                   torch.randn(n, 6, device=card))
    nan_rows = torch.isnan(y).any(dim=1)
    assert int(nan_rows.sum()) == 1 and bool(nan_rows[2 * tile + 3])
    assert bool(torch.isnan(y[2 * tile + 3]).all())


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(card):
    a = K.BlockCSR.from_dense(_graph(40, seed=15, density=0.2), 16,
                              device=card)
    x = torch.randn(40, 8, device=card)
    with pytest.raises(TypeError):
        K.bsr_spmm(a, x.double())
    with pytest.raises(ValueError):
        K.bsr_spmm(a, torch.randn(8, 40, device=card).t())   # not contiguous
    with pytest.raises(ValueError):
        K.bsr_spmm(a, x[:30].contiguous())                   # wrong n
    with pytest.raises(ValueError):
        K.bsr_spmm(dataclasses.replace(a, block_vals=a.block_vals.cpu()), x)
    with pytest.raises(NotImplementedError):
        K.spmm_dvals(a, x, x)
