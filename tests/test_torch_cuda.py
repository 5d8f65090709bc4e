"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without
one. The file imports neither JAX nor the JAX package, so it also runs
on a GPU host without JAX, where the suite's conftest (which imports
JAX) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: f32 rtol/atol 1e-5 (the kernel sums the blocks in another
order than the plain version's batched products); a bf16 output may
differ by one bf16 rounding (rtol 2^-7). `sddmm` and `spmm_dvals`
write f32 whatever their inputs' dtype; `spmm_dvals` sums up to ~1000
products per slot, hence its atol 1e-4.

`bsr_spmm` and `dia_spmm` sum only the entries of clean blocks and run
a block densely where a non-finite input needs it; `K.DENSE_BLOCKS`
counts those blocks on the card: 0 on finite inputs, above 0 in the
non-finite cases.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gptst_tpu_torch.kernels import sddmm as S
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


def _f32_sum_bound(plain, s, attr, x, k):
    """Per output, the most two f32 summation orders of its k products
    can differ by: each order's rounding error is at most
    gamma_k * sum |a| |x|, gamma_k = k u / (1 - k u), u = 2^-24 (the
    standard bound for a sum of k products, any order, FMA or not); so
    twice that. `sum |a| |x|` is the plain version on |A| and |x|."""
    u = 2.0 ** -24
    mag = plain(dataclasses.replace(s, **{attr: getattr(s, attr).abs()}),
                x.abs())
    return 2 * (k * u / (1 - k * u)) * mag


@pytest.mark.parametrize("tile,n,f,band", [
    (16, 150, 7, 32), (32, 250, 96, 64), (64, 200, 130, 128),
    (128, 300, 64, 256), (128, 300, 1000, 64)])
def test_cuda_kernels_match_plain(card, tile, n, f, band):
    """Ragged rows and widths (F not a multiple of the 16-byte copies:
    plain loads; else cp.async), both structures, f32 and bf16 x, f32
    and bf16 values. At TB = 128 in f32 the two staged x tiles take
    64 KB of dynamic shared memory, and each row tile has 3 blocks
    (double buffering); F = 1000 spans 16 feature tiles, the last one
    ragged. Finite inputs: no block runs densely. x is drawn from a
    seeded generator. f32 outputs are held to the rounding bound of a
    sum of k products in two orders (`_f32_sum_bound`), k the largest
    row or column count of the graph: up to 300 at a band of +-256 on
    300 nodes, where a fixed atol of 1e-5 was too tight for an output
    that cancels (one failure in six runs of the card tests); bf16
    outputs to one bf16 rounding."""
    adj = _graph(n, seed=16, band=band)
    rows, cols, vals = _edges(adj)
    k = int(max((adj != 0).sum(0).max(), (adj != 0).sum(1).max()))
    a, at = K.BlockCSR.pair_from_coo(rows, cols, vals, n, tile, device=card)
    d, dt = K.dia_pair_from_coo(rows, cols, vals, n, tile, device=card)
    x = torch.randn(n, f, device=card, generator=torch.Generator(
        device=card).manual_seed(tile * 7919 + f))
    K.reset_launch_counts()
    for vdtype in (torch.float32, torch.bfloat16):
        structs = [
            (K.bsr_spmm, K.bsr_spmm_plain, "block_vals", dataclasses.replace(
                s, block_vals=s.block_vals.to(vdtype))) for s in (a, at)
        ] + [
            (K.dia_spmm, K.dia_spmm_plain, "vals", dataclasses.replace(
                s, vals=s.vals.to(vdtype))) for s in (d, dt)
        ]
        for xdtype in (torch.float32, torch.bfloat16):
            xd = x.to(xdtype)
            for kernel, plain, attr, s in structs:
                got = kernel(s, xd)
                assert got.dtype == xdtype
                want = plain(s, xd)
                if xdtype == torch.float32:
                    bound = _f32_sum_bound(plain, s, attr, xd, k)
                    assert bool(((got - want).abs() <= bound).all()), \
                        float(((got - want).abs() - bound).max())
                else:
                    torch.testing.assert_close(got, want, **TOL[xdtype])
    assert K.dense_block_counts() == {"bsr_spmm": 0, "dia_spmm": 0}
    assert K.LAUNCHES["bsr_spmm"] == K.LAUNCHES["dia_spmm"] == 8


@pytest.mark.parametrize("case", ["nan_x_under_zero_slot", "inf_x",
                                  "nan_value_off_entry",
                                  "finite_value_off_entry"])
@pytest.mark.parametrize("kernel", ["bsr_spmm", "dia_spmm"])
def test_cuda_nonfinite_cases_run_blocks_densely(card, kernel, case):
    """0 * NaN, 0 * Inf and values outside the entries: the kernel
    gives the plain version's NaN, Inf and finite values, and counts
    the blocks it ran densely; the kernels' plain twin agrees."""
    n, tile, f = 300, 32, 200
    adj = _graph(n, seed=17, band=tile) if kernel == "dia_spmm" \
        else _graph(n, seed=17, density=0.03)
    rows, cols, vals = _edges(adj)
    if kernel == "dia_spmm":
        s, _ = K.dia_pair_from_coo(rows, cols, vals, n, tile, device=card)
        fn, plain, twin, attr = (K.dia_spmm, K.dia_spmm_plain,
                                 K.dia_spmm_entries_plain, "vals")
        blocks = s.blocks()
    else:
        s, _ = K.BlockCSR.pair_from_coo(rows, cols, vals, n, tile,
                                        device=card)
        fn, plain, twin, attr = (K.bsr_spmm, K.bsr_spmm_plain,
                                 K.bsr_spmm_entries_plain, "block_vals")
        blocks = s
    x = torch.randn(n, f, device=card)
    if case in ("nan_x_under_zero_slot", "inf_x"):
        x[40, 130] = float("nan") if case.startswith("nan") else float("inf")
    else:
        b = int(blocks.block_ptr[1])        # the first block of row tile 1
        off = ~K.entry_mask_bits(blocks.entries.mask, tile)[b]
        r, k = map(int, off.nonzero()[0])
        v = getattr(s, attr).clone()
        v.view(-1, tile, tile)[b, r, k] = (float("nan") if case.startswith(
            "nan") else 0.5)
        s = dataclasses.replace(s, **{attr: v})
    K.reset_launch_counts()
    got = fn(s, x)
    dense = K.dense_block_counts()[kernel]
    want = plain(s, x)
    assert dense > 0
    for ref in (want, twin(s, x)):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        torch.testing.assert_close(got, ref, **TOL[torch.float32],
                                   equal_nan=True)
    # 0 * Inf is NaN too; a finite value outside the entries makes none
    assert bool(torch.isnan(got).any()) == (case != "finite_value_off_entry")
    assert bool(torch.isinf(got).any()) == (case == "inf_x")


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


def _directed_band(n, band, seed):
    """A weighted directed graph (5 out-edges per node within +-band,
    row-normalized as GWN's `asym_adj`): its pattern and values are not
    symmetric."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 5)
    cols = np.clip(rows + rng.integers(-band, band + 1, rows.size), 0, n - 1)
    adj = np.zeros((n, n), np.float32)
    adj[rows, cols] = rng.uniform(0.2, 1.0, rows.size)
    np.fill_diagonal(adj, 0.0)
    adj /= np.maximum(adj.sum(1, keepdims=True), 1e-12)
    assert not np.array_equal(adj != 0, adj.T != 0)
    return adj


@pytest.mark.parametrize("f", [256, 3072])
@pytest.mark.parametrize("graph,kernel", [("random", "bsr_spmm"),
                                          ("band", "dia_spmm")])
def test_cuda_directed_transposed_structures_at_gwn_widths(card, f, graph,
                                                           kernel):
    """GWN's aggregation: the transposed structure of a directed,
    row-normalized graph in the forward (`bcsr_t` / `dia_t`) and the
    original in the backward, at the widths of GWN's folded x (batch 8 x
    T x 32: F = 256 to 3,072), on 1,000 nodes (the last 128-row tile
    ragged), against the plain versions; then `graph_matmul(S.T, x)`
    and its dX through autograd, on the card against the CPU. No block
    runs densely."""
    n = 1000
    # "random": out-edges anywhere (block-CSR and a COO tail); "band":
    # within +-100 (a DIA band, w = 1)
    adj = (_directed_band(n, n, 41) if graph == "random"
           else _directed_band(n, 100, 42))
    rng = np.random.default_rng(43)
    x = rng.standard_normal((n, f)).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    K.reset_launch_counts()
    out = {}
    for dev in ("cpu", card):
        sup = make_support(adj, dense_threshold=0, device=dev)
        assert (sup.dia is not None) == (kernel == "dia_spmm")
        if dev == card:
            attr = "vals" if sup.dia is not None else "block_vals"
            plain = (K.dia_spmm_plain if sup.dia is not None
                     else K.bsr_spmm_plain)
            for s in ((sup.dia_t, sup.dia) if sup.dia is not None
                      else (sup.bcsr_t, sup.bcsr)):
                xc = torch.tensor(x, device=card)
                got = getattr(K, kernel)(s, xc)
                want = plain(s, xc)
                k = int((adj != 0).sum(0).max() if s is sup.bcsr_t
                        or s is sup.dia_t else (adj != 0).sum(1).max())
                bound = _f32_sum_bound(plain, s, attr, xc, k)
                assert bool(((got - want).abs() <= bound).all())
        xt = torch.tensor(x[None], device=dev, requires_grad=True)
        y = graph_matmul(sup.T, xt)
        y.backward(torch.tensor(g[None], device=dev))
        out[str(dev)] = (y.detach().cpu(), xt.grad.cpu())
    assert K.LAUNCHES[kernel] == 4
    assert K.dense_block_counts()[kernel] == 0
    for got, want in zip(out[str(card)], out["cpu"]):
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    a = torch.tensor(adj, dtype=torch.float64)
    torch.testing.assert_close(out["cpu"][0][0].double(),
                               a.T @ torch.tensor(x, dtype=torch.float64),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("graph,kernel", [("random", "bsr_spmm"),
                                          ("scrambled_band", "dia_spmm")])
def test_cuda_kernels_at_the_eval_width(card, graph, kernel):
    """F = 1,024, the eval-mode TGCN's x aggregation (batch 16 x the
    64-wide fused embedding), at TB = 128: the kernel on A and on the
    transposed structure against its plain version, and the forward and
    dX through autograd (the transposed launch that carries the
    gradient into the head) on the card against the CPU. Finite
    inputs: no block runs densely."""
    n, f = 1500, 1024
    adj = (_graph(n, seed=21, density=0.004) if graph == "random"
           else _scrambled_band(n, seed=21))
    rng = np.random.default_rng(22)
    # the node-major (N, B * D) operand TGCN's cell aggregates
    x = rng.standard_normal((n, f)).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    K.reset_launch_counts()
    out = {}
    for dev in ("cpu", card):
        sup = make_support(adj, dense_threshold=0, device=dev)
        assert (sup.dia is not None) == (kernel == "dia_spmm")
        if dev == card:
            pair = ((sup.dia, sup.dia_t) if sup.dia is not None
                    else (sup.bcsr, sup.bcsr_t))
            plain = getattr(K, f"{kernel}_plain")
            xf = torch.tensor(x, device=card)
            for s in pair:
                torch.testing.assert_close(getattr(K, kernel)(s, xf),
                                           plain(s, xf), **TOL[torch.float32])
        xt = torch.tensor(x, device=dev, requires_grad=True)
        y = graph_matmul(sup, xt)
        y.backward(torch.tensor(g, device=dev))
        out[str(dev)] = (y.detach().cpu(), xt.grad.cpu())
    for got, want in zip(out[str(card)], out["cpu"]):
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert K.LAUNCHES[kernel] == 4
    assert K.dense_block_counts()[kernel] == 0


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
    with pytest.raises(ValueError):                          # no entry lists
        K.bsr_spmm(dataclasses.replace(a, entries=None), x)
    with pytest.raises(TypeError):
        K.bsr_spmm(dataclasses.replace(a, entries=dataclasses.replace(
            a.entries, idx=a.entries.idx.long())), x)
    # d block_vals: a kernel now, with the same checks
    assert K.spmm_dvals(a, x, x).shape == a.block_vals.shape
    with pytest.raises(TypeError):
        K.spmm_dvals(a, x.double(), x.double())
    with pytest.raises(ValueError):
        K.spmm_dvals(a, x, x[:, :4])                         # g, x differ
    with pytest.raises(ValueError):
        K.spmm_dvals(a, x[:30], x[:30])                      # wrong n
    with pytest.raises(ValueError):
        K.spmm_dvals(dataclasses.replace(a, block_cols=a.block_cols.cpu()),
                     x, x)
    p = S.SDDMMPattern.from_bcsr(a)
    e1, e2 = torch.randn(40, 10, device=card), torch.randn(10, 40, device=card)
    assert S.sddmm_blocks(p, e1, e2).shape == a.block_vals.shape
    with pytest.raises(TypeError):
        S.sddmm_blocks(p, e1.double(), e2)
    with pytest.raises(ValueError):
        S.sddmm_blocks(p, e1, e2[:, :30])                    # wrong e2
    with pytest.raises(ValueError):
        S.sddmm_blocks(p, e2.t(), e2)                        # not contiguous
    with pytest.raises(ValueError):
        S.sddmm_blocks(dataclasses.replace(p, mask=p.mask.cpu()), e1, e2)


def _pattern(n, tile, seed, device):
    """An SDDMM pattern over a random sparse graph of n nodes (ragged
    last tile, several blocks per row tile)."""
    adj = _graph(n, seed, density=0.03)
    return S.SDDMMPattern.from_bcsr(K.BlockCSR.from_dense(adj, tile,
                                                          device=device))


@pytest.mark.parametrize("tile,n,d", [(16, 150, 3), (64, 200, 10),
                                      (128, 300, 10), (128, 260, 20)])
def test_cuda_sddmm_matches_plain(card, tile, n, d):
    """f32 and bf16 e1/e2 (the output is f32 either way), ragged N, a
    rank below and above the kernel's 16-wide slice; pad blocks zero."""
    p = _pattern(n, tile, seed=21, device=card)
    e1, e2 = torch.randn(n, d, device=card), torch.randn(d, n, device=card)
    for t1 in (torch.float32, torch.bfloat16):
        for t2 in (torch.float32, torch.bfloat16):
            a, b = e1.to(t1), e2.to(t2)
            before = K.LAUNCHES["sddmm"]
            got = S.sddmm_blocks(p, a, b)
            assert K.LAUNCHES["sddmm"] == before + 1
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, S.sddmm_plain(p, a, b),
                                       **TOL[torch.float32])
            assert not got[-8:].any()


def test_cuda_sddmm_nan_survives_the_mask(card):
    """The product is multiplied by the mask, not selected with it: a NaN
    in e1 reaches every slot of its row in the blocks of its row tile,
    masked slots included, as in the plain version."""
    n, tile = 150, 16
    p = _pattern(n, tile, seed=22, device=card)
    e1, e2 = torch.randn(n, 10, device=card), torch.randn(10, n, device=card)
    e1[37, 4] = float("nan")
    got = S.sddmm_blocks(p, e1, e2)
    want = S.sddmm_plain(p, e1, e2)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    in_row = p.row_ids == 37 // tile
    assert bool(torch.isnan(got[in_row][:, 37 % tile]).all())
    assert not torch.isnan(got[~in_row]).any()
    fin = ~torch.isnan(want)
    torch.testing.assert_close(got[fin], want[fin], **TOL[torch.float32])


# d block_vals sums F products of N(0, 1) values in another order than
# the plain version's batched product: atol 1e-4 at F up to 1030
DVALS_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tile,n,f", [(16, 150, 7), (64, 200, 130),
                                      (128, 300, 1030), (128, 300, 1024)])
def test_cuda_spmm_dvals_matches_plain(card, tile, n, f):
    """Ragged N and F, f32 and bf16 g and x, pad blocks zero. At TB = 128
    with F a multiple of 4, f32 g and x take the warpgroup (wgmma) path,
    every other case the mma.sync path."""
    a = K.BlockCSR.from_dense(_graph(n, seed=23, density=0.03), tile,
                              device=card)
    g, x = torch.randn(n, f, device=card), torch.randn(n, f, device=card)
    for tg in (torch.float32, torch.bfloat16):
        for tx in (torch.float32, torch.bfloat16):
            gd, xd = g.to(tg), x.to(tx)
            before = K.LAUNCHES["spmm_dvals"]
            got = K.spmm_dvals(a, gd, xd)
            assert K.LAUNCHES["spmm_dvals"] == before + 1
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, K.spmm_dvals_plain(a, gd, xd),
                                       **DVALS_TOL)
            assert not got[a.nnzb_logical:].any()


def test_cuda_spmm_dvals_nan_reaches_its_column_tile(card):
    """A NaN in x at node r reaches column r % TB of exactly the blocks
    whose column tile holds r; the pad blocks stay zero."""
    n, tile, r = 150, 16, 70
    a = K.BlockCSR.from_dense(_graph(n, seed=24, density=0.05), tile,
                              device=card)
    g, x = torch.randn(2, n, 5, device=card), torch.randn(2, n, 5, device=card)
    x[1, r, 2] = float("nan")
    got = K.spmm_dvals(a, g, x)
    want = K.spmm_dvals_plain(a, g, x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    nb = a.nnzb_logical
    hit = a.block_cols[:nb] == r // tile
    assert bool(hit.any())
    assert bool(torch.isnan(got[:nb][hit][:, :, r % tile]).all())
    assert int(torch.isnan(got).sum()) == int(hit.sum()) * tile
    assert not got[nb:].any()


@pytest.mark.parametrize("tile,f", [(16, 7), (128, 1024)])
def test_cuda_spmm_dvals_inf_and_top_binade(card, tile, f):
    """3xTF32 keeps the dense product's non-finite values: an Inf in x
    gives +-Inf where g is nonzero and NaN where g is 0; an x of
    FLT_MAX (the top binade, where rounding to TF32 would overflow)
    under g of magnitude <= 0.5 gives finite values. Ragged F = 7 stages
    by plain loads, F = 1024 by cp.async."""
    n, r, c = 300, 70, 3
    a = K.BlockCSR.from_dense(_graph(n, seed=27, density=0.05), tile,
                              device=card)
    g, x = torch.randn(n, f, device=card), torch.randn(n, f, device=card)
    g[: n // 2, c] = 0.0
    xi = x.clone()
    xi[r, c] = float("inf")
    got = K.spmm_dvals(a, g, xi)
    want = K.spmm_dvals_plain(a, g, xi)
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())
    torch.testing.assert_close(got, want, equal_nan=True, **DVALS_TOL)
    xm = x.clone()
    xm[r, c] = torch.finfo(torch.float32).max
    gm = g.clone()
    gm[:, c] = gm[:, c].clamp(-0.5, 0.5)
    got = K.spmm_dvals(a, gm, xm)
    want = K.spmm_dvals_plain(a, gm, xm)
    assert bool(torch.isfinite(got).all()) and want.abs().max() > 1e37
    torch.testing.assert_close(got, want, **DVALS_TOL)


def test_cuda_adaptive_support_matches_cpu(card):
    """softmax(relu(E1 E2)) on a pattern, aggregated, and its gradients to
    E1 and E2 (through `spmm_dvals` and the SDDMM backward), on the card
    against the CPU."""
    n, tile = 200, 32
    rng = np.random.default_rng(25)
    e1 = rng.standard_normal((n, 10)).astype(np.float32)
    e2 = rng.standard_normal((10, n)).astype(np.float32)
    x = rng.standard_normal((2, n, 6)).astype(np.float32)
    g = rng.standard_normal((2, n, 6)).astype(np.float32)
    adj = _graph(n, seed=26, density=0.03) + np.eye(n, dtype=np.float32)
    out = {}
    for dev in ("cpu", card):
        p = S.SDDMMPattern.from_bcsr(K.BlockCSR.from_dense(adj, tile,
                                                           device=dev))
        t1 = torch.tensor(e1, device=dev, requires_grad=True)
        t2 = torch.tensor(e2, device=dev, requires_grad=True)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        before = dict(K.LAUNCHES)
        y = graph_matmul(S.adaptive_support(p, t1, t2), xt)
        y.backward(torch.tensor(g, device=dev))
        runs = {k: K.LAUNCHES[k] - before[k]
                for k in ("sddmm", "spmm_dvals", "bsr_spmm")}
        assert runs == ({"sddmm": 1, "spmm_dvals": 1, "bsr_spmm": 2}
                        if dev == card else dict.fromkeys(runs, 0))
        out[str(dev)] = [y.detach().cpu()] + [
            t.grad.cpu() for t in (t1, t2, xt)]
    for got, want in zip(out[str(card)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_cuda_adaptive_support_repeated_on_poisoned_memory(card):
    """`test_cuda_adaptive_support_matches_cpu` 50 times in one process,
    after the file's earlier kernels, each time on memory that the
    caching allocator hands out NaN-filled (a freed 256 MiB NaN block:
    output, staging and fold buffers and the memory past x's end read
    NaN unless written), and `bsr_spmm` on an x whose storage runs on
    into NaN (a ragged last row tile must not read past row n). Under
    deterministic algorithms (the block-row softmax sums rows with
    `index_add`, whose float atomics otherwise change the last bits
    from run to run) the card side must equal its first run bitwise,
    and the CPU's within the tolerances above, every time."""
    n, tile = 200, 32
    rng = np.random.default_rng(25)
    e1 = rng.standard_normal((n, 10)).astype(np.float32)
    e2 = rng.standard_normal((10, n)).astype(np.float32)
    x = rng.standard_normal((2, n, 6)).astype(np.float32)
    g = rng.standard_normal((2, n, 6)).astype(np.float32)
    adj = _graph(n, seed=26, density=0.03) + np.eye(n, dtype=np.float32)

    def run(dev):
        p = S.SDDMMPattern.from_bcsr(K.BlockCSR.from_dense(adj, tile,
                                                           device=dev))
        t1 = torch.tensor(e1, device=dev, requires_grad=True)
        t2 = torch.tensor(e2, device=dev, requires_grad=True)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        y = graph_matmul(S.adaptive_support(p, t1, t2), xt)
        y.backward(torch.tensor(g, device=dev))
        return [y.detach().cpu()] + [t.grad.cpu() for t in (t1, t2, xt)]

    want = run("cpu")
    a = K.BlockCSR.from_dense(adj, tile, device=card)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _repeat_on_poisoned_memory(card, run, want, a, n, rng)
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


def _repeat_on_poisoned_memory(card, run, want, a, n, rng):
    first = None
    for _ in range(50):
        torch.full((64 << 20,), float("nan"), device=card)
        got = run(card)
        buf = torch.full((n + 7, 130), float("nan"), device=card)
        xs = buf.view(-1)[: n * 130].view(n, 130)
        xs.copy_(torch.tensor(rng.standard_normal((n, 130)),
                              dtype=torch.float32, device=card))
        y = K.bsr_spmm(a, xs)
        assert bool(torch.isfinite(y).all())
        torch.testing.assert_close(y, K.bsr_spmm_plain(a, xs),
                                   **TOL[torch.float32])
        for gt, w in zip(got, want):
            torch.testing.assert_close(gt, w, rtol=1e-4, atol=1e-5)
        if first is None:
            first = got
        for gt, f0 in zip(got, first):
            assert torch.equal(gt, f0)


def _ring(card, parts, n, f, seed):
    """The fused ring on `parts` ranks of one card, and the plain
    version's inputs: the ring-ordered blocks on the card."""
    from gptst_tpu_torch.kernels import halo_spmm as R
    from gptst_tpu_torch.parallel.halo import partition_adjacency
    from gptst_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=[card] * parts, graph_axis_size=parts)
    adj = _graph(n, seed, density=0.05)
    fn, n_pad = R.make_fused_ring_spmm(mesh, adj, f)
    blocks = R._rotate_blocks(partition_adjacency(adj, parts))
    a_rot = [torch.as_tensor(b, device=card) for b in blocks]
    return mesh, fn, n_pad, a_rot


@pytest.mark.parametrize("parts,n,f", [(1, 70, 5), (2, 150, 130),
                                       (4, 301, 67)])
def test_cuda_ring_spmm_matches_plain(card, parts, n, f):
    """P virtual ranks on one card, ragged n_loc and F, f32 and bf16 x
    (the output keeps x's dtype); P^2 kernel launches per call."""
    from gptst_tpu_torch.kernels import halo_spmm as R
    from gptst_tpu_torch.parallel.mesh import shard_rows

    mesh, fn, n_pad, a_rot = _ring(card, parts, n, f, seed=31)
    x = torch.randn(n_pad, f, device=card)
    for dtype in (torch.float32, torch.bfloat16):
        xs = shard_rows(x.to(dtype), mesh)
        before = K.LAUNCHES["ring_spmm"]
        got = fn(xs)
        assert K.LAUNCHES["ring_spmm"] - before == parts * parts
        want = R.ring_spmm_plain(a_rot, xs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            torch.testing.assert_close(g, w, **TOL[dtype])


def test_cuda_ring_spmm_nan_reaches_every_row_of_its_column(card):
    """Dense blocks, zeros included, as the TPU kernel multiplies them: a
    NaN in one x row reaches every output row of its column, on every
    rank, and no other column."""
    from gptst_tpu_torch.parallel.mesh import gather_rows, shard_rows

    mesh, fn, n_pad, _ = _ring(card, 4, 250, 9, seed=32)
    x = torch.randn(n_pad, 9, device=card)
    x[100, 3] = float("nan")
    got = gather_rows(fn(shard_rows(x, mesh)), card)
    assert bool(torch.isnan(got[:, 3]).all())
    assert not torch.isnan(got[:, [0, 1, 2, 4, 5, 6, 7, 8]]).any()


@pytest.mark.parametrize("n,f", [(250, 9), (512, 128)])
def test_cuda_ring_spmm_inf_and_top_binade(card, n, f):
    """3xTF32 keeps the dense product's non-finite values: an Inf in x
    gives +Inf in every output row of its column where the row's weight
    is nonzero and NaN where it is 0; an x of FLT_MAX (the top binade,
    where rounding to TF32 would overflow) alone in its column, under
    weights <= 1, gives finite values. Ragged n_loc and F stage by plain
    loads; n = 512, F = 128 by cp.async."""
    from gptst_tpu_torch.kernels import halo_spmm as R
    from gptst_tpu_torch.parallel.mesh import gather_rows, shard_rows

    mesh, fn, n_pad, a_rot = _ring(card, 4, n, f, seed=34)
    x = torch.randn(n_pad, f, device=card)
    r, c = 100, 3
    xi = x.clone()
    xi[r, c] = float("inf")
    got = gather_rows(fn(shard_rows(xi, mesh)), card)
    want = gather_rows(R.ring_spmm_plain(a_rot, shard_rows(xi, mesh)), card)
    assert bool(torch.isnan(want[:, c]).any())
    assert bool(torch.isinf(want[:, c]).any())
    torch.testing.assert_close(got, want, equal_nan=True,
                               **TOL[torch.float32])
    xm = x.clone()
    xm[:, c] = 0.0
    xm[r, c] = torch.finfo(torch.float32).max
    got = gather_rows(fn(shard_rows(xm, mesh)), card)
    want = gather_rows(R.ring_spmm_plain(a_rot, shard_rows(xm, mesh)), card)
    assert bool(torch.isfinite(got).all()) and want.abs().max() > 1e37
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_cuda_ring_spmm_rejects_what_the_kernel_does_not_take(card):
    from gptst_tpu_torch.parallel.mesh import shard_rows

    mesh, fn, n_pad, _ = _ring(card, 2, 60, 8, seed=33)
    x = torch.randn(n_pad, 8, device=card)
    with pytest.raises(TypeError):
        fn(shard_rows(x.double(), mesh))
    with pytest.raises(ValueError):
        fn([s.cpu() for s in shard_rows(x, mesh)])           # wrong device
    with pytest.raises(ValueError):
        fn(shard_rows(x[:, :7].contiguous(), mesh))          # wrong F
    with pytest.raises(ValueError):
        fn([s.t().contiguous().t() for s in shard_rows(x, mesh)])




def _trained_tgcn(card, support, remat: str, monkeypatch, capture: bool):
    """TGCN (160 nodes, 8 units) on `support` through the trainer, K = 4:
    43 windows in batches of 4, so each of 2 epochs has two chunks of 4
    full batches through `StepGraph` (replayed from one captured step
    with `capture`; else the same step eagerly on the card) and 3 steps
    one at a time. Returns the per-step losses, the parameters, the
    launches counted (from 0) and the runner."""
    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.data.pipeline import build_dataset
    from gptst_tpu_torch.models.build import GraphPredictor, predictor_forward
    from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
    from gptst_tpu_torch.train import trainer as T

    class Eager(T.StepGraph):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.capture = False

    monkeypatch.setattr(T, "StepGraph", T.StepGraph if capture else Eager)
    n = 160
    cfg = default_config("PEMS08", mode="ori", model="TGCN", num_nodes=n,
                         batch_size=4, scan_steps=4, epochs=2,
                         lr_decay=False, log_step=1000)
    ds = build_dataset(cfg, num_steps=200, seed=0)
    ds.x_train, ds.y_train = ds.x_train[:43], ds.y_train[:43]
    net = TGCN(TGCNConfig(num_nodes=n, rnn_units=8, remat=remat), dim_in=1,
               dim_out=1, horizon=12,
               generator=torch.Generator().manual_seed(0)).to(card)
    tr = T.Trainer(model=predictor_forward(cfg, GraphPredictor(net, support)),
                   cfg=cfg, dataset=ds, seed=0, device=card)
    K.reset_launch_counts()
    losses = []
    for epoch in (1, 2):
        tr.train_epoch(epoch)
        losses.append(tr._losses.clone())
    return (torch.stack(losses), dict(tr.model.named_parameters()),
            dict(K.LAUNCHES), tr._runner)


@pytest.mark.parametrize("kind,remat,room", [
    ("bsr_spmm", "none", True), ("bsr_spmm", "full", True),
    ("dia_spmm", "none", True), ("bsr_spmm", "none", False)])
def test_cuda_replayed_train_steps_match_eager_ones(card, kind, remat, room,
                                                    monkeypatch):
    """Replays of the captured train step against the same step run
    eagerly, from the same weights: every step's losses and the
    parameters within rtol 1e-4, and the kernel launches counted
    through the replays equal to the eager run's. A random graph at
    tile 16 gives `bsr_spmm`, a band `dia_spmm`; `remat` full runs the
    cell under `torch.utils.checkpoint` inside the capture. Without
    `room` the card reports no free memory, so the runner drops its
    graph before each epoch's one-step batches and captures again in
    the next epoch (`StepGraph.beside`)."""
    adj = _graph(160, seed=40, band=None if kind == "bsr_spmm" else 10,
                 density=0.03)
    sup = make_support(adj, dense_threshold=0, tile=16, device=card)
    assert (sup.dia is None) == (kind == "bsr_spmm")
    if not room:
        total = torch.cuda.mem_get_info(card)[1]
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None: (0, total))
    got, got_p, got_n, runner = _trained_tgcn(card, sup, remat, monkeypatch,
                                              capture=True)
    want, want_p, want_n, eager = _trained_tgcn(card, sup, remat,
                                                monkeypatch, capture=False)
    assert runner.capture and not eager.captures
    assert runner.captures == (1 if room else 2)
    assert (runner.graph is None) == (not room) and runner.pool_bytes > 0
    assert runner.launches[kind] > 0
    assert got_n == want_n and got_n[kind] > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    for k, w in want_p.items():
        torch.testing.assert_close(got_p[k], w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_cuda_staged_adam_steps_as_python_scalars_did(card):
    """`ClippedAdam` reads its learning rate and bias corrections from
    staged device rows (so that a captured step reads each replay's);
    on the card its parameters and moments equal, bit for bit, the
    update written with Python-scalar divisors (which CUDA applies as a
    multiply by the reciprocal taken in double; the staged rows hold
    those reciprocals), across an LR milestone,
    clipped and unclipped steps."""
    from gptst_tpu_torch.config.config import default_config
    from gptst_tpu_torch.train.trainer import ClippedAdam, make_lr_schedule

    gen = torch.Generator(device=card).manual_seed(3)
    init = [torch.randn(64, 33, generator=gen, device=card),
            torch.randn(1000, generator=gen, device=card)]
    grads = [[torch.randn(p.shape, generator=gen, device=card)
              * (0.01 if i % 2 else 10.0) for p in init] for i in range(7)]
    lr_fn = make_lr_schedule(default_config(
        "PEMS08", lr_init=3e-3, lr_decay=True, lr_decay_step=(1,),
        lr_decay_rate=0.3), steps_per_epoch=3)
    params = [p.clone().requires_grad_() for p in init]
    opt = ClippedAdam(params, lr_fn, max_norm=5.0)
    opt.stage(7)
    want = [p.clone() for p in init]
    mus = [torch.zeros_like(p) for p in init]
    nus = [torch.zeros_like(p) for p in init]
    for count, g in enumerate(grads, 1):
        for p, gi in zip(params, g):
            p.grad = gi.clone()
        opt.step()
        norm = torch.stack([(gi * gi).sum() for gi in g]).sum().sqrt()
        lr = lr_fn(count - 1)
        bc1, bc2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
        for j, gi in enumerate(g):
            gi = torch.where(norm < 5.0, gi, gi / norm * 5.0)
            mus[j] = (1 - 0.9) * gi + 0.9 * mus[j]
            nus[j] = (1 - 0.999) * (gi * gi) + 0.999 * nus[j]
            want[j].add_((mus[j] / bc1) / ((nus[j] / bc2).sqrt() + 1e-8)
                         * -lr)
    for p, w, mu, nu in zip(params, want, mus, nus):
        assert torch.equal(p.detach(), w)
        assert torch.equal(opt.state[p]["mu"], mu)
        assert torch.equal(opt.state[p]["nu"], nu)
