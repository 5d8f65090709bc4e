"""The port's GWN (and `diffusion_conv`, `adaptive_adj`, `BatchStatsNorm`,
`TimeConv`, dropout) against the JAX package's, on the CPU.

Weights: the JAX init with N(0, 0.1^2) noise on every leaf (the norms'
scales and biases start at 1 and 0, where a wrong gradient could hide),
carried over by `convert.py`; dropout 0 for value parity.

  * the full default depth (blocks 4, layers 2) at narrow widths on
    dense doubletransition supports plus the adaptive adjacency: the
    prediction and every gradient rtol 1e-4 with an atol of 1e-5 of each
    tensor's largest entry (f32 sums in another order through 8
    BatchStatsNorms; a gconv bias, 0 in exact arithmetic before its
    BatchStatsNorm, of the model's largest gradient);
  * the sparse path (`make_support(dense_threshold=0)`) on a DIRECTED
    graph, so A != A^T in pattern and values, at N = 480 (ragged last
    tile): block-CSR behind RCM (tile 32) and the DIA band with its COO
    tail (tile 64, with and without RCM), against the JAX Pallas kernels
    in interpret mode (atol 2e-3 of the largest entry: the JAX side's
    own f32 gradients are that far from float64 there) and the port's
    float64 run on the dense supports at the tolerances above. GWN
    aggregates by A^T, so its forward runs the transposed structures
    and its backward the original ones; a model given the untransposed
    supports is far off;
  * every `adjtype` and the SVD-seeded nodevecs against the JAX
    package's `_build_gwn`; under a mesh the JAX package's behaviour (the aptonly
    model unchanged, static supports raise an AttributeError);
  * a 2-epoch `-mode eval -model GWN` trajectory against `gptst_tpu`'s
    Trainer: losses and report rtol 1e-3 (CORR atol 1e-3), and against
    the port's own float64 run rtol 1e-4 (see the test's docstring);
  * the init laws and dropout by their moments;
  * `ops/temporal.GatedDilatedConv` (WaveNet's gate, which no predictor
    uses) at dilation 1 and 2: values and every gradient rtol 1e-5.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.graph.artifacts import asym_adj, random_sensor_graph
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import gwn as jgwn
from gptst_tpu.ops import graph_conv as jgc
from gptst_tpu.ops.temporal import GatedDilatedConv as JGated
from gptst_tpu.parallel.mesh import make_mesh as jmake_mesh
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import (
    _kernel_to_port, flax_to_state_dict, state_dict_to_flax,
)
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors.gwn import GWN, GWNConfig
from gptst_tpu_torch.ops import graph_conv as tgc
from gptst_tpu_torch.ops.norm import BatchStatsNorm, dropout
from gptst_tpu_torch.ops.temporal import GatedDilatedConv
from gptst_tpu_torch.parallel.mesh import make_mesh
from gptst_tpu_torch.train.trainer import Trainer, make_optimizer

NARROW = dict(nhid=4, residual_channels=8, dilation_channels=8,
              dropout=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny torch ops: one intra-op thread, as in the other port
    test files (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        jspmm.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _noisy(params, seed=7, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)


def _directed(n, band, seed, permute):
    """A weighted directed graph: each node sends 5 edges within +-band,
    values U(0.2, 1); node labels shuffled with `permute` (RCM then
    recovers the band)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 5)
    cols = np.clip(rows + rng.integers(-band, band + 1, rows.size), 0, n - 1)
    a = np.zeros((n, n), np.float32)
    a[rows, cols] = rng.uniform(0.2, 1.0, rows.size)
    np.fill_diagonal(a, 0.0)
    if permute:
        p = rng.permutation(n)
        a = a[p][:, p]
    return a


@functools.lru_cache(maxsize=None)
def _jax_init(cfg: tuple, shape: tuple, n_sup: int):
    """GWN's JAX init of config `cfg` (its items) for x of `shape`,
    compiled once per config: the values depend on the key and the
    shapes alone, so it runs on dense zero supports, and the three
    sparse cases share one compile (~8-11 s of CPU each)."""
    model = jgwn.GWN(cfg=jgwn.GWNConfig(**dict(cfg)), dim_in=shape[-1],
                     dim_out=1, horizon=12)
    n = shape[2]
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros(shape),
        tuple(jnp.zeros((n, n)) for _ in range(n_sup))))


def _run_both(cfg, jsups, tsups, x, g, n_sup):
    """Prediction and gradients of sum(pred * g) on both sides, the
    port on the JAX init (noised) carried over."""
    model = jgwn.GWN(cfg=jgwn.GWNConfig(**cfg), dim_in=x.shape[-1],
                     dim_out=1, horizon=12)
    params = _noisy(_jax_init(tuple(sorted(cfg.items())), x.shape,
                              len(jsups)))

    def jloss(p):
        pred = model.apply(p, jnp.asarray(x), tuple(jsups))
        return jnp.sum(pred * jnp.asarray(g)), pred

    (_, jpred), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    net = GWN(GWNConfig(**cfg), dim_in=x.shape[-1], dim_out=1, horizon=12,
              num_supports=n_sup)
    net.load_state_dict(flax_to_state_dict(params))
    pred = net(torch.tensor(x), tuple(tsups))
    (pred * torch.tensor(g)).sum().backward()
    # the last layer's diffusion conv and norm reach no output (only the
    # skip path does): no gradient here, zeros in JAX
    grads = state_dict_to_flax({
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in net.named_parameters()})
    return (np.asarray(jpred), jgrads), (pred.detach().numpy(), grads), net


def _float64_run(net, mats, x, g):
    """The port's prediction and gradients in float64 on the dense
    supports, for the same weights."""
    net64 = copy.deepcopy(net).double()
    net64.zero_grad(set_to_none=True)
    pred = net64(torch.tensor(x, dtype=torch.float64),
                 tuple(torch.tensor(m, dtype=torch.float64) for m in mats))
    (pred * torch.tensor(g, dtype=torch.float64)).sum().backward()
    return pred.detach().numpy(), state_dict_to_flax({
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in net64.named_parameters()})


def _assert_close(port, jax_side, rtol=1e-4, rel_atol=1e-5):
    (pred, grads), (jpred, jgrads) = port, jax_side
    np.testing.assert_allclose(pred, jpred, rtol=rtol,
                               atol=rel_atol * np.abs(jpred).max())
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(got) == len(want)
    unused = set()
    # a gconv bias feeds a BatchStatsNorm, which removes any constant per
    # channel: its gradient is 0 in exact arithmetic and rounding noise
    # here, held to the atol of the largest gradient of the model
    scale = max(float(np.abs(w).max()) for _, w in want)
    for path, w in want:
        w, key = np.asarray(w), jax.tree_util.keystr(path)
        if not np.abs(w).max() > 0:
            unused.add(key)
        atol = rel_atol * (scale if "gconv_b" in key else np.abs(w).max())
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol,
                                   err_msg=key)
    # zero exactly where the last layer's outputs go unread
    assert len(unused) == 4 and all(
        "gconv_" in k or "BatchStatsNorm" in k for k in unused), unused


def test_convert_round_trips_and_matches_the_flax_tree():
    for kw in (dict(aptonly=False), dict(gcn_bool=False)):
        cfg = dict(num_nodes=12, **NARROW, **kw)
        n_sup = 0 if kw.get("gcn_bool") is False else 2
        net = GWN(GWNConfig(**cfg), dim_in=3, dim_out=1, horizon=12,
                  num_supports=n_sup,
                  generator=torch.Generator().manual_seed(0))
        sd = net.state_dict()
        back = flax_to_state_dict(state_dict_to_flax(sd))
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        sups = tuple(jnp.eye(12) for _ in range(n_sup))
        shapes = jax.eval_shape(
            jgwn.GWN(cfg=jgwn.GWNConfig(**cfg), dim_in=3, dim_out=1,
                     horizon=12).init,
            jax.random.PRNGKey(0), jnp.zeros((2, 12, 12, 3)), sups)
        assert (jax.tree.map(np.shape, state_dict_to_flax(sd))
                == jax.tree.map(lambda a: a.shape, shapes))


def test_full_depth_on_dense_supports_matches_jax():
    """blocks 4, layers 2 (the published depth), doubletransition
    supports of a directed graph and the adaptive adjacency."""
    n, b = 20, 2
    rng = np.random.default_rng(0)
    adj = random_sensor_graph(n, avg_degree=4, seed=2, directed=True)
    adj = adj * rng.uniform(0.2, 1.0, adj.shape).astype(np.float32)
    mats = [asym_adj(adj), asym_adj(adj.T)]
    x = rng.standard_normal((b, 12, n, 2)).astype(np.float32)
    g = rng.standard_normal((b, 12, n, 1)).astype(np.float32)
    cfg = dict(num_nodes=n, aptonly=False, **NARROW)
    jax_side, port, _ = _run_both(
        cfg, [jnp.asarray(m) for m in mats],
        [torch.tensor(m) for m in mats], x, g, 2)
    _assert_close(port, jax_side)


# directed graphs at N = 480 (the last 32- or 64-row tile is ragged):
# label-shuffled with a wide band, RCM finds the band and the blocks stay
# block-CSR; a narrow band is a DIA band (w = 1 in tiles unshuffled, 3
# after RCM), with the COO tail of its stray edges
SPARSE = {"bcsr_rcm": (200, True, 32, True),
          "dia": (40, False, 64, False),
          "dia_rcm": (40, True, 64, True)}


@functools.lru_cache(maxsize=None)
def _sparse_supports(kind):
    """The directed graph of `kind` and its supports in both packages,
    built once for the two tests that read them."""
    band, permute, tile, reorder = SPARSE[kind]
    adj = _directed(480, band, seed=0, permute=permute)
    mats = [asym_adj(adj), asym_adj(adj.T)]
    assert not np.array_equal(mats[0] != 0, mats[0].T != 0)
    mk = functools.partial(dict, dense_threshold=0, tile=tile,
                           reorder=reorder)
    jsups = [jgc.make_support(m, **mk()) for m in mats]
    tsups = [tgc.make_support(m, **mk(), device="cpu") for m in mats]
    for s, js in zip(tsups, jsups):
        assert (s.perm is not None) == reorder == (js.perm is not None)
        assert (s.dia is not None) == kind.startswith("dia") \
            == (js.dia is not None)
    return mats, jsups, tsups


@pytest.mark.parametrize("kind", sorted(SPARSE))
def test_sparse_directed_supports_match_jax(kind):
    """Transposed, non-symmetric supports through the kernels' plain
    versions (forward: `bcsr_t` / `dia_t`; backward: `bcsr` / `dia`)
    against the JAX Pallas kernels, at blocks 1, layers 2."""
    mats, jsups, tsups = _sparse_supports(kind)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 480, 1)).astype(np.float32)
    g = rng.standard_normal((2, 12, 480, 1)).astype(np.float32)
    cfg = dict(num_nodes=480, aptonly=False, blocks=1, **NARROW)
    jax_side, port, net = _run_both(cfg, jsups, tsups, x, g, 2)
    # the JAX package's own f32 gradients through its sparse path (on
    # the `dia_rcm` graph) are farther from float64 than its dense-
    # support gradients or its sparse products alone: JAX at an atol of
    # 2e-3 of each largest entry, the port's float64 run at the tight one
    _assert_close(port, jax_side, rel_atol=2e-3)
    _assert_close(port, _float64_run(net, mats, x, g))
    # the same weights on the untransposed supports (a swap of A and A^T)
    with torch.no_grad():
        swapped = net(torch.tensor(x), tuple(s.T for s in tsups)).numpy()
    assert np.abs(swapped - jax_side[0]).max() > 1e-2 * np.abs(
        jax_side[0]).max()


@pytest.mark.parametrize("kind", sorted(SPARSE))
def test_transposed_structures_are_not_swapped(kind):
    """`graph_matmul(S.T, x)` is A^T x and carries A g back, where A is
    directed: swapping `bcsr` and `bcsr_t` (or `dia` and `dia_t`, or the
    COO tails) in the forward or in the backward fails here."""
    mats, _, tsups = _sparse_supports(kind)
    a = torch.tensor(mats[0], dtype=torch.float64)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((3, 480, 5)), requires_grad=True)
    g = torch.tensor(rng.standard_normal((3, 480, 5)))
    out = tgc.graph_matmul(tsups[0].T, x.float())
    out.backward(g.float())
    want = a.T @ x.detach()
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x.grad, a @ g, rtol=1e-5, atol=1e-5)
    assert (a @ x.detach() - want).abs().max() > 0.1


def test_every_adjtype_and_the_svd_nodevecs_match_jax(monkeypatch):
    """The support matrices each `adjtype` builds and the SVD-seeded
    nodevecs of `randomadj=False` (from supports[0]), against the JAX
    package's `_build_gwn`: the JAX `make_support` and `GWN` are recorded, nothing
    compiles."""
    n = 14
    adj = random_sensor_graph(n, avg_degree=4, seed=3, directed=True)
    seen = {}
    monkeypatch.setattr(jbuild, "make_support",
                        lambda m, **k: seen.setdefault("mats", []).append(
                            np.asarray(m)) or jnp.asarray(m))
    monkeypatch.setattr(jgwn, "GWN", lambda **k: seen.update(model=k))
    for adjtype in ("doubletransition", "transition", "symnadj", "scalap",
                    "normlap", "identity"):
        for randomadj in (True, False):
            ov = (("adjtype", adjtype), ("aptonly", "False"),
                  ("randomadj", str(randomadj)))
            seen.clear()
            jbuild.build_predictor(jax_default_config(
                "PEMS08", mode="ori", model="GWN", num_nodes=n,
                predictor_overrides=ov), adj=adj)
            cfg = default_config("PEMS08", mode="ori", model="GWN",
                                 num_nodes=n, predictor_overrides=ov)
            pred = tbuild.build_predictor(cfg, adj=adj, device="cpu")
            got = [s.numpy() for s in pred.graph[0]]
            assert len(got) == len(seen["mats"]) > 0
            for a, b in zip(got, seen["mats"]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
            init = seen["model"]["nodevec_init"]
            net = pred.net
            if randomadj:
                assert init is None
                continue
            for i, p in ((0, net.nodevec1), (1, net.nodevec2)):
                want = np.asarray(init[i](None, p.shape))
                np.testing.assert_allclose(p.detach().numpy(), want,
                                           rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="adj type"):
        tbuild.build_predictor(default_config(
            "PEMS08", mode="ori", model="GWN", num_nodes=n,
            predictor_overrides=(("adjtype", "bogus"), ("aptonly", "False"))),
            adj=adj, device="cpu")


def test_under_a_mesh_gwn_does_what_the_jax_package_does():
    """The default (aptonly: the dense adaptive adjacency only) runs
    node-sharded over the mesh's four graph ranks and gives the
    one-device prediction (rtol 1e-5, atol 1e-6: the products by Aᵀ sum
    the ranks' partials in another order, as GSPMD's do); with static
    supports the sharded supports have no transpose, and both packages
    raise AttributeError (ROADMAP.md Queue 3, item 15)."""
    n = 12
    adj = random_sensor_graph(n, avg_degree=4, seed=4)
    x = torch.randn(2, 12, n, 3, generator=torch.Generator().manual_seed(0))
    mesh = make_mesh(devices=["cpu"] * 4, graph_axis_size=4)
    cfg = default_config("PEMS08", mode="ori", model="GWN", num_nodes=n,
                         predictor_overrides=(("dropout", "0"),))
    plain = tbuild.build_model(cfg, adj=adj, device="cpu")
    sharded = tbuild.build_model(cfg, adj=adj, device="cpu", mesh=mesh)
    assert sharded.predictor.shards(torch.device("cpu")).parts == 4
    torch.testing.assert_close(sharded(x).pred, plain(x).pred, rtol=1e-5,
                               atol=1e-6)
    ov = (("aptonly", "False"),)
    with pytest.raises(AttributeError, match="item 15"):
        tbuild.build_model(cfg.replace(predictor_overrides=ov), adj=adj,
                           device="cpu", mesh=mesh)(x)
    jcfg = jax_default_config("PEMS08", mode="ori", model="GWN",
                              num_nodes=n, predictor_overrides=ov)
    init, _ = jbuild.build_model(jcfg, adj=adj,
                                 mesh=jmake_mesh(4, graph_axis_size=4))
    with pytest.raises(AttributeError):
        init(jax.random.PRNGKey(0))


def test_init_laws_by_their_moments():
    """flax Dense and Conv: lecun normal (truncated, std 1/sqrt(fan_in))
    and zero bias; gconv weights xavier uniform; nodevecs N(0, 1);
    BatchStatsNorm ones and zeros. Each at a width where its sample
    moments are within a few percent."""
    net = GWN(GWNConfig(num_nodes=2000, nhid=64, residual_channels=64,
                        dilation_channels=64, aptonly=False),
              dim_in=64, dim_out=1, horizon=12, num_supports=2,
              generator=torch.Generator().manual_seed(0))

    def moments(t):
        t = t.detach().double()
        return float(t.mean()), float(t.std())

    for w, fan in ((net.start_conv.weight, 64), (net.dense[0].weight, 64),
                   (net.end_conv_1.weight, 512),
                   (net.dilated[0].weight, 2 * 64)):
        mean, std = moments(w)
        assert abs(mean) < 0.05 / np.sqrt(fan)
        assert abs(std * np.sqrt(fan) - 1.0) < 0.05
    assert not net.start_conv.bias.any() and not net.dilated[3].bias.any()
    w = net.gconv_w_0_0                  # (7 * 64, 64)
    lim = np.sqrt(6.0 / sum(w.shape))
    assert float(w.abs().max()) <= lim
    assert abs(moments(w)[1] / (lim / np.sqrt(3.0)) - 1.0) < 0.03
    for e in (net.nodevec1, net.nodevec2):
        mean, std = moments(e)
        assert abs(mean) < 0.03 and abs(std - 1.0) < 0.03
    assert all(bool((m.scale == 1).all() and (m.bias == 0).all())
               for m in net.norm)


@pytest.mark.parametrize("dilation", [1, 2])
def test_gated_dilated_conv_matches_jax(dilation):
    """tanh(filter) * sigmoid(gate) of two VALID (2, 1) convs: T = 12
    shrinks by the dilation."""
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((3, 12, 5, 6)).astype(np.float32)
    g = rng.standard_normal((3, 12 - dilation, 5, 8)).astype(np.float32)
    jm = JGated(8, kernel=2, dilation=dilation)
    p = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    @jax.jit
    def jvals(pp, a, gg):
        out, vjp = jax.vjp(jm.apply, pp, a)
        return out, *vjp(gg)

    jout, jgp, jgx = jvals(p, jnp.asarray(x), jnp.asarray(g))
    m = GatedDilatedConv(6, 8, kernel=2, dilation=dilation)
    m.load_state_dict({
        f"conv.{j}.{k}": torch.tensor(
            _kernel_to_port(v) if k == "weight" else v)
        for j in range(2) for k, v in (
            ("weight", p["params"][f"Conv_{j}"]["kernel"]),
            ("bias", p["params"][f"Conv_{j}"]["bias"]))})
    xt = torch.tensor(x, requires_grad=True)
    out = m(xt)
    out.backward(torch.tensor(g))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), jout, **tol)
    np.testing.assert_allclose(xt.grad.numpy(), jgx, **tol)
    for j in range(2):
        conv, want = m.conv[j], jgp["params"][f"Conv_{j}"]
        np.testing.assert_allclose(conv.weight.grad.numpy(),
                                   _kernel_to_port(np.asarray(
                                       want["kernel"])), **tol)
        np.testing.assert_allclose(conv.bias.grad.numpy(), want["bias"],
                                   **tol)


def test_batch_stats_norm_and_dropout():
    """BatchStatsNorm normalizes by the batch's statistics in training
    and in eval alike, as the JAX module; dropout keeps 1 - rate of the
    entries, scaled by 1 / (1 - rate), and only with a generator."""
    from gptst_tpu.ops.norm import BatchStatsNorm as JNorm

    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.standard_normal((4, 6, 9, 5))).astype(np.float32)
    jm = JNorm()
    p = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    m = BatchStatsNorm(5)
    m.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()})
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    for mode in (True, False):
        m.train(mode)
        np.testing.assert_allclose(m(torch.tensor(x)).detach().numpy(),
                                   want, rtol=1e-5, atol=1e-5)
    ones = torch.ones(400_000)
    assert torch.equal(dropout(ones, 0.3, None), ones)
    out = dropout(ones, 0.3, torch.Generator().manual_seed(0))
    kept = out != 0
    # binomial: std of the kept share is sqrt(0.21 / 4e5) ~ 7e-4
    assert abs(float(kept.double().mean()) - 0.7) < 5e-3
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / 0.7))


CFG = dict(mode="eval", model="GWN", num_nodes=16, hidden_dim=16,
           embed_dim=8, embed_dim_spa=4, HS=4, HT=6, HT_Tem=4,
           batch_size=16, epochs=2, lr_decay=False, early_stop=False,
           debug=False, log_step=1000,
           predictor_overrides=tuple(
               (k, str(v)) for k, v in dict(NARROW, blocks=1).items()))


def _port_eval_run(cfg, ds, pre, params, double=False):
    """The port's 2-epoch eval run from `params` (the encoder `pre`
    frozen in f32), with `double` the head, the predictor, the batches
    and the optimizer state in float64. Returns the per-step losses and
    the result."""
    model = tbuild.build_model(cfg, device="cpu",
                               scaler_zeros=ds.scaler_zeros,
                               pretrain_params=pre.state_dict())
    model.load_state_dict(flax_to_state_dict(params))
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 device="cpu")
    if double:
        model.head.double()
        model.predictor.double()
        put = tr._put
        tr._put = lambda a: put(a).double()
        tr.optimizer = make_optimizer(cfg, model.parameters(),
                                      tr.steps_per_epoch)
    losses = []
    train_batch = tr._train_batch

    def recording(xb, yb):
        out = train_batch(xb, yb)
        losses.append(float(out[0]))
        return out

    tr._train_batch = recording
    return losses, tr.train()


def test_eval_gwn_trajectory_matches_jax():
    """`-mode eval -model GWN` (frozen GPT-ST encoder, Fusion head, GWN
    at dim_in 16 on its adaptive adjacency, blocks 1): 2 epochs of Adam
    through both trainers from the same weights (the port's init,
    carried over). Losses, history and report rtol 1e-3 against JAX and
    1e-4 against the port's float64 run: Adam turns f32 gradient
    rounding into a drift over 14 steps, up to 1.2e-4 between the two
    packages and 2.6e-5 between the port's f32 and float64 runs (the
    first loss agrees with JAX to 1e-6)."""
    cfg = default_config("PEMS08", **CFG)
    ds = build_dataset(cfg, num_steps=220, seed=cfg.seed)
    pre = tbuild.build_pretrain(cfg.replace(mode="pretrain"),
                                ds.scaler_zeros, "cpu", 0).gptst
    params = state_dict_to_flax(tbuild.build_model(
        cfg, device="cpu", seed=1, scaler_zeros=ds.scaler_zeros,
        pretrain_params=pre.state_dict()).state_dict())
    jcfg = jax_default_config("PEMS08", **CFG, scan_steps=1)
    jds = jax_build_dataset(jcfg, num_steps=220, seed=jcfg.seed)
    _, forward = jbuild.build_model(
        jcfg, scaler_zeros=jds.scaler_zeros,
        pretrain_params=state_dict_to_flax(pre.state_dict()))
    jtr = JTrainer(forward=forward, params=params, cfg=jcfg, dataset=jds,
                   seed=jcfg.seed)
    jlosses = []
    run_chunk = jtr._run_chunk
    jtr._run_chunk = lambda *a, **k: [jlosses.append(t) or (t, f)
                                      for t, f in run_chunk(*a, **k)]
    jres = jtr.train()
    losses, res = _port_eval_run(cfg, ds, pre, params)
    assert len(losses) == len(jlosses) == 2 * 7
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(res["history"], jres["history"], rtol=1e-3)
    # MAE, RMSE and MAPE rtol 1e-3; CORR (0.11 here, a difference of
    # sums) atol 1e-3
    np.testing.assert_allclose(res["report"]["average"][:3],
                               jres["report"]["average"][:3], rtol=1e-3)
    np.testing.assert_allclose(res["report"]["average"][3],
                               jres["report"]["average"][3], atol=1e-3)
    losses64, res64 = _port_eval_run(cfg, ds, pre, params, double=True)
    np.testing.assert_allclose(losses, losses64, rtol=1e-4)
    np.testing.assert_allclose(res["history"], res64["history"], rtol=1e-4)
