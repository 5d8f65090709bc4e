"""MSDR, ASTGCN, STGODE, ST_WA and DMVSTNET node-sharded over the mesh's
'graph' axis, on `["cpu"] * P` ranks, at N = 14 (no width of the models
is 14) and tiny widths, the weights the port's init plus N(0, 0.1^2)
noise (MSDR's W, b, R and attention start at zero, which would hide
the learned adjacency's gradients):

  * each of the five under (1, 2) against the port's one-device step
    with the generator drawn (ST_WA's latents): the prediction, the
    loss (rtol 1e-5) and every gradient (rtol 1e-4 with an atol of 1e-5
    of each tensor's largest entry); and, without a generator, the loss
    and gradients against `gptst_tpu`'s `value_and_grad` of its loss on
    the same weights (`convert.py`): jitted under GSPMD on a (1, 2) host
    mesh (MSDR's static supports there are the JAX package's halo
    supports), STGODE's un-jitted on one device (ROADMAP.md Queue 3,
    item 10); ST_WA's port side replays the draws of JAX's default key;
  * every node-local layer's output, every dense graph's rows, every
    node table a rank reads and ST_WA's spatial attention maps hold N/2
    nodes on each rank, and MSDR's static supports never gather x;
  * `ShardedSupport.on_shards` (the halo exchange and the ring, the
    ranks' shards in and out) against `gptst_tpu`'s sharded support on
    the host mesh, and its refusal of shards that are not its ranges;
  * `run_one_step` of STGODE at (2, 2) against (1, 1): `NodeBatchNorm`'s
    batch statistics over data rows and ranks;
  * eval: the frozen encoder's node shards reach a sharded DMVSTNET
    with no gather of the embedding;
  * N = 15 under (1, 2) runs whole, equals one device and warns once.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.ops import graph_conv as jgc
from gptst_tpu.parallel import mesh as jmesh
from gptst_tpu.train.loss import build_loss as jbuild_loss
from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import state_dict_to_flax
from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models import gptst as tg
from gptst_tpu_torch.models.predictors import astgcn as tastgcn
from gptst_tpu_torch.models.predictors import stwa as tstwa
from gptst_tpu_torch.ops import graph_conv as tgc
from gptst_tpu_torch.parallel import halo as thalo
from gptst_tpu_torch.parallel import mesh as tmesh
from gptst_tpu_torch.parallel.spmd import run_one_step
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms, model_forwards
from torch_parity import one_torch_thread

_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B, STEP = 14, 4, 3
CASES = {
    "MSDR": ("PEMS08", (("rnn_units", "4"), ("max_diffusion_step", "2"),
                        ("pre_k", "3"), ("adapt_rank", "3"))),
    "ASTGCN": ("PEMS08", (("nb_chev_filter", "4"), ("nb_time_filter", "4"))),
    "STGODE": ("PEMS08", (("out_channels", "[4,2,4]"), ("n_layers", "1"))),
    "ST_WA": ("PEMS08", (("channels", "4"), ("heads", "2"),
                         ("memory_size", "4"))),
    "DMVSTNET": ("PEMS08", (("hidden_dim", "4"), ("topo_embedded_dim", "3"))),
}
GPTST_SMALL = dict(hidden_dim=16, embed_dim=8, embed_dim_spa=4, HS=4, HT=6,
                   HT_Tem=4, change_epoch=1, epochs=4)
ADJ = random_sensor_graph(N, avg_degree=4, seed=3)
ADJ15 = random_sensor_graph(15, avg_degree=4, seed=3)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """n -> a data root holding STGODE's prefab distance files for n
    nodes (`STGODE/PEMS08/`), so both packages' `build_model` read the same
    two graphs and compute no DTW."""
    rng = np.random.default_rng(7)
    roots = {}
    for n in (N, 15):
        roots[n] = tmp_path_factory.mktemp(f"data{n}")
        d = roots[n] / "STGODE" / "PEMS08"
        d.mkdir(parents=True)
        dtw = rng.random((n, n))
        sp = 100 * rng.random((n, n))
        sp[rng.random((n, n)) < 0.4] = np.inf
        np.save(d / "PEMS08_dtw_distance.npy", (dtw + dtw.T) / 2)
        np.save(d / "PEMS08_spatial_distance.npy", sp)
    return roots


def _root(data_root, name, n):
    return {"data_root": str(data_root[n])} if name == "STGODE" else {}


def _mesh(d, g):
    return tmesh.make_mesh(devices=["cpu"] * (d * g), graph_axis_size=g)


def _cfg(name, data_root, n=N, **kw):
    ds, ov = CASES[name]
    return default_config(ds, mode="ori", model=name, num_nodes=n,
                          batch_size=B, predictor_overrides=ov,
                          **_root(data_root, name, n), **kw)


def _noised(model, seed=5):
    """The port's init plus N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p += torch.tensor(0.1 * rng.standard_normal(p.shape),
                              dtype=p.dtype)
    return model


def _pair(name, mesh, data_root, n=N):
    """The same noised model one-device and under `mesh`."""
    cfg = _cfg(name, data_root, n)
    adj = ADJ if n == N else ADJ15
    one = _noised(tbuild.build_model(cfg, adj=adj, device="cpu", seed=0))
    sharded = tbuild.build_model(cfg, adj=adj, device="cpu", seed=0,
                                 mesh=mesh)
    sharded.load_state_dict(one.state_dict())
    return cfg, one, sharded


def _inputs(cfg, n=N, seed=1):
    rng = np.random.default_rng(seed)
    c = cfg.input_base_dim + 2
    x = rng.standard_normal((B, 12, n, c)).astype(np.float32)
    y = (np.abs(rng.standard_normal((B, 12, n, c))) + 0.1).astype(np.float32)
    return x, y


def _loss_fn(cfg):
    return build_loss(cfg.loss_func, 0.0, 1.0, cfg.mape_thresh, False)


def _step(model, cfg, x, y, mesh=None, generator=None):
    """Prediction, loss and every gradient (zeros where none) of one
    loss on `model`, through the mesh's data-parallel forward."""
    fwd = model_forwards(model, cfg, mesh)[1] if mesh is not None else None
    preds = []
    inner = fwd or model

    def forward(x_, **kw):
        out = inner(x_, **kw)
        preds.append(out.pred)
        return out

    model.zero_grad(set_to_none=True)
    terms = make_loss_terms(model, _loss_fn(cfg), cfg, forward=forward)
    total, _ = terms(torch.tensor(x), torch.tensor(y), STEP,
                     generator=generator)
    total.backward()
    return preds[0].detach(), total.item(), {
        k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for k, p in model.named_parameters()}


def _close_grads(got: dict, want: dict) -> None:
    """rtol 1e-4 with an atol of 1e-5 of each tensor's largest entry; a
    tensor whose largest entry is at most 1e-5 of the model's largest
    (zero in exact arithmetic: MSDR's att_b, a softmax's shift) is held
    at 1e-5 of the latter, as `torch_parity._assert_close`."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            np.asarray(got[k]), w, rtol=1e-4,
            atol=1e-5 * (scale if scale > 1e-5 * top else top),
            err_msg=str(k))


def _jax_draws(n=N, m=4, layers=3) -> list[torch.Tensor]:
    """The eps arrays JAX's ST_WA draws from its default key
    (`PRNGKey(0)`), replayed as `tests/test_torch_stwa.py` does."""
    rng, r = jax.random.split(jax.random.PRNGKey(0))
    out = [jax.random.normal(r, (B, n, m))]
    for _ in range(layers):
        rng, r = jax.random.split(rng)
        out.append(jax.random.normal(r, (n, m)))
    return [torch.tensor(np.asarray(a)) for a in out]


@pytest.fixture(scope="module")
def jax_side(data_root):
    """name -> (loss, gradients by flax path) of `gptst_tpu`'s
    `value_and_grad` of its loss (no key: ST_WA's default key) on the
    noised weights and `_inputs`: jitted under GSPMD on a (1, 2) host
    mesh, STGODE's un-jitted on one device. Computed once per model."""
    seen = {}

    def get(name):
        if name in seen:
            return seen[name]
        ds, ov = CASES[name]
        jcfg = jax_default_config(ds, mode="ori", model=name, num_nodes=N,
                                  batch_size=B, predictor_overrides=ov,
                                  **_root(data_root, name, N))
        jm = None if name == "STGODE" else jmesh.make_mesh(
            2, graph_axis_size=2)
        _, forward = jbuild.build_model(jcfg, adj=ADJ, mesh=jm)
        cfg = _cfg(name, data_root)
        model = _noised(tbuild.build_model(cfg, adj=ADJ, device="cpu",
                                           seed=0))
        params = state_dict_to_flax(model.predictor.net.state_dict())
        terms = jmake_loss_terms(forward, jbuild_loss(
            jcfg.loss_func, 0.0, 1.0, jcfg.mape_thresh, False), jcfg)
        x, y = (jnp.asarray(a) for a in _inputs(cfg))
        grad = jax.value_and_grad(
            lambda p, a, b: terms(p, a, b, None, 1, STEP), has_aux=True)
        if jm is not None:
            params = jmesh.shard_params(params, jm, N)
            x, y = jmesh.shard_batch((x, y), jm)
            grad = jax.jit(grad)
        (loss, _), grads = grad(params, x, y)
        seen[name] = float(loss), {
            path: np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}
        return seen[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device_and_jax(name, jax_side, data_root,
                                                 monkeypatch):
    mesh = _mesh(1, 2)
    cfg, one, sharded = _pair(name, mesh, data_root)
    assert sharded.predictor.shards(torch.device("cpu")).parts == 2
    x, y = _inputs(cfg)
    p1, l1, g1 = _step(one, cfg, x, y,
                       generator=torch.Generator().manual_seed(11))
    p2, l2, g2 = _step(sharded, cfg, x, y, mesh,
                       generator=torch.Generator().manual_seed(11))
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=1e-4,
                               atol=1e-5 * p1.abs().max().item())
    _close_grads(g2, g1)
    # no generator: JAX's loss and gradients on the same weights (the
    # step above where the network draws nothing from the generator)
    if sharded.predictor.takes_generator:
        monkeypatch.setattr(tstwa.STWA, "draw",
                            lambda self, x_, g_: _jax_draws())
        _, l2, g2 = _step(sharded, cfg, x, y, mesh)
    jloss, jgrads = jax_side(name)
    np.testing.assert_allclose(l2, jloss, rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k[len("predictor.net."):]: v for k, v in g2.items()})))
    _close_grads(got, jgrads)


# the node-free (B, T, T) scores of ASTGCN's temporal attention, and
# MSDR's cell (a tuple: the window and the output) are not checked by
# the hook; their node-indexed parts are
NODE_FREE = (tastgcn.TemporalAttention,)
# node-indexed parameters whose node axis is not the first, by its axis
NODE_AXIS = {"ASTGCN": {"bs": 1, "U2": 1}, "MSDR": {".R": 1},
             "ST_WA": {"proxies": 2}}


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_half_the_nodes(name, data_root, monkeypatch):
    """Under (1, 2): every submodule that returns node shards returns
    N/2 nodes a rank, every dense graph is held as (N/2, N) rows a rank,
    every node table whose first axis is N (`param_pspec`'s rule) and
    the node-indexed parameters of `NODE_AXIS` are read by their ranks'
    rows alone; ST_WA's spatial maps are (B, heads, P, N/2, N) a rank;
    MSDR's static supports take the shards and never run the gathering
    product."""
    mesh = _mesh(1, 2)
    cfg, _, model = _pair(name, mesh, data_root)
    net = model.predictor.net
    widths, rows, split, maps = set(), set(), {}, set()
    for m in net.modules():
        if not isinstance(m, NODE_FREE):
            m.register_forward_hook(lambda _, a, out: widths.add(
                tuple(t.shape[-2] if t.dim() > 3 else t.shape[1]
                      for t in out)
                if isinstance(out, list) else None))
    matmul, cut = tgc.NodeRows.matmul, tmesh.NodeShards.split
    attend = tstwa.SpatialAttention._attend
    on_shards = thalo.ShardProduct.on_shards

    def record_rows(self, xs):
        rows.add(tuple(tuple(a.shape) for a in self.rows))
        return matmul(self, xs)

    def record_split(self, t, dim=-2):
        out = cut(self, t, dim)
        split[id(t)] = [s.shape[dim] for s in out]
        return out

    def record_maps(m, x, key, value):
        maps.add((x.shape[-2], key.shape[-2]))
        return attend(m, x, key, value)

    def record_support(self, xs):
        rows.add(("support",) + tuple(x.shape[-2] for x in xs))
        return on_shards(self, xs)

    monkeypatch.setattr(tgc.NodeRows, "matmul", record_rows)
    monkeypatch.setattr(tmesh.NodeShards, "split", record_split)
    monkeypatch.setattr(tstwa.SpatialAttention, "_attend",
                        staticmethod(record_maps))
    monkeypatch.setattr(thalo.ShardProduct, "on_shards", record_support)
    monkeypatch.setattr(thalo.ShardProduct, "__call__", None)
    x, y = _inputs(cfg)
    _step(model, cfg, x, y, mesh, generator=torch.Generator().manual_seed(1))
    widths.discard(None)
    assert widths == {(N // 2, N // 2)}, widths
    if name == "ASTGCN":      # the constant (K, N, N) stack, by its rows
        assert split[id(model.predictor.graph[0])] == [N // 2, N // 2]
    elif name == "MSDR":      # learned adjacencies; the halo supports
        assert rows == {((N // 2, N),) * 2, ("support", N // 2, N // 2)}
    elif name != "ST_WA":
        assert rows == {((N // 2, N),) * 2}, rows
    if name == "ST_WA":
        assert maps == {(N // 2, N)}, maps
    params = dict(net.named_parameters())
    tables = [(k, p, 0) for k, p in params.items() if p.shape[0] == N] + [
        (k, p, ax) for k, p in params.items()
        for part, ax in NODE_AXIS.get(name, {}).items()
        if k.endswith(part)]
    assert tables
    for k, p, ax in tables:
        assert p.shape[ax] == N, k
        assert split.get(id(p)) == [N // 2, N // 2], k


@pytest.mark.parametrize("parts", [2, 4])
def test_sharded_support_takes_and_gives_shards(parts):
    """`ShardedSupport.on_shards` on the ranks' shards (no gather) gives
    the ranks' rows of `gptst_tpu`'s sharded product on the host mesh
    (the halo exchange, which `make_sharded_support` picks whenever the
    ring moves no fewer rows), and so does the ring's `on_shards` beside
    JAX's ring; the gradient reaches every shard. Shards that are not
    the support's rank ranges are refused (N not divided, a reordered
    partition)."""
    from gptst_tpu.parallel import halo as jhalo
    from gptst_tpu_torch.graph import partition as tpart

    jm = jmesh.make_mesh(parts, graph_axis_size=parts)
    mesh = _mesh(1, parts)
    n = 12 * parts
    rng = np.random.default_rng(parts)
    adj = sym_adj(random_sensor_graph(n, avg_degree=3, seed=parts))
    jsup = jgc.make_sharded_support(adj, jm)
    tsup = tgc.make_sharded_support(adj, mesh)
    assert (tsup.kind, tsup.n_pad) == (jsup.kind, n) == ("halo", n)
    shards = tmesh.NodeShards(tuple(mesh.graph_devices(0)), n)
    x = rng.standard_normal((2, 3, n, 5)).astype(np.float32)
    for fn, want in (
            (lambda xs: tgc.graph_matmul(tsup, xs),
             jgc.graph_matmul(jsup, jnp.asarray(x))),
            (thalo.make_ring_spmm(mesh, adj)[0].on_shards,
             jhalo.make_ring_spmm(jm, adj)[0](jnp.asarray(x)))):
        xt = torch.tensor(x, requires_grad=True)
        got = fn(shards.split(xt))
        assert [g.shape for g in got] == [(2, 3, n // parts, 5)] * parts
        np.testing.assert_allclose(torch.cat(got, dim=-2).detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        sum(g.sum() for g in got).backward()
        np.testing.assert_allclose(
            xt.grad.numpy(), np.broadcast_to(adj.sum(0)[:, None], x.shape),
            rtol=1e-5, atol=1e-5)
    ragged = tgc.make_sharded_support(adj[:-1, :-1], mesh)
    with pytest.raises(ValueError, match="do not match"):
        ragged.on_shards(shards.split(torch.zeros(n, 2)))
    reordered = tgc.make_sharded_support(
        None, mesh, tpart.partition_graph(adj, parts, reorder=True))
    assert not reordered.in_node_order
    with pytest.raises(ValueError, match="node order kept: False"):
        reordered.on_shards(shards.split(torch.zeros(n, 2)))


def test_run_one_step_at_2_2_matches_one_device(data_root):
    """STGODE's Adam step under (2, 2), `NodeBatchNorm`'s statistics
    meeting over two data rows of two graph ranks, against (1, 1): the
    losses rtol 1e-5, the gradients as `_close_grads`, every parameter
    after the step within lr (Adam's first step is lr * g / (|g| +
    1e-8): a gradient that is f32 noise around 0 moves by up to lr
    either way) and at atol 1e-6 where the gradient is above that
    noise."""
    cfg, one, sharded = _pair("STGODE", _mesh(2, 2), data_root)
    x, y = _inputs(cfg)
    want = run_one_step(cfg, _mesh(1, 1), one, x, y, seed=3)
    got = run_one_step(cfg, _mesh(2, 2), sharded, x, y, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    def grads(model):     # the discarded TCN convs: none
        return {k: np.zeros(p.shape, np.float32) if p.grad is None
                else p.grad.numpy() for k, p in model.named_parameters()}

    g1 = grads(one)
    _close_grads(grads(sharded), g1)
    top = max(float(np.abs(g).max()) for g in g1.values())
    params = dict(sharded.named_parameters())
    for k, p in one.named_parameters():
        want_p, got_p = p.detach().numpy(), params[k].detach().numpy()
        sure = np.abs(g1[k]) > 1e-5 * top
        np.testing.assert_allclose(got_p, want_p, atol=cfg.lr_init,
                                   err_msg=k)
        np.testing.assert_allclose(got_p[sure], want_p[sure], atol=1e-6,
                                   err_msg=k)


@pytest.fixture
def build_warnings():
    seen = []

    class Seen(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = Seen()
    logging.getLogger("build").addHandler(handler)
    yield seen
    logging.getLogger("build").removeHandler(handler)


def test_an_undivided_node_axis_runs_whole(build_warnings, data_root):
    """N = 15 under (1, 2): ASTGCN runs whole on the row's first device,
    says so once, and its step is the one-device step; at N = 14 none
    of the five warns."""
    mesh = _mesh(1, 2)
    for name in CASES:
        _pair(name, mesh, data_root)
    assert build_warnings == []
    n = 15
    cfg, one, sharded = _pair("ASTGCN", mesh, data_root, n)
    assert sharded.predictor.shards(torch.device("cpu")) is None
    assert len(build_warnings) == 1 and "ASTGCN" in build_warnings[0]
    x, y = _inputs(cfg, n)
    p1, l1, g1 = _step(one, cfg, x, y)
    p2, l2, g2 = _step(sharded, cfg, x, y, mesh)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    assert torch.equal(p1, p2)
    _close_grads(g2, g1)


def test_eval_encoder_shards_reach_a_sharded_dmvstnet(monkeypatch):
    """Eval DMVSTNET under (1, 2): the frozen encoder's shards go to the
    head and the predictor on their ranks (the (B, T, N, 16) embedding
    is never gathered: `GPTST.encode` is gone, and the only gathers are
    the predictor's: x_spa's for the adjacency's rows, and the
    prediction), and the prediction is the one-device one (rtol
    1e-5)."""
    mesh = _mesh(1, 2)
    kw = dict(GPTST_SMALL, mode="eval", model="DMVSTNET", num_nodes=N,
              batch_size=B, predictor_overrides=CASES["DMVSTNET"][1])
    cfg = default_config("PEMS08", **kw)
    pre = tbuild.build_pretrain(cfg.replace(mode="pretrain"), -0.5, "cpu",
                                0).gptst.state_dict()
    one, sharded = (tbuild.build_model(cfg, adj=ADJ, device="cpu", seed=1,
                                       scaler_zeros=-0.5, mesh=m,
                                       pretrain_params=pre)
                    for m in (None, mesh))
    gathers = []
    gather = tmesh.NodeShards.gather
    monkeypatch.setattr(tmesh.NodeShards, "gather", lambda self, s, dim=-2: (
        gathers.append(s[0].shape[-1]) or gather(self, s, dim)))
    monkeypatch.setattr(tg.GPTST, "encode", None)     # the gathering path
    x, _ = _inputs(cfg)
    with torch.no_grad():
        got = sharded(torch.tensor(x)).pred
        assert gathers == [4, cfg.output_dim], gathers
        monkeypatch.undo()
        want = one(torch.tensor(x)).pred
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
