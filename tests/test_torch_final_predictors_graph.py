"""TGCN, STMGCN, STSGCN and STFGNN node-sharded over the mesh's 'graph'
axis, on `["cpu"] * P` ranks, at N = 14 (no width of the models is 14)
and tiny widths, the weights the port's init plus N(0, 0.1^2) noise;
STSGCN and STFGNN on row-normalized synchronous graphs, as their parity
tests feed them (with noisy weights the raw graphs drive the loss to
~1e10): STSGCN's through both packages' `construct_sync_adj`, STFGNN's
as the fusion-graph prefab of a tmp data root, which both builders read.

  * each of the four under (1, 2) against the port's one-device step:
    the prediction, the loss (rtol 1e-5) and every gradient (rtol 1e-4
    with an atol of 1e-5 of each tensor's largest entry); and against
    `gptst_tpu`'s `value_and_grad` of its loss on the same weights
    (`convert.py`), jitted under GSPMD on a (1, 2) host mesh (TGCN's
    support there is the JAX package's halo support);
  * every rank holds N/2 nodes of the network's output and of every
    node-local layer's, of `spatial_emb` and of its graph rows; TGCN's
    support takes and gives the ranks' shards and never gathers x;
  * `strided_rows` of (S N, S N) graphs are the whole graph's rows,
    column-permuted, and their products with the gathered windows the
    whole product's rows;
  * TGCN on the halo exchange, the ring and a `partition_graph_coo`
    partition against one device, and its refusal of a partition that
    reorders the nodes;
  * `run_one_step` of TGCN at (2, 2) against (1, 1);
  * eval: the frozen encoder's node shards reach a sharded TGCN with no
    gather of the embedding;
  * N = 15 under (1, 2): each of the four runs whole, equals one device
    and warns once.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import stsgcn as jstsgcn
from gptst_tpu.parallel import mesh as jmesh
from gptst_tpu.train.loss import build_loss as jbuild_loss
from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import state_dict_to_flax
from gptst_tpu_torch.graph import partition as tpart
from gptst_tpu_torch.graph.artifacts import random_sensor_graph, sym_adj
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models import gptst as tg
from gptst_tpu_torch.models.predictors import stfgnn as tstfgnn
from gptst_tpu_torch.models.predictors import stsgcn as tstsgcn
from gptst_tpu_torch.ops import graph_conv as tgc
from gptst_tpu_torch.ops import recurrent as trec
from gptst_tpu_torch.parallel import halo as thalo
from gptst_tpu_torch.parallel import mesh as tmesh
from gptst_tpu_torch.parallel.spmd import run_one_step
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms, model_forwards
from torch_parity import one_torch_thread

_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread", "graphs")

N, B, STEP = 14, 4, 3
CASES = {
    "TGCN": ("PEMS08", (("rnn_units", "4"),)),
    "STMGCN": ("NYC_BIKE", (("lstm_hidden_dim", "4"),
                            ("gcn_hidden_dim", "4"),
                            ("lstm_num_layers", "2"))),
    "STSGCN": ("PEMS08", (("filter_list", "[[4,4,4],[4,4,4]]"),
                          ("first_layer_embedding_size", "4"))),
    "STFGNN": ("PEMS08", (("hidden_dims", "[[4,4,4]]"),
                          ("first_layer_embedding_size", "4"),
                          ("out_layer_dim", "8"))),
}
GPTST_SMALL = dict(hidden_dim=16, embed_dim=8, embed_dim_spa=4, HS=4, HT=6,
                   HT_Tem=4, change_epoch=1, epochs=4)
ADJ = {n: random_sensor_graph(n, avg_degree=4, seed=3) for n in (N, 15)}
# the graph rows a rank holds under (1, 2), by model
ROWS = {"STMGCN": (2, 3, N // 2, N), "STSGCN": (3 * N // 2, 3 * N),
        "STFGNN": (4 * N // 2, 4 * N)}


def _row_normalized(a: np.ndarray) -> np.ndarray:
    return (a / a.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """n -> a data root holding STFGNN's row-normalized fusion graph for
    n nodes (`STFGNN/PEMS08/PEMS08_adj_mx.npy`, of `ADJ[n]` and a random
    symmetric DTW graph), with both packages' `construct_sync_adj`
    row-normalized for the module."""
    rng = np.random.default_rng(7)
    roots = {}
    for n in (N, 15):
        roots[n] = tmp_path_factory.mktemp(f"data{n}")
        d = roots[n] / "STFGNN" / "PEMS08"
        d.mkdir(parents=True)
        dtw = (rng.random((n, n)) < 0.3).astype(np.float32)
        np.save(d / "PEMS08_adj_mx.npy", _row_normalized(
            tstfgnn.construct_adj_fusion(ADJ[n], np.maximum(dtw, dtw.T), 4)))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tstsgcn, jstsgcn):
            mp.setattr(mod, "construct_sync_adj",
                       lambda a, steps=3, f=mod.construct_sync_adj:
                       _row_normalized(np.asarray(f(a, steps))))
        yield roots


def _mesh(d, g):
    return tmesh.make_mesh(devices=["cpu"] * (d * g), graph_axis_size=g)


def _cfg(name, roots, n=N, **kw):
    ds, ov = CASES[name]
    return default_config(ds, mode="ori", model=name, num_nodes=n,
                          batch_size=B, predictor_overrides=ov,
                          data_root=str(roots[n]), **kw)


def _noised(model, seed=5):
    """The port's init plus N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p += torch.tensor(0.1 * rng.standard_normal(p.shape),
                              dtype=p.dtype)
    return model


def _pair(name, mesh, roots, n=N):
    """The same noised model one-device and under `mesh`."""
    cfg = _cfg(name, roots, n)
    one = _noised(tbuild.build_model(cfg, adj=ADJ[n], device="cpu", seed=0))
    sharded = tbuild.build_model(cfg, adj=ADJ[n], device="cpu", seed=0,
                                 mesh=mesh)
    sharded.load_state_dict(one.state_dict())
    return cfg, one, sharded


def _inputs(cfg, n=N, seed=1):
    rng = np.random.default_rng(seed)
    c = cfg.input_base_dim + 2
    x = rng.standard_normal((B, 12, n, c)).astype(np.float32)
    y = (np.abs(rng.standard_normal((B, 12, n, c))) + 0.1).astype(np.float32)
    return x, y


def _step(model, cfg, x, y, mesh=None):
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
    terms = make_loss_terms(model, build_loss(
        cfg.loss_func, 0.0, 1.0, cfg.mape_thresh, False), cfg,
        forward=forward)
    total, _ = terms(torch.tensor(x), torch.tensor(y), STEP)
    total.backward()
    return preds[0].detach(), total.item(), {
        k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for k, p in model.named_parameters()}


def _close_grads(got: dict, want: dict) -> None:
    """rtol 1e-4 with an atol of 1e-5 of each tensor's largest entry; a
    tensor whose largest entry is at most 1e-5 of the model's largest is
    held at 1e-5 of the latter, as `torch_parity._assert_close`."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(
            np.asarray(got[k]), w, rtol=1e-4,
            atol=1e-5 * (scale if scale > 1e-5 * top else top),
            err_msg=str(k))


def _same_step(got, want, exact=False):
    """Two `_step` results: the loss rtol 1e-5, the prediction rtol 1e-4
    with an atol of 1e-5 of its largest entry (equal with `exact`), the
    gradients as `_close_grads`."""
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    if exact:
        assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-4,
                               atol=1e-5 * want[0].abs().max().item())
    _close_grads(got[2], want[2])


@pytest.fixture(scope="module")
def jax_side(graphs):
    """(name, the port's network) -> (loss, gradients by flax path) of
    `gptst_tpu`'s jitted `value_and_grad` of its loss on the network's
    weights and `_inputs`, under GSPMD on a (1, 2) host mesh. Computed
    once per model."""
    seen = {}

    def get(name, net):
        if name in seen:
            return seen[name]
        ds, ov = CASES[name]
        jcfg = jax_default_config(ds, mode="ori", model=name, num_nodes=N,
                                  batch_size=B, predictor_overrides=ov,
                                  data_root=str(graphs[N]))
        jm = jmesh.make_mesh(2, graph_axis_size=2)
        _, forward = jbuild.build_model(jcfg, adj=ADJ[N], mesh=jm)
        params = jmesh.shard_params(state_dict_to_flax(net.state_dict()),
                                    jm, N)
        terms = jmake_loss_terms(forward, jbuild_loss(
            jcfg.loss_func, 0.0, 1.0, jcfg.mape_thresh, False), jcfg)
        x, y = jmesh.shard_batch(tuple(jnp.asarray(a)
                                       for a in _inputs(jcfg)), jm)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, a, b: terms(p, a, b, None, 1, STEP),
            has_aux=True))(params, x, y)
        seen[name] = float(loss), {
            path: np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}
        return seen[name]

    return get


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


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device_and_jax(name, jax_side, graphs,
                                                 build_warnings):
    mesh = _mesh(1, 2)
    cfg, one, sharded = _pair(name, mesh, graphs)
    assert build_warnings == []
    assert sharded.predictor.shards(torch.device("cpu")).parts == 2
    x, y = _inputs(cfg)
    jloss, jgrads = jax_side(name, one.predictor.net)
    got = _step(sharded, cfg, x, y, mesh)
    _same_step(got, _step(one, cfg, x, y))
    np.testing.assert_allclose(got[1], jloss, rtol=1e-5)
    _close_grads(dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k[len("predictor.net."):]: v for k, v in got[2].items()}))),
        jgrads)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_half_the_nodes(name, graphs, monkeypatch):
    """Under (1, 2): the network and every submodule that returns node
    shards return N/2 nodes a rank, TGCN's cell keeps N/2 nodes of its
    state a rank and its support takes and gives the ranks' shards
    (the gathering product never runs), every dense graph is held as
    its ranks' rows alone (`MeshRows`), and `spatial_emb` is read by its
    ranks' nodes."""
    mesh = _mesh(1, 2)
    cfg, _, model = _pair(name, mesh, graphs)
    net = model.predictor.net
    widths, split, support = set(), {}, set()
    for m in net.modules():
        m.register_forward_hook(lambda _, a, out: widths.add(
            tuple(t.shape[-2] for t in out)
            if isinstance(out, list) else None))
    cut, update = tmesh.NodeShards.split, trec.GraphGRUCell._update
    on_shards = thalo.ShardProduct.on_shards

    def record_split(self, t, dim=-2):
        out = cut(self, t, dim)
        split[id(t)] = [s.shape[dim] for s in out]
        return out

    def record_update(self, az, h, u):
        widths.add(("state", h.shape[-2]))
        return update(self, az, h, u)

    def record_support(self, xs):
        support.add(tuple(x.shape[-2] for x in xs))
        return on_shards(self, xs)

    monkeypatch.setattr(tmesh.NodeShards, "split", record_split)
    monkeypatch.setattr(trec.GraphGRUCell, "_update", record_update)
    monkeypatch.setattr(thalo.ShardProduct, "on_shards", record_support)
    monkeypatch.setattr(thalo.ShardProduct, "__call__", None)
    x, y = _inputs(cfg)
    _step(model, cfg, x, y, mesh)
    widths.discard(None)
    if name == "TGCN":
        assert widths == {(N // 2, N // 2), ("state", N // 2)}, widths
        assert support == {(N // 2, N // 2)}, support
        return
    assert widths == {(N // 2, N // 2)}, widths
    (graph,) = model.predictor.graph
    rows = graph.of(model.predictor.shards(torch.device("cpu")))
    assert isinstance(graph, tgc.MeshRows) and len(graph.by_ranks) == 1
    assert [tuple(r.shape) for r in rows] == [ROWS[name]] * 2
    embs = [p for k, p in net.named_parameters() if k.endswith("spatial_emb")]
    assert len(embs) == {"STMGCN": 0, "STSGCN": 2, "STFGNN": 1}[name]
    assert all(p.shape[2] == N and split.get(id(p)) == [N // 2, N // 2]
               for p in embs)


@pytest.mark.parametrize("steps, parts", [(3, 2), (4, 2), (4, 7)])
def test_strided_rows_are_the_whole_graphs_rows(steps, parts):
    """Rank g's `strided_rows` of an (S N, S N) graph are the whole
    graph's rows {s N + v : v in rank g's nodes}, step by step, with the
    columns in the order of the ranks' window stacks all-gathered; times
    those gathered stacks they give rank g's rows of the whole product
    (float64: the same sums)."""
    rng = np.random.default_rng(steps * parts)
    a = torch.tensor(rng.standard_normal((steps * N, steps * N)))
    shards = tmesh.NodeShards((torch.device("cpu"),) * parts, N)
    n_loc = N // parts
    mine = [[s * N + g * n_loc + v for s in range(steps)
             for v in range(n_loc)] for g in range(parts)]
    gathered_order = sum(mine, [])
    x = torch.tensor(rng.standard_normal((2, 6, N, 3)))
    whole = torch.einsum("mn,bwnc->bwmc", a, tstsgcn.window_stack(x, steps))
    gathered = torch.cat([tstsgcn.window_stack(xg, steps)
                          for xg in shards.split(x)], dim=-2)
    rows = tgc.strided_rows(a, shards, steps)
    assert len(rows) == parts
    for g, r in enumerate(rows):
        assert torch.equal(r, a[mine[g]][:, gathered_order])
        torch.testing.assert_close(
            torch.einsum("mn,bwnc->bwmc", r, gathered),
            whole[:, :, mine[g]], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["halo", "ring", "coo", "reordered"])
def test_sharded_tgcn_on_each_kind_of_support(kind, graphs):
    """TGCN under (1, 2) on the halo exchange `build_model` picks, on the
    ring and on a `partition_graph_coo` partition (the node order kept)
    steps as one device; on a partition that reorders the nodes
    `ShardedSupport.on_shards` refuses the shards."""
    mesh = _mesh(1, 2)
    cfg, one, sharded = _pair("TGCN", mesh, graphs)
    a = sym_adj(ADJ[N])
    (sup,) = sharded.predictor.graph
    assert sup.kind == "halo"
    if kind == "ring":
        fn, n_pad = thalo.make_ring_spmm(mesh, a)
        sup = tgc.ShardedSupport(fn=fn, n=N, n_pad=n_pad, kind="ring")
    elif kind == "coo":
        r, c = np.nonzero(a)
        sup = tgc.make_sharded_support(
            None, mesh, part=tpart.partition_graph_coo(r, c, a[r, c], N, 2))
        assert sup.in_node_order
    elif kind == "reordered":
        sup = tgc.make_sharded_support(
            None, mesh, part=tpart.partition_graph(a, 2, reorder=True))
        assert not sup.in_node_order
    sharded.predictor.graph = (sup,)
    x, y = _inputs(cfg)
    if kind == "reordered":
        with pytest.raises(ValueError, match="node order kept: False"):
            _step(sharded, cfg, x, y, mesh)
        return
    _same_step(_step(sharded, cfg, x, y, mesh), _step(one, cfg, x, y))


def test_run_one_step_at_2_2_matches_one_device(graphs):
    """TGCN's Adam step under (2, 2), two data rows of two graph ranks
    each on its own halo exchange, against (1, 1): the losses rtol 1e-5,
    the gradients as `_close_grads`, every parameter after the step
    within lr (Adam's first step is lr * g / (|g| + 1e-8): a gradient
    that is f32 noise around 0 moves by up to lr either way) and at
    atol 1e-6 where the gradient is above that noise."""
    cfg, one, sharded = _pair("TGCN", _mesh(2, 2), graphs)
    x, y = _inputs(cfg)
    want = run_one_step(cfg, _mesh(1, 1), one, x, y, seed=3)
    got = run_one_step(cfg, _mesh(2, 2), sharded, x, y, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    g1 = {k: p.grad.numpy() for k, p in one.named_parameters()}
    _close_grads({k: p.grad.numpy() for k, p in sharded.named_parameters()},
                 g1)
    top = max(float(np.abs(g).max()) for g in g1.values())
    params = dict(sharded.named_parameters())
    for k, p in one.named_parameters():
        want_p, got_p = p.detach().numpy(), params[k].detach().numpy()
        sure = np.abs(g1[k]) > 1e-5 * top
        np.testing.assert_allclose(got_p, want_p, atol=cfg.lr_init,
                                   err_msg=k)
        np.testing.assert_allclose(got_p[sure], want_p[sure], atol=1e-6,
                                   err_msg=k)


def test_eval_encoder_shards_reach_a_sharded_tgcn(monkeypatch):
    """Eval TGCN under (1, 2): the frozen encoder's shards go to the head
    and the predictor on their ranks (the (B, T, N, 16) embedding is
    never gathered: `GPTST.encode` is gone, the support's gathering
    product too, and the only gather is the prediction's), and the
    prediction is the one-device one (rtol 1e-5)."""
    mesh = _mesh(1, 2)
    kw = dict(GPTST_SMALL, mode="eval", model="TGCN", num_nodes=N,
              batch_size=B, predictor_overrides=CASES["TGCN"][1])
    cfg = default_config("PEMS08", **kw)
    pre = tbuild.build_pretrain(cfg.replace(mode="pretrain"), -0.5, "cpu",
                                0).gptst.state_dict()
    one, sharded = (tbuild.build_model(cfg, adj=ADJ[N], device="cpu",
                                       seed=1, scaler_zeros=-0.5, mesh=m,
                                       pretrain_params=pre)
                    for m in (None, mesh))
    gathers = []
    gather = tmesh.NodeShards.gather
    monkeypatch.setattr(tmesh.NodeShards, "gather", lambda self, s, dim=-2: (
        gathers.append(s[0].shape[-1]) or gather(self, s, dim)))
    monkeypatch.setattr(tg.GPTST, "encode", None)     # the gathering path
    monkeypatch.setattr(thalo.ShardProduct, "__call__", None)
    x, _ = _inputs(cfg)
    with torch.no_grad():
        got = sharded(torch.tensor(x)).pred
        assert gathers == [cfg.output_dim], gathers
        monkeypatch.undo()
        want = one(torch.tensor(x)).pred
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_an_undivided_node_axis_runs_whole(name, build_warnings, graphs):
    """N = 15 under (1, 2): the model runs whole on the row's first
    device (TGCN's aggregation on its support padded to 16 nodes), says
    so once, counting its dense graph operand, and its step is the
    one-device step (the same on the same dense graph)."""
    n = 15
    mesh = _mesh(1, 2)
    cfg, one, sharded = _pair(name, mesh, graphs, n)
    assert sharded.predictor.shards(torch.device("cpu")) is None
    assert len(build_warnings) == 1, build_warnings
    (message,) = build_warnings
    assert message.startswith(f"{name} under a graph axis of 2"), message
    assert ("1 graph operands" in message) == (name != "TGCN"), message
    x, y = _inputs(cfg, n)
    _same_step(_step(sharded, cfg, x, y, mesh), _step(one, cfg, x, y),
               exact=name != "TGCN")
