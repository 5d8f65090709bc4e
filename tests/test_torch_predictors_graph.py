"""STGCN, GWN, MTGNN and CCRNN node-sharded over the mesh's 'graph' axis,
on `["cpu"] * P` ranks, at N = 14 (no width of the models is 14) and
tiny widths, the weights the port's init plus N(0, 0.1^2) noise (MTGNN's
embeddings then at 0.1 of their scale, off tanh's saturation, as
`tests/test_torch_mtgnn.py` keeps them):

  * each of the four under (1, 2) against the port's one-device step
    with dropout drawn (CCRNN teacher-forced): the prediction, the loss
    (rtol 1e-5) and every gradient (rtol 1e-4 with an atol of 1e-5 of
    each tensor's largest entry); and, without a generator, the loss and
    gradients against `gptst_tpu`'s jitted `value_and_grad` of its loss
    on the same weights (`convert.py`): one-device JAX for three, GSPMD
    on a (1, 2) host mesh for GWN (on the graph axis GSPMD gives the
    one-device values within 1e-6);
  * every node-local layer's output, every learned graph's rows and
    every node table a rank reads hold N/2 nodes on each rank;
  * `run_one_step` of GWN (batch statistics and dropout over data rows
    and ranks) at (2, 2) against (1, 1);
  * N = 15 under (1, 2) runs whole (the graph axis does not divide it),
    equals one device and warns once;
  * STGCN in bf16 under (1, 2) against JAX as
    `tests/test_torch_stgcn.py::test_bf16_loss_and_grads_match_jax`;
  * eval: the frozen encoder's node shards reach a sharded STGCN with no
    gather (the prediction and a trainer's test report as one device's,
    rtol 1e-5 and 1e-4);
  * GWN with static supports under (1, 2) raises in both packages
    (ROADMAP.md Queue 3, item 15).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.parallel import mesh as jmesh
from gptst_tpu.train.loss import build_loss as jbuild_loss
from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.graph.artifacts import random_sensor_graph
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models import gptst as tg
from gptst_tpu_torch.ops import graph_conv as tgc
from gptst_tpu_torch.parallel import mesh as tmesh
from gptst_tpu_torch.parallel.spmd import run_one_step
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms, model_forwards
from gptst_tpu_torch.train.trainer import Trainer
from torch_parity import one_torch_thread

_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B, STEP = 14, 4, 1711     # CCRNN's coins are fair at step 1711
CASES = {
    "STGCN": ("PEMS08", (("blocks1", "[8,4,8]"), ("drop_prob", "0.3"))),
    "GWN": ("PEMS08", (("nhid", "4"), ("blocks", "1"))),
    "MTGNN": ("PEMS08", (("conv_channels", "4"), ("residual_channels", "4"),
                         ("skip_channels", "8"), ("end_channels", "8"),
                         ("layers", "1"), ("subgraph_size", "5"),
                         ("node_dim", "6"))),
    "CCRNN": ("NYC_BIKE", (("hidden_size", "4"), ("n_dim", "8"))),
}
GPTST_SMALL = dict(hidden_dim=16, embed_dim=8, embed_dim_spa=4, HS=4, HT=6,
                   HT_Tem=4, change_epoch=1, epochs=4)
ADJ = random_sensor_graph(N, avg_degree=4, seed=3)
ADJ15 = random_sensor_graph(15, avg_degree=4, seed=3)


def _mesh(d, g):
    return tmesh.make_mesh(devices=["cpu"] * (d * g), graph_axis_size=g)


def _cfg(name, n=N, **kw):
    ds, ov = CASES[name]
    return default_config(ds, mode="ori", model=name, num_nodes=n,
                          batch_size=B, predictor_overrides=ov, **kw)


def _noised(model, seed=5):
    """The port's init plus N(0, 0.1^2), MTGNN's embeddings at 0.1."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p += torch.tensor(0.1 * rng.standard_normal(p.shape),
                              dtype=p.dtype)
            if k.endswith(("gc.emb1", "gc.emb2")):
                p *= 0.1
    return model


def _pair(name, mesh, n=N, **kw):
    """The same noised model one-device and under `mesh`."""
    cfg = _cfg(name, n, **kw)
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
    (GWN's gconv biases, 0 in exact arithmetic before a BatchStatsNorm)
    is held at 1e-5 of the latter, as `torch_parity._assert_close`."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 0.0)
        np.testing.assert_allclose(
            np.asarray(got[k]), w, rtol=1e-4,
            atol=1e-5 * (scale if scale > 1e-5 * top else top),
            err_msg=str(k))


@pytest.fixture(scope="module")
def jax_side():
    """name -> (loss, gradients by flax path) of `gptst_tpu`'s jitted
    `value_and_grad` of its loss (no key: no dropout, no teacher
    forcing) on the noised weights and `_inputs`; GWN's under GSPMD on a
    (1, 2) host mesh. Computed once per model."""
    seen = {}

    def get(name):
        if name in seen:
            return seen[name]
        ds, ov = CASES[name]
        jcfg = jax_default_config(ds, mode="ori", model=name, num_nodes=N,
                                  batch_size=B, predictor_overrides=ov)
        jm = jmesh.make_mesh(2, graph_axis_size=2) if name == "GWN" else None
        _, forward = jbuild.build_model(jcfg, adj=ADJ, mesh=jm)
        cfg = _cfg(name)
        model = _noised(tbuild.build_model(cfg, adj=ADJ, device="cpu",
                                           seed=0))
        params = state_dict_to_flax(model.predictor.net.state_dict())
        terms = jmake_loss_terms(forward, jbuild_loss(
            jcfg.loss_func, 0.0, 1.0, jcfg.mape_thresh, False), jcfg)
        x, y = (jnp.asarray(a) for a in _inputs(cfg))
        if jm is not None:
            params = jmesh.shard_params(params, jm, N)
            x, y = jmesh.shard_batch((x, y), jm)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, a, b: terms(p, a, b, None, 1, STEP),
            has_aux=True))(params, x, y)
        seen[name] = float(loss), {
            path: np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)}
        return seen[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device_and_jax(name, jax_side):
    mesh = _mesh(1, 2)
    cfg, one, sharded = _pair(name, mesh)
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
    # no generator: JAX's loss and gradients on the same weights
    _, loss, grads = _step(sharded, cfg, x, y, mesh)
    jloss, jgrads = jax_side(name)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k[len("predictor.net."):]: v for k, v in grads.items()})))
    _close_grads(got, jgrads)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_half_the_nodes(name, monkeypatch):
    """Under (1, 2): every submodule that returns node shards returns
    N/2 nodes a rank, every learned or predefined graph is held as
    (N/2, N) rows a rank, and every node table whose first axis is N
    (`param_pspec`'s rule), with MTGNN's (T, N, C) norms, is read by
    its ranks' rows alone."""
    mesh = _mesh(1, 2)
    cfg, _, model = _pair(name, mesh)
    net = model.predictor.net
    widths, rows, split = set(), set(), {}
    for m in net.modules():
        m.register_forward_hook(lambda _, a, out: widths.add(
            tuple(t.shape[-2] if t.dim() > 3 else t.shape[1] for t in out)
            if isinstance(out, list) else None))
    matmul, cut = tgc.NodeRows.matmul, tmesh.NodeShards.split

    def record_rows(self, xs):
        rows.add(tuple(tuple(a.shape) for a in self.rows))
        return matmul(self, xs)

    def record_split(self, t, dim=-2):
        out = cut(self, t, dim)
        split[id(t)] = [s.shape[dim] for s in out]
        return out

    monkeypatch.setattr(tgc.NodeRows, "matmul", record_rows)
    monkeypatch.setattr(tmesh.NodeShards, "split", record_split)
    x, y = _inputs(cfg)
    _step(model, cfg, x, y, mesh, generator=torch.Generator().manual_seed(1))
    widths.discard(None)
    assert widths == {(N // 2, N // 2)}, widths
    if name == "STGCN":       # the constant (K, N, N) stack, by its rows
        assert split[id(model.predictor.graph[0])] == [N // 2, N // 2]
    else:
        assert rows == {((N // 2, N),) * 2}, rows
    tables = [(k, p) for k, p in net.named_parameters()
              if p.shape[0] == N or (name, k[:5]) == ("MTGNN", "norm.")]
    assert tables
    for k, p in tables:
        assert split.get(id(p)) == [N // 2, N // 2], k


def test_run_one_step_at_2_2_matches_one_device():
    """GWN's Adam step under (2, 2), its batch statistics and dropout
    meeting over two data rows of two graph ranks, against (1, 1): the
    losses rtol 1e-5, the gradients as `_close_grads`, every parameter
    after the step within lr (Adam's first step is lr * g / (|g| +
    1e-8): a gradient that is f32 noise around 0 moves by up to lr
    either way) and at atol 1e-6 where the gradient is above that
    noise."""
    cfg, one, sharded = _pair("GWN", _mesh(2, 2))
    x, y = _inputs(cfg)
    want = run_one_step(cfg, _mesh(1, 1), one, x, y, seed=3)
    got = run_one_step(cfg, _mesh(2, 2), sharded, x, y, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    def grads(model):     # the last layer's gconv and norm: none
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


def test_an_undivided_node_axis_runs_whole(build_warnings):
    """N = 15 under (1, 2): MTGNN runs whole on the row's first device,
    says so once, and its step is the one-device step."""
    n = 15
    mesh = _mesh(1, 2)
    cfg, one, sharded = _pair("MTGNN", mesh, n)
    assert sharded.predictor.shards(torch.device("cpu")) is None
    assert len(build_warnings) == 1 and "MTGNN" in build_warnings[0]
    x, y = _inputs(cfg, n)
    gen = torch.Generator().manual_seed(2)
    p1, l1, g1 = _step(one, cfg, x, y, generator=gen)
    gen = torch.Generator().manual_seed(2)
    p2, l2, g2 = _step(sharded, cfg, x, y, mesh, generator=gen)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    assert torch.equal(p1, p2)
    _close_grads(g2, g1)


def test_bf16_stgcn_under_the_graph_axis_matches_jax():
    """`compute_dtype=bfloat16` under (1, 2): the loss at rtol 1e-4 and
    each gradient f32 within a relative L2 of 0.1 of JAX's, the bounds
    of `tests/test_torch_stgcn.py::test_bf16_loss_and_grads_match_jax`
    (the node sums over the ranks accumulate in f32)."""
    mesh = _mesh(1, 2)
    ov = (("blocks1", "[8,4,8]"),)
    kw = dict(mode="ori", model="STGCN", num_nodes=N, batch_size=B,
              compute_dtype="bfloat16", predictor_overrides=ov)
    jcfg = jax_default_config("PEMS08", **kw)
    _, forward = jbuild.build_model(jcfg, adj=ADJ)
    cfg = default_config("PEMS08", **kw)
    model = tbuild.build_model(cfg, adj=ADJ, device="cpu", mesh=mesh)
    rng = np.random.default_rng(5)
    with torch.no_grad():     # `test_bf16_loss_and_grads_match_jax`'s noise
        for p in model.parameters():
            p += torch.tensor(0.02 * rng.standard_normal(p.shape),
                              dtype=p.dtype)
    params = state_dict_to_flax(model.predictor.net.state_dict())
    x, y = _inputs(cfg)
    loss_fn = ("mask_mae", 50.0, 10.0, None, False)
    jterms = jmake_loss_terms(forward, jbuild_loss(*loss_fn), jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jterms(p, jnp.asarray(x), jnp.asarray(y), None, 1, 0),
        has_aux=True))(params)
    terms = make_loss_terms(model, build_loss(*loss_fn), cfg,
                            forward=model_forwards(model, cfg, mesh)[1])
    loss, _ = terms(torch.tensor(x), torch.tensor(y))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    flat = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k: p.grad for k, p in model.predictor.net.named_parameters()})))
    for path, w in jax.tree_util.tree_leaves_with_path(jgrads):
        got, w = flat[path], np.asarray(w)
        assert got.dtype == np.float32 and np.abs(w).max() > 0, path
        rel = np.linalg.norm(got - w) / np.linalg.norm(w)
        assert rel < 0.1, (jax.tree_util.keystr(path), rel)


def test_eval_encoder_shards_reach_a_sharded_stgcn(monkeypatch, tmp_path):
    """Eval STGCN under (1, 2): the frozen encoder's shards go to the
    head and the predictor on their ranks (the (B, T, N, 16) embedding
    is never gathered: `GPTST.encode` is gone, and the only gathers are
    the predictor's), every encoder layer sees N/2 nodes a rank, and
    the prediction (rtol 1e-5) and a 1-epoch trainer's test report
    (rtol 1e-4, as `tests/test_torch_spmd.py` holds a trainer's: the
    steps carry the sums' order into the weights) are the one-device
    ones."""
    mesh = _mesh(1, 2)
    kw = dict(GPTST_SMALL, mode="eval", model="STGCN", num_nodes=N,
              batch_size=B, epochs=1, lr_decay=False, early_stop=False,
              log_step=1000, predictor_overrides=(("blocks1", "[8,4,8]"),))
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
    widths = set()
    for m in sharded.encoder.modules():
        if isinstance(m, (tg.HyperTem, tg.Cap)):
            m.register_forward_pre_hook(lambda _, a: widths.add(
                tuple(t.shape[2] for t in a[0])
                if isinstance(a[0], list) else a[0].shape[2]))
    x, _ = _inputs(cfg)
    with torch.no_grad():
        got = sharded(torch.tensor(x)).pred
        # the Chebyshev products' all-gathers (4 wide) and the prediction
        assert gathers == [4, 4, cfg.output_dim], gathers
        assert widths == {N // 2, (7, 7)}, widths
        monkeypatch.undo()
        want = one(torch.tensor(x)).pred
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    reports = []
    for m, model in ((None, one), (mesh, sharded)):
        ds = build_dataset(cfg, num_steps=120, seed=cfg.seed)
        log_dir = tmp_path / ("one" if m is None else "mesh")
        log_dir.mkdir()
        tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                     log_dir=str(log_dir), device="cpu", mesh=m)
        reports.append(tr.train()["report"])
    for part in ("per_horizon", "average"):
        np.testing.assert_allclose(reports[1][part], reports[0][part],
                                   rtol=1e-4)


def test_gwn_static_supports_under_the_graph_axis_raise_in_both():
    """GWN `--aptonly False` on a (1, 2) mesh: the sharded supports have
    no transpose, an AttributeError in both packages (ROADMAP.md Queue
    3, item 15)."""
    ov = (("aptonly", "False"), ("nhid", "4"))
    cfg = default_config("PEMS08", mode="ori", model="GWN", num_nodes=N,
                         predictor_overrides=ov)
    model = tbuild.build_model(cfg, adj=ADJ, device="cpu", mesh=_mesh(1, 2))
    with pytest.raises(AttributeError, match="item 15"):
        model(torch.zeros(2, 12, N, 3))
    jcfg = jax_default_config("PEMS08", mode="ori", model="GWN", num_nodes=N,
                              predictor_overrides=ov)
    init, _ = jbuild.build_model(jcfg, adj=ADJ,
                                 mesh=jmesh.make_mesh(2, graph_axis_size=2))
    with pytest.raises(AttributeError):
        init(jax.random.PRNGKey(0))
