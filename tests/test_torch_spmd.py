"""The data axis of the port: `parallel/mesh.py`'s layout rules and
`parallel/spmd.py`'s data-parallel step, on `["cpu"] * P` ranks, against
`gptst_tpu.parallel` on the conftest's 8 host devices and against the
port's own one-device step.

The data-parallel step must be the one-device step's math, as the JAX
step under GSPMD is: the loss at rtol 1e-5 and every gradient at rtol
1e-4 with an atol of 1e-5 of the tensor's largest entry (f32 sums in
another order), for every predictor and mode and each place where the
one-device math couples the batch: the masked loss over uneven kept
counts, `BatchStatsNorm` and STGODE's node batch norm, GPT-ST's mask
(both branches), dropout, ST_WA's latents, CCRNN's coin, a ragged tail,
and TGCN's sparse and node-sharded supports. Against the
JAX package: the loss at rtol 1e-4 and the parameters at atol 1e-5
after one step, as `tests/test_spmd.py` holds GSPMD to the local step;
the trainer's losses and report at rtol 1e-4.
"""

import concurrent.futures
import copy
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.models import build as jbuild
from gptst_tpu.parallel import mesh as jmesh
from gptst_tpu.parallel import spmd as jspmd
from gptst_tpu.train.loss import build_loss as jbuild_loss
from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch import run as trun
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.kernels import spmm
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.ops.graph_conv import (
    ShardedSupport, SparseSupport, make_support,
)
from gptst_tpu_torch.parallel import mesh as tmesh
from gptst_tpu_torch.parallel.rows import (
    ROW_LAUNCHES, RowGroup, batch_count, row_scope,
)
from gptst_tpu_torch.parallel.spmd import DataParallel, run_one_step
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms, model_forwards
from gptst_tpu_torch.train.trainer import Trainer
from torch_parity import assert_step_matches_jax, one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")


def _mesh(d, g):
    return tmesh.make_mesh(devices=["cpu"] * (d * g), graph_axis_size=g)


# --- the layout rules --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_match_jax(n):
    for g in (None, 1, n):
        want = dict(jmesh.make_mesh(n, graph_axis_size=g).shape)
        got = tmesh.make_mesh(devices=["cpu"] * n, graph_axis_size=g)
        assert tmesh.choose_mesh_shape(n, g) == jmesh.choose_mesh_shape(n, g)
        assert got.shape == want
        d = want["data"]
        assert got.row_devices == [CPU] * d and got.root == CPU
        assert all(got.graph_devices(r) == [CPU] * want["graph"]
                   for r in range(d))


def _marks(model: torch.nn.Module, num_nodes: int) -> set:
    """The flax paths of the parameters the port's `param_pspec` puts
    on 'graph' (marked with ones through `convert.py`)."""
    flat = state_dict_to_flax({
        k: torch.full_like(p, float(tmesh.param_pspec(p, num_nodes) != ()))
        for k, p in model.named_parameters()})
    return {path for path, v in jax.tree_util.tree_leaves_with_path(flat)
            if np.asarray(v).all()}


@pytest.mark.parametrize("mode, model", [("pretrain", "STGCN"),
                                         ("ori", "TGCN")],
                         ids=["GPT-ST", "TGCN"])
def test_param_pspec_picks_the_jax_leaves(mode, model):
    n = 13                       # no width of either model is 13
    kw = dict(mode=mode, model=model, num_nodes=n)
    init_fn, _ = jbuild.build_model(jax_default_config("PEMS08", **kw))
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    want = {path for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)
            if jmesh.param_pspec(leaf, n) != jax.sharding.PartitionSpec()}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        assert tmesh.param_pspec(leaf, n) == tuple(jmesh.param_pspec(leaf, n))
    net = tbuild.build_model(default_config("PEMS08", **kw), device="cpu")
    net = net.gptst if mode == "pretrain" else net.predictor.net
    assert _marks(net, n) == want
    assert (len(want) > 0) == (mode == "pretrain")
    layout = tmesh.shard_params(net, _mesh(2, 1), n)
    assert sum(v != () for v in layout.values()) == len(want)


@pytest.mark.parametrize("b, d", [(8, 2), (8, 4), (7, 2), (7, 4)])
def test_shard_batch_matches_jax_specs(b, d):
    jm = jmesh.make_mesh(2 * d, graph_axis_size=2)
    mesh = _mesh(d, 2)
    for n in (6, 5):
        x = np.arange(b * 2 * n * 3, dtype=np.float32).reshape(b, 2, n, 3)
        (jx,) = jmesh.shard_batch((jnp.asarray(x),), jm)
        spec = tmesh.batch_spec(x.shape, mesh)
        assert spec == tuple(jx.sharding.spec)
        assert tmesh.batch_pspec() == tuple(jmesh.batch_pspec())
        (shards,) = tmesh.shard_batch((torch.tensor(x),), mesh)
        assert len(shards) == (d if b % d == 0 else 1)
        assert (spec[0] is None) == (b % d != 0)
        np.testing.assert_array_equal(torch.cat(shards).numpy(), x)


# --- one step against the JAX package ---------------------------------------

@pytest.fixture(scope="module")
def tiny_pretrain():
    """`tests/test_spmd.py`'s `_tiny_pretrain(16, 8)` with every point
    masked (mask_ratio 1.0: JAX's and torch's draws differ, and then no
    draw matters), on the port's init carried to JAX, with `jax.grad`
    of JAX's loss on those parameters and x at epoch 1 (by flax path;
    the same for every mesh)."""
    kw = dict(mode="pretrain", model="STGCN", num_nodes=16, batch_size=8,
              epochs=20, change_epoch=1, mask_ratio=1.0, log_dir=None)
    jcfg = jax_default_config("PEMS08", **kw)
    cfg = default_config("PEMS08", **kw)
    model = tbuild.build_model(cfg, device="cpu", seed=0, scaler_zeros=0.0)
    params = state_dict_to_flax(model.gptst.state_dict())
    _, forward = jbuild.build_model(jcfg, scaler_zeros=0.0)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                     (8, jcfg.lag, 16, 3)))
    loss = jbuild_loss(jcfg.loss_func, 0.0, 1.0, jcfg.mape_thresh, True)
    terms = jmake_loss_terms(forward, loss, jcfg)
    epoch, count = jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32)
    jgrads = dict(jax.tree_util.tree_leaves_with_path(jax.jit(jax.grad(
        lambda p: terms(p, x, x, jax.random.PRNGKey(0), epoch, count)[0]
    ))(params)))
    return jcfg, forward, params, cfg, model, x, jgrads


@pytest.mark.parametrize("d", [4, 2])
def test_run_one_step_matches_jax(tiny_pretrain, d, monkeypatch):
    """The loss at rtol 1e-4; the step's gradients against `jax.grad` of
    JAX's loss on the same parameters and x, and every parameter after
    the Adam step against JAX's step
    (`torch_parity.assert_step_matches_jax`)."""
    jcfg, forward, params, cfg, model, x, jgrads = tiny_pretrain
    stepped = []
    monkeypatch.setattr(jspmd.jax, "block_until_ready",
                        lambda t: stepped.append(t) or t)
    jtotal, jflow = jspmd.run_one_step(
        jcfg, jmesh.make_mesh(d, graph_axis_size=1), forward, params, x, x)
    model = copy.deepcopy(model)
    total, flow = run_one_step(cfg, _mesh(d, 1), model, x, x)
    np.testing.assert_allclose([total, flow], [jtotal, jflow], rtol=1e-4)
    assert_step_matches_jax(
        model, {k: p.grad for k, p in model.gptst.named_parameters()},
        model.gptst.state_dict(), jgrads, stepped[0], cfg.lr_init)


# --- the data-parallel step against the one-device step ---------------------

GPTST_SMALL = dict(hidden_dim=16, embed_dim=8, embed_dim_spa=4, HS=4, HT=6,
                   HT_Tem=4, change_epoch=1, epochs=4)
CASES = {
    # name: (dataset, mode, model, overrides, nodes, batch, mesh, epoch)
    "gptst_random": ("PEMS08", "pretrain", "STGCN", (), 12, 8, (2, 1), 1),
    "gptst_adaptive": ("PEMS08", "pretrain", "STGCN", (), 12, 8, (2, 1), 3),
    "mtgnn": ("PEMS08", "ori", "MTGNN", (), 12, 8, (2, 1), None),
    "gwn": ("PEMS08", "ori", "GWN", (("nhid", "4"),), 12, 8, (2, 1), None),
    "stgode": ("PEMS08", "ori", "STGODE", (("out_channels", "[4,2,4]"),
                                           ("n_layers", "1")),
               12, 8, (2, 1), None),
    "ccrnn": ("NYC_BIKE", "ori", "CCRNN",
              (("hidden_size", "4"), ("n_dim", "8")), 12, 8, (2, 1), None),
    "stwa": ("PEMS08", "ori", "ST_WA", (("channels", "4"), ("heads", "2"),
                                        ("memory_size", "4")),
             8, 8, (2, 1), None),
    "stgcn": ("PEMS08", "ori", "STGCN", (), 12, 8, (2, 1), None),
    "msdr": ("PEMS08", "ori", "MSDR", (("rnn_units", "4"),), 12, 8, (2, 1),
             None),
    "stmgcn": ("NYC_BIKE", "ori", "STMGCN", (("lstm_hidden_dim", "4"),
                                             ("gcn_hidden_dim", "4")),
               12, 8, (2, 1), None),
    "astgcn": ("PEMS08", "ori", "ASTGCN", (("nb_chev_filter", "4"),
                                           ("nb_time_filter", "4")),
               12, 8, (2, 1), None),
    "stsgcn": ("PEMS08", "ori", "STSGCN",
               (("filter_list", "[[4,4,4],[4,4,4]]"),
                ("first_layer_embedding_size", "4")), 12, 8, (2, 1), None),
    "stfgnn": ("PEMS08", "ori", "STFGNN",
               (("hidden_dims", "[[4,4,4]]"),
                ("first_layer_embedding_size", "4"),
                ("out_layer_dim", "8")), 12, 8, (2, 1), None),
    "dmvstnet": ("NYC_BIKE", "ori", "DMVSTNET", (("hidden_dim", "4"),
                                                 ("topo_embedded_dim", "4")),
                 12, 8, (2, 1), None),
    "eval_gwn": ("PEMS08", "eval", "GWN", (("nhid", "4"),), 12, 8, (2, 1),
                 None),
    # the frozen encoder node-sharded on each row's two graph ranks
    "eval_tgcn_graph": ("PEMS08", "eval", "TGCN", (("rnn_units", "4"),), 12,
                        8, (2, 2), None),
    "tgcn_sparse": ("PEMS08", "ori", "TGCN", (("rnn_units", "8"),), 130, 8,
                    (2, 1), None),
    "tgcn_sharded": ("PEMS08", "ori", "TGCN", (("rnn_units", "8"),), 130, 8,
                     (2, 2), None),
    "uneven_mask": ("PEMS08", "ori", "TGCN", (("rnn_units", "4"),), 12, 8,
                    (2, 1), None),
    "ragged": ("PEMS08", "ori", "TGCN", (("rnn_units", "4"),), 12, 7,
               (2, 1), None),
}


def _case_inputs(name, n, b, c):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, 12, n, c)).astype(np.float32)
    y = rng.standard_normal((b, 12, n, c)).astype(np.float32)
    if name == "uneven_mask":
        # the loss keeps labels above 0: about half on data row 0, one
        # entry in 20 on row 1
        y[b // 2:] = -np.abs(y[b // 2:])
        y[b // 2:, :, ::20] *= -1
    return torch.tensor(x), torch.tensor(y)


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_step_matches_one_device(name, monkeypatch,
                                              tmp_path):
    ds, mode, model, ov, n, b, (d, g), epoch = CASES[name]
    monkeypatch.chdir(tmp_path)      # STGODE caches its DTW graph here
    if name.startswith("tgcn_"):
        monkeypatch.setattr(tbuild, "make_support", functools.partial(
            make_support, dense_threshold=0, tile=64))
    kw = dict(GPTST_SMALL) if mode in ("pretrain", "eval") else {}
    cfg = default_config(ds, mode=mode, model=model, num_nodes=n,
                         batch_size=b, predictor_overrides=ov, **kw)
    mesh = _mesh(d, g)
    encoder = None
    if mode == "eval":         # a random GPT-ST as the frozen encoder
        encoder = tbuild.build_pretrain(cfg.replace(mode="pretrain"), -0.5,
                                        "cpu").state_dict()
        encoder = {k[len("gptst."):]: v for k, v in encoder.items()}
    one, dp = (tbuild.build_model(cfg, device="cpu", seed=0,
                                  scaler_zeros=-0.5, mesh=m,
                                  pretrain_params=encoder)
               for m in (None, mesh))
    if name.startswith("tgcn_"):
        (sup,) = dp.predictor.graph
        assert isinstance(sup, ShardedSupport if g > 1 else SparseSupport)
        if g > 1:
            assert len(sup.row_fns) == d - 1
    loss = build_loss(cfg.loss_func, 0.0, 1.0, cfg.mape_thresh,
                      mode == "pretrain")
    x, y = _case_inputs(name, n, b, cfg.input_base_dim + 2)
    step_kw = {"epoch": epoch} if mode == "pretrain" else {}
    # CCRNN's teacher-forcing threshold 300 / (300 + e^(step / 300)) is
    # 1/2 at step 300 ln 300: its coins are then fair
    step = 1711 if model == "CCRNN" else 3
    results = []
    for model_, forward in ((one, None),
                            (dp, model_forwards(dp, cfg, mesh)[1])):
        terms = make_loss_terms(model_, loss, cfg, forward=forward)
        gen = torch.Generator().manual_seed(11)
        total, flow = terms(x, y, step, generator=gen, **step_kw)
        total.backward()
        results.append((total.item(), flow.item(), {
            k: p.grad for k, p in model_.named_parameters()}))
    (t1, f1, g1), (t2, f2, g2) = results
    np.testing.assert_allclose([t2, f2], [t1, f1], rtol=1e-5)
    if mode == "pretrain":
        assert (t1 > f1) == (epoch > cfg.change_epoch)
    assert g1.keys() == g2.keys()
    for k, want in g1.items():
        if want is None:
            assert g2[k] is None, k
            continue
        np.testing.assert_allclose(
            g2[k].numpy(), want.numpy(), rtol=1e-4,
            atol=1e-5 * want.abs().max().item(), err_msg=k)


def test_a_failing_row_releases_the_others():
    """A row that raises before a meeting releases the rows waiting at
    it, and the step raises the row's error."""
    cfg = default_config("PEMS08", mode="ori", model="MTGNN", num_nodes=12)
    model = tbuild.build_model(cfg, device="cpu", seed=0)
    dp = DataParallel(model, _mesh(2, 1))
    x = torch.zeros(4, 12, 12, 3)
    x[2:] = float("nan")
    calls = []

    def boom(mod, args):
        calls.append(1)
        if torch.isnan(args[0]).any():
            raise FloatingPointError("row 1")

    model.predictor.register_forward_pre_hook(boom)
    with pytest.raises(FloatingPointError, match="row 1"):
        dp(x, generator=torch.Generator().manual_seed(0))
    assert len(calls) == 2


def test_rows_meet_in_order_and_count_launches_under_contention():
    """16 row threads (more than the cores) with a 1 µs switch interval:
    meeting i combines every row's i-th value, no launch count is lost
    to a race, and the rows' first launches on a device share one
    dense-block counter."""
    n, k = 16, 50
    group = RowGroup(n)
    key = ("bsr_spmm", CPU)

    def row(r):
        with row_scope(group, r):
            out = []
            counter = spmm._dense_counter(*key)
            for i in range(k):
                spmm.count_launch("bsr_spmm")
                out.append(batch_count(r * k + i))
            return out, counter

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spmm.reset_launch_counts()
    ROW_LAUNCHES.clear()
    spmm.DENSE_BLOCKS.pop(key, None)
    try:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            futures = [pool.submit(row, r) for r in range(n)]
            results = [f.result(timeout=60) for f in futures]
        want = [sum(r * k + i for r in range(n)) for i in range(k)]
        assert [out for out, _ in results] == [want] * n
        assert all(c is spmm.DENSE_BLOCKS[key] for _, c in results)
        assert spmm.LAUNCHES["bsr_spmm"] == n * k
        assert ROW_LAUNCHES == {r: {"bsr_spmm": k} for r in range(n)}
    finally:
        sys.setswitchinterval(old)
        spmm.reset_launch_counts()
        ROW_LAUNCHES.clear()
        spmm.DENSE_BLOCKS.pop(key, None)


# --- the trainer and the CLI ------------------------------------------------

TRAIN_CFG = dict(mode="ori", model="TGCN", num_nodes=20, batch_size=16,
                 epochs=2, lr_decay=True, lr_decay_step=(1,),
                 early_stop=False, debug=False, log_step=1000,
                 predictor_overrides=(("rnn_units", "8"),))
NUM_STEPS = 220


@pytest.fixture
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        jspmm.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _recorded(tr, name):
    """Wrap the trainer's per-batch method `name` to record each
    batch's total loss."""
    losses, fn = [], getattr(tr, name)

    def recording(*a, **k):
        out = fn(*a, **k)
        losses.extend([out[0]] if name == "_train_batch"
                      else [t for t, _ in out])
        return out

    setattr(tr, name, recording)
    return losses


def _torch_trainer(cfg, state, mesh, log_dir=None, **build):
    """The port's trainer of `cfg`, TGCN's weights from `state` (the
    whole model's with `build`, `build_model`'s eval-mode arguments)."""
    ds = build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    model = tbuild.build_model(cfg, device="cpu", mesh=mesh, **build)
    (model if build else model.predictor.net).load_state_dict(state)
    return Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                   log_dir=log_dir, device="cpu", mesh=mesh)


# eval mode: the frozen GPT-ST encoder at small widths
EVAL_CFG = dict(TRAIN_CFG, mode="eval", hidden_dim=16, embed_dim=8,
                embed_dim_spa=4, HS=4, HT=6, HT_Tem=4)


def _eval_params(cfg, jcfg, jds, jm):
    """Eval mode's JAX forward under `jm` and its parameters, the port's
    init carried to JAX (a JAX GPT-ST init runs op by op), with the
    port's build arguments (the encoder's state dict)."""
    ds = build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    pre = tbuild.build_pretrain(cfg.replace(mode="pretrain"),
                                ds.scaler_zeros, "cpu", 0).gptst.state_dict()
    build = dict(seed=1, scaler_zeros=ds.scaler_zeros, pretrain_params=pre)
    params = state_dict_to_flax(tbuild.build_model(
        cfg, device="cpu", **build).state_dict())
    _, forward = jbuild.build_model(jcfg, scaler_zeros=jds.scaler_zeros,
                                    mesh=jm,
                                    pretrain_params=state_dict_to_flax(pre))
    return forward, params, build


@pytest.mark.parametrize("d, g, mode", [
    pytest.param(2, 1, "ori", id="2-1"), pytest.param(2, 2, "ori", id="2-2"),
    pytest.param(1, 2, "eval", id="eval-1-2")])
def test_trainer_under_a_mesh_matches_jax_and_one_device(d, g, mode,
                                                         _interpret):
    """Two epochs of TGCN at 20 nodes (the halo exchange under (2, 2)),
    batch 16 with a ragged tail of 8 on row 0: the JAX trainer under
    the same mesh and the port's one-device trainer, from the same
    weights; per-step losses, val losses (the history's best) and the
    test report at rtol 1e-4. In eval mode under (1, 2) the frozen
    GPT-ST encoder runs node-sharded (every HyperTem and Cap input
    holds 10 nodes on each rank) and TGCN aggregates through its 2-rank
    halo."""
    kw = TRAIN_CFG if mode == "ori" else EVAL_CFG
    jcfg = jax_default_config("PEMS08", **kw, scan_steps=1)
    jds = jax_build_dataset(jcfg, num_steps=NUM_STEPS, seed=jcfg.seed)
    jm = jmesh.make_mesh(d * g, graph_axis_size=g)
    cfg = default_config("PEMS08", **kw)
    build = {}
    if mode == "ori":
        init_fn, forward = jbuild.build_model(jcfg, mesh=jm)
        params = init_fn(jax.random.PRNGKey(jcfg.seed))
    else:
        forward, params, build = _eval_params(cfg, jcfg, jds, jm)
    jtr = JTrainer(forward=forward, params=params, cfg=jcfg, dataset=jds,
                   seed=jcfg.seed, mesh=jm)
    jlosses = _recorded(jtr, "_run_chunk")
    jres = jtr.train()
    state = flax_to_state_dict(jax.tree.map(np.asarray, params))
    runs, widths = [], set()
    for mesh in (_mesh(d, g), None):
        tr = _torch_trainer(cfg, state, mesh, **build)
        if mode == "eval" and mesh is not None:
            for m in tr.model.encoder.modules():
                if type(m).__name__ in ("HyperTem", "Cap"):
                    m.register_forward_pre_hook(lambda _, a: widths.add(
                        tuple(t.shape[2] for t in a[0])
                        if isinstance(a[0], list) else a[0].shape[2]))
        losses = _recorded(tr, "_train_batch")
        res = tr.train()
        runs.append(([float(v) for v in losses], res))
    assert widths == ({10, (10, 10)} if mode == "eval" else set())
    for losses, res in runs:
        assert len(losses) == len(jlosses) == 2 * 7
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        np.testing.assert_allclose(res["history"], jres["history"],
                                   rtol=1e-4)
        np.testing.assert_allclose(res["best_loss"], jres["best_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(res["report"]["per_horizon"],
                                   jres["report"]["per_horizon"], rtol=1e-4)
        np.testing.assert_allclose(res["report"]["average"],
                                   jres["report"]["average"], rtol=1e-4)


def test_mesh_checkpoints_load_and_resume(tmp_path):
    """A `best_model.pt` trained under a (2, 1) mesh loads into a
    one-device trainer with the same test report, and a mesh run killed
    after its epoch-1 checkpoint and resumed under the mesh reproduces
    the uninterrupted run (rtol 1e-6)."""
    cfg = default_config("PEMS08", **{**TRAIN_CFG, "epochs": 2,
                                      "ckpt_every_epochs": 1})
    state = tbuild.build_model(cfg, device="cpu").predictor.net.state_dict()
    for sub in ("full", "killed", "one"):
        (tmp_path / sub).mkdir()
    full = _torch_trainer(cfg, state, _mesh(2, 1), str(tmp_path / "full"))
    res = full.train()
    one = _torch_trainer(cfg, state, None, str(tmp_path / "one"))
    one.load_checkpoint(str(tmp_path / "full" / "best_model.pt"))
    np.testing.assert_allclose(one.test()["average"],
                               res["report"]["average"], rtol=1e-6)
    part1 = _torch_trainer(cfg.replace(epochs=1), state, _mesh(2, 1),
                           str(tmp_path / "killed")).train()
    part2 = _torch_trainer(cfg, state, _mesh(2, 1),
                           str(tmp_path / "killed")).train(resume=True)
    assert len(part2["history"]) == 1
    np.testing.assert_allclose(part1["history"] + part2["history"],
                               res["history"], rtol=1e-6)
    np.testing.assert_allclose(part2["report"]["average"],
                               res["report"]["average"], rtol=1e-6)


@pytest.mark.parametrize("use_mesh, graph_axis_size",
                         [("True", 0), ("True", 4), ("False", 0)])
def test_cli_builds_the_jax_mesh(use_mesh, graph_axis_size, tmp_path,
                                 monkeypatch):
    """`run.main` with four CPU ranks visible builds the mesh that
    `gptst_tpu/run.py` builds over four devices
    (`make_mesh(graph_axis_size=cfg.graph_axis_size or None)`), logs it
    and passes it to `build_model` and `Trainer`; `-use_mesh False`
    builds none."""
    import gptst_tpu_torch.models.build as build_mod
    import gptst_tpu_torch.train as train_mod

    monkeypatch.setattr(trun, "mesh_devices", lambda device: [CPU] * 4)
    seen = {}
    build, trainer = build_mod.build_model, train_mod.Trainer
    monkeypatch.setattr(build_mod, "build_model", lambda *a, **k: (
        seen.__setitem__("build", k["mesh"]) or build(*a, **k)))
    monkeypatch.setattr(train_mod, "Trainer", lambda *a, **k: (
        seen.__setitem__("trainer", k["mesh"]) or trainer(*a, **k)))
    out = tmp_path / "m.json"
    assert trun.main([
        "-dataset", "PEMS08", "-mode", "ori", "-model", "TGCN",
        "-num_nodes", "12", "-epochs", "1", "-batch_size", "16",
        "-num_steps", "200", "--rnn_units", "4", "-device", "cpu",
        "-use_mesh", use_mesh, "-graph_axis_size", str(graph_axis_size),
        "-log_dir", str(tmp_path), "-metrics_out", str(out)]) == 0
    assert np.isfinite(json.loads(out.read_text())["average"]).all()
    assert seen["build"] is seen["trainer"]
    if use_mesh == "False":
        assert seen["build"] is None
        return
    want = jmesh.make_mesh(4, graph_axis_size=graph_axis_size or None)
    assert seen["build"].shape == dict(want.shape)
