"""GPT-ST over the mesh's 'graph' axis: node-sharded pretraining and the
frozen encoder, on `["cpu"] * P` ranks, against `gptst_tpu.parallel`'s
GSPMD step on the conftest's host devices and against the port's own
one-device step.

  * one pretrain step under (1, 2) and (2, 2) against JAX's
    `run_one_step` on `make_mesh(2 d, graph_axis_size=2)`: losses rtol
    1e-4, gradients rtol 1e-4 with an atol of 1e-5 of each tensor's
    largest entry, the parameters after the Adam step as
    `tests/test_torch_spmd.py::test_run_one_step_matches_jax` holds
    them (mask_ratio 1.0: JAX's and torch's draws differ);
  * both mask branches under (1, 2) and (2, 2) against the port's
    one-device step (the mask equal, the losses rtol 1e-5, the
    gradients as above), and the node width of every trunk layer's
    input on each rank;
  * N = 15 under (1, 2) runs whole (the graph axis does not divide it)
    and matches, with the WARNING; no WARNING for a sharded GPT-ST, one
    for the predictors that keep node tables whole;
  * the CLI's pretrain -> eval -> test across a (1, 2) mesh of CPU
    ranks and one device, checkpoints loading both ways;
  * `dryrun.dryrun_multichip(4, devices=["cpu"] * 4)`.

The `-mode eval -model TGCN` trainer under (1, 2) against the JAX
trainer is a case of `test_trainer_under_a_mesh_matches_jax_and_one_device`
in `tests/test_torch_spmd.py`.
"""

import copy
import json
import logging

import jax
import numpy as np
import pytest
import torch

from gptst_tpu.parallel import mesh as jmesh
from gptst_tpu.parallel import spmd as jspmd
from gptst_tpu_torch import dryrun
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models import gptst as tg
from gptst_tpu_torch.ops.param_pool import node_param_linear
from gptst_tpu_torch.parallel import mesh as tmesh
from gptst_tpu_torch.parallel.spmd import run_one_step
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms, model_forwards
from test_torch_spmd import tiny_pretrain
from torch_parity import gptst_by_path, one_torch_thread

_ = (one_torch_thread, tiny_pretrain)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

GPTST_SMALL = dict(hidden_dim=16, embed_dim=8, embed_dim_spa=4, HS=4, HT=6,
                   HT_Tem=4, change_epoch=1, epochs=4)


def _mesh(d, g):
    return tmesh.make_mesh(devices=["cpu"] * (d * g), graph_axis_size=g)


def _close_grads(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


# --- one step against the JAX package ---------------------------------------

@pytest.fixture(scope="module")
def jax_grads(tiny_pretrain):
    """`jax.grad` of JAX's pretrain loss at epoch 1 on the fixture's
    weights and x, by flax path."""
    return tiny_pretrain[-1]


@pytest.mark.parametrize("d", [1, 2])
def test_run_one_step_matches_jax_on_the_graph_axis(tiny_pretrain, jax_grads,
                                                    d, monkeypatch):
    """(d, 2) on both sides: the losses rtol 1e-4, the gradients against
    `jax.grad`, and every parameter after the Adam step against Adam's
    first step on `jax.grad` (atol 1e-5 where that gradient is 0 or at
    least 1e-6, else within lr: the step is lr * g / (|g| + 1e-8), which
    amplifies gradients that are f32 noise) and against JAX's step under
    the mesh (atol 1e-5 on the same entries, where JAX's step is that
    Adam step: under (2, 2) GSPMD's own gradient sums flip 279 of the
    ~1e6 entries, 8 of them with |g| >= 1e-6, by up to 2 lr)."""
    jcfg, forward, params, cfg, model, x, _ = tiny_pretrain
    stepped = []
    monkeypatch.setattr(jspmd.jax, "block_until_ready",
                        lambda t: stepped.append(t) or t)
    jm = jmesh.make_mesh(2 * d, graph_axis_size=2)
    assert dict(jm.shape) == {"data": d, "graph": 2}
    jtotal, jflow = jspmd.run_one_step(jcfg, jm, forward, params, x, x)
    mesh = _mesh(d, 2)
    model = copy.deepcopy(model)
    model.gptst.mesh = mesh
    total, flow = run_one_step(cfg, mesh, model, x, x)
    np.testing.assert_allclose([total, flow], [jtotal, jflow], rtol=1e-4)
    grads = gptst_by_path(
        {k: p.grad for k, p in model.gptst.named_parameters()}, model)
    _close_grads(grads, jax_grads)
    got = gptst_by_path(model.gptst.state_dict(), model)
    before = dict(jax.tree_util.tree_leaves_with_path(params))
    lr, off, entries = cfg.lr_init, 0, 0
    for path, want in jax.tree_util.tree_leaves_with_path(stepped[0]):
        want, name = np.asarray(want), jax.tree_util.keystr(path)
        jg = np.asarray(jax_grads[path])
        adam = np.asarray(before[path]) - lr * jg / (np.abs(jg) + 1e-8)
        sure = (np.abs(jg) >= 1e-6) | (jg == 0)
        np.testing.assert_allclose(got[path][sure], adam[sure], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got[path], adam, atol=lr, err_msg=name)
        own = np.abs(want - adam) <= 1e-5
        np.testing.assert_allclose(got[path][sure & own],
                                   want[sure & own], atol=1e-5, err_msg=name)
        off += int((~own).sum())
        entries += own.size
    assert off <= 1e-3 * entries, off


# --- against the port's one-device step -------------------------------------

def _pair(n: int, mesh, **kw):
    """The same GPT-ST (seed 0, small widths) one-device and under
    `mesh`, with its config."""
    cfg = default_config("PEMS08", mode="pretrain", num_nodes=n,
                         batch_size=8, **{**GPTST_SMALL, **kw})
    return cfg, [tbuild.build_model(cfg, device="cpu", seed=0,
                                    scaler_zeros=-0.5, mesh=m)
                 for m in (None, mesh)]


def _widths(model) -> list:
    """A forward pre-hook on every `HyperTem` and `Cap`: the node width
    of the input each call gets, per rank."""
    seen = []

    def hook(mod, args):
        x = args[0]
        seen.append((type(mod).__name__,
                     tuple(t.shape[2] for t in x) if isinstance(x, list)
                     else (x.shape[2],)))

    for m in model.modules():
        if isinstance(m, (tg.HyperTem, tg.Cap)):
            m.register_forward_pre_hook(hook)
    return seen


def _step(model, cfg, x, epoch, mesh=None):
    """Loss, flow, mask and every gradient of one pretrain loss on
    `model` with a generator seeded 11."""
    loss = build_loss(cfg.loss_func, 0.0, 1.0, cfg.mape_thresh, True)
    fwd = None if mesh is None else model_forwards(model, cfg, mesh)[1]
    masks = []
    inner = fwd or model

    def forward(x_, **kw):
        out = inner(x_, **kw)
        masks.append(out.mask)
        return out

    terms = make_loss_terms(model, loss, cfg, forward=forward)
    total, flow = terms(x, x, 3, generator=torch.Generator().manual_seed(11),
                        epoch=epoch)
    total.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             for k, p in model.named_parameters()}
    return total.item(), flow.item(), masks[0], grads


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("epoch", [1, 3], ids=["random", "adaptive"])
def test_mask_branches_match_one_device(d, epoch):
    """Both branches of the curriculum (epoch <= change_epoch 1, and 3):
    the mask under (d, 2) is the one-device mask, element for element,
    and the step is the one-device step; inside the trunks every HyperTem
    and Cap input holds N/2 nodes on each rank."""
    n = 16
    mesh = _mesh(d, 2)
    cfg, (one, sharded) = _pair(n, mesh)
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (8, 12, n, 3)).astype(np.float32))
    seen = _widths(sharded)
    t1, f1, m1, g1 = _step(one, cfg, x, epoch)
    t2, f2, m2, g2 = _step(sharded, cfg, x, epoch, mesh)
    assert torch.equal(m1, m2)
    assert 0 < float(m1.mean()) < 1
    np.testing.assert_allclose([t2, f2], [t1, f1], rtol=1e-5)
    assert (t1 > f1) == (epoch > cfg.change_epoch)
    _close_grads({k: v.numpy() for k, v in g2.items()},
                 {k: v.numpy() for k, v in g1.items()})
    # per data row: two trunks of 4 HyperTem calls on each rank and 2
    # Cap calls over both ranks
    assert sorted({w for _, w in seen}) == [(n // 2,), (n // 2, n // 2)]
    assert sum(name == "Cap" for name, _ in seen) == 4 * d
    assert sum(name == "HyperTem" for name, _ in seen) == 8 * 2 * d


def test_encode_is_node_sharded_and_matches():
    """The frozen encoder's embedding under (1, 2): each trunk layer
    sees N/2 nodes per rank, the output is whole on the row's device and
    equals the one-device embedding (rtol 1e-5, atol 1e-6)."""
    n = 16
    cfg, (one, sharded) = _pair(n, _mesh(1, 2))
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (4, 12, n, 3)).astype(np.float32))
    seen = _widths(sharded)
    with torch.no_grad():
        want = one.gptst.encode(x)
        got = sharded.gptst.encode(x)
    assert got.shape == want.shape == (4, 12, n, cfg.hidden_dim)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert {w for _, w in seen} == {(n // 2,), (n // 2, n // 2)}


def test_node_param_linear_takes_a_table_slice():
    """A rank's rows of the node table give that rank's rows of the
    whole product."""
    rng = np.random.default_rng(3)
    x, emb = (torch.tensor(rng.standard_normal(s).astype(np.float32))
              for s in ((2, 3, 10, 5), (10, 4)))
    w, b = (torch.tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((4, 5, 6), (4, 6)))
    whole = node_param_linear(x, emb, w, b)
    shards = tmesh.NodeShards((torch.device("cpu"),) * 2, 10)
    for g, (xg, eg) in enumerate(zip(shards.split(x),
                                     shards.split(emb, dim=0))):
        lo, hi = shards.node_range(g)
        torch.testing.assert_close(node_param_linear(xg, eg, w, b),
                                   whole[:, :, lo:hi])


@pytest.fixture
def build_warnings():
    """The messages `models/build.py` logs."""
    seen = []

    class Seen(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = Seen()
    logging.getLogger("build").addHandler(handler)
    yield seen
    logging.getLogger("build").removeHandler(handler)


def test_an_undivided_node_axis_runs_whole(build_warnings):
    """N = 15 under (1, 2): GPT-ST runs whole on the row's first device,
    says so once, and its step is the one-device step."""
    n = 15
    mesh = _mesh(1, 2)
    cfg, (one, sharded) = _pair(n, mesh)
    assert len(build_warnings) == 1 and "GPT-ST" in build_warnings[0]
    seen = _widths(sharded)
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (8, 12, n, 3)).astype(np.float32))
    t1, f1, m1, g1 = _step(one, cfg, x, 3)
    t2, f2, m2, g2 = _step(sharded, cfg, x, 3, mesh)
    assert torch.equal(m1, m2)
    np.testing.assert_allclose([t2, f2], [t1, f1], rtol=1e-6)
    _close_grads({k: v.numpy() for k, v in g2.items()},
                 {k: v.numpy() for k, v in g1.items()})
    assert {w for _, w in seen} == {(n,)}


@pytest.mark.parametrize("mode, model, warns", [
    ("pretrain", "STGCN", False), ("eval", "TGCN", False),
    ("eval", "GWN", False), ("ori", "MTGNN", False), ("ori", "STGCN", False),
    ("eval", "CCRNN", False), ("ori", "ASTGCN", False),
    ("eval", "ST_WA", False), ("ori", "STSGCN", False),
    ("eval", "STMGCN", False), ("ori", "TGCN", False)])
def test_whole_node_table_warnings(mode, model, warns, build_warnings):
    """Under (1, 2) at 14 nodes (no width of the models) a GPT-ST
    (pretrain, eval's encoder) logs nothing, nor does any predictor:
    each runs node-sharded where the graph axis divides the node count
    (the warning where it does not is held at 15 nodes by
    `tests/test_torch_final_predictors_graph.py` and the other graph
    files)."""
    kw = dict(GPTST_SMALL) if mode != "ori" else {}
    cfg = default_config("PEMS08", mode=mode, model=model, num_nodes=14,
                         predictor_overrides=(("nhid", "4"),)
                         if model == "GWN" else (), **kw)
    encoder = None
    if mode == "eval":
        encoder = tbuild.build_pretrain(cfg.replace(mode="pretrain"), 0.0,
                                        "cpu").gptst
    built = tbuild.build_model(cfg, device="cpu", mesh=_mesh(1, 2),
                               pretrain_params=encoder)
    assert len(build_warnings) == int(warns), build_warnings
    if mode != "pretrain":
        assert built.predictor.mesh is not None
    if mode == "eval":
        assert built.encoder.mesh is not None


def test_build_enhanced_leaves_a_passed_gptst_as_it_was():
    """`build_enhanced(mesh=...)` on a GPT-ST passed in: the eval model's
    encoder is node-sharded over the mesh and shares the passed
    module's parameters; the passed module's own `mesh` is unchanged,
    both ways (None stays None, a mesh stays that mesh)."""
    cfg = default_config("PEMS08", mode="eval", model="TGCN", num_nodes=14,
                         **GPTST_SMALL)
    pre = tbuild.build_pretrain(cfg.replace(mode="pretrain"), 0.0, "cpu")
    mesh = _mesh(1, 2)
    for passed, given in ((None, mesh), (mesh, None)):
        pre.gptst.mesh = passed
        built = tbuild.build_enhanced(cfg, 0.0, pre, device="cpu",
                                      mesh=given)
        assert pre.gptst.mesh is passed and built.encoder.mesh is given
        assert built.encoder is not pre.gptst
        for (k, p), (_, q) in zip(built.encoder.named_parameters(),
                                  pre.gptst.named_parameters()):
            assert p is q, k


def test_cli_cycle_across_the_graph_axis(tmp_path, monkeypatch):
    """`run.main` with two CPU ranks visible (`run.mesh_devices`
    patched, as `test_torch_spmd.py` shows the CLI four) and
    `-graph_axis_size 2`: pretrain builds and logs a (1, 2) mesh and
    runs GPT-ST node-sharded; its checkpoint loads into a one-device
    eval run (`-use_mesh False`), whose `best_model.pt` loads into a
    test run under the mesh (the encoder node-sharded, TGCN through a
    2-rank halo) with the eval run's report (rtol 1e-5)."""
    from gptst_tpu_torch import run

    monkeypatch.setattr(run, "mesh_devices", lambda device: [device] * 2)
    built = []
    build = tbuild.build_model
    monkeypatch.setattr(tbuild, "build_model", lambda *a, **k: (
        built.append(k["mesh"]) or build(*a, **k)))

    def flags(mode, *extra):
        return ["-dataset", "PEMS08", "-mode", mode, "-model", "TGCN",
                "-num_nodes", "12", "-batch_size", "8", "-epochs", "2",
                "-num_steps", "220", "-log_dir", str(tmp_path),
                "-lr_decay", "False", "-early_stop", "False",
                "-hidden_dim", "16", "-embed_dim", "8", "-embed_dim_spa",
                "4", "-HS", "4", "-HT", "6", "-HT_Tem", "4",
                "-change_epoch", "1", "-log_step", "10000", "-device",
                "cpu", *extra]

    mesh_flags = ("-use_mesh", "True", "-graph_axis_size", "2")
    ev, te = tmp_path / "eval.json", tmp_path / "test.json"
    assert run.main(flags("pretrain", *mesh_flags)) == 0
    assert run.main(flags("eval", "-metrics_out", str(ev), "-use_mesh",
                          "False")) == 0
    assert run.main(flags("test", "-metrics_out", str(te),
                          *mesh_flags)) == 0
    assert [m if m is None else m.shape for m in built] == [
        {"data": 1, "graph": 2}, None, {"data": 1, "graph": 2}]
    ev, te = json.loads(ev.read_text()), json.loads(te.read_text())
    np.testing.assert_allclose(te["per_horizon"], ev["per_horizon"],
                               rtol=1e-5)
    np.testing.assert_allclose(te["average"], ev["average"], rtol=1e-5)


# --- the entry points --------------------------------------------------------

def test_entry_and_dryrun_multichip_on_cpu_ranks():
    """`entry()` on the CPU, and `dryrun_multichip(4)` on four CPU ranks:
    a (2, 2) mesh at 170 nodes and batch 64, both mask branches, the
    rings against `adj @ x` (rtol 1e-4, atol 1e-4, as JAX's dry run)."""
    fn, args = dryrun.entry("cpu")
    assert fn(*args).shape == (8, 12, 16, 1)
    out = dryrun.dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["mesh"] == {"data": 2, "graph": 2}
    assert out["graph_mesh"] == {"data": 1, "graph": 4}
    assert out["num_nodes"] == 170
    (t1, f1), (t2, f2) = out["gptst_losses"]
    assert t2 > f2 and np.isfinite([t1, f1, t2, f2, out["tgcn_loss"]]).all()
    for k in ("ring", "fused_ring"):
        np.testing.assert_allclose(out[k], out["adj_x"], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
