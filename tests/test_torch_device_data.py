"""The trainer's device-resident train split (`device_data`), on the CPU.

With `device_data` and K above 1 (`scan_steps` 0, the default, means
16) the port's `Trainer` holds the train split on its device and
gathers each batch there by index; otherwise every batch is gathered
on the host. STGCN at 16 nodes, batch 8, 67 windows (8 full batches
and a ragged tail of 3):

  * the resident path and the host path (`device_data=False`, and
    `scan_steps=1`) give bitwise-equal per-step losses, history, best
    loss, test report and parameters; on the resident path no numpy
    array reaches `_put` during a train epoch;
  * the same under a (2, 1) CPU mesh (`Trainer(mesh=...)`), where the
    resident path hands the data-parallel step `PlacedBatch`es;
  * a `torch.OutOfMemoryError` where the split is placed logs a warning
    with the split's bytes and gives the host path and its losses; any
    other error propagates;
  * against `gptst_tpu`'s own indexed path (`scan_steps=4`,
    `device_data=True`, as `tests/test_indexed_path.py` builds it:
    STGCN, no randomness in training) on the same weights carried
    through `convert.py`: 83 windows, batch 8, so 8 batches go through
    the K-step dispatch (two jitted scans of 4 there, the port's
    `StepGraph` here) and the leftovers (two full batches and a ragged
    tail of 3) one step at a time on both sides; per-epoch losses at
    rtol 1e-5, parameters at rtol 1e-4 and atol 1e-5, that file's
    tolerances.

The resident split over 'graph' (`parallel/mesh.place_split`), TGCN
(a sparse support, `dense_threshold` 0 and tile 64, where a row runs
whole; the halo exchange on a row's graph ranks) and GPT-ST pretrain
at small widths, 16 nodes, batch 8, 55 windows (6 full batches and a
ragged tail of 7, which no data axis of 2 divides), 2 epochs:

  * on (1, 2), (2, 2) and, at 15 nodes, a (2, 2) mesh whose graph axis
    does not divide N, each device's part equals the addressable shard
    of that device of `gptst_tpu`'s own `Trainer._put_split` on a JAX
    mesh of the same shape;
  * on (1, 2) and (2, 2) the resident path trains as the host path bit
    for bit (per-step losses, history, best loss, report, parameters),
    and no batch of x, nor a view of one, reaches `shard_batch` or
    `NodeShards.split`'s copying branch during its train epochs (the
    host path's do: the check sees them);
  * a `torch.OutOfMemoryError` at one device's part gives the host path
    on every device (across processes: `tests/test_torch_distributed.py`,
    case (h)).
"""

import contextlib
import functools
import logging
import types

import jax
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.models import build as jbuild
from gptst_tpu.parallel import mesh as jmesh
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.ops.graph_conv import make_support
from gptst_tpu_torch.parallel import mesh as tmesh
from gptst_tpu_torch.parallel import spmd
from gptst_tpu_torch.parallel.mesh import (
    NodeShards, PlacedBatch, ResidentSplit, make_mesh, place_split,
)
from gptst_tpu_torch.train.trainer import Trainer
from torch_parity import noisy, one_torch_thread

CFG = dict(mode="ori", model="STGCN", num_nodes=16, batch_size=8, epochs=2,
           lr_decay=True, lr_decay_step=(1,), early_stop=False, debug=False,
           log_step=1000)
NUM_STEPS = 150          # 67 train windows
HOST = {"device_data_false": dict(device_data=False),
        "scan_steps_1": dict(scan_steps=1)}

_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.lru_cache(maxsize=None)
def _state():
    """STGCN's weights for every run: the port's init with noise."""
    cfg = default_config("PEMS08", **CFG)
    net = tbuild.build_model(cfg, device="cpu").predictor.net
    return flax_to_state_dict(noisy(state_dict_to_flax(net.state_dict())))


def _trainer(cfg, mesh=None):
    ds = build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    model = tbuild.build_model(cfg, device="cpu", mesh=mesh)
    model.predictor.net.load_state_dict(_state())
    return Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                   device="cpu", mesh=mesh)


def _train(tr):
    """`tr.train()` with its per-step losses, the types `_put` got
    during the train epochs, and the calls of `shard_batch` and of
    `NodeShards.split`'s copying branch there that took a batch of x
    the step was handed, or a view of it (`x_copies`)."""
    losses, puts, in_train = [], [], [False]
    train_batch, put, train_epoch = tr._train_batch, tr._put, tr.train_epoch
    step, xs, x_copies = tr._step, set(), []

    def stepping(x, y):
        # this step's x, alive through it: no other tensor shares its
        # storage until it ends
        shards = x.rows if isinstance(x, PlacedBatch) else [x]
        xs.clear()
        xs.update(t.untyped_storage().data_ptr() for r in shards
                  for t in (r if isinstance(r, list) else [r]))
        return step(x, y)

    def watch(fn, name):
        def watched(*args, **kw):
            t = next(a for a in args if not isinstance(a, NodeShards))
            if (in_train[0] and isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() in xs):
                x_copies.append(name)
            return fn(*args, **kw)
        return watched

    def recording(xb, yb):
        out = train_batch(xb, yb)
        losses.append(out[0].item())
        return out

    def putting(a):
        if in_train[0]:
            puts.append(type(a))
        return put(a)

    def epoch(e):
        in_train[0] = True
        try:
            return train_epoch(e)
        finally:
            in_train[0] = False

    tr._train_batch, tr._put, tr.train_epoch = recording, putting, epoch
    tr._step = stepping
    with contextlib.ExitStack() as stack:
        for owner, name in ((spmd, "shard_batch"), (NodeShards, "split")):
            fn = getattr(owner, name)
            setattr(owner, name, watch(fn, name))
            stack.callback(setattr, owner, name, fn)
        res = tr.train()
    params = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    return dict(losses=losses, puts=puts, res=res, params=params,
                resident=tr.train_split is not None, x_copies=x_copies,
                split=tr.train_split)


@functools.lru_cache(maxsize=None)
def _run(host: str | None = None, mesh: bool = False):
    """The 2-epoch run of CFG: resident, or with the host case `host`;
    on one device or a (2, 1) CPU mesh."""
    cfg = default_config("PEMS08", **CFG, **HOST.get(host, {}))
    m = make_mesh(devices=["cpu"] * 2, graph_axis_size=1) if mesh else None
    return _train(_trainer(cfg, m))


def _assert_same(got, want, steps: int = 2 * 9):
    assert got["losses"] == want["losses"]
    assert len(got["losses"]) == steps
    for key in ("history", "best_loss", "report"):
        assert got["res"][key] == want["res"][key], key
    assert got["params"].keys() == want["params"].keys()
    for k, p in want["params"].items():
        assert torch.equal(got["params"][k], p), k


@pytest.mark.parametrize("mesh", [False, True], ids=["one-device", "2-1"])
@pytest.mark.parametrize("host", sorted(HOST))
def test_resident_split_trains_as_the_host_path(host, mesh):
    resident, hosted = _run(None, mesh), _run(host, mesh)
    assert resident["resident"] and not hosted["resident"]
    # each of the 18 steps puts its x and y
    assert len(resident["puts"]) == len(hosted["puts"]) == 2 * 2 * 9
    # under a mesh the resident batches come placed on the data rows
    assert set(resident["puts"]) == {PlacedBatch if mesh else torch.Tensor}
    assert set(hosted["puts"]) == {np.ndarray}
    _assert_same(resident, hosted)


def test_resident_split_lies_on_the_device_once():
    cfg = default_config("PEMS08", **CFG)
    tr = _trainer(cfg, make_mesh(devices=["cpu"] * 2, graph_axis_size=1))
    split = tr.train_split
    # the two data rows of one device share its one copy, whole
    assert isinstance(split, ResidentSplit) and len(split.tensors()) == 2
    assert split.x[0] == split.x[1] and split.y[0] == split.y[1]
    (x,), (y,) = split.x[0], split.y[0]
    assert x.device == y.device == tr.mesh.root == tr.device
    assert x.dtype == y.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), tr.dataset.x_train)
    np.testing.assert_array_equal(y.numpy(), tr.dataset.y_train)
    assert tr._put(x) is x                    # no copy on the device
    one = _trainer(cfg)                       # one device: (x, y) there
    assert isinstance(one.train_split, tuple)
    assert one._put(one.train_split[0]) is one.train_split[0]


def _failing_put(error):
    put = Trainer._put

    def failing(self, a):
        if a is self.dataset.y_train:         # x already placed
            raise error
        return put(self, a)

    return failing


def test_out_of_memory_at_placement_takes_the_host_path(monkeypatch,
                                                        caplog):
    cfg = default_config("PEMS08", **CFG)
    logger = logging.getLogger("trainer")
    logger.addHandler(caplog.handler)
    monkeypatch.setattr(Trainer, "_put", _failing_put(
        torch.OutOfMemoryError("out of memory")))
    try:
        tr = _trainer(cfg)
    finally:
        logger.removeHandler(caplog.handler)
    monkeypatch.undo()
    assert tr.train_split is None
    nbytes = tr.dataset.x_train.nbytes + tr.dataset.y_train.nbytes
    (rec,) = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert f"({nbytes} bytes)" in rec.getMessage()
    got = _train(tr)
    assert set(got["puts"]) == {np.ndarray}
    _assert_same(got, _run(None))


def test_other_errors_at_placement_propagate(monkeypatch):
    cfg = default_config("PEMS08", **CFG)
    monkeypatch.setattr(Trainer, "_put",
                        _failing_put(RuntimeError("not a memory error")))
    with pytest.raises(RuntimeError, match="not a memory error"):
        _trainer(cfg)


def test_resident_split_matches_the_jax_indexed_path():
    """Two epochs of `gptst_tpu`'s indexed K-step dispatch against the
    port's resident path from the same weights, both with float64
    parameters: in f32 the two packages' sums drift apart through Adam
    (the epoch loss 6.1e-5 apart after 8 steps here;
    `tests/test_torch_stgcn.py` holds the f32 trajectory). The split
    stays f32 on both sides; the port's `_put` casts each gathered
    batch, JAX promotes it in the step, whose loss stays f32 (its
    `pred.astype(jnp.float32)`): the epoch losses agree to ~1.5e-7,
    the parameters to ~1.5e-8 of each tensor's largest entry."""
    kw = dict(mode="ori", model="STGCN", num_nodes=16, batch_size=8,
              epochs=2, lr_decay=False, early_stop=False, log_step=1000,
              scan_steps=4, device_data=True)
    jcfg = jax_default_config("PEMS08", **kw)
    jds = jax_build_dataset(jcfg, num_steps=200, seed=0)
    # two chunks of 4 x 8, then 8, 8 and a ragged 3
    jds.x_train, jds.y_train = jds.x_train[:83], jds.y_train[:83]
    _, forward = jbuild.build_model(jcfg)
    cfg = default_config("PEMS08", **kw)
    model = tbuild.build_model(cfg, device="cpu")
    params = noisy(state_dict_to_flax(model.predictor.net.state_dict()))
    model.predictor.net.load_state_dict(flax_to_state_dict(params))
    model.double()
    model.predictor.graph = tuple(t.double() for t in model.predictor.graph)
    ds = build_dataset(cfg, num_steps=200, seed=0)
    ds.x_train, ds.y_train = ds.x_train[:83], ds.y_train[:83]
    np.testing.assert_array_equal(ds.x_train, jds.x_train)
    tr = Trainer(model=model, cfg=cfg, seed=0, device="cpu", dataset=ds)
    assert tr.train_split is not None
    assert tr.train_split[0].dtype == torch.float32
    put = tr._put
    tr._put = lambda a: put(a).double()
    with jax.enable_x64(True):
        jtr = JTrainer(forward=forward, cfg=jcfg, dataset=jds,
                       params=jax.tree.map(
                           lambda a: np.asarray(a, np.float64), params))
        assert jtr._indexed_step is not None
        for epoch in (1, 2):
            want = jtr.train_epoch(epoch, jax.random.PRNGKey(7))
            np.testing.assert_allclose(tr.train_epoch(epoch), want,
                                       rtol=1e-5)
        jparams = jax.tree.map(np.asarray, jtr.params)
    assert tr._runner is not None and tr.batch_seen == jtr.batch_seen == 22
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k: p.detach() for k, p in model.predictor.net.named_parameters()})))
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(leaves) == len(got)
    for path, w in leaves:
        assert w.dtype == np.float64
        np.testing.assert_allclose(np.asarray(got[path]), w, rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


# --- the resident split over 'graph' ----------------------------------------

GRAPH_FLAGS = dict(num_nodes=16, batch_size=8, epochs=2, lr_decay=False,
                   early_stop=False, debug=False, log_step=1000)
GRAPH_MODELS = {
    "TGCN": dict(mode="ori", model="TGCN",
                 predictor_overrides=(("rnn_units", "4"),)),
    "GPT-ST": dict(mode="pretrain", model="STGCN", hidden_dim=16,
                   embed_dim=8, embed_dim_spa=4, HS=4, HT=6, HT_Tem=4,
                   change_epoch=1),
}
GRAPH_STEPS = 130        # 55 train windows: 6 full batches, a tail of 7
GRAPH_MESHES = {"1-2": (1, 2), "2-2": (2, 2)}


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _graph_trainer(model: str, mesh: str, host: bool = False):
    d, g = GRAPH_MESHES[mesh]
    cfg = default_config("PEMS08", **GRAPH_FLAGS, **GRAPH_MODELS[model],
                         device_data=not host)
    m = make_mesh(devices=["cpu"] * (d * g), graph_axis_size=g)
    ds = build_dataset(cfg, num_steps=GRAPH_STEPS, seed=cfg.seed)
    # TGCN's support block-CSR (tile 64) where a row runs whole
    with _patched(tbuild, "make_support", functools.partial(
            make_support, dense_threshold=0, tile=64)):
        net = tbuild.build_model(cfg, device="cpu", mesh=m, seed=3,
                                 scaler_zeros=ds.scaler_zeros)
    return Trainer(model=net, cfg=cfg, dataset=ds, seed=cfg.seed,
                   device="cpu", mesh=m)


@functools.lru_cache(maxsize=None)
def _graph_run(model: str, mesh: str, host: bool = False):
    return _train(_graph_trainer(model, mesh, host))


@pytest.mark.parametrize("mesh,nodes", [("1-2", 16), ("2-2", 16),
                                        ("2-2", 15)],
                         ids=["1-2", "2-2", "2-2-whole"])
def test_resident_split_lies_as_the_jax_trainer_puts_it(mesh, nodes):
    d, g = GRAPH_MESHES[mesh]
    if nodes == 16:                   # the trainer's own placement
        split = _graph_run("TGCN", mesh)["split"]
        arrays = (split.x, split.y)
        ds = _graph_trainer("TGCN", mesh, host=True).dataset
    else:
        cfg = default_config("PEMS08", **GRAPH_FLAGS, **GRAPH_MODELS["TGCN"])
        ds = build_dataset(cfg, num_steps=GRAPH_STEPS, seed=cfg.seed)
        ds.x_train, ds.y_train = (a[:, :, :nodes]
                                  for a in (ds.x_train, ds.y_train))
        split = place_split((ds.x_train, ds.y_train), make_mesh(
            devices=["cpu"] * (d * g), graph_axis_size=g))
    assert isinstance(split, ResidentSplit)
    sharded = nodes % g == 0
    assert [sh.parts for sh in split.rows] == [g if sharded else 1] * d
    holder = types.SimpleNamespace(mesh=jmesh.make_mesh(d * g,
                                                        graph_axis_size=g))
    for placed, host in zip((split.x, split.y),
                            (ds.x_train, ds.y_train)):
        want = JTrainer._put_split(holder, host)
        assert len(want.addressable_shards) == d * g
        for shard in want.addressable_shards:
            r, k = np.argwhere(holder.mesh.devices == shard.device)[0]
            got = placed[r][k if sharded else 0]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shard.data))
    if sharded:       # half the nodes of every window on each rank
        assert split.rank_bytes() == [[(ds.x_train.nbytes
                                        + ds.y_train.nbytes) // g] * g] * d


@pytest.mark.parametrize("mesh", sorted(GRAPH_MESHES))
@pytest.mark.parametrize("model", sorted(GRAPH_MODELS))
def test_resident_sharded_split_trains_as_the_host_path(model, mesh):
    resident, hosted = _graph_run(model, mesh), _graph_run(model, mesh, True)
    assert resident["resident"] and not hosted["resident"]
    assert set(resident["puts"]) == {PlacedBatch}
    # no batch of x crosses between devices on the resident path; the
    # host path's root splits each one over the rows and the ranks
    assert resident["x_copies"] == []
    assert {"shard_batch", "split"} <= set(hosted["x_copies"])
    _assert_same(resident, hosted, steps=2 * 7)


def test_out_of_memory_on_one_device_takes_the_host_path(caplog):
    """The part of rank 1 (row 0) runs out of memory; every device takes
    the host path, and the run is the host path's."""
    calls = []
    put = tmesh.put_array

    def failing(a, device):
        calls.append(a.shape)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("out of memory")
        return put(a, device)

    logger = logging.getLogger("trainer")
    logger.addHandler(caplog.handler)
    try:
        with _patched(tmesh, "put_array", failing):
            tr = _graph_trainer("TGCN", "2-2")
    finally:
        logger.removeHandler(caplog.handler)
    assert calls[1][2] == 8 and tr.train_split is None and not tr._orders
    (rec,) = [r for r in caplog.records if r.levelno == logging.WARNING]
    nbytes = tr.dataset.x_train.nbytes + tr.dataset.y_train.nbytes
    assert f"({nbytes} bytes)" in rec.getMessage()
    _assert_same(_train(tr), _graph_run("TGCN", "2-2", True), steps=2 * 7)
