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
  * the same under a (2, 1) CPU mesh (`Trainer(mesh=...)`);
  * a `torch.OutOfMemoryError` where the split is placed logs a warning
    with the split's bytes and gives the host path and its losses; any
    other error propagates;
  * against `gptst_tpu`'s own indexed path (`scan_steps=4`,
    `device_data=True`, as `tests/test_indexed_path.py` builds it:
    STGCN, no randomness in training) on the same weights carried
    through `convert.py`: 64 windows, batch 8, so every batch goes
    through the one jitted K-step dispatch; per-epoch losses at rtol
    1e-5, parameters at rtol 1e-4 and atol 1e-5, that file's
    tolerances.
"""

import functools
import logging

import jax
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.models import build as jbuild
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.parallel.mesh import make_mesh
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
    """`tr.train()` with its per-step losses and the types `_put` got
    during the train epochs."""
    losses, puts, in_train = [], [], [False]
    train_batch, put, train_epoch = tr._train_batch, tr._put, tr.train_epoch

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
    res = tr.train()
    params = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    return dict(losses=losses, puts=puts, res=res, params=params,
                resident=tr.train_split is not None)


@functools.lru_cache(maxsize=None)
def _run(host: str | None = None, mesh: bool = False):
    """The 2-epoch run of CFG: resident, or with the host case `host`;
    on one device or a (2, 1) CPU mesh."""
    cfg = default_config("PEMS08", **CFG, **HOST.get(host, {}))
    m = make_mesh(devices=["cpu"] * 2, graph_axis_size=1) if mesh else None
    return _train(_trainer(cfg, m))


def _assert_same(got, want):
    assert got["losses"] == want["losses"]
    assert len(got["losses"]) == 2 * 9
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
    assert set(resident["puts"]) == {torch.Tensor}
    assert set(hosted["puts"]) == {np.ndarray}
    _assert_same(resident, hosted)


def test_resident_split_lies_on_the_device_once():
    cfg = default_config("PEMS08", **CFG)
    tr = _trainer(cfg, make_mesh(devices=["cpu"] * 2, graph_axis_size=1))
    x, y = tr.train_split
    assert x.device == y.device == tr.mesh.root == tr.device
    assert x.dtype == y.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), tr.dataset.x_train)
    np.testing.assert_array_equal(y.numpy(), tr.dataset.y_train)
    batch = next(iter(tr._train_batches(7)))
    assert tr._put(batch[0]) is batch[0]      # no copy on the device


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
    jds = jax_build_dataset(jcfg, num_steps=145, seed=0)
    assert jds.x_train.shape[0] == 64       # whole chunks of 4 x 8
    _, forward = jbuild.build_model(jcfg)
    cfg = default_config("PEMS08", **kw)
    model = tbuild.build_model(cfg, device="cpu")
    params = noisy(state_dict_to_flax(model.predictor.net.state_dict()))
    model.predictor.net.load_state_dict(flax_to_state_dict(params))
    model.double()
    model.predictor.graph = tuple(t.double() for t in model.predictor.graph)
    tr = Trainer(model=model, cfg=cfg, seed=0, device="cpu",
                 dataset=build_dataset(cfg, num_steps=145, seed=0))
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
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k: p.detach() for k, p in model.predictor.net.named_parameters()})))
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(leaves) == len(got)
    for path, w in leaves:
        assert w.dtype == np.float64
        np.testing.assert_allclose(np.asarray(got[path]), w, rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))
