"""K train steps per dispatch (`train/step.StepGraph` and the trainer's
chunks), on the CPU, where the runner takes the captured step's body
eagerly through the same buffers and step state as on the card.

  * The runner against the one-step path, bit for bit: the same
    trainer once as it runs (chunks of full batches through the
    runner) and once with every chunk taken one step at a time
    (`Trainer._one_steps`, the `_train_batch` path), both on the staged
    `ClippedAdam` and the same staged step inputs; 43 windows in
    batches of 4 with K = 4 (two full chunks, then three leftover
    batches with a ragged tail), or 40 (the two leftover batches a
    chunk of their own, through the runner), on the resident split and
    on the host path. Per-step losses, every parameter and the
    optimizer's `mu`, `nu` and `count` are equal. TGCN on a sparse
    support (`make_support(dense_threshold=0, tile=16)`), CCRNN (its
    teacher-forcing coins read the staged thresholds of the JAX
    trainer's step counts) and GPT-ST pretrain over 2 epochs across
    `change_epoch` 1 (epoch 2 adds the KL term; the adaptive mask,
    `ada_type` all and half).
  * The staged `ClippedAdam` against optax's `clip_by_global_norm` and
    `adam` on a piecewise-constant schedule, in float64: 8 steps across
    an LR milestone, clipped and unclipped, staged in two epochs and
    then past its rows; parameters and moments at rtol 1e-12.
  * `models/gptst.rank_counts` (the mask's per-rank counts) equals
    `torch.bincount`; CCRNN's staged step inputs are the thresholds of
    the counts and draw the same coins.
  * A full checkpoint written with `scan_steps` 4 restores into a
    trainer with `scan_steps` 1, and back.
  * Under a (1, 1) mesh (one data row on one device, the mesh each
    process holds with one process per card) the chunks go through the
    runner, bit for bit as without a mesh; under a mesh with threaded
    data rows or graph ranks the trainer steps one at a time, which it
    decides at construction and logs once with the reason.

Against `gptst_tpu`'s own K-step dispatch:
`tests/test_torch_device_data.py::test_resident_split_matches_the_jax_indexed_path`.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.gptst import rank_counts
from gptst_tpu_torch.ops.graph_conv import make_support
from gptst_tpu_torch.parallel.mesh import make_mesh
from gptst_tpu_torch.train.trainer import (
    ClippedAdam, Trainer, make_lr_schedule,
)
from torch_parity import one_torch_thread

_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRAIN = dict(batch_size=4, scan_steps=4, lr_decay=True, lr_decay_step=(1,),
             early_stop=False, debug=False, log_step=1000, num_nodes=12)
GPTST = dict(hidden_dim=16, embed_dim=8, embed_dim_spa=4, HS=4, HT=6,
             HT_Tem=4, change_epoch=1)
MODELS = {
    "TGCN": ("PEMS08", dict(mode="ori", model="TGCN", num_nodes=16,
                            predictor_overrides=(("rnn_units", "4"),)), 2),
    "CCRNN": ("NYC_BIKE", dict(mode="ori", model="CCRNN",
                               predictor_overrides=(("hidden_size", "4"),
                                                    ("n_dim", "8"))), 2),
    "pretrain-all": ("PEMS08", dict(mode="pretrain", ada_type="all",
                                    **GPTST), 2),
    "pretrain-half": ("PEMS08", dict(mode="pretrain", ada_type="half",
                                     **GPTST), 2),
}


@functools.lru_cache(maxsize=None)
def _data(name: str, windows: int):
    dataset, kw, epochs = MODELS[name]
    cfg = default_config(dataset, **{**TRAIN, **kw, "epochs": epochs})
    ds = build_dataset(cfg, num_steps=200, seed=0)
    assert ds.x_train.shape[0] >= windows
    return cfg, ds.x_train[:windows], ds.y_train[:windows]


def _trained(name: str, windows: int, resident: bool, one_steps: bool,
             monkeypatch, mesh=None):
    """The per-step losses, parameters and optimizer of `epochs` train
    epochs (under `mesh`, where given); with `one_steps` every chunk
    goes one step at a time."""
    if name == "TGCN":
        monkeypatch.setattr(tbuild, "make_support", functools.partial(
            make_support, dense_threshold=0, tile=16))
    cfg, x, y = _data(name, windows)
    cfg = cfg.replace(device_data=resident)
    ds = build_dataset(cfg, num_steps=200, seed=0)
    ds.x_train, ds.y_train = x, y
    tr = Trainer(model=tbuild.build_model(cfg, device="cpu", seed=0,
                                          mesh=mesh),
                 cfg=cfg, dataset=ds, seed=0, device="cpu", mesh=mesh)
    assert (tr.train_split is not None) == resident
    if one_steps:
        tr._train_steps = lambda batches, order, epoch: tr._one_steps(
            batches, order)
    losses = []
    for epoch in range(1, cfg.epochs + 1):
        tr.train_epoch(epoch)
        losses.append(tr._losses.clone())
    assert (tr._runner is None) == one_steps
    opt = tr.optimizer
    return dict(losses=torch.stack(losses), count=opt.count,
                params=dict(tr.model.named_parameters()),
                moments={k: opt.state[p] for k, p
                         in tr.model.named_parameters() if p in opt.state})


_ONE_STEPS: dict = {}
_RUNNER: dict = {}


def _assert_equal_runs(got: dict, want: dict) -> None:
    assert torch.equal(got["losses"], want["losses"])
    assert got["count"] == want["count"]
    assert got["params"].keys() == want["params"].keys()
    for k, p in want["params"].items():
        assert torch.equal(got["params"][k], p), k
    assert got["moments"].keys() == want["moments"].keys()
    for k, st in want["moments"].items():
        for m in ("mu", "nu"):
            assert torch.equal(got["moments"][k][m], st[m]), (k, m)


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "host"])
@pytest.mark.parametrize("name,windows", [
    ("TGCN", 43), ("TGCN", 40), ("CCRNN", 43), ("pretrain-all", 43),
    ("pretrain-half", 43)])
def test_runner_takes_the_one_step_path_bit_for_bit(name, windows, resident,
                                                    monkeypatch):
    """The one-step run is made once for both paths: at 43 and 40
    windows the resident and the host path cut the same chunks, so
    they give the same step counts, and a batch gathered on either
    holds the same values (`tests/test_torch_device_data.py`)."""
    got = _RUNNER[name, windows, resident] = _trained(
        name, windows, resident, False, monkeypatch)
    if (name, windows) not in _ONE_STEPS:
        _ONE_STEPS[name, windows] = _trained(name, windows, resident, True,
                                             monkeypatch)
    want = _ONE_STEPS[name, windows]
    steps = -(-windows // 4)
    assert got["losses"].shape == (MODELS[name][2], steps, 2)
    assert torch.isfinite(got["losses"]).all()
    assert got["count"] == MODELS[name][2] * steps
    _assert_equal_runs(got, want)


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "host"])
def test_a_one_device_mesh_takes_the_runner_bit_for_bit(resident,
                                                        monkeypatch):
    """A (1, 1) CPU mesh: the chunks go through the runner, and the run
    equals the trainer's without a mesh, bit for bit."""
    mesh = make_mesh(devices=["cpu"], graph_axis_size=1)
    got = _trained("TGCN", 43, resident, False, monkeypatch, mesh=mesh)
    if ("TGCN", 43, resident) not in _RUNNER:
        _RUNNER["TGCN", 43, resident] = _trained("TGCN", 43, resident, False,
                                                 monkeypatch)
    _assert_equal_runs(got, _RUNNER["TGCN", 43, resident])


@pytest.mark.parametrize("d,g,why", [
    (2, 1, "2 data rows are host threads here"),
    (1, 2, "2 graph ranks are devices here")], ids=["2-1", "1-2"])
def test_threaded_rows_and_graph_ranks_step_one_at_a_time(d, g, why,
                                                          caplog):
    """Under a mesh whose data rows are threads or whose graph ranks
    are devices of this process, the trainer decides at construction
    to step one at a time, logs why once, and takes no chunk through
    the runner."""
    cfg, x, y = _data("TGCN", 40)
    ds = build_dataset(cfg, num_steps=200, seed=0)
    ds.x_train, ds.y_train = x, y
    mesh = make_mesh(devices=["cpu"] * (d * g), graph_axis_size=g)
    logger = logging.getLogger("trainer")
    logger.addHandler(caplog.handler)
    try:
        tr = Trainer(model=tbuild.build_model(cfg, device="cpu", seed=0,
                                              mesh=mesh),
                     cfg=cfg, dataset=ds, seed=0, device="cpu", mesh=mesh)
        assert np.isfinite(tr.train_epoch(1))
    finally:
        logger.removeHandler(caplog.handler)
    assert not tr.chunked and not tr.captured and tr._runner is None
    said = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("K steps per dispatch")]
    assert said == [f"K steps per dispatch: one step at a time under this "
                    f"mesh ({why})"]


def test_staged_clipped_adam_matches_optax_in_float64():
    """lr 2^-7 halved at step 3 (values f32 and float64 share), max norm
    1; gradient scales 0.1 and 3 alternate, so some steps clip."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,)]
    init = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) * (0.1 if i % 2 else 3.0)
              for s in shapes] for i in range(8)]
    cfg = default_config("PEMS08", lr_init=2.0 ** -7, lr_decay=True,
                         lr_decay_step=(1,), lr_decay_rate=0.5)
    params = [torch.tensor(a, requires_grad=True) for a in init]
    opt = ClippedAdam(params, make_lr_schedule(cfg, steps_per_epoch=3),
                      max_norm=1.0)
    for i, g in enumerate(grads):
        if i in (0, 3):
            opt.stage(3)           # two epochs of 3, then past the rows
        for p, gi in zip(params, g):
            p.grad = torch.tensor(gi)
        opt.step()
    assert opt.count == 8 and opt.slot.item() == 2
    with jax.enable_x64(True):
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
            optax.piecewise_constant_schedule(2.0 ** -7, {3: 0.5}),
            eps=1e-8))

        @jax.jit
        def update(g, state, jp):
            upd, state = tx.update(g, state, jp)
            return optax.apply_updates(jp, upd), state

        jp = [jnp.asarray(a) for a in init]
        state = tx.init(jp)
        for g in grads:
            jp, state = update([jnp.asarray(a) for a in g], state, jp)
        adam = state[1][0]
        assert int(adam.count) == 8
        for i, p in enumerate(params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]),
                                       rtol=1e-12, atol=0)
            for m in ("mu", "nu"):
                np.testing.assert_allclose(
                    opt.state[p][m].numpy(),
                    np.asarray(getattr(adam, m)[i]), rtol=1e-12, atol=0)


def test_rank_counts_equal_bincount():
    gen = torch.Generator().manual_seed(0)
    ranks = torch.randint(0, 7, (500,), generator=gen)
    ranks[ranks == 3] = 4                 # a rank with no element
    assert torch.equal(rank_counts(ranks, 10),
                       torch.bincount(ranks, minlength=10))


def test_staged_thresholds_draw_the_coins_of_the_counts():
    """CCRNN's staged step inputs are its teacher-forcing thresholds of
    the counts, and a staged threshold draws the coins the count does."""
    from types import SimpleNamespace

    from gptst_tpu_torch.models.predictors import ccrnn

    counts = [0, 5, 299, 300, 1711, 10 ** 6]
    net = SimpleNamespace(cfg=ccrnn.CCRNNConfig(num_nodes=4))
    staged = ccrnn.CCRNN.step_inputs(net, counts)
    assert staged.dtype == torch.float32 and staged.shape == (6,)
    for c, thr in zip(counts, staged):
        assert torch.equal(thr, ccrnn.teacher_forcing_threshold(c, 300))
        coins = [ccrnn.teacher_forcing_coins(
            12, s, 300, torch.Generator().manual_seed(c)) for s in (c, thr)]
        assert torch.equal(*coins)


def test_bf16_step_hands_ccrnn_its_f32_thresholds(monkeypatch):
    """With `compute_dtype` bfloat16 the train forward casts the
    parameters, x and y, not the staged step input (as `gptst_tpu`'s
    step casts params, x and y only): every step of an epoch, through
    the runner and one step at a time, hands CCRNN's coins the f32
    threshold of its JAX step count."""
    from gptst_tpu_torch.models.predictors import ccrnn
    from gptst_tpu_torch.train.trainer import jax_step_counts

    seen = []
    coins = ccrnn.teacher_forcing_coins

    def spy(horizon, step, cl_decay_steps, generator):
        seen.append(step)
        return coins(horizon, step, cl_decay_steps, generator)

    monkeypatch.setattr(ccrnn, "teacher_forcing_coins", spy)
    cfg, x, y = _data("CCRNN", 43)
    cfg = cfg.replace(compute_dtype="bfloat16")
    ds = build_dataset(cfg, num_steps=200, seed=0)
    ds.x_train, ds.y_train = x, y
    tr = Trainer(model=tbuild.build_model(cfg, device="cpu", seed=0),
                 cfg=cfg, dataset=ds, seed=0, device="cpu")
    tr.batch_seen = 1900      # thresholds that round apart in bf16
    assert np.isfinite(tr.train_epoch(1))
    counts = jax_step_counts(43, 4, 4, True, 1900)
    want = torch.stack([ccrnn.teacher_forcing_threshold(c, 300)
                        for c in counts])
    assert not torch.equal(want.bfloat16().float(), want)
    assert [s.dtype for s in seen] == [torch.float32] * len(counts)
    assert torch.equal(torch.stack(seen), want)


@pytest.mark.parametrize("src,dst", [(4, 1), (1, 4)],
                         ids=["K4-to-1", "1-to-K4"])
def test_checkpoints_load_across_the_paths(src, dst, tmp_path):
    """A full checkpoint written by one path (`scan_steps` 4, chunks
    through the runner, or 1) restores into a trainer of the other:
    parameters, moments and the step count, and it trains on."""
    cfg, x, y = _data("TGCN", 40)

    def trainer(k):
        c = cfg.replace(scan_steps=k)
        ds = build_dataset(c, num_steps=200, seed=0)
        ds.x_train, ds.y_train = x, y
        return Trainer(model=tbuild.build_model(c, device="cpu", seed=0),
                       cfg=c, dataset=ds, seed=0, device="cpu")

    a, b = trainer(src), trainer(dst)
    a.train_epoch(1)
    path = str(tmp_path / "full_ckpt.pt")
    a.save_full_checkpoint(path, 1, a._snapshot(), 1.0, 0)
    assert b.restore_full_checkpoint(path) == 2
    assert b.optimizer.count == a.optimizer.count == 10
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
        for m in ("mu", "nu"):
            assert torch.equal(a.optimizer.state[p][m],
                               b.optimizer.state[q][m]), (k, m)
    assert np.isfinite(b.train_epoch(2))
