"""A 2-epoch `-mode ori -model TGCN` run of the port against the JAX one.

Both trainers start from the same weights (the JAX init, carried over
by `convert.py`), see the same batches in the same order and take the
same optimizer steps (clip_by_global_norm(5) + Adam, with an LR decay
boundary after epoch 1), so the per-step losses and the final
per-horizon MAE/RMSE/MAPE/CORR agree. Tolerance rtol 1e-4 on the
losses and 1e-3 on the metrics: f32 sums in another order, amplified a
little by Adam over 2 epochs. Run once on the dense support and once
through the sparse path (`make_support` patched in both build modules
to `dense_threshold=0, tile=16`).
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.models import build as jbuild
from gptst_tpu.ops.graph_conv import make_support as jmake_support
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.ops.graph_conv import make_support
from gptst_tpu_torch.train.trainer import Trainer
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(mode="ori", model="TGCN", num_nodes=20, batch_size=16, epochs=2,
           lr_decay=True, lr_decay_step=(1,), early_stop=False, debug=False,
           log_step=1000, predictor_overrides=(("rnn_units", "8"),))
NUM_STEPS = 220


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        jspmm.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _jax_run(cfg):
    ds = jax_build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    init_fn, forward = jbuild.build_model(cfg)
    params = init_fn(jax.random.PRNGKey(cfg.seed))
    tr = JTrainer(forward=forward, params=params, cfg=cfg, dataset=ds,
                  seed=cfg.seed)
    losses = []
    run_chunk = tr._run_chunk

    def recording(*a, **k):
        out = run_chunk(*a, **k)
        losses.extend(t for t, _ in out)
        return out

    tr._run_chunk = recording
    return params, losses, tr.train()


def _torch_run(cfg, params):
    ds = build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    model = tbuild.build_model(cfg, device="cpu")
    model.predictor.net.load_state_dict(
        flax_to_state_dict(jax.tree.map(np.asarray, params)))
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 device="cpu")
    losses = []
    train_batch = tr._train_batch

    def recording(xb, yb):
        out = train_batch(xb, yb)
        losses.append(out[0])
        return out

    tr._train_batch = recording
    result = tr.train()
    return [float(v) for v in losses], result


@pytest.mark.parametrize("sparse", [False, True])
def test_ori_tgcn_trajectory_matches_jax(sparse, monkeypatch):
    if sparse:
        monkeypatch.setattr(jbuild, "make_support", functools.partial(
            jmake_support, dense_threshold=0, tile=16))
        monkeypatch.setattr(tbuild, "make_support", functools.partial(
            make_support, dense_threshold=0, tile=16))
    # one optimizer step per dispatch on the JAX side (no scan compile);
    # the batch order is the same on every JAX path
    params, jlosses, jres = _jax_run(
        jax_default_config("PEMS08", **CFG, scan_steps=1))
    tlosses, tres = _torch_run(default_config("PEMS08", **CFG), params)
    assert len(tlosses) == len(jlosses) == 2 * 7
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(tres["history"], jres["history"], rtol=1e-4)
    np.testing.assert_allclose(tres["best_loss"], jres["best_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tres["report"]["per_horizon"],
                               jres["report"]["per_horizon"], rtol=1e-3)
    np.testing.assert_allclose(tres["report"]["average"],
                               jres["report"]["average"], rtol=1e-3)


def test_cli_runs_on_cpu_and_writes_metrics(tmp_path):
    from gptst_tpu_torch.run import main

    out = tmp_path / "m.json"
    assert main(["-dataset", "PEMS08", "-mode", "ori", "-model", "TGCN",
                 "-num_nodes", "12", "-epochs", "1", "-batch_size", "16",
                 "-num_steps", "200", "--rnn_units", "4", "-device", "cpu",
                 "-log_dir", str(tmp_path), "-metrics_out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert len(rep["per_horizon"]) == 12 and np.isfinite(rep["average"]).all()
    assert (tmp_path / "PEMS08" / "best_model.pt").exists()


def test_cli_refuses_what_is_not_ported(tmp_path):
    """Every predictor and a mesh with a data axis above 1 (batch
    parallelism) are ported; the CLI's default device needs a card."""
    from gptst_tpu_torch.parallel.mesh import make_mesh
    from gptst_tpu_torch.run import main

    assert make_mesh(devices=["cpu"] * 4,
                     graph_axis_size=2).shape == {"data": 2, "graph": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-mode", "ori", "-model", "TGCN", "-num_nodes", "12",
                  "-log_dir", str(tmp_path)])


def test_bf16_loss_and_grads_match_jax(monkeypatch):
    """`compute_dtype=bfloat16` on the sparse path: the forward runs on
    a bf16 cast of the parameters and inputs, the loss and gradients
    stay f32. Tolerance: rtol 1e-3 on the loss, 2e-2 of the largest
    gradient entry on the gradients (bf16 keeps 8 mantissa bits and the
    two frameworks round at different places over the 12 GRU steps)."""
    import jax.numpy as jnp

    from gptst_tpu.train.loss import build_loss as jbuild_loss
    from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import make_loss_terms

    monkeypatch.setattr(jbuild, "make_support", functools.partial(
        jmake_support, dense_threshold=0, tile=16))
    monkeypatch.setattr(tbuild, "make_support", functools.partial(
        make_support, dense_threshold=0, tile=16))
    kw = dict(CFG, compute_dtype="bfloat16")
    jcfg = jax_default_config("PEMS08", **kw)
    init_fn, forward = jbuild.build_model(jcfg)
    params = jax.jit(init_fn)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 20, 3)).astype(np.float32)
    y = rng.standard_normal((4, 12, 20, 3)).astype(np.float32)
    jterms = jmake_loss_terms(
        forward, jbuild_loss("mask_mae", 50.0, 10.0, None, False), jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jterms(p, jnp.asarray(x), jnp.asarray(y), None, 1, 0),
        has_aux=True))(params)

    cfg = default_config("PEMS08", **kw)
    model = tbuild.build_model(cfg, device="cpu")
    model.predictor.net.load_state_dict(
        flax_to_state_dict(jax.tree.map(np.asarray, params)))
    terms = make_loss_terms(
        model, build_loss("mask_mae", 50.0, 10.0, None, False), cfg)
    seen = []
    model.predictor.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    loss, _ = terms(torch.tensor(x), torch.tensor(y))
    loss.backward()
    assert seen == [torch.bfloat16] and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    grads = state_dict_to_flax(
        {k: p.grad for k, p in model.predictor.net.named_parameters()})
    for got, want in zip(jax.tree_util.tree_leaves(grads),
                         jax.tree_util.tree_leaves(jgrads)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())
