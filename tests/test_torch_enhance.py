"""The port's eval mode (frozen GPT-ST encoder, Fusion head, predictor)
against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and the same weights: the
head's JAX init, and for the trajectories the port's init (GPT-ST from
`build_pretrain`, head and predictor from `build_model` in eval mode;
a JAX init of GPT-ST runs op by op and costs ~15 s of CPU), carried
over by `convert.py`.

  * head and Fusion: values and the input gradients rtol 1e-5, atol
    1e-6; the weight gradients (sums over B*T*N positions) rtol 1e-5
    and an atol of 1e-6 of the tensor's largest entry;
  * a 2-epoch `-mode eval -model TGCN` trajectory through both trainers
    (`scan_steps=1` on the JAX side), on the dense support and through
    the sparse path (`make_support` patched to `dense_threshold=0,
    tile=16` in both build modules, the JAX Pallas kernels in interpret
    mode): per-step losses, history and best loss rtol 1e-4, the
    per-horizon and average report rtol 1e-3, the tolerances of
    `tests/test_torch_train.py`;
  * the encoder is outside the optimizer and `state_dict()`, bitwise
    unchanged by training, and reads the calendar channels;
  * the CLI's pretrain -> eval (under `-profile_dir`) -> test cycle for
    TGCN and the default STGCN, and test mode of an ori model.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.models import build as jbuild
from gptst_tpu.models import enhance as jenhance
from gptst_tpu.ops.graph_conv import make_support as jmake_support
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.enhance import EnhanceHead
from gptst_tpu_torch.ops.graph_conv import make_support
from gptst_tpu_torch.train.trainer import Trainer

N = 20
SMALL = dict(num_nodes=N, hidden_dim=16, embed_dim=8, embed_dim_spa=4,
             HS=4, HT=6, HT_Tem=4)
CFG = dict(mode="eval", model="TGCN", **SMALL, batch_size=16, epochs=2,
           lr_decay=True, lr_decay_step=(1,), early_stop=False, debug=False,
           log_step=1000, predictor_overrides=(("rnn_units", "8"),))
NUM_STEPS = 220


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here runs many tiny torch ops. With the suite's
    workers sharing the cores, torch's intra-op threads spin against
    each other: on 8 cores beside 7 busy processes the kill-and-resume
    test took 198 s with 8 threads and 10 s with one."""
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


def _sparse(monkeypatch):
    monkeypatch.setattr(jbuild, "make_support", functools.partial(
        jmake_support, dense_threshold=0, tile=16))
    monkeypatch.setattr(tbuild, "make_support", functools.partial(
        make_support, dense_threshold=0, tile=16))


def test_head_and_fusion_match_jax():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((2, 12, N, 3)).astype(np.float32)
    emb = rng.standard_normal((2, 12, N, 16)).astype(np.float32)
    g = rng.standard_normal((2, 12, N, 16)).astype(np.float32)
    head = jenhance.EnhanceHead(hidden_dim=16, input_base_dim=1)
    params = jax.tree.map(np.asarray, head.init(
        jax.random.PRNGKey(3), jnp.asarray(src), jnp.asarray(emb)))

    def jfn(p, s, e):
        return jnp.sum(head.apply(p, s, e) * g)

    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2)))(
        params, src, emb)
    port = EnhanceHead(16, 1)
    port.load_state_dict(flax_to_state_dict(params))
    s, e = (torch.tensor(a, requires_grad=True) for a in (src, emb))
    out = port(s, e)
    val = (out * torch.tensor(g)).sum()
    val.backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(head.apply(params, jnp.asarray(src), jnp.asarray(emb))),
        **tol)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    got = state_dict_to_flax({k: p.grad for k, p in port.named_parameters()})
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(jgrads[0])
    assert len(flat_got) == len(flat_want) == 8
    # a weight's gradient sums B*T*N = 480 products of O(1) terms: its
    # f32 rounding is ~1e-6 of the gradient's scale, so the atol is
    # 1e-6 of each tensor's largest entry
    for a, b in zip(flat_got, flat_want):
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                   atol=1e-6 * max(1.0, scale))
    # the calendar channels reach no output of the head
    assert not s.grad[..., 1:].any() and s.grad[..., :1].abs().max() > 0
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgrads[1]), **tol)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jgrads[2]), **tol)


def _small_eval_model(model="TGCN", seed=0):
    """The port's eval model at the test's widths: GPT-ST drawn from
    `seed` (`build_pretrain`) and handed over as its state dict, the
    head and predictor from `seed + 1`."""
    cfg = default_config("PEMS08", **{**CFG, "model": model})
    ds = build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    pre = tbuild.build_pretrain(cfg.replace(mode="pretrain"),
                                ds.scaler_zeros, "cpu", seed).gptst
    model = tbuild.build_model(cfg, device="cpu", seed=seed + 1,
                               scaler_zeros=ds.scaler_zeros,
                               pretrain_params=pre.state_dict())
    return cfg, ds, pre, model


def _jax_eval_run(cfg, pre, params):
    ds = jax_build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    _, forward = jbuild.build_model(
        cfg, scaler_zeros=ds.scaler_zeros, pretrain_params=pre)
    tr = JTrainer(forward=forward, params=params, cfg=cfg, dataset=ds,
                  seed=cfg.seed)
    losses = []
    run_chunk = tr._run_chunk

    def recording(*a, **k):
        out = run_chunk(*a, **k)
        losses.extend(t for t, _ in out)
        return out

    tr._run_chunk = recording
    return losses, tr.train()


@pytest.mark.parametrize("sparse", [False, True])
def test_eval_tgcn_trajectory_matches_jax(sparse, monkeypatch):
    if sparse:
        _sparse(monkeypatch)
    cfg, ds, pre, model = _small_eval_model()
    params = state_dict_to_flax(model.state_dict())
    assert set(params) == {"head", "predictor"}
    jlosses, jres = _jax_eval_run(
        jax_default_config("PEMS08", **CFG, scan_steps=1),
        state_dict_to_flax(pre.state_dict()), params)
    model.load_state_dict(flax_to_state_dict(params))
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 device="cpu")
    losses = []
    train_batch = tr._train_batch

    def recording(xb, yb):
        out = train_batch(xb, yb)
        losses.append(float(out[0]))
        return out

    tr._train_batch = recording
    tres = tr.train()
    assert len(losses) == len(jlosses) == 2 * 7
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(tres["history"], jres["history"], rtol=1e-4)
    np.testing.assert_allclose(tres["best_loss"], jres["best_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tres["report"]["per_horizon"],
                               jres["report"]["per_horizon"], rtol=1e-3)
    np.testing.assert_allclose(tres["report"]["average"],
                               jres["report"]["average"], rtol=1e-3)


def test_encoder_stays_frozen_and_reads_the_calendar():
    cfg, ds, pre, model = _small_eval_model()
    names = {k for k, _ in model.named_parameters()}
    assert names and all(k.startswith(("head.", "predictor."))
                         for k in names)
    assert set(model.state_dict()) == names
    tr = Trainer(model=model, cfg=cfg.replace(epochs=1), dataset=ds,
                 seed=cfg.seed, device="cpu")
    opt_params = {id(p) for g in tr.optimizer.param_groups
                  for p in g["params"]}
    assert opt_params == {id(p) for p in model.parameters()}
    want = {k: v.clone() for k, v in pre.state_dict().items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tr.train_epoch(1)
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert all(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    # nonzero gradients into the head and the predictor
    x = torch.from_numpy(ds.x_train[:4])
    pred = model(x).pred
    pred.square().mean().backward()
    for k, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, k
    # the encoder reads the calendar channels of the full input: moving
    # them changes the embedding (and so the prediction)
    x2 = x.clone()
    x2[..., 1:] = x2[..., 1:].roll(1, dims=1)
    with torch.no_grad():
        assert not torch.equal(model.encode(x2), model.encode(x))


def test_bf16_leaves_the_encoder_in_f32():
    """`compute_dtype=bfloat16`: the cast reaches the head and the
    predictor only; the encoder runs on f32 weights and an f32 input,
    as in the JAX package (whose cast covers only the trainable
    tree)."""
    from gptst_tpu_torch.train.loss import build_loss
    from gptst_tpu_torch.train.step import make_loss_terms

    cfg, ds, pre, model = _small_eval_model()
    cfg = cfg.replace(compute_dtype="bfloat16")
    seen = []
    model.encoder.encoder.register_forward_hook(
        lambda mod, args, out: seen.append(
            (args[0].dtype, mod.node_embeddings.dtype)))
    terms = make_loss_terms(
        model, build_loss("mask_mae", 50.0, 10.0, None, False), cfg)
    x = torch.from_numpy(ds.x_train[:4])
    y = torch.from_numpy(ds.y_train[:4])
    loss, _ = terms(x, y)
    loss.backward()
    assert seen == [(torch.float32, torch.float32)]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.grad.dtype == torch.float32 and p.grad.abs().max() > 0
               for p in model.parameters())


def _flags(tmp_path, mode, model="TGCN", extra=()):
    return ["-dataset", "PEMS08", "-mode", mode, "-model", model,
            "-num_nodes", "12", "-batch_size", "8", "-epochs", "2",
            "-num_steps", "220", "-log_dir", str(tmp_path),
            "-lr_decay", "False", "-early_stop", "False",
            "-hidden_dim", "16", "-embed_dim", "8", "-embed_dim_spa", "4",
            "-HS", "4", "-HT", "6", "-HT_Tem", "4", "-change_epoch", "1",
            "-log_step", "10000", "-device", "cpu", *extra]


@pytest.mark.parametrize("model", ["TGCN", "STGCN"])
def test_cli_pretrain_eval_test_cycle(tmp_path, model):
    from gptst_tpu_torch import run

    best = tmp_path / "PEMS08" / "best_model.pt"
    assert not run.checkpoint_is_enhanced(str(best))
    assert run.main(_flags(tmp_path, "pretrain")) == 0
    assert (tmp_path / "PEMS08" / "gptst_pretrain.ckpt").exists()
    ev, te = tmp_path / "eval.json", tmp_path / "test.json"
    prof = tmp_path / "profile"
    assert run.main(_flags(tmp_path, "eval", model,
                           ("-metrics_out", str(ev), "-profile_dir",
                            str(prof)))) == 0
    assert (prof / "trace.json").stat().st_size > 0
    assert run.checkpoint_is_enhanced(str(best))
    keys = torch.load(best, weights_only=True).keys()
    assert not any(k.startswith("encoder") for k in keys)
    assert run.main(_flags(tmp_path, "test", model,
                           ("-metrics_out", str(te)))) == 0
    ev, te = json.loads(ev.read_text()), json.loads(te.read_text())
    assert np.isfinite(ev["history"]).all() and len(ev["history"]) == 2
    np.testing.assert_allclose(te["per_horizon"], ev["per_horizon"],
                               rtol=1e-6)
    np.testing.assert_allclose(te["average"], ev["average"], rtol=1e-6)


def test_test_mode_of_an_ori_model(tmp_path):
    """An ori-trained best_model.pt is rebuilt with ori semantics: no
    pretrain checkpoint is needed."""
    from gptst_tpu_torch import run

    ori, te = tmp_path / "ori.json", tmp_path / "test.json"
    assert run.main(_flags(tmp_path, "ori", "STGCN",
                           ("-metrics_out", str(ori)))) == 0
    best = tmp_path / "PEMS08" / "best_model.pt"
    assert best.exists() and not run.checkpoint_is_enhanced(str(best))
    assert not (tmp_path / "PEMS08" / "gptst_pretrain.ckpt").exists()
    assert run.main(_flags(tmp_path, "test", "STGCN",
                           ("-metrics_out", str(te)))) == 0
    np.testing.assert_allclose(json.loads(te.read_text())["average"],
                               json.loads(ori.read_text())["average"],
                               rtol=1e-6)


def test_device_memory_stats_without_a_card():
    from gptst_tpu_torch.utils.observability import device_memory_stats

    stats = device_memory_stats()
    if torch.cuda.is_available():
        assert set(stats) == {f"cuda:{i}"
                              for i in range(torch.cuda.device_count())}
    else:
        assert stats == {"cpu": None}


def test_eval_without_the_encoder_raises():
    cfg = default_config("PEMS08", **CFG)
    with pytest.raises(ValueError, match="pretrain_params"):
        tbuild.build_model(cfg, device="cpu")
