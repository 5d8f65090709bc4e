"""The port's MSDR against the JAX package's, on transplanted weights.

Every parameter is drawn from a numpy seed, nonzero, and carried into
both packages by `convert.py`: at a fresh init W, b, R and the
attention weights are zero, and then every gradient into `gconv_w` and
the node embeddings is zero too, which would hide a broken learned-
adjacency backward. The forward and every gradient match on the dense
path and on the sparse path (static supports through
`make_support(dense_threshold=0, tile=16)`, the learned adjacency on an
SDDMM pattern; the JAX Pallas kernels in interpret mode). Tolerance
rtol 1e-4, and an atol of 1e-4 of each gradient's largest entry: the
sparse sums, the softmax and the split attention sums run in another
order, and a gradient entry summed over 24 layer-steps can cancel to
far below the others. att_b's gradient is zero in exact arithmetic (it
shifts every logit of a softmax): it is held to an atol of 1e-5.

The sparse cases use a node count that is a multiple of the pattern's
tile and a graph whose every node has a pattern entry: a row with none
is 0/1e-38 in the block-row softmax, and XLA on the CPU flushes that
subnormal floor to zero, so the JAX package gives NaN there where the
port gives 0 (`test_torch_sddmm.py`, ROADMAP Queue 3).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.graph.artifacts import random_sensor_graph
from gptst_tpu.kernels import sddmm as jsddmm
from gptst_tpu.kernels import spmm as jspmm
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors.msdr import MSDR as JMSDR
from gptst_tpu.models.predictors.msdr import MSDRConfig as JMSDRConfig
from gptst_tpu.ops.graph_conv import make_support as jmake_support
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.kernels.sddmm import SDDMMPattern
from gptst_tpu_torch.kernels.spmm import BlockCSR
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors.msdr import (
    MSDR, MSDRConfig, dual_random_walk_supports,
)
from gptst_tpu_torch.ops.graph_conv import make_support
from gptst_tpu_torch.train.trainer import Trainer
from torch_parity import one_torch_thread

# many tiny torch ops: one intra-op thread (the workers share the cores)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B, T = 48, 2, 4
CFG = dict(num_nodes=N, rnn_units=8, num_rnn_layers=2, pre_k=3,
           adapt_rank=4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    patched = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(jspmm.pl, "pallas_call", patched)
    monkeypatch.setattr(jsddmm.pl, "pallas_call", patched)


def _tile16_patterns(mat0, n):
    """Both packages' learned-adjacency pattern of `mat0`'s edges at
    tile 16 (several blocks at these sizes)."""
    r, c = np.nonzero(mat0)
    v = mat0[r, c]
    return (jsddmm.SDDMMPattern.from_bcsr(
                jspmm.BlockCSR.from_coo(r, c, v, n, tile=16)),
            SDDMMPattern.from_bcsr(
                BlockCSR.from_coo(r, c, v, n, tile=16, device="cpu")))


def _graph(sparse):
    """Both packages' supports and learned-adjacency pattern."""
    mats = dual_random_walk_supports(random_sensor_graph(N, 5, seed=2))
    if not sparse:
        return (tuple(jnp.asarray(m) for m in mats), None,
                tuple(torch.tensor(m) for m in mats), None)
    jp, tp = _tile16_patterns(mats[0], N)
    return (tuple(jmake_support(m, dense_threshold=0, tile=16) for m in mats),
            jp,
            tuple(make_support(m, dense_threshold=0, tile=16, device="cpu")
                  for m in mats),
            tp)


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, T, N, 1)).astype(np.float32),
            rng.standard_normal((B, T, N, 1)).astype(np.float32))


def _perturb(tree, seed):
    """The init plus N(0, 0.1^2) noise: every weight nonzero, the scale
    of each kept."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape)).astype(np.float32), tree)


@functools.lru_cache
def _random_params(remat="none", seed=1):
    """A JAX MSDR and a flax tree of nonzero random weights: the port's
    init in JAX's layout (a JAX init runs the interpreted kernels op by
    op), perturbed."""
    model = JMSDR(cfg=JMSDRConfig(**CFG, remat=remat), dim_in=1, dim_out=1,
                  horizon=T)
    net = MSDR(MSDRConfig(**CFG, remat=remat), dim_in=1, dim_out=1,
               generator=torch.Generator().manual_seed(0))
    return model, _perturb(state_dict_to_flax(
        net.state_dict(), chunked=remat == "full"), seed)


def _torch_net(params, remat="none"):
    net = MSDR(MSDRConfig(**CFG, remat=remat), dim_in=1, dim_out=1)
    net.load_state_dict(flax_to_state_dict(params))
    return net


@pytest.mark.parametrize("remat", ["none", "full"])
def test_convert_round_trips(remat):
    """Both flax layouts: cells at encoder/cell{i}, and one level deeper
    at encoder/seg/cell{i} under chunked remat."""
    model, params = _random_params(remat)
    assert ("seg" in params["params"]["encoder"]) == (remat == "full")
    x, _ = _inputs()
    jsups, jp, _, _ = _graph(False)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jsups, jp)
    assert jax.tree.map(np.shape, shapes) == jax.tree.map(np.shape, params)
    back = state_dict_to_flax(flax_to_state_dict(params),
                              chunked=remat == "full")
    flat, tree = jax.tree_util.tree_flatten(params)
    flat2, tree2 = jax.tree_util.tree_flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        np.testing.assert_array_equal(a, b)
    net = _torch_net(params)
    assert set(net.state_dict()) == set(flax_to_state_dict(params))


@pytest.mark.parametrize("sparse", [False, True])
def test_forward_and_grads_match(sparse):
    x, g = _inputs()
    jsups, jp, tsups, tp = _graph(sparse)
    model, params = _random_params()

    def jloss(p):
        pred = model.apply(p, jnp.asarray(x), jsups, jp)
        return jnp.sum(pred * jnp.asarray(g)), pred

    (_, jpred), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    net = _torch_net(params)
    pred = net(torch.tensor(x), tsups, tp)
    (pred * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               rtol=1e-4, atol=1e-5)
    tgrads = state_dict_to_flax({k: p.grad for k, p in net.named_parameters()})
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(jgrads),
            jax.tree_util.tree_leaves(tgrads)):
        want = np.asarray(want)
        scale = 1e-1 if path[-1].key == "att_b" else np.abs(want).max()
        assert scale > 0, path
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_none(remat):
    """The chunked checkpoint recomputes the same ops: equal to "none"
    on the sparse learned path (the learned supports enter the
    checkpointed segments as captured tensors)."""
    x, g = _inputs()
    _, _, tsups, tp = _graph(True)
    _, params = _random_params()
    out = {}
    for rm in ("none", remat):
        net = _torch_net(params, remat=rm)
        pred = net(torch.tensor(x), tsups, tp)
        (pred * torch.tensor(g)).sum().backward()
        out[rm] = [pred.detach()] + [p.grad for p in net.parameters()]
    for a, b in zip(out["none"], out[remat]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_adapt_pattern_arrays_equal():
    mats = dual_random_walk_supports(random_sensor_graph(300, 6, seed=3))
    jp = jbuild.msdr_adapt_pattern(mats[0], 300)
    tp = tbuild.msdr_adapt_pattern(mats[0], 300, device="cpu")
    assert tp.tile == jp.tile == 128 and tp.n == jp.n
    for name in ("row_ids", "cols", "ptr", "mask", "t_ptr", "t_cols",
                 "t_order"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    assert dataclasses.asdict(MSDRConfig(num_nodes=5)) == \
        dataclasses.asdict(JMSDRConfig(num_nodes=5))


TRAIN = dict(mode="ori", model="MSDR", num_nodes=32, batch_size=16,
             epochs=2, lr_decay=True, lr_decay_step=(1,), early_stop=False,
             debug=False, log_step=1000,
             predictor_overrides=(("rnn_units", "4"), ("pre_k", "2")))


def test_ori_msdr_trajectory_matches_jax_sparse(monkeypatch):
    """2 epochs of `-mode ori -model MSDR` through both trainers on the
    sparse path (static supports and the learned-adjacency pattern at
    tile 16), from the same random nonzero weights:
    per-step losses rtol 1e-4, test metrics 1e-3 (Adam amplifies the
    summation-order differences a little over 2 epochs)."""
    monkeypatch.setattr(jbuild, "make_support", functools.partial(
        jmake_support, dense_threshold=0, tile=16))
    monkeypatch.setattr(tbuild, "make_support", functools.partial(
        make_support, dense_threshold=0, tile=16))
    monkeypatch.setattr(jbuild, "msdr_adapt_pattern",
                        lambda m, n: _tile16_patterns(m, n)[0])
    monkeypatch.setattr(tbuild, "msdr_adapt_pattern",
                        lambda m, n, device: _tile16_patterns(m, n)[1])
    jcfg = jax_default_config("PEMS08", **TRAIN, scan_steps=1)
    _, forward = jbuild.build_model(jcfg)
    cfg = default_config("PEMS08", **TRAIN)
    model = tbuild.build_model(cfg, device="cpu")
    # the port's init carried over (a JAX init runs the interpreted
    # kernels op by op), perturbed
    params = _perturb(state_dict_to_flax(model.predictor.net.state_dict()), 4)
    tr = JTrainer(forward=forward, params=params, cfg=jcfg,
                  dataset=jax_build_dataset(jcfg, num_steps=160,
                                            seed=jcfg.seed),
                  seed=jcfg.seed)
    jlosses = []
    run_chunk = tr._run_chunk

    def recording_chunk(*a, **k):
        out = run_chunk(*a, **k)
        jlosses.extend(t for t, _ in out)
        return out

    tr._run_chunk = recording_chunk
    jres = tr.train()

    model.predictor.net.load_state_dict(flax_to_state_dict(params))
    ttr = Trainer(model=model, cfg=cfg, seed=cfg.seed, device="cpu",
                  dataset=build_dataset(cfg, num_steps=160, seed=cfg.seed))
    tlosses = []
    train_batch = ttr._train_batch

    def recording_batch(xb, yb):
        out = train_batch(xb, yb)
        tlosses.append(float(out[0]))
        return out

    ttr._train_batch = recording_batch
    tres = ttr.train()
    assert len(tlosses) == len(jlosses) > 4
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    np.testing.assert_allclose(tres["history"], jres["history"], rtol=1e-4)
    np.testing.assert_allclose(tres["report"]["average"],
                               jres["report"]["average"], rtol=1e-3)


def test_cli_runs_msdr_on_cpu(tmp_path):
    from gptst_tpu_torch.run import main

    out = tmp_path / "m.json"
    assert main(["-dataset", "PEMS08", "-mode", "ori", "-model", "MSDR",
                 "-num_nodes", "12", "-epochs", "1", "-batch_size", "16",
                 "-num_steps", "200", "--rnn_units", "4", "-device", "cpu",
                 "-log_dir", str(tmp_path), "-metrics_out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert len(rep["per_horizon"]) == 12 and np.isfinite(rep["average"]).all()
