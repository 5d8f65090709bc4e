"""The port's STSGCN (`SyncLayer`, `construct_sync_adj`, the builder and
`convert.py`) against the JAX package's, on the CPU, and three Adam
steps of its `mask_huber` training against the JAX trainer.

Weights: the JAX init with N(0, 0.1^2) noise on every leaf (the
position embeddings and biases start at 0), carried over by
`convert.py`. The model tests feed the synchronous adjacency divided by
its row sums: the raw 0/1 graph multiplies the activations by its row
sums (~3-5) in each of the 12 sub-layers, and with noisy weights the
loss reaches ~1e10, where f32 keeps no digit of the comparison.

  * `SyncLayer` (GLU and relu): values and input gradients rtol 1e-5,
    atol 1e-5 of the largest entry;
  * the whole model at published widths (4 x [64, 64, 64], embedding
    64, 128-wide heads) on N = 16, dim_in 1 and 64 (eval mode): the
    loss rtol 1e-5, the prediction and every gradient rtol 1e-4 with an
    atol of 1e-5 of each tensor's largest entry;
    both packages also run in float64, where the port is held to JAX at
    rtol 1e-9 with an atol of 1e-9 of each tensor's largest entry, and
    each f32 atol adds twice JAX's own f32 distance from its float64
    run (`tests/torch_parity.py`);
  * the builder's (3N, 3N) adjacency equal to JAX's; `convert.py` round
    trips; the per-window weights' law U(+-1/sqrt(C * W));
  * 3 Adam steps through both trainers from the same init on the
    builder's graph, lr 1e-4 (at the default 3e-3 both packages' losses
    jump by ~50x in the second step): the per-step losses rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import stsgcn as jstsgcn
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors import stsgcn as tstsgcn
from gptst_tpu_torch.train.trainer import Trainer
from torch_parity import (
    assert_model_matches, assert_round_trip, cli_cycle, closure_array,
    noisy, one_torch_thread,
)

N = 16
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((N, N)) < 0.2).astype(np.float32)
    return np.maximum(a, a.T)


def _row_normalized(adj):
    return (adj / adj.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("activation", ["GLU", "relu"])
def test_sync_layer_matches_jax(activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, N, 6)).astype(np.float32)
    adj = _row_normalized(tstsgcn.construct_sync_adj(_graph()))
    kw = dict(num_nodes=N, activation=activation)
    jm = jstsgcn.SyncLayer(jstsgcn.STSGCNConfig(**kw), (7, 7, 7), 12)
    p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x, adj))
    tm = tstsgcn.SyncLayer(tstsgcn.STSGCNConfig(**kw), (7, 7, 7), 12, N, 6)
    tm.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()})
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, torch.tensor(adj))
    g = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.tensor(g))

    @jax.jit
    def jvals(a, gg):
        jout, vjp = jax.vjp(lambda b: jm.apply(p, b, adj), a)
        return jout, vjp(gg)[0]

    jout, jg = jvals(jnp.asarray(x), jnp.asarray(g))
    assert out.shape == jout.shape == (2, 10, N, 7)
    for got, want in ((out.detach().numpy(), jout), (xt.grad.numpy(), jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dim_in", [1, 64])
def test_model_loss_and_grads_match_jax(dim_in):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 12, N, dim_in)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 1)).astype(np.float32)
    adj = _row_normalized(tstsgcn.construct_sync_adj(_graph()))
    jm = jstsgcn.STSGCN(cfg=jstsgcn.STSGCNConfig(num_nodes=N),
                        dim_in=dim_in, dim_out=1, horizon=12, lag=12)
    params = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x, adj))
    net = tstsgcn.STSGCN(tstsgcn.STSGCNConfig(num_nodes=N), dim_in=dim_in,
                         dim_out=1, horizon=12, lag=12)
    assert_model_matches(jm, net, params, x, [adj], y, against64=True)


def test_convert_round_trips_and_sync_adj_equals_jax():
    jm = jstsgcn.STSGCN(cfg=jstsgcn.STSGCNConfig(num_nodes=N), dim_in=1,
                        dim_out=1, horizon=12, lag=12)
    net = tstsgcn.STSGCN(tstsgcn.STSGCNConfig(num_nodes=N), dim_in=1,
                         dim_out=1, horizon=12, lag=12,
                         generator=torch.Generator().manual_seed(0))
    assert_round_trip(net, jm, jnp.zeros((2, 12, N, 1)),
                      jnp.zeros((3 * N, 3 * N)))
    adj = _graph(3) * np.random.default_rng(3).random((N, N))
    kw = dict(mode="ori", model="STSGCN", num_nodes=N)
    _, apply_fn = jbuild._build_stsgcn(jax_default_config("PEMS08", **kw),
                                       1, adj)
    pred = tbuild.build_predictor(default_config("PEMS08", **kw), adj=adj,
                                  device="cpu")
    np.testing.assert_array_equal(pred.graph[0].numpy(),
                                  closure_array(apply_fn, "sync_adj"))


def test_per_window_weight_law():
    """flax's fan_in of a (W, C, 2F) stack is C * W: U(+-1/sqrt(C * W)),
    std 1/sqrt(3 C W); biases and position embeddings zero."""
    net = tstsgcn.STSGCN(tstsgcn.STSGCNConfig(num_nodes=N), dim_in=1,
                         dim_out=1, horizon=12, lag=12,
                         generator=torch.Generator().manual_seed(0)
                         ).requires_grad_(False)
    layer = net.sync_layers[0]
    w = layer.w0                                       # (10, 64, 128)
    lim = 1.0 / np.sqrt(64 * 10)
    assert float(w.abs().max()) <= lim
    assert abs(float(w.double().std()) / (lim / np.sqrt(3)) - 1) < 0.02
    assert not layer.b0.any() and not layer.temporal_emb.any()
    assert not layer.spatial_emb.any()


CFG = dict(mode="ori", model="STSGCN", num_nodes=N, batch_size=40, epochs=1,
           lr_init=1e-4, lr_decay=False, early_stop=False, debug=False,
           log_step=1000)


def test_three_adam_steps_match_the_jax_trainer():
    """`mask_huber` (the STSGCN config's loss), Adam, 3 train steps on
    the builder's graph (PEMS08's synthetic sensor graph) from the
    port's init, carried to JAX (a JAX init is one more compile): the
    per-step losses rtol 1e-4. Each trainer runs its one train epoch
    alone (JAX with the key its `train()` folds in for epoch 1): no
    validation or test pass, which would compile two more JAX
    programs."""
    jcfg = jax_default_config("PEMS08", **CFG, scan_steps=1)
    assert jcfg.loss_func == "mask_huber"
    jds = jax_build_dataset(jcfg, num_steps=220, seed=jcfg.seed)
    _, forward = jbuild.build_model(jcfg)
    cfg = default_config("PEMS08", **CFG)
    model = tbuild.build_model(cfg, device="cpu")
    params = state_dict_to_flax(model.predictor.net.state_dict())
    jtr = JTrainer(forward=forward, params=params, cfg=jcfg, dataset=jds,
                   seed=jcfg.seed)
    jlosses = []
    run_chunk = jtr._run_chunk
    jtr._run_chunk = lambda *a, **k: [jlosses.append(t) or (t, f)
                                      for t, f in run_chunk(*a, **k)]
    jtr.train_epoch(1, jax.random.fold_in(jax.random.PRNGKey(jtr.seed), 1))
    assert cfg.loss_func == "mask_huber"
    ds = build_dataset(cfg, num_steps=220, seed=cfg.seed)
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 device="cpu")
    losses = []
    train_batch = tr._train_batch

    def recording(xb, yb):
        out = train_batch(xb, yb)
        losses.append(float(out[0]))
        return out

    tr._train_batch = recording
    tr.train_epoch(1)
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_cli_ori_eval_test_on_cpu(tmp_path, monkeypatch):
    """`python -m gptst_tpu_torch.run -mode ori|pretrain|eval|test -model
    STSGCN -device cpu` at tiny widths; the test report equals eval's."""
    monkeypatch.chdir(tmp_path)
    cli_cycle(tmp_path, "PEMS08", "STSGCN", [
        '--filter_list', '[[4, 4, 4], [4, 4, 4]]',
        '--first_layer_embedding_size', '4'])
