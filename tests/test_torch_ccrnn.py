"""The port's CCRNN, the step count its scheduled sampling reads, and
the four remaining masked metrics, against the JAX package's, on the CPU.

  * values and every gradient without teacher forcing, and with every
    coin set (the JAX draw patched to 0, the port's coins to True), at
    NYC_BIKE's widths (dim 2, hidden 25, k_hop 3) on 12 nodes, the
    weights the JAX init (SVD embeddings of a random support) with
    N(0, 0.05^2) noise on every leaf (w1, w2 start as the identity, b1,
    b2 at 0), carried over by `convert.py`: rtol 1e-4 with an atol of
    1e-5 of each tensor's largest entry;
  * the threshold cl / (cl + exp(step / cl)) in float32 as JAX computes
    it, exp overflow included, and the coins' rate: per step, 24,000
    port coins and 24,000 JAX coins each within 4.5 binomial standard
    deviations of the threshold;
  * the step count, batch by batch over two epochs, against what the
    JAX package's default trainer (`scan_steps` 0 -> 16, device-resident
    batches) hands its forward: 17 full batches (a chunk of one left),
    a ragged tail beside a full batch, `device_data` off and
    `scan_steps` 1;
  * `masked_pnbi`, `masked_opnbi`, `masked_mare` and `masked_smape`
    rtol 1e-6 on random inputs with masked entries;
  * the init laws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.eval import metrics as jmetrics
from gptst_tpu.models.api import ModelOutput as JModelOutput
from gptst_tpu.models.predictors import ccrnn as jccrnn
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.eval import metrics as tmetrics
from gptst_tpu_torch.models.api import ModelOutput
from gptst_tpu_torch.models.predictors import ccrnn as tccrnn
from gptst_tpu_torch.models.predictors.ccrnn import CCRNN, CCRNNConfig
from gptst_tpu_torch.train.trainer import Trainer, jax_step_counts

N = 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny torch ops: one intra-op thread, as in the other port
    test files (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    rng = np.random.default_rng(0)
    sup = np.abs(rng.standard_normal((N, N))).astype(np.float32)
    sup /= sup.sum(axis=1, keepdims=True)
    e1, e2 = jccrnn.svd_graph_embeddings(sup, N)
    jm = jccrnn.CCRNN(cfg=jccrnn.CCRNNConfig(num_nodes=N, n_dim=N),
                      dim_in=2, dim_out=2, horizon=12, emb1_init=e1,
                      emb2_init=e2)
    x = rng.standard_normal((3, 12, N, 2)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 2)).astype(np.float32)
    noise = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * noise.standard_normal(
            np.shape(a))).astype(np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    net = CCRNN(CCRNNConfig(num_nodes=N, n_dim=N), dim_in=2, dim_out=2,
                horizon=12, emb1_init=e1, emb2_init=e2)
    net.load_state_dict(flax_to_state_dict(params))
    return jm, params, net, x, y


def _assert_match(net, jm, params, x, y, teacher):
    g = np.random.default_rng(2).standard_normal(y.shape).astype(np.float32)
    if teacher:
        args = (jnp.asarray(y), jax.random.PRNGKey(3), jnp.asarray(5))
    else:
        args = ()

    def jloss(p):
        pred = jm.apply(p, jnp.asarray(x), *args)
        return jnp.sum(pred * jnp.asarray(g)), pred

    (_, jpred), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    kw = (dict(y=torch.tensor(y), step=5,
               generator=torch.Generator().manual_seed(0))
          if teacher else {})
    net.zero_grad(set_to_none=True)
    pred = net(torch.tensor(x), **kw)
    (pred * torch.tensor(g)).sum().backward()
    jpred = np.asarray(jpred)
    np.testing.assert_allclose(pred.detach().numpy(), jpred, rtol=1e-4,
                               atol=1e-5 * np.abs(jpred).max())
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in net.named_parameters()})))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(got) == len(want)
    # one gconv layer reads only the first of the three graphs, so w1,
    # w2, b1 and b2 get no gradient, and the attention softmax is over
    # one entry, so its weights get none: exactly 0 on both sides
    unread = ("attlinear", "'w1'", "'w2'", "'b1'", "'b2'")
    for path, w in want:
        w = np.asarray(w)
        assert (np.abs(w).max() > 0) != any(
            u in jax.tree_util.keystr(path) for u in unread), path
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    return pred.detach()


def test_convert_round_trips_and_matches_the_flax_tree():
    jm, params, net, x, _ = _pair()
    sd = net.state_dict()
    back = flax_to_state_dict(state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert (jax.tree.map(np.shape, state_dict_to_flax(sd))
            == jax.tree.map(np.shape, params))


def test_values_and_gradients_match_jax(monkeypatch):
    """Without teacher forcing (no targets, generator or step: the
    decoder feeds back its predictions), then with every coin set."""
    jm, params, net, x, y = _pair()
    free = _assert_match(net, jm, params, x, y, teacher=False)
    monkeypatch.setattr(jccrnn.jax.random, "uniform",
                        lambda key, shape: jnp.zeros(shape))
    monkeypatch.setattr(tccrnn, "teacher_forcing_coins",
                        lambda h, *a: torch.ones(h, dtype=torch.bool))
    forced = _assert_match(net, jm, params, x, y, teacher=True)
    assert (forced[:, 1:] - free[:, 1:]).abs().max() > 1e-3


def test_teacher_forcing_threshold_and_coin_rate():
    cl = 300
    for step in (0, 1, 17, 300, 1711, 5000, 30000, 10 ** 6):
        want = float(cl / (cl + jnp.exp(jnp.asarray(step, jnp.int32)
                                        .astype(jnp.float32) / cl)))
        got = float(tccrnn.teacher_forcing_threshold(step, cl))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tccrnn.teacher_forcing_threshold(10 ** 6, cl)) == 0.0
    gen = torch.Generator().manual_seed(0)
    for step in (0, 1711, 2000):
        thr = float(tccrnn.teacher_forcing_threshold(step, cl))
        n = 2000 * 12
        port = torch.stack([tccrnn.teacher_forcing_coins(12, step, cl, gen)
                            for _ in range(2000)]).double().mean()
        keys = jax.random.split(jax.random.PRNGKey(step), 2000)
        jrate = float(jnp.mean(jax.vmap(
            lambda k: jax.random.uniform(k, (12,)) < thr)(keys)))
        sd = np.sqrt(thr * (1 - thr) / n)
        assert abs(float(port) - thr) < 4.5 * sd + 1e-12, (step, port, thr)
        assert abs(jrate - thr) < 4.5 * sd + 1e-12, (step, jrate, thr)


class _StepRecorder(torch.nn.Module):
    """An ori-mode model that records the step count it is handed."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.steps: list[int] = []

    def forward(self, x, y=None, step=None, generator=None):
        self.steps.append(step)
        return ModelOutput(pred=x[..., :1] * self.w)


@pytest.mark.parametrize("n_train,scan_steps,device_data", [
    (34, 0, True), (35, 0, True), (35, 0, False), (35, 1, True)])
def test_step_counts_match_the_jax_default_trainer(n_train, scan_steps,
                                                   device_data):
    """batch 2: 34 windows are 17 full batches (16 fused, a chunk of one
    left, 1-based); 35 add a ragged tail beside the 17th batch."""
    kw = dict(num_nodes=4, batch_size=2, scan_steps=scan_steps,
              device_data=device_data, lr_decay=False, debug=False)
    jcfg = jax_default_config("PEMS08", mode="ori", model="TGCN", **kw)
    jds = jax_build_dataset(jcfg, num_steps=200, seed=0)
    jds.x_train, jds.y_train = jds.x_train[:n_train], jds.y_train[:n_train]
    seen = []

    def forward(params, x, y=None, rng=None, epoch=None, step=None):
        jax.debug.callback(lambda s: seen.append(int(s)), step)
        return JModelOutput(pred=x[..., :1] * params["w"])

    jtr = JTrainer(forward=forward, params={"w": jnp.ones(())}, cfg=jcfg,
                   dataset=jds, seed=0)
    for epoch in (1, 2):
        jtr.train_epoch(epoch, jax.random.PRNGKey(epoch))
        jax.effects_barrier()
    cfg = default_config("PEMS08", mode="ori", model="TGCN", **kw)
    ds = build_dataset(cfg, num_steps=200, seed=0)
    ds.x_train, ds.y_train = ds.x_train[:n_train], ds.y_train[:n_train]
    model = _StepRecorder()
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=0, device="cpu")
    for epoch in (1, 2):
        tr.train_epoch(epoch)
    assert len(seen) == len(model.steps) == 2 * -(-n_train // 2)
    assert model.steps == seen
    per_epoch = -(-n_train // 2)
    assert model.steps[:per_epoch] == jax_step_counts(
        n_train, 2, scan_steps, device_data, 0)
    if (n_train, scan_steps, device_data) == (34, 0, True):
        assert seen[:17] == list(range(16)) + [17]


@pytest.mark.parametrize("name", ["masked_pnbi", "masked_opnbi",
                                  "masked_mare", "masked_smape"])
@pytest.mark.parametrize("thresh", [None, 0.0, 0.5])
def test_remaining_metrics_match_jax(name, thresh):
    rng = np.random.default_rng(4)
    true = rng.standard_normal((8, 12, 5, 2)).astype(np.float32)
    true[true < -1.0] = 0.0          # masked at thresholds 0 and 0.5
    pred = rng.standard_normal(true.shape).astype(np.float32)
    want = float(getattr(jmetrics, name)(jnp.asarray(pred),
                                         jnp.asarray(true), thresh))
    got = float(getattr(tmetrics, name)(torch.tensor(pred),
                                        torch.tensor(true), thresh))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_init_laws():
    """w1, w2 the identity, b1, b2 zero, the nodevecs the SVD
    embeddings; the gconv kernels xavier normal (truncated, std
    sqrt(2 / (in + out))), the attention and output Dense lecun normal,
    zero biases."""
    n = 400
    e1 = np.random.default_rng(5).standard_normal((n, 50)).astype(np.float32)
    net = CCRNN(CCRNNConfig(num_nodes=n, hidden_size=64), dim_in=2,
                dim_out=2, horizon=12, emb1_init=e1, emb2_init=e1.T,
                generator=torch.Generator().manual_seed(0)).requires_grad_(
                    False)
    assert torch.equal(net.w1, torch.eye(50)) and not net.b1.any()
    assert torch.equal(net.nodevec2, torch.tensor(e1.T))
    cell = net.encoder.cell0
    w = cell.ru.gconv0.weight                 # (128, 4 * 66)
    std = np.sqrt(2.0 / sum(w.shape))
    assert abs(float(w.std()) / std - 1.0) < 0.03
    assert not cell.ru.gconv0.bias.any()
    att = cell.cand.attlinear.weight          # (1, n * 64)
    assert abs(float(att.std()) * np.sqrt(att.shape[1]) - 1.0) < 0.03
