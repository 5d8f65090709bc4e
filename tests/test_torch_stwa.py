"""The port's ST_WA against the JAX package's, on the CPU.

Weights: the port's init with N(0, 0.1^2) noise on every leaf (Dense
biases start at zero), carried to JAX by `convert.py` (a jitted JAX init
of the full depth takes ~9 s here; `test_convert_round_trips` holds the
tree against the JAX init's shapes). The draws: JAX's module
draws its four eps from the key it is given (`split` then `normal`,
`gptst_tpu/models/predictors/stwa.py:209-219`); the test replays those
splits to compute the same arrays, in the run's own precision, and hands
them to the port as `draws`.

  * the whole model at published widths (channels 16, 8 heads, memory
    16) on N = 8: dynamic at dim_in 1 at the published depth (cuts
    (12, 6), (3, 4), (1, 3)), dynamic at dim_in 64 (eval mode's fused
    embedding, through `eval_dimin`) and static at 64 at a cut depth
    ((4, 6), (1, 3): cuts 2 and 3 of the first layer still slice an
    empty window), each compile of JAX's full-depth gradient taking
    ~8 s here: the loss rtol 1e-5, the prediction and every
    gradient rtol 1e-4 with an atol of 1e-5 of each tensor's largest
    entry plus twice JAX's own f32 distance from its float64 run; in
    float64 the port at rtol 1e-9 of JAX (`torch_parity`);
  * the generator path draws what the JAX module draws, in its order
    (the data latent (B, N, M), then one (N, M) per layer); without a
    generator the draws are a fresh generator seeded 0 on every call;
  * `convert.py` both ways, bare and under the eval-mode tree
    (`predictor.net.*`); the init laws; one CLI cycle (ori, pretrain,
    eval, test at tiny widths).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.models.predictors import stwa as jstwa
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors.stwa import STWA, STWAConfig
from torch_parity import (
    assert_model_matches, assert_round_trip, cli_cycle, noisy,
    one_torch_thread,
)

N, B, M = 8, 2, 16
KEY = jax.random.PRNGKey(5)
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_draws(key, dtype, b=B, n=N, m=M, layers=3) -> list[np.ndarray]:
    """The eps arrays JAX's STWA draws from `key`, replayed: the data
    latent's, then each layer's."""
    with jax.enable_x64(dtype == np.float64):
        rng, r = jax.random.split(key)
        out = [jax.random.normal(r, (b, n, m))]
        for _ in range(layers):
            rng, r = jax.random.split(rng)
            out.append(jax.random.normal(r, (n, m)))
        out = [np.asarray(a) for a in out]
    assert all(a.dtype == dtype for a in out)
    return out


CUT = ((4, 6), (1, 3))


@pytest.mark.parametrize("dynamic,dim_in,cuts", [
    (True, 1, STWAConfig.layer_cuts), (True, 64, CUT), (False, 64, CUT)])
def test_model_loss_and_grads_match_jax(dynamic, dim_in, cuts):
    rng = np.random.default_rng(dim_in + dynamic)
    x = rng.standard_normal((B, 12, N, dim_in)).astype(np.float32)
    y = rng.standard_normal((B, 12, N, 1)).astype(np.float32)
    cfg = dict(num_nodes=N, dynamic=dynamic, layer_cuts=cuts)
    jm = jstwa.STWA(cfg=jstwa.STWAConfig(**cfg), dim_in=dim_in, dim_out=1,
                    horizon=12, lag=12)
    net = STWA(STWAConfig(**cfg), dim_in=dim_in, dim_out=1, horizon=12,
               lag=12, generator=torch.Generator().manual_seed(0))
    assert (net.eval_dimin is not None) == (dynamic and dim_in != 1)
    params = noisy(state_dict_to_flax(net.state_dict()))

    def draws(dtype):
        if not dynamic:     # the static branch draws nothing
            return None
        return {"draws": [torch.tensor(a) for a in jax_draws(
            KEY, dtype, layers=len(cuts))]}

    keyed = types.SimpleNamespace(apply=lambda p, a: jm.apply(p, a, KEY))
    grads = assert_model_matches(keyed, net, params, x, [], y,
                                 against64=True, torch_kw=draws)
    if dynamic:    # the memories and the latent MLPs reach the loss
        for k in ("mu", "logvar"):
            assert np.abs(grads[(jax.tree_util.DictKey("params"),
                                 jax.tree_util.DictKey("layer0"),
                                 jax.tree_util.DictKey(k))]).max() > 0


def test_generator_draws_in_the_jax_order():
    """With a generator the forward equals the same forward given the
    draws made from an equal generator in the documented order; without
    one, a fresh generator seeded 0 on every call (validation)."""
    cfg = STWAConfig(num_nodes=N, channels=8, heads=2, memory_size=4)
    net = STWA(cfg, 1, 1, 12, 12, generator=torch.Generator().manual_seed(0))
    x = torch.randn(B, 12, N, 1)

    def drawn(seed):
        g = torch.Generator().manual_seed(seed)
        return [torch.randn(B, N, 4, generator=g)] + [
            torch.randn(N, 4, generator=g) for _ in range(3)]

    with torch.no_grad():
        got = net(x, generator=torch.Generator().manual_seed(3))
        assert torch.equal(got, net(x, draws=drawn(3)))
        first, *layers = drawn(3)
        assert not torch.equal(got, net(x, draws=[first, *layers[::-1]]))
        assert torch.equal(net(x), net(x))
        assert torch.equal(net(x), net(x, draws=drawn(0)))
        assert not torch.equal(net(x), got)


@pytest.mark.parametrize("dynamic", [True, False])
def test_convert_round_trips(dynamic):
    jm = jstwa.STWA(cfg=jstwa.STWAConfig(num_nodes=N, dynamic=dynamic),
                    dim_in=64, dim_out=1, horizon=12, lag=12)
    net = STWA(STWAConfig(num_nodes=N, dynamic=dynamic), 64, 1, 12, 12,
               generator=torch.Generator().manual_seed(0))
    assert_round_trip(net, jm, jnp.zeros((2, 12, N, 64)))


def test_eval_mode_model_and_its_tree():
    """`build_model` in eval mode: the predictor at dim_in = hidden_dim
    (with `eval_dimin`), its keys under `predictor.net.`, and the
    enhanced tree both ways."""
    cfg = default_config("PEMS08", mode="pretrain", num_nodes=N,
                         hidden_dim=8, embed_dim=4, HS=3, HT=4, HT_Tem=2,
                         change_epoch=1)
    gpt = tbuild.build_model(cfg, device="cpu")
    model = tbuild.build_model(cfg.replace(mode="eval", model="ST_WA"),
                               device="cpu", pretrain_params=gpt.gptst)
    net = model.predictor.net
    assert net.eval_dimin.in_features == 8
    sd = model.state_dict()
    tree = state_dict_to_flax(sd)
    assert set(tree) == {"head", "predictor"}
    assert tree["predictor"]["params"]["eval_dimin"]["kernel"].shape == (8, 1)
    back = flax_to_state_dict(tree)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    x = torch.randn(2, 12, N, 3)
    g = torch.Generator().manual_seed(1)
    assert model(x, generator=g).pred.shape == (2, 12, N, 1)


def test_init_laws():
    """flax's laws: `torch_linear` U(+-1/sqrt(fan_in)) kernels, zero
    Dense biases, N(0, 1) proxies and memories, U[0, 1) static
    generator weights."""
    net = STWA(STWAConfig(num_nodes=1024), 1, 1, 12, 12,
               generator=torch.Generator().manual_seed(0)).requires_grad_(
                   False)
    w = net.proj1.weight            # (512, 256): fan_in 256
    assert float(w.abs().max()) <= 1 / 16
    assert abs(float(w.std()) * 16 * 3 ** 0.5 - 1) < 0.01
    assert not any(lin.bias.any() for lin in net.modules()
                   if isinstance(lin, torch.nn.Linear))
    layer = net.layers[0]
    for p in (layer.proxies, layer.mu, layer.logvar):
        assert abs(float(p.mean())) < 0.05 and abs(float(p.std()) - 1) < 0.05
    static = STWA(STWAConfig(num_nodes=4, channels=64, heads=8,
                             dynamic=False), 1, 1, 12, 12,
                  generator=torch.Generator().manual_seed(0))
    w = static.layers[0].tpg[0].weights.detach()
    assert 0 <= float(w.min()) and float(w.max()) < 1
    assert abs(float(w.mean()) - 0.5) < 0.02


def test_cli_ori_eval_test_on_cpu(tmp_path):
    """`python -m gptst_tpu_torch.run -mode ori|pretrain|eval|test -model
    ST_WA -device cpu` at tiny widths; the test report (its draws from
    the trainer's test generator) equals eval's."""
    cli_cycle(tmp_path, "PEMS08", "ST_WA", [
        "--channels", "4", "--heads", "2", "--memory_size", "4"])
