"""The port's ASTGCN (both attentions, the attended Chebyshev conv, the
block, the builder's Chebyshev stack and `convert.py`) against the JAX
package's, on the CPU.

Weights: the JAX init with N(0, 0.1^2) noise on every leaf, carried over
by `convert.py`.

  * `TemporalAttention`, `SpatialAttention` (softmax over axis 1):
    values and input gradients rtol 1e-5, atol 1e-5 of the largest
    entry; one `ASTGCNBlock` (time_strides 1 and 2) the same at rtol
    1e-4 (flax's LayerNorm takes the variance as E[x^2] - E[x]^2,
    torch's from the centred values);
  * the whole model at published widths (2 blocks, K 3, 64/64) on
    N = 16, dim_in 1 and 64 (eval mode): the loss rtol 1e-5, the
    prediction and every gradient rtol 1e-4 with an atol of 1e-5 of
    each tensor's largest entry;
    both packages also run in float64, where the port is held to JAX at
    rtol 1e-9 with an atol of 1e-9 of each tensor's largest entry, and
    each f32 atol adds twice JAX's own f32 distance from its float64
    run (`tests/torch_parity.py`);
  * the builder's stack equal to JAX's; `convert.py` round trips; the
    init laws with flax's fans for `bs` (1, N, N), `Theta` (K, F, O) and
    `final_w` (T, F, H * D).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import astgcn as jastgcn
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors import astgcn as tastgcn
from torch_parity import (
    assert_model_matches, assert_round_trip, cli_cycle, closure_array,
    noisy, one_torch_thread,
)

N = 16
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _check(jm, tm, params, *args, rng, rtol=1e-5):
    """Values and the gradient into args[0] of jm.apply(params, *args)
    and tm(*args)."""
    xt = torch.tensor(args[0], requires_grad=True)
    out = tm(xt, *(torch.tensor(a) for a in args[1:]))
    g = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.tensor(g))

    @jax.jit
    def jvals(a, gg):
        jout, jvjp = jax.vjp(lambda b: jm.apply(params, b, *args[1:]), a)
        return jout, jvjp(gg)[0]

    jout, jg = jvals(jnp.asarray(args[0]), jnp.asarray(g))
    for got, want in ((out.detach().numpy(), jout), (xt.grad.numpy(), jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=1e-5 * np.abs(want).max())


def test_attentions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 12, N, 5)).astype(np.float32)
    for jcls, tcls in ((jastgcn.TemporalAttention, tastgcn.TemporalAttention),
                       (jastgcn.SpatialAttention, tastgcn.SpatialAttention)):
        jm = jcls(12, N)
        p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
        tm = tcls(12, N, 5)
        tm.load_state_dict({k: torch.tensor(v)
                            for k, v in p["params"].items()})
        _check(jm, tm, p, x, rng=rng)


@pytest.mark.parametrize("strides", [1, 2])
def test_block_matches_jax(strides):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, N, 6)).astype(np.float32)
    cheb = (0.3 * rng.standard_normal((3, N, N))).astype(np.float32)
    cfg = dict(num_nodes=N, nb_chev_filter=8, nb_time_filter=7,
               time_strides=strides)
    jm = jastgcn.ASTGCNBlock(jastgcn.ASTGCNConfig(**cfg), 12)
    p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x, cheb))
    tm = tastgcn.ASTGCNBlock(tastgcn.ASTGCNConfig(**cfg), 12, 6)
    # the block's keys are the model's below `block.0.`
    sd = flax_to_state_dict({"params": {"ASTGCNBlock_0": p["params"]}})
    tm.load_state_dict({k.removeprefix("block.0."): v for k, v in sd.items()})
    assert tm(torch.tensor(x), torch.tensor(cheb)).shape == (
        2, 12 // strides, N, 7)
    _check(jm, tm, p, x, cheb, rng=rng, rtol=1e-4)


@pytest.mark.parametrize("dim_in", [1, 64])
def test_model_loss_and_grads_match_jax(dim_in):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 12, N, dim_in)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 1)).astype(np.float32)
    cheb = (0.3 * rng.standard_normal((3, N, N))).astype(np.float32)
    jm = jastgcn.ASTGCN(cfg=jastgcn.ASTGCNConfig(num_nodes=N),
                        dim_in=dim_in, dim_out=1, horizon=12, lag=12)
    net = tastgcn.ASTGCN(tastgcn.ASTGCNConfig(num_nodes=N), dim_in=dim_in,
                         dim_out=1, horizon=12, lag=12,
                         generator=torch.Generator().manual_seed(0))
    # the port's init carried to JAX (a JAX init is one more compile)
    params = noisy(state_dict_to_flax(net.state_dict()))
    assert_model_matches(jm, net, params, x, [cheb], y, against64=True)


def test_convert_round_trips():
    cfg = dict(num_nodes=N, time_strides=2)
    jm = jastgcn.ASTGCN(cfg=jastgcn.ASTGCNConfig(**cfg), dim_in=1,
                        dim_out=1, horizon=12, lag=12)
    net = tastgcn.ASTGCN(tastgcn.ASTGCNConfig(**cfg), dim_in=1, dim_out=1,
                         horizon=12, lag=12,
                         generator=torch.Generator().manual_seed(0))
    assert_round_trip(net, jm, jnp.zeros((2, 12, N, 1)),
                      jnp.zeros((3, N, N)))


def test_builder_stack_equals_jax():
    rng = np.random.default_rng(3)
    adj = (rng.random((N, N)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    kw = dict(mode="ori", model="ASTGCN", num_nodes=N)
    _, apply_fn = jbuild._build_astgcn(jax_default_config("PEMS08", **kw), 1,
                                       adj)
    pred = tbuild.build_predictor(default_config("PEMS08", **kw), adj=adj,
                                  device="cpu")
    np.testing.assert_array_equal(pred.graph[0].numpy(),
                                  closure_array(apply_fn, "cheb"))


def test_init_laws_use_flax_fans():
    """xavier uniform U(+-sqrt(6 / (fan_in + fan_out))) with fan_in =
    shape[-2] * receptive and fan_out = shape[-1] * receptive; vectors
    U[0, 1)."""
    n = 400
    net = tastgcn.ASTGCN(tastgcn.ASTGCNConfig(num_nodes=n), dim_in=64,
                         dim_out=2, horizon=12, lag=12,
                         generator=torch.Generator().manual_seed(0)
                         ).requires_grad_(False)
    blk = net.block[0]
    for t, fans in ((blk.spatial_att.bs, (n, n)),
                    (blk.Theta, (64 * 3, 64 * 3)),
                    (net.final_w, (64 * 12, 24 * 12)),
                    (blk.temporal_att.U2, (64, n))):
        lim = np.sqrt(6.0 / sum(fans))
        assert float(t.abs().max()) <= lim
        assert abs(float(t.double().std()) / (lim / np.sqrt(3)) - 1) < 0.03
    u = blk.spatial_att.W3
    assert float(u.min()) >= 0 and float(u.max()) < 1
    assert abs(float(blk.time_conv.weight.double().std()) * np.sqrt(3 * 64)
               - 1) < 0.03
    assert not blk.time_conv.bias.any()


def test_cli_ori_eval_test_on_cpu(tmp_path, monkeypatch):
    """`python -m gptst_tpu_torch.run -mode ori|pretrain|eval|test -model
    ASTGCN -device cpu` at tiny widths; the test report equals eval's."""
    monkeypatch.chdir(tmp_path)
    cli_cycle(tmp_path, "PEMS08", "ASTGCN", [
        '--nb_chev_filter', '4', '--nb_time_filter', '4'])
