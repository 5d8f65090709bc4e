"""The port's STGCN (and its ops: temporal convs, `cheb_conv`, the dense
`graph_matmul`) against the JAX package's, on the CPU, at N = 20.

Weights: the JAX init with noise added to every leaf (LayerNorm scales
and biases, conv and theta biases are 1 and 0 at init, where a wrong
gradient could hide), carried over by `convert.py`.

  * forward and every gradient: rtol 1e-4 and an atol of 1e-5 of each
    tensor's largest entry (f32 sums in another order through two
    Chebyshev convolutions and three LayerNorms);
  * a 2-epoch `-mode ori` trajectory against `gptst_tpu`'s Trainer
    (`scan_steps=1`): losses, history, best loss and report rtol 1e-3,
    and the same run against the port's float64 run at rtol 1e-5 (the
    JAX package's own f32 trajectory is up to 4e-4 from float64; see
    the test's docstring);
  * bf16 (`compute_dtype=bfloat16`, the path `tests/test_bf16_drift.py`
    runs): the dense products follow `jnp.einsum`'s promotion, a bf16 x
    on the f32 support or Chebyshev stack gives f32 (ROADMAP.md Queue 3,
    item 2). Every module's output dtype as in JAX; the loss rtol 1e-4;
    gradients f32 with a relative L2 error under 0.1 (see the test's
    docstring for why not tighter);
  * TGCN (and MSDR) on a dense support with a bf16 input raise a
    TypeError, as the JAX package's scan carries do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.graph.artifacts import (
    cheb_poly_stack, random_sensor_graph, scaled_laplacian, sym_adj,
)
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import stgcn as jstgcn
from gptst_tpu.ops import graph_conv as jgc
from gptst_tpu.ops import temporal as jtemporal
from gptst_tpu.train.loss import build_loss as jbuild_loss
from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors.msdr import MSDR, MSDRConfig
from gptst_tpu_torch.models.predictors.stgcn import STGCN, STGCNConfig
from gptst_tpu_torch.models.predictors.tgcn import TGCN, TGCNConfig
from gptst_tpu_torch.ops import graph_conv as tgc
from gptst_tpu_torch.ops.temporal import TemporalConv
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms
from gptst_tpu_torch.train.trainer import Trainer, make_optimizer

N, B = 20, 3


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


def _noisy(params, seed=7, scale=0.1):
    """Every leaf of a flax tree plus N(0, scale^2) noise (numpy)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)


def _cheb():
    adj = random_sensor_graph(N, avg_degree=5, seed=2)
    return cheb_poly_stack(scaled_laplacian(adj), 3).astype(np.float32)


def _assert_tree(got, want, rtol=1e-4, rel_atol=1e-5):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(paths)
    for path, w in paths:
        w = np.asarray(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(flat[path], w, rtol=rtol,
                                   atol=rel_atol * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_convert_round_trips():
    net = STGCN(STGCNConfig(num_nodes=N), dim_in=40, dim_out=1,
                generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    back = flax_to_state_dict(state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    model = jstgcn.STGCN(cfg=jstgcn.STGCNConfig(num_nodes=N), dim_in=40,
                         dim_out=1)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 12, N, 40)), jnp.asarray(_cheb()))
    want = jax.tree.map(lambda a: a.shape, shapes)
    got = jax.tree.map(np.shape, state_dict_to_flax(sd))
    assert got == want


@pytest.mark.parametrize("act", ["GLU", "sigmoid", "relu"])
@pytest.mark.parametrize("c_in,c_out,kt", [(5, 3, 3), (3, 5, 3), (4, 4, 1)])
def test_temporal_conv_matches(act, c_in, c_out, kt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 6, c_in)).astype(np.float32)
    mod = jtemporal.TemporalConv(kt=kt, c_out=c_out, act=act)
    params = _noisy(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = TemporalConv(kt, c_in, c_out, act)
    p = params["params"]
    sd = {"kernel": torch.tensor(p["Conv_0"]["kernel"]),
          "bias": torch.tensor(p["Conv_0"]["bias"])}
    if "Dense_0" in p:
        sd["proj.weight"] = torch.tensor(p["Dense_0"]["kernel"].T)
        sd["proj.bias"] = torch.tensor(p["Dense_0"]["bias"])
    port.load_state_dict(sd)
    np.testing.assert_allclose(
        port(torch.tensor(x)).detach().numpy(),
        np.asarray(mod.apply(params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_dense_graph_matmul_and_cheb_conv_promote_like_jax():
    rng = np.random.default_rng(4)
    sup = sym_adj(random_sensor_graph(N, avg_degree=5, seed=2)).astype(
        np.float32)
    x = rng.standard_normal((B, 12, N, 4)).astype(np.float32)
    theta = rng.standard_normal((4, 5, 3)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    cheb = _cheb()
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        xt, xj = torch.tensor(x).to(dt), jnp.asarray(x).astype(jdt)
        got = tgc.graph_matmul(torch.tensor(sup), xt)
        want = jgc.graph_matmul(jnp.asarray(sup), xj)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        # theta in x's dtype, as the bf16 forward casts the parameters
        got = tgc.cheb_conv(xt, torch.tensor(cheb), torch.tensor(theta).to(dt),
                            torch.tensor(bias).to(dt))
        want = jgc.cheb_conv(xj, jnp.asarray(cheb),
                             jnp.asarray(theta).astype(jdt),
                             jnp.asarray(bias).astype(jdt))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_stgcn():
    """The JAX STGCN at eval width (dim_in 40 > 32: the first temporal
    conv projects), its noisy weights and one jitted value_and_grad."""
    model = jstgcn.STGCN(cfg=jstgcn.STGCNConfig(num_nodes=N), dim_in=40,
                         dim_out=1)
    cheb = jnp.asarray(_cheb())
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 12, N, 40)).astype(np.float32)
    g = rng.standard_normal((B, 12, N, 1)).astype(np.float32)
    params = _noisy(jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x), cheb))

    @jax.jit
    def vg(p, x):
        def f(p):
            out = model.apply(p, x, cheb)
            return jnp.sum(out * g), out
        return jax.value_and_grad(f, has_aux=True)(p)

    (val, out), grads = vg(params, jnp.asarray(x))
    return params, x, g, (float(val), np.asarray(out), grads)


def test_forward_and_grads_match(jax_stgcn):
    params, x, g, (jval, jout, jgrads) = jax_stgcn
    net = STGCN(STGCNConfig(num_nodes=N), dim_in=40, dim_out=1)
    net.load_state_dict(flax_to_state_dict(params))
    out = net(torch.tensor(x), torch.tensor(_cheb()))
    val = (out * torch.tensor(g)).sum()
    val.backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_allclose(val.item(), jval, rtol=1e-4)
    _assert_tree(state_dict_to_flax(
        {k: p.grad for k, p in net.named_parameters()}), jgrads)


def test_dropout_draws_from_the_generator():
    net = STGCN(STGCNConfig(num_nodes=N, drop_prob=0.3), dim_in=1,
                dim_out=1, generator=torch.Generator().manual_seed(0))
    x, cheb = torch.randn(2, 12, N, 1), torch.tensor(_cheb())
    run = [net(x, cheb, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])
    # as in the JAX package, a generator and not the module's mode runs
    # dropout (the trainer's test report passes one)
    net.eval()
    assert torch.equal(net(x, cheb, torch.Generator().manual_seed(1)),
                       run[0])
    plain = net(x, cheb)
    net.train()
    assert torch.equal(net(x, cheb), plain)
    assert not torch.equal(plain, run[0])


CFG = dict(mode="ori", model="STGCN", num_nodes=N, batch_size=16, epochs=2,
           lr_decay=True, lr_decay_step=(1,), early_stop=False, debug=False,
           log_step=1000)


def _port_run(cfg, params, double=False):
    """The port's 2-epoch run from `params`, in f32 or, with `double`,
    with the model, its Chebyshev stack, the batches and the optimizer
    state in float64. Returns the per-step losses and the result."""
    ds = build_dataset(cfg, num_steps=220, seed=cfg.seed)
    model = tbuild.build_model(cfg, device="cpu")
    model.predictor.net.load_state_dict(flax_to_state_dict(params))
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 device="cpu")
    if double:
        model.double()
        model.predictor.graph = tuple(t.double()
                                      for t in model.predictor.graph)
        put = tr._put
        tr._put = lambda a: put(a).double()
        tr.optimizer = make_optimizer(cfg, model.parameters(),
                                      tr.steps_per_epoch)
    losses = []
    train_batch = tr._train_batch

    def recording(xb, yb):
        out = train_batch(xb, yb)
        losses.append(float(out[0]))
        return out

    tr._train_batch = recording
    res = tr.train()
    return np.asarray(losses), res


def test_ori_stgcn_trajectory_matches_jax():
    """Per-step losses, history and best loss against `gptst_tpu` at
    rtol 1e-3, the report at 1e-3, and against the port's own float64
    run at rtol 1e-5. The JAX side's f32 trajectory is the looser one:
    its bias gradients (f32 sums over B*T*N positions) are ~1e-6 to
    3e-5 of their scale from float64 where the port's are ~1e-7, and
    Adam turns that into a drift of up to 4e-4 in 14 steps (the port's
    f32 run stays within 1.5e-6 of its float64 run)."""
    jcfg = jax_default_config("PEMS08", **CFG, scan_steps=1)
    jds = jax_build_dataset(jcfg, num_steps=220, seed=jcfg.seed)
    _, forward = jbuild.build_model(jcfg)
    cfg = default_config("PEMS08", **CFG)
    # the port's init as both sides' weights (a JAX init is one more
    # compile), with noise so that no LayerNorm weight starts at 1 or 0
    init = tbuild.build_model(cfg, device="cpu").predictor.net
    params = _noisy(state_dict_to_flax(init.state_dict()), scale=0.02)
    jtr = JTrainer(forward=forward, params=params, cfg=jcfg, dataset=jds,
                   seed=jcfg.seed)
    jlosses = []
    run_chunk = jtr._run_chunk
    jtr._run_chunk = lambda *a, **k: [jlosses.append(t) or (t, f)
                                      for t, f in run_chunk(*a, **k)]
    jres = jtr.train()
    losses, res = _port_run(cfg, params)
    assert len(losses) == len(jlosses) == 2 * 7
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(res["history"], jres["history"], rtol=1e-3)
    np.testing.assert_allclose(res["best_loss"], jres["best_loss"],
                               rtol=1e-3)
    np.testing.assert_allclose(res["report"]["per_horizon"],
                               jres["report"]["per_horizon"], rtol=1e-3)
    np.testing.assert_allclose(res["report"]["average"],
                               jres["report"]["average"], rtol=1e-3)
    losses64, res64 = _port_run(cfg, params, double=True)
    np.testing.assert_allclose(losses, losses64, rtol=1e-5)
    np.testing.assert_allclose(res["history"], res64["history"], rtol=1e-5)


def test_bf16_loss_and_grads_match_jax():
    """The path of `tests/test_bf16_drift.py`: `build_model` and
    `make_loss_terms` with `compute_dtype=bfloat16` at N = 20. Only the
    first temporal conv computes in bf16 (bf16 x, bf16 weights); from
    the Chebyshev product on, JAX's promotion makes every result f32.
    That bf16 conv's GLU rounds differently in the two packages: XLA on
    the CPU computes a bf16 logistic as 1/(1+exp(-x)) rounding each op
    to bf16, torch rounds the f32 sigmoid once, so ~30% of its outputs
    differ by an ulp. Downstream the upstream gradient of an L1 loss
    whose residuals share one sign is uniform, which each LayerNorm's
    backward cancels, so those ulps reach the gradients of the two
    blocks at a few percent. Hence: the loss at rtol 1e-4 (the port's
    earlier bf16 cast of the support and stack was 1.8e-4 away), each
    gradient f32 with a relative L2 error under 0.1, and every
    module's output dtype equal to JAX's with values within 2e-2 of the
    largest (`test_bf16_module_dtypes_follow_jax`)."""
    kw = dict(CFG, compute_dtype="bfloat16")
    jcfg = jax_default_config("PEMS08", **kw)
    _, forward = jbuild.build_model(jcfg)
    cfg = default_config("PEMS08", **kw)
    model = tbuild.build_model(cfg, device="cpu")
    params = _noisy(state_dict_to_flax(model.predictor.net.state_dict()),
                    scale=0.02)
    model.predictor.net.load_state_dict(flax_to_state_dict(params))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, N, 3)).astype(np.float32)
    y = rng.standard_normal((4, 12, N, 3)).astype(np.float32)
    jterms = jmake_loss_terms(
        forward, jbuild_loss("mask_mae", 50.0, 10.0, None, False), jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jterms(p, jnp.asarray(x), jnp.asarray(y), None, 1, 0),
        has_aux=True))(params)
    terms = make_loss_terms(
        model, build_loss("mask_mae", 50.0, 10.0, None, False), cfg)
    loss, _ = terms(torch.tensor(x), torch.tensor(y))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    grads = state_dict_to_flax(
        {k: p.grad for k, p in model.predictor.net.named_parameters()})
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, w in jax.tree_util.tree_leaves_with_path(jgrads):
        got, w = flat[path], np.asarray(w)
        assert got.dtype == np.float32 and np.abs(w).max() > 0, path
        rel = np.linalg.norm(got - w) / np.linalg.norm(w)
        assert rel < 0.1, (jax.tree_util.keystr(path), rel)


def test_bf16_module_dtypes_follow_jax():
    """Each STGCN module's output on bf16 weights and a bf16 input: the
    dtype JAX's promotion gives (bf16 for the first temporal conv, f32
    from the Chebyshev conv on), values within 2e-2 of the largest."""
    cheb = _cheb()
    net = STGCN(STGCNConfig(num_nodes=N), 1, 1,
                generator=torch.Generator().manual_seed(0))
    params = _noisy(state_dict_to_flax(net.state_dict()), scale=0.02)
    net.load_state_dict(flax_to_state_dict(params))
    net = net.bfloat16()
    x = np.random.default_rng(0).standard_normal((4, 12, N, 1)).astype(
        np.float32)
    model = jstgcn.STGCN(cfg=jstgcn.STGCNConfig(num_nodes=N), dim_in=1,
                         dim_out=1)
    _, st = model.apply(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(cheb),
        capture_intermediates=True)
    got = {}
    for name, mod in net.named_modules():
        mod.register_forward_hook(
            lambda m, a, o, name=name: got.__setitem__(name, o))
    net(torch.tensor(x).bfloat16(), torch.tensor(cheb))
    scopes = {"block0.tconv0": ("STConvBlock_0", "TemporalConv_0"),
              "block0.sconv": ("STConvBlock_0", "SpatioConvLayer_0"),
              "block0.tconv1": ("STConvBlock_0", "TemporalConv_1"),
              "block0.norm": ("STConvBlock_0", "LayerNorm_0"),
              "block1": ("STConvBlock_1",), "output": ("OutputLayer_0",),
              "": ()}
    dtypes = {}
    for name, path in scopes.items():
        d = st["intermediates"]
        for p in path:
            d = d[p]
        want = d["__call__"][0]
        dtypes[name] = str(got[name].dtype).removeprefix("torch.")
        assert dtypes[name] == str(want.dtype), name
        w = np.asarray(want, np.float32)
        np.testing.assert_allclose(got[name].detach().float().numpy(), w,
                                   rtol=0, atol=2e-2 * np.abs(w).max(),
                                   err_msg=name)
    assert dtypes["block0.tconv0"] == "bfloat16"
    assert dtypes["block0.sconv"] == dtypes[""] == "float32"


def test_tgcn_on_a_dense_bf16_support_raises_like_jax():
    from gptst_tpu.models.predictors.tgcn import TGCN as JTGCN
    from gptst_tpu.models.predictors.tgcn import TGCNConfig as JTGCNConfig

    sup = sym_adj(random_sensor_graph(N, avg_degree=5, seed=2)).astype(
        np.float32)
    x = np.zeros((2, 12, N, 1), np.float32)
    model = JTGCN(cfg=JTGCNConfig(num_nodes=N, rnn_units=4), dim_in=1,
                  dim_out=1, horizon=12)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(sup))
    with pytest.raises(TypeError):
        jax.eval_shape(model.apply, params, jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(sup))
    net = TGCN(TGCNConfig(num_nodes=N, rnn_units=4), 1, 1, 12).bfloat16()
    with pytest.raises(TypeError, match="ROADMAP.md Queue 3, item 6"):
        net(torch.zeros(2, 12, N, 1, dtype=torch.bfloat16),
            torch.tensor(sup))
    # an f32 input on the f32 dense support (bf16 weights, the eval
    # mode's fused embedding) computes in f32, as in the JAX package
    out = net(torch.zeros(2, 12, N, 1), torch.tensor(sup))
    assert out.dtype == torch.float32
    # MSDR's static supports: the same refusal (JAX's MSDR raises the
    # same scan-carry TypeError on a dense bf16 support)
    msdr = MSDR(MSDRConfig(num_nodes=N, rnn_units=4), 1, 1).bfloat16()
    with pytest.raises(TypeError, match="ROADMAP.md Queue 3, item 6"):
        msdr(torch.zeros(2, 12, N, 1, dtype=torch.bfloat16),
             (torch.tensor(sup), torch.tensor(sup)))
