"""The port's STGODE (`ODEG`, `TemporalConvNet` with its discarded
branch, `NodeBatchNorm`, the builder's two graphs and `convert.py`)
against the JAX package's, on the CPU.

Weights: the JAX init with N(0, 0.1^2) noise on every leaf (ODEG's w
starts at I, d at 1, alpha at 0.8), carried over by `convert.py`. A
torch None gradient (the TCN convs whose output the forward discards)
is JAX's zero.

  * `ODEG` (one Euler step of size 6, x0 detached), the TCN (widths
    that differ: the conv chain and the 1x1 downsample; widths that
    match: relu(x), the convs with no gradient) and `NodeBatchNorm`
    (the population variance over (B, T, C)): values and gradients
    rtol 1e-5, atol 1e-5 of the largest entry; ODEG's clip(d, 0, 1) at
    d = 1 passes half the gradient, as JAX's does;
  * the whole model at published widths ([64, 32, 64], 3 layers) on
    N = 16, dim_in 1 and 64 (eval mode, where every TCN discards its
    convs): the loss rtol 1e-5, the prediction and every gradient rtol
    1e-4 with an atol of 1e-5 of each tensor's largest entry;
    both packages also run in float64, where the port is held to JAX at
    rtol 1e-9 with an atol of 1e-9 of each tensor's largest entry, and
    each f32 atol adds twice JAX's own f32 distance from its float64
    run (`tests/torch_parity.py`). The JAX side runs
    un-jitted here: under `jax.jit`, XLA on the CPU recomputes the
    branch outputs inside the fused backward of the max over the 12
    branches, the recomputed values differ from the forward's in the
    last bit, and JAX's max rule (the gradient goes where the operand
    equals the max) then drops gradients (up to 2.4 of a gradient's
    scale against the un-jitted run and the port's float64 run);
  * the builder's normalized graphs equal to JAX's, from the prefab
    distance files and from the DTW graph; `convert.py` round trips,
    unused TCN parameters included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import stgode as jstgode
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors import stgode as tstgode
from torch_parity import (
    assert_model_matches, assert_round_trip, cli_cycle, closure_array,
    noisy, one_torch_thread,
)

N = 16
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _adj(seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((N, N)) < 0.3).astype(np.float32)
    return tstgode.stgode_normalized_adj(np.maximum(a, a.T))


def _by_name(params):
    return {k: np.asarray(v) for k, v in params["params"].items()}


def _tcn_keys(params):
    """A TCN's flax tree -> the port's keys and layouts."""
    sd = flax_to_state_dict({"params": {"sp_0_0": {
        "TemporalConvNet_0": params["params"]}}})
    return {k.removeprefix("blocks.sp_0_0.tcn.0."): v.numpy()
            for k, v in sd.items()}


def _check_part(jm, tm, p, x, *rest, rng, to_port=_by_name):
    """Values, the input gradient and every parameter gradient (the JAX
    gradient tree renamed by `to_port`)."""
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, *(torch.tensor(a) for a in rest))
    g = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.tensor(g))

    @jax.jit
    def jvals(pp, a, gg):
        jout, vjp = jax.vjp(lambda q, b: jm.apply(q, b, *rest), pp, a)
        return jout, *vjp(gg)

    jout, jgp, jgx = jvals(p, jnp.asarray(x), jnp.asarray(g))
    got = {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
           for k, v in tm.named_parameters()}
    pairs = [(out.detach().numpy(), jout, "out"),
             (xt.grad.numpy(), jgx, "x")]
    want = to_port(jgp)
    assert set(want) == set(got)
    pairs += [(got[k], w, k) for k, w in want.items()]
    for a, want, what in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(a, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    return got


def test_odeg_matches_jax_and_halves_the_gradient_at_the_clip():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, N, 8)).astype(np.float32)
    jm = jstgode.ODEG(8, 12)
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), x, _adj())
    tm = tstgode.ODEG(8, 12, N)
    for params in (p, noisy(p)):     # d, d2 at exactly 1, then not
        tm.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in params["params"].items()})
        tm.zero_grad()
        got = _check_part(jm, tm, params, x, _adj(), rng=rng)
        assert np.abs(got["d"]).max() > 0


@pytest.mark.parametrize("c_in", [3, 64])
def test_temporal_conv_net_both_branches(c_in):
    """c_in 3: the causal dilated chain plus the 1x1 downsample; c_in 64
    (= the last width): relu(x), and the convs get no gradient."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, N, c_in)).astype(np.float32)
    jm = jstgode.TemporalConvNet((64, 32, 64))
    p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    tm = tstgode.TemporalConvNet(c_in, (64, 32, 64))
    tm.load_state_dict({k: torch.tensor(v)
                        for k, v in _tcn_keys(p).items()})
    assert (tm.down is None) == (c_in == 64)
    _check_part(jm, tm, p, x, rng=rng, to_port=_tcn_keys)
    if c_in == 64:
        assert all(q.grad is None for q in tm.parameters())


def test_node_batch_norm_uses_the_population_variance():
    rng = np.random.default_rng(3)
    x = (3.0 + rng.standard_normal((4, 12, N, 5))).astype(np.float32)
    jm = jstgode.NodeBatchNorm(N)
    p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    tm = tstgode.NodeBatchNorm(N)
    tm.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()})
    _check_part(jm, tm, p, x, rng=rng)
    y = tstgode.NodeBatchNorm(N)(torch.tensor(x)).detach()
    torch.testing.assert_close(y.var(dim=(0, 1, 3), correction=0),
                               torch.ones(N), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dim_in", [1, 64])
def test_model_loss_and_grads_match_jax(dim_in):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 12, N, dim_in)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 1)).astype(np.float32)
    graphs = [_adj(5), _adj(6)]
    jm = jstgode.STGODE(cfg=jstgode.STGODEConfig(num_nodes=N),
                        dim_in=dim_in, dim_out=1, horizon=12, lag=12)
    params = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), x, *graphs))
    net = tstgode.STGODE(tstgode.STGODEConfig(num_nodes=N), dim_in=dim_in,
                         dim_out=1, horizon=12, lag=12)
    jgrads = assert_model_matches(jm, net, params, x, graphs, y, jit=False,
                                  against64=True)
    unused = [k for k, v in net.named_parameters() if v.grad is None]
    # the 3 convs (6 tensors) of every block's second TCN and of the
    # first TCN of each `_1` block; at dim_in 64 also of each `_0`
    # block's first TCN: 12 blocks in all
    assert len(unused) == (144 if dim_in == 64 else 108)
    assert all(".tcn." in k for k in unused)
    zero = [p for p, w in jgrads.items() if not w.any()]
    assert len(zero) == len(unused)


def test_convert_round_trips_with_the_unused_convs():
    for dim_in in (1, 64):
        jm = jstgode.STGODE(cfg=jstgode.STGODEConfig(num_nodes=N),
                            dim_in=dim_in, dim_out=1, horizon=12, lag=12)
        net = tstgode.STGODE(tstgode.STGODEConfig(num_nodes=N),
                             dim_in=dim_in, dim_out=1, horizon=12, lag=12,
                             generator=torch.Generator().manual_seed(0))
        assert_round_trip(net, jm, jnp.zeros((2, 12, N, dim_in)),
                          jnp.zeros((N, N)), jnp.zeros((N, N)))


@pytest.mark.parametrize("prefab", [False, True])
def test_builder_graphs_equal_jax(tmp_path, monkeypatch, prefab):
    """With `STGODE/PEMS08/PEMS08_{dtw,spatial}_distance.npy` under the
    data root (semantic: z-scored DTW distances through a gaussian
    kernel and a threshold; spatial: the same over the finite distances)
    and without them (`adj` and the DTW graph of the default series'
    daily profiles, cached under the working directory)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(7)
    if prefab:
        d = tmp_path / "data" / "STGODE" / "PEMS08"
        d.mkdir(parents=True)
        dtw = rng.random((N, N))
        sp = 100 * rng.random((N, N))
        sp[rng.random((N, N)) < 0.2] = np.inf
        np.save(d / "PEMS08_dtw_distance.npy", (dtw + dtw.T) / 2)
        np.save(d / "PEMS08_spatial_distance.npy", sp)
    a = (rng.random((N, N)) < 0.3).astype(np.float32)
    kw = dict(mode="ori", model="STGODE", num_nodes=N,
              data_root=str(tmp_path / "data"))
    _, apply_fn = jbuild._build_stgode(jax_default_config("PEMS08", **kw), 1,
                                       a)
    pred = tbuild.build_predictor(default_config("PEMS08", **kw), adj=a,
                                  device="cpu")
    for got, name in zip(pred.graph, ("adj_sp", "adj_se")):
        np.testing.assert_array_equal(got.numpy(),
                                      closure_array(apply_fn, name))


def test_cli_ori_eval_test_on_cpu(tmp_path, monkeypatch):
    """`python -m gptst_tpu_torch.run -mode ori|pretrain|eval|test -model
    STGODE -device cpu` at tiny widths; the test report equals eval's."""
    monkeypatch.chdir(tmp_path)
    cli_cycle(tmp_path, "PEMS08", "STGODE", [
        '--out_channels', '[4, 2, 4]', '--n_layers', '1'])


@pytest.mark.parametrize("model", ["STMGCN", "STFGNN", "STGODE"])
def test_builders_take_a_series_graph(tmp_path, monkeypatch, model):
    """`build_predictor(..., series_graph=s)` assembles the graphs from
    `adj` and `s` as the JAX package's functions do (STMGCN's Chebyshev
    stacks, STFGNN's fusion graph, STGODE's normalized pair), and reads
    neither a prefab nor the series; any other model refuses it."""
    from gptst_tpu.graph.artifacts import cheb_poly_stack_rescaled
    from gptst_tpu.models.predictors.stfgnn import construct_adj_fusion

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("gptst_tpu_torch.data.pipeline.load_raw_series",
                        lambda *a, **k: pytest.fail("series read"))
    for io_fn in ("load_stmgcn_prefabs", "load_stfgnn_fusion_prefab",
                  "load_stgode_prefabs"):
        monkeypatch.setattr(f"gptst_tpu_torch.graph.io.{io_fn}",
                            lambda *a, **k: pytest.fail("prefab read"))
    rng = np.random.default_rng(8)
    a, s = ((rng.random((N, N)) < 0.3).astype(np.float32) for _ in "as")
    dataset = "NYC_BIKE" if model == "STMGCN" else "PEMS08"
    cfg = default_config(dataset, mode="ori", model=model, num_nodes=N)
    pred = tbuild.build_predictor(cfg, adj=a, device="cpu", series_graph=s)
    want = {"STMGCN": lambda: [np.nan_to_num(np.stack([
                cheb_poly_stack_rescaled(a, 2),
                cheb_poly_stack_rescaled(s, 2)])).astype(np.float32)],
            "STFGNN": lambda: [construct_adj_fusion(a, s, 4)],
            "STGODE": lambda: [jstgode.stgode_normalized_adj(a),
                               jstgode.stgode_normalized_adj(s)]}[model]()
    assert len(pred.graph) == len(want)
    for got, w in zip(pred.graph, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w, np.float32))
    with pytest.raises(TypeError):
        tbuild.build_predictor(cfg.replace(model="ASTGCN"), adj=a,
                               device="cpu", series_graph=s)
