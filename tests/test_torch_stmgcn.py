"""The port's STMGCN (its LSTM stack, `MultiSupportGCN`, the builder's
support stacks and `convert.py`) against the JAX package's, on the CPU.

Weights: the JAX init with N(0, 0.1^2) noise on every leaf, carried over
by `convert.py`.

  * the LSTM stack (3 layers, hidden 64, zero carry, the last step of
    the last layer) against flax `nn.RNN(nn.OptimizedLSTMCell)`: values
    and every gradient rtol 1e-5, atol 1e-5 of each tensor's largest
    entry; remat "full" and "dots" equal to "none" bitwise;
  * `MultiSupportGCN`: values and gradients rtol 1e-5, atol 1e-6;
  * the whole model at published widths (LSTM 64 x 3, GCN 64, cheb_k
    2) on N = 16, dim_in 2 (NYC_BIKE) and 64 (eval mode): the loss rtol
    1e-5, the prediction and every gradient rtol 1e-4 with an atol of
    1e-5 of each tensor's largest entry;
  * the builder's (2, 3, N, N) stacks equal to JAX's, from the NYC
    prefab CSVs and without them; `convert.py` round trips; the init
    laws (orthogonal recurrent kernels, lecun-normal input kernels).
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import stmgcn as jstmgcn
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import _lstm_to_port, state_dict_to_flax
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors.stmgcn import (
    STMGCN, MultiSupportGCN, STMGCNConfig,
)
from gptst_tpu_torch.ops.recurrent import LSTMStack
from torch_parity import (
    assert_model_matches, assert_round_trip, cli_cycle, closure_array,
    noisy, one_torch_thread,
)

N = 16
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _FlaxStack(fnn.Module):
    hidden: int
    layers: int

    @fnn.compact
    def __call__(self, seq):
        h = seq
        for i in range(self.layers):
            h = fnn.RNN(fnn.OptimizedLSTMCell(self.hidden), name=f"l{i}")(h)
        return h[:, -1]


def test_lstm_stack_matches_flax_and_remat_changes_nothing():
    rng = np.random.default_rng(0)
    seq = rng.standard_normal((40, 12, 2)).astype(np.float32)
    g = rng.standard_normal((40, 64)).astype(np.float32)
    jm = _FlaxStack(64, 3)
    p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(seq)))

    @jax.jit
    def jvals(pp, s, gg):
        out, vjp = jax.vjp(jm.apply, pp, s)
        return out, *vjp(gg)

    jout, jgp, jgs = jvals(p, jnp.asarray(seq), jnp.asarray(g))
    net = LSTMStack(2, 64, 3)
    net.load_state_dict({
        f"{i}.{k}": torch.tensor(v) for i in range(3) for k, v in
        _lstm_to_port(p["params"][f"OptimizedLSTMCell_{i}"]).items()})
    outs = {}
    for remat in ("none", "full", "dots"):
        net.zero_grad()
        s = torch.tensor(seq, requires_grad=True)
        out = net(s, remat)
        out.backward(torch.tensor(g))
        outs[remat] = (out.detach(), s.grad,
                       [q.grad.clone() for q in net.parameters()])
    out, s_grad, grads = outs["none"]
    for remat in ("full", "dots"):
        assert torch.equal(outs[remat][0], out)
        assert torch.equal(outs[remat][1], s_grad)
        assert all(torch.equal(a, b) for a, b in zip(outs[remat][2], grads))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_allclose(s_grad.numpy(), np.asarray(jgs), rtol=1e-5,
                               atol=1e-5 * np.abs(jgs).max())
    for i, cell in enumerate(net):
        want = _lstm_to_port(jgp["params"][f"OptimizedLSTMCell_{i}"])
        for k, q in cell.named_parameters():
            np.testing.assert_allclose(q.grad.numpy(), want[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(want[k]).max(),
                                       err_msg=f"{i}.{k}")


def test_multi_support_gcn_matches_jax():
    rng = np.random.default_rng(1)
    sup = rng.standard_normal((3, N, N)).astype(np.float32)
    x = rng.standard_normal((4, N, 12)).astype(np.float32)
    g = rng.standard_normal((4, N, 8)).astype(np.float32)
    jm = jstmgcn.MultiSupportGCN(8)
    p = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), sup, x))

    @jax.jit
    def jvals(pp, a, gg):
        out, vjp = jax.vjp(lambda q, b: jm.apply(q, sup, b), pp, a)
        return out, *vjp(gg)

    jout, jgp, jgx = jvals(p, jnp.asarray(x), jnp.asarray(g))
    m = MultiSupportGCN(3, 12, 8)
    m.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()})
    xt = torch.tensor(x, requires_grad=True)
    out = m(torch.tensor(sup), xt)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    for k in ("W", "b"):
        np.testing.assert_allclose(getattr(m, k).grad.numpy(),
                                   np.asarray(jgp["params"][k]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dim_in", [2, 64])
def test_model_loss_and_grads_match_jax(dim_in):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 12, N, dim_in)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 2)).astype(np.float32)
    stacks = (0.3 * rng.standard_normal((2, 3, N, N))).astype(np.float32)
    cfg = dict(num_nodes=N)
    jm = jstmgcn.STMGCN(cfg=jstmgcn.STMGCNConfig(**cfg), dim_in=dim_in,
                        dim_out=2)
    net = STMGCN(STMGCNConfig(**cfg), dim_in=dim_in, dim_out=2,
                 generator=torch.Generator().manual_seed(0))
    # the port's init carried to JAX (a JAX init is one more compile)
    params = noisy(state_dict_to_flax(net.state_dict()))
    assert_model_matches(jm, net, params, x, [stacks], y)


def test_convert_round_trips():
    jm = jstmgcn.STMGCN(cfg=jstmgcn.STMGCNConfig(num_nodes=N), dim_in=2,
                        dim_out=2)
    net = STMGCN(STMGCNConfig(num_nodes=N), dim_in=2, dim_out=2,
                 generator=torch.Generator().manual_seed(0))
    assert_round_trip(net, jm, jnp.zeros((2, 12, N, 2)),
                      jnp.zeros((2, 3, N, N)))


@pytest.mark.parametrize("prefab", [False, True])
def test_builder_supports_equal_jax(tmp_path, prefab):
    """With the NYC prefab CSVs (`STMGCN_demand/{dis,pcc}_bb.csv`) and
    without them (`adj` and the Pearson graph of the default series'
    training split, cut to `num_nodes` columns)."""
    rng = np.random.default_rng(3)
    if prefab:
        d = tmp_path / "STMGCN_demand"
        d.mkdir()
        for name in ("dis_bb", "pcc_bb"):
            a = np.abs(rng.standard_normal((N, N)))
            np.savetxt(d / f"{name}.csv", (a + a.T) / 2, delimiter=",")
    kw = dict(mode="ori", model="STMGCN", num_nodes=N,
              data_root=str(tmp_path))
    adj = (rng.random((N, N)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    _, apply_fn = jbuild._build_stmgcn(
        jax_default_config("NYC_BIKE", **kw), 2, adj)
    want = closure_array(apply_fn, "stacks")
    pred = tbuild.build_predictor(default_config("NYC_BIKE", **kw), adj=adj,
                                  device="cpu")
    assert want.shape == (2, 3, N, N)
    np.testing.assert_array_equal(pred.graph[0].numpy(), want)


def test_init_laws():
    net = STMGCN(STMGCNConfig(num_nodes=N, lstm_hidden_dim=256),
                 dim_in=512, dim_out=2,
                 generator=torch.Generator().manual_seed(0)).requires_grad_(
                     False)
    cell = net.cg_lstm[0].lstm[0]
    for g in cell.weight_hh.detach().split(256):
        torch.testing.assert_close(g @ g.T, torch.eye(256), atol=1e-4,
                                   rtol=0)
    assert abs(float(cell.weight_ih.std()) * np.sqrt(512) - 1) < 0.02
    assert not cell.bias_hh.any()
    w = net.gcn[0].W            # xavier normal (3 * 256, 64)
    assert abs(float(w.std()) * np.sqrt((768 + 64) / 2) - 1) < 0.03


def test_cli_ori_eval_test_on_cpu(tmp_path, monkeypatch):
    """`python -m gptst_tpu_torch.run -mode ori|pretrain|eval|test -model
    STMGCN -device cpu` at tiny widths; the test report equals eval's."""
    monkeypatch.chdir(tmp_path)
    cli_cycle(tmp_path, "NYC_BIKE", "STMGCN", [
        '--lstm_hidden_dim', '4', '--gcn_hidden_dim', '4',
        '--lstm_num_layers', '2'])
