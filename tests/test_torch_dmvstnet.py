"""The port's DMVSTNET against the JAX package's, on the CPU.

Weights: the port's init with N(0, 0.1^2) noise on every leaf (Dense
biases start at zero), carried to JAX by `convert.py`.

  * the whole model at published widths (hidden 64, so an LSTM 128
    wide, topo 16) on N = 12, dim_out 2, at dim_in 2 (NYC_BIKE) and 64
    (eval mode's fused embedding), on a raw 0/1 adjacency: the loss rtol
    1e-5, the prediction and every gradient rtol 1e-4 with an atol of
    1e-5 of each tensor's largest entry plus twice JAX's own f32
    distance from its float64 run; in float64 the port at rtol 1e-9 of
    JAX (`torch_parity`). flax's `nn.RNN` makes its carry in the cell's
    `param_dtype`, float32, which a float64 scan refuses, so for these
    runs the test makes the (zero) carry in the input's precision;
  * the builder's adjacency equal to JAX's (`load_base_adjacency`'s
    matrix as it is, not row-normalized); `convert.py` both ways, bare
    and under the eval-mode tree (`predictor.net.*`); the init laws; one CLI cycle on NYC_BIKE (ori, pretrain, eval, test at
    tiny widths).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.models import build as jbuild
from gptst_tpu.models.predictors import dmvstnet as jdmv
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.models.predictors.dmvstnet import (
    DMVSTNet, DMVSTNetConfig,
)
from torch_parity import (
    assert_model_matches, assert_round_trip, cli_cycle, closure_array, noisy,
    one_torch_thread,
)

N = 12
_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def carry_in_input_precision(monkeypatch):
    init = fnn.OptimizedLSTMCell.initialize_carry

    def initialize_carry(self, rng, input_shape):
        return jax.tree.map(lambda c: c.astype(jnp.result_type(float)),
                            init(self, rng, input_shape))

    monkeypatch.setattr(fnn.OptimizedLSTMCell, "initialize_carry",
                        initialize_carry)


@pytest.mark.usefixtures("carry_in_input_precision")
@pytest.mark.parametrize("dim_in", [2, 64])
def test_model_loss_and_grads_match_jax(dim_in):
    rng = np.random.default_rng(dim_in)
    x = rng.standard_normal((3, 12, N, dim_in)).astype(np.float32)
    y = rng.standard_normal((3, 12, N, 2)).astype(np.float32)
    adj = (rng.random((N, N)) < 0.3).astype(np.float32)
    jm = jdmv.DMVSTNet(cfg=jdmv.DMVSTNetConfig(num_nodes=N), dim_in=dim_in,
                       dim_out=2)
    net = DMVSTNet(DMVSTNetConfig(num_nodes=N), dim_in=dim_in, dim_out=2,
                   generator=torch.Generator().manual_seed(0))
    params = noisy(state_dict_to_flax(net.state_dict()))
    assert_model_matches(jm, net, params, x, [adj], y, against64=True)


def test_convert_round_trips():
    jm = jdmv.DMVSTNet(cfg=jdmv.DMVSTNetConfig(num_nodes=N), dim_in=2,
                       dim_out=2)
    net = DMVSTNet(DMVSTNetConfig(num_nodes=N), dim_in=2, dim_out=2,
                   generator=torch.Generator().manual_seed(0))
    assert_round_trip(net, jm, jnp.zeros((2, 12, N, 2)), jnp.zeros((N, N)))


def test_eval_mode_tree_round_trips():
    """`build_model` in eval mode on NYC_BIKE: the predictor at dim_in =
    hidden_dim under `predictor.net.`, the enhanced tree both ways."""
    cfg = default_config("NYC_BIKE", mode="pretrain", num_nodes=N,
                         hidden_dim=8, embed_dim=4, HS=3, HT=4, HT_Tem=2,
                         change_epoch=1)
    gpt = tbuild.build_model(cfg, device="cpu")
    model = tbuild.build_model(cfg.replace(mode="eval", model="DMVSTNET"),
                               device="cpu", pretrain_params=gpt.gptst)
    assert model.predictor.net.lin_in_spa.in_features == 8
    sd = model.state_dict()
    tree = state_dict_to_flax(sd)
    assert set(tree) == {"head", "predictor"}
    assert tree["predictor"]["params"]["OptimizedLSTMCell_0"]["ii"][
        "kernel"].shape == (128, 128)
    back = flax_to_state_dict(tree)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    assert model(torch.randn(2, 12, N, 4)).pred.shape == (2, 12, N, 2)


def test_builder_passes_the_raw_adjacency():
    """Both builders hand the network `load_base_adjacency`'s matrix as
    it is: rows do not sum to 1."""
    kw = dict(mode="ori", model="DMVSTNET", num_nodes=N)
    adj = np.abs(np.random.default_rng(3).standard_normal(
        (N, N))).astype(np.float32)
    _, apply_fn = jbuild._build_dmvstnet(
        jax_default_config("NYC_BIKE", **kw), 2, adj)
    want = closure_array(apply_fn, "adj_j")
    pred = tbuild.build_predictor(default_config("NYC_BIKE", **kw), adj=adj,
                                  device="cpu")
    np.testing.assert_array_equal(pred.graph[0].numpy(), want)
    np.testing.assert_array_equal(want, adj)


def test_init_laws():
    """flax's laws: lecun-normal Dense kernels, zero biases, xavier
    uniform `node_embeddings` (N, E) and `w` (E, h, h) with flax's fans
    (h * E each way for `w`)."""
    net = DMVSTNet(DMVSTNetConfig(num_nodes=512), dim_in=256, dim_out=2,
                   generator=torch.Generator().manual_seed(0)).requires_grad_(
                       False)
    w = net.lin_in_spa.weight       # (64, 256)
    assert abs(float(w.std()) * 16 - 1) < 0.03
    assert not net.lin_in_spa.bias.any() and not net.output.bias.any()
    emb, pool = net.node_embeddings, net.w
    lim = np.sqrt(6 / (512 + 16))
    assert float(emb.abs().max()) <= lim
    assert abs(float(emb.std()) * np.sqrt(3) / lim - 1) < 0.03
    lim = np.sqrt(6 / (2 * 64 * 16))
    assert float(pool.abs().max()) <= lim
    assert abs(float(pool.std()) * np.sqrt(3) / lim - 1) < 0.03


def test_cli_ori_eval_test_on_cpu(tmp_path):
    """`python -m gptst_tpu_torch.run -dataset NYC_BIKE -mode
    ori|pretrain|eval|test -model DMVSTNET -device cpu` at tiny widths;
    the test report equals eval's."""
    cli_cycle(tmp_path, "NYC_BIKE", "DMVSTNET", [
        "--hidden_dim", "4", "--topo_embedded_dim", "4"])
