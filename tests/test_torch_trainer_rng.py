"""The test report's generator, against `gptst_tpu`'s trainer.

`gptst_tpu`'s `Trainer.test` splits `PRNGKey(seed + 777)` once per batch
and hands the key to the forward in every mode
(`gptst_tpu/train/trainer.py:388-394`), and its GWN and MTGNN builders
run dropout whenever they get a key (`gptst_tpu/models/build.py:555-557,
621-623`): their test reports are computed with dropout on. The port's
`Trainer.test` hands the forward one generator seeded with `seed + 777`
in every mode (the draws cannot be JAX's threefry bits; which calls get
one is what is held).

On 12 nodes, with the port's init carried to JAX by `convert.py` (the
JAX init runs op by op, ~7 s here): each
package's `-mode ori` test report (per horizon and average MAE, RMSE,
MAPE, CORR) at dropout 0.3 is more than 1e-3 (relative) from its report
at dropout 0, where rounding alone moves it by ~1e-6; at dropout 0 the
two packages' reports agree (rtol 1e-4, atol 1e-5: the same weights
and windows, f32 sums in another order); two calls of the port's
`test()` give equal reports.
"""

import numpy as np
import pytest
import torch

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.models import build as jbuild
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import state_dict_to_flax
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models import build as tbuild
from gptst_tpu_torch.train.trainer import Trainer
from torch_parity import one_torch_thread

_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_STEPS = 200
CFG = dict(mode="ori", num_nodes=12, batch_size=64, early_stop=False,
           debug=False, log_step=1000)
NARROW = {"GWN": dict(blocks=1, nhid=4, residual_channels=8,
                      dilation_channels=8, skip_channels=16,
                      end_channels=16),
          "MTGNN": dict(layers=1, subgraph_size=6, conv_channels=8,
                        residual_channels=8, skip_channels=16,
                        end_channels=16)}


def _cfg(default, model, dropout):
    return default("PEMS08", model=model, **CFG, predictor_overrides=tuple(
        (k, str(v)) for k, v in dict(NARROW[model], dropout=dropout).items()))


def _metrics(report) -> np.ndarray:
    return np.asarray(report["per_horizon"] + [report["average"]],
                      np.float64)


@pytest.mark.parametrize("model", ["GWN", "MTGNN"])
def test_test_report_runs_dropout_as_the_jax_trainer_does(model):
    sd, port = None, {}
    for rate in (0.3, 0.0):
        cfg = _cfg(default_config, model, rate)
        net = tbuild.build_model(cfg, device="cpu")
        if sd is None:
            sd = net.predictor.net.state_dict()
        net.predictor.net.load_state_dict(sd)
        tr = Trainer(model=net, cfg=cfg, seed=cfg.seed, device="cpu",
                     dataset=build_dataset(cfg, num_steps=NUM_STEPS,
                                           seed=cfg.seed))
        port[rate] = _metrics(tr.test())
        if rate:
            assert np.array_equal(_metrics(tr.test()), port[rate])
    params, jax_reports = state_dict_to_flax(sd), {}
    for rate in (0.3, 0.0):
        cfg = _cfg(jax_default_config, model, rate)
        _, forward = jbuild.build_model(cfg)
        ds = jax_build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
        jax_reports[rate] = _metrics(JTrainer(
            forward=forward, params=params, cfg=cfg, dataset=ds,
            seed=cfg.seed).test())
    for reports in (jax_reports, port):
        rel = np.abs(reports[0.3] - reports[0.0]) / np.abs(reports[0.0])
        assert rel.max() > 1e-3, reports
    np.testing.assert_allclose(port[0.0], jax_reports[0.0], rtol=1e-4,
                               atol=1e-5)
    assert np.isfinite(port[0.3]).all()
