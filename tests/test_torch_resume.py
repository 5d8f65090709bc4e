"""Kill-and-resume in the port, port against port (`tests/test_resume.py`
holds the JAX package the same way): a run interrupted after a periodic
checkpoint and resumed reproduces the uninterrupted history (rtol
1e-6), and the restored bookkeeping is the saved one."""

import json

import numpy as np
import pytest
import torch

from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.data.pipeline import build_dataset
from gptst_tpu_torch.models.build import build_model
from gptst_tpu_torch.train.trainer import Trainer, make_optimizer


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


def _make(tmp_path, epochs, ckpt_every, model="STGCN"):
    cfg = default_config(
        "PEMS08", mode="ori", model=model, num_nodes=12, batch_size=8,
        epochs=epochs, lr_decay=True, lr_decay_step=(3,), early_stop=False,
        debug=True, log_step=10_000, ckpt_every_epochs=ckpt_every)
    ds = build_dataset(cfg, num_steps=260, seed=5)
    return Trainer(model=build_model(cfg, device="cpu"), cfg=cfg, dataset=ds,
                   seed=cfg.seed, log_dir=str(tmp_path), device="cpu")


def test_kill_and_resume_reproduces_trajectory(tmp_path):
    (tmp_path / "straight").mkdir()
    full = _make(tmp_path / "straight", epochs=6, ckpt_every=0).train()
    assert len(full["history"]) == 6

    # checkpoint every 2 epochs, "die" after epoch 4
    kill = tmp_path / "killed"
    kill.mkdir()
    part1 = _make(kill, epochs=4, ckpt_every=2).train()["history"]
    assert len(part1) == 4 and (kill / "full_ckpt.pt").exists()
    # a fresh trainer and a fresh init, resumed: trains epochs 5 and 6
    second = _make(kill, epochs=6, ckpt_every=2)
    part2 = second.train(resume=True)
    assert len(part2["history"]) == 2
    np.testing.assert_allclose(part1 + part2["history"], full["history"],
                               rtol=1e-6)
    np.testing.assert_allclose(part2["best_loss"], full["best_loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(part2["report"]["average"],
                               full["report"]["average"], rtol=1e-6)


def test_resume_restores_best_bookkeeping(tmp_path):
    t = _make(tmp_path, epochs=3, ckpt_every=1)
    res = t.train()
    t2 = _make(tmp_path, epochs=3, ckpt_every=1)
    start = t2.restore_full_checkpoint(str(tmp_path / "full_ckpt.pt"))
    assert start == 4
    assert np.isfinite(t2._best_loss) and t2._best_loss == res["best_loss"]
    assert t2.batch_seen == t.batch_seen > 0
    assert t2.optimizer.count == t.optimizer.count == t.batch_seen
    # the restored best state differs from a fresh init
    fresh = _make(tmp_path, epochs=1, ckpt_every=0).model.state_dict()
    k = next(iter(fresh))
    assert not torch.equal(t2._best_state[k], fresh[k])
    for k, v in t.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[k], v), k


def test_optimizer_state_round_trips():
    w = torch.nn.Parameter(torch.randn(5))
    opt = make_optimizer(default_config("PEMS08"), [w], steps_per_epoch=2)
    for _ in range(3):
        opt.zero_grad()
        (w ** 2).sum().backward()
        opt.step()
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = make_optimizer(default_config("PEMS08"), [w2], steps_per_epoch=2)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 3
    for o, p in ((opt, w), (opt2, w2)):
        o.zero_grad()
        (p ** 2).sum().backward()
        o.step()
    assert torch.equal(w, w2)


def test_cli_resume(tmp_path):
    """`-ckpt_every_epochs` and `-resume True` through `run.main`, TGCN:
    a 2-epoch run resumed to 3 epochs gives the straight 3-epoch
    history."""
    from gptst_tpu_torch.run import main

    def flags(log_dir, epochs, out, extra=()):
        return ["-dataset", "PEMS08", "-mode", "ori", "-model", "TGCN",
                "-num_nodes", "12", "-epochs", str(epochs), "-batch_size",
                "16", "-num_steps", "200", "--rnn_units", "4", "-device",
                "cpu", "-log_dir", str(log_dir), "-metrics_out", str(out),
                "-ckpt_every_epochs", "1", *extra]

    assert main(flags(tmp_path / "a", 3, tmp_path / "a.json")) == 0
    assert main(flags(tmp_path / "b", 2, tmp_path / "b1.json")) == 0
    assert main(flags(tmp_path / "b", 3, tmp_path / "b2.json",
                      ("-resume", "True"))) == 0
    a, b1, b2 = (json.loads((tmp_path / f).read_text())
                 for f in ("a.json", "b1.json", "b2.json"))
    assert len(b2["history"]) == 1
    np.testing.assert_allclose(b1["history"] + b2["history"], a["history"],
                               rtol=1e-6)
