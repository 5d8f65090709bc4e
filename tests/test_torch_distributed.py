"""The data axis across processes: `gptst_tpu_torch/core/distributed.py`
and the data-parallel step and trainer over a process group.

Two processes (gloo on the CPU, the process group joined through a
FileStore in a temporary directory) run `tests/torch_distributed_child.py`,
which imports only the port; the test starts them with a deadline and
kills them past it. One spawn runs cases (b) to (g), each checked by its
own test while the one-process side is computed here:

  (a) without a process group: no group made, the coordinator, and
      `global_mesh` over 8 CPU ranks shaped as JAX's `global_mesh` on
      the conftest's 8 host devices;
  (b) a global (2, 1) mesh: `run_one_step` of `tests/test_torch_spmd.py`'s
      tiny GPT-ST pretrain (GPT-ST's mask meets across processes)
      against `gptst_tpu.parallel.spmd.run_one_step` on `make_mesh(2,
      graph_axis_size=1)`, at `test_run_one_step_matches_jax`'s
      tolerances;
  (c) a global (2, 2) mesh: one step of GWN (batch statistics, dropout)
      and of TGCN through a node-sharded support, and on a global
      (4, 1) mesh, two data rows in each process, of GPT-ST at its
      adaptive mask, against the port's one-process step on a mesh of
      the same shape (losses rtol 1e-5; gradients and parameters rtol
      1e-4 with an atol of 1e-5 of each tensor's largest entry);
  (d) the trainer under a global (2, 1) mesh with a ragged tail batch:
      every step's loss, the history, the report and the final
      parameters against the one-process (2, 1) trainer, the same early
      stop, and files from rank 0 alone;
  (f) the trainer of (d) at K = 4 (`scan_steps` 4): each process holds
      one data row of the global (2, 1) mesh, so each epoch's chunk of
      4 full batches goes through the runner (`train/step.StepGraph`,
      its body eager on the CPU) and the rest one step at a time; every
      step's losses as the epochs staged them (`Trainer._losses`), the
      history and the report against `gptst_tpu`'s jitted trainer on
      `make_mesh(2, graph_axis_size=1)` at `scan_steps` 4 (its indexed
      K-step dispatch; rtol 1e-4) and against the port's one-process
      (2, 1) trainer, which steps one at a time (rtol 1e-5);
  (g) GWN's trainer (batch statistics, dropout) at K = 4 the same way,
      every chunk under a dispatch mode that raises on a host read (as
      a CUDA graph capture would refuse one): against the one-process
      (2, 1) trainer (rtol 1e-5);
  (e) after (b) to (g), rank 1 raises in a forward: rank 0, waiting
      for it in a collective, fails too, within the deadline.

In (b) to (d), (f) and (g) both processes end with the same
parameters, bit for bit.
"""

import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gptst_tpu.config.config import default_config as jax_default_config
from gptst_tpu.core import distributed as jdist
from gptst_tpu.data.pipeline import build_dataset as jax_build_dataset
from gptst_tpu.models import build as jbuild
from gptst_tpu.parallel import mesh as jmesh
from gptst_tpu.parallel import spmd as jspmd
from gptst_tpu.train.loss import build_loss as jbuild_loss
from gptst_tpu.train.step import make_loss_terms as jmake_loss_terms
from gptst_tpu.train.trainer import Trainer as JTrainer
from gptst_tpu_torch.config.config import default_config
from gptst_tpu_torch.convert import state_dict_to_flax
from gptst_tpu_torch.core import (
    global_mesh, initialize_distributed, is_coordinator,
)
from gptst_tpu_torch.models.build import build_model
from gptst_tpu_torch.parallel.mesh import make_mesh
from torch_parity import assert_step_matches_jax, one_torch_thread
import torch_distributed_child as child

_ = one_torch_thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHILD = pathlib.Path(child.__file__)
# seconds the processes of one spawn may take in all (they take ~10)
DEADLINE = 120


class Spawn:
    """`world` processes of `torch_distributed_child.py CASES`, started
    at once; `wait()` joins them within DEADLINE, or kills them all and
    fails."""

    def __init__(self, cases: str, out: pathlib.Path, world: int = 2):
        self.out = out
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        for k in ("RANK", "WORLD_SIZE", "GPTST_NUM_PROCESSES"):
            env.pop(k, None)
        self.logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
        self.start = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, str(CHILD), cases, str(r), str(world),
             str(out / "store"), str(out)], cwd=out, env=env,
            stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]
        self.seconds = None

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()

    def wait(self) -> list[int]:
        """The return codes; kills every process past the deadline."""
        if self.seconds is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(
                        self.start + DEADLINE - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"the processes did not end within {DEADLINE} s")
            self.seconds = time.monotonic() - self.start
            self.kill()
        return [p.returncode for p in self.procs]

    def log(self, r: int) -> str:
        return (self.out / f"rank{r}.log").read_text()

    def results(self, key: str) -> list[dict]:
        """Each rank's results of `key`; fails with the logs where a
        process has none."""
        rcs = self.wait()
        got = [torch.load(path, weights_only=False) if path.exists()
               else {} for path in (self.out / f"rank{r}.pt"
                                    for r in range(len(rcs)))]
        assert all(key in g for g in got), "\n".join(
            self.log(r)[-3000:] for r in range(len(rcs)))
        return got


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Cases (b) to (g) in one spawn of two processes."""
    spawn = Spawn("steps,fail", tmp_path_factory.mktemp("steps"))
    yield spawn
    spawn.kill()


def _assert_ranks_equal(results: list[dict], key: str, field: str) -> None:
    first = results[0][key][field]
    for res in results[1:]:
        assert res[key][field].keys() == first.keys()
        for k, v in first.items():
            np.testing.assert_array_equal(res[key][field][k].numpy(),
                                          v.numpy(), err_msg=k)


def _assert_close(got: dict, want: dict, what: str) -> None:
    """rtol 1e-4 with an atol of 1e-5 of each tensor's largest entry;
    None (no gradient) where the other has None."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, (what, k)
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item(),
                                   err_msg=f"{what} {k}")


# --- (a) without a process group -------------------------------------------

@pytest.mark.parametrize("g", [None, 1, 2, 4])
def test_global_mesh_without_a_process_group_matches_jax(g, monkeypatch):
    for k in ("GPTST_NUM_PROCESSES", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed()
    assert not dist.is_initialized()
    assert is_coordinator() and jdist.is_coordinator()
    got = global_mesh(g, devices=["cpu"] * 8)
    want = jdist.global_mesh(g)
    assert got.shape == dict(want.shape)
    assert got.local_rows == want.shape["data"] and got.processes == 1
    assert got.data_offset == 0 and got.root == torch.device("cpu")


# --- (b) GPT-ST across two processes against JAX ---------------------------

def test_two_processes_step_matches_jax(steps, monkeypatch):
    cfg, model = child.pretrain_model()
    jcfg = jax_default_config("PEMS08", **child.PRETRAIN)
    params = state_dict_to_flax(model.gptst.state_dict())
    _, forward = jbuild.build_model(jcfg, scaler_zeros=0.0)
    x = child.pretrain_input()
    loss = jbuild_loss(jcfg.loss_func, 0.0, 1.0, jcfg.mape_thresh, True)
    terms = jmake_loss_terms(forward, loss, jcfg)
    epoch, count = jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32)
    jgrads = dict(jax.tree_util.tree_leaves_with_path(jax.jit(jax.grad(
        lambda p: terms(p, x, x, jax.random.PRNGKey(0), epoch, count)[0]
    ))(params)))
    stepped = []
    monkeypatch.setattr(jspmd.jax, "block_until_ready",
                        lambda t: stepped.append(t) or t)
    jlosses = jspmd.run_one_step(
        jcfg, jmesh.make_mesh(2, graph_axis_size=1), forward, params, x, x)
    results = steps.results("pretrain")
    for r, res in enumerate(results):
        assert res["mesh"] == ({"data": 2, "graph": 1}, r)
        got = res["pretrain"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
        assert_step_matches_jax(model, got["grads"], got["params"], jgrads,
                                stepped[0], cfg.lr_init)
    _assert_ranks_equal(results, "pretrain", "params")


# --- (c) GWN, TGCN and GPT-ST across two processes of two ranks each --------

@pytest.mark.parametrize("name", list(child.STEPS))
def test_two_processes_step_matches_one_process(steps, name):
    d, g = child.STEPS[name][-1]
    want = child.one_step(name, make_mesh(devices=["cpu"] * (2 * d * g),
                                          graph_axis_size=g))
    results = steps.results(name)
    for r, res in enumerate(results):
        got = res[name]
        assert got["mesh"] == ({"data": 2 * d, "graph": g}, r * d)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _assert_close(got["grads"], want["grads"], f"rank {r} grad")
        _assert_close(got["params"], want["params"], f"rank {r} param")
    _assert_ranks_equal(results, name, "params")


# --- (d) the trainer --------------------------------------------------------

def test_trainer_across_processes_matches_one_process(steps, tmp_path):
    want = child.train(make_mesh(devices=["cpu"] * 2, graph_axis_size=1),
                       str(tmp_path))
    epochs = child.TRAIN["epochs"]
    assert len(want["history"]) < epochs        # it stopped early
    results = steps.results("train")
    for r, res in enumerate(results):
        got = res["train"]
        assert len(got["losses"]) == len(want["losses"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert len(got["history"]) == len(want["history"])
        np.testing.assert_allclose(got["history"], want["history"],
                                   rtol=1e-5)
        for part in ("per_horizon", "average"):
            np.testing.assert_allclose(got["report"][part],
                                       want["report"][part], rtol=1e-4)
        _assert_close(got["state"], want["state"], f"rank {r} param")
        assert got["files"] == (want["files"] if r == 0 else [])
    assert want["files"] == ["best_model.pt", "full_ckpt.pt"]
    _assert_ranks_equal(results, "train", "state")


# --- (f), (g) K steps per dispatch across processes ------------------------

def _one_process_k4(kw: dict, seed: int) -> dict:
    """The port's one-process (2, 1) trainer of `kw`: its data rows are
    threads, so it steps one at a time."""
    want = child.train(make_mesh(devices=["cpu"] * 2, graph_axis_size=1),
                       None, kw, seed)
    assert not want["chunked"] and want["chunks"] == []
    return want


def _assert_chunked_runs(results: list[dict], key: str, want: dict,
                         chunks: int) -> None:
    """Each process's run of `key` took each epoch's chunk of 4 full
    batches through the runner and matches `want` (losses and history
    at rtol 1e-5, the report at 1e-4, the parameters at `_assert_close`),
    the ranks bit for bit."""
    for r, res in enumerate(results):
        got = res[key]
        assert got["chunked"] and got["chunks"] == [4] * chunks
        assert len(got["epoch_losses"]) == len(want["epoch_losses"])
        np.testing.assert_allclose(got["epoch_losses"],
                                   want["epoch_losses"], rtol=1e-5)
        np.testing.assert_allclose(got["history"], want["history"],
                                   rtol=1e-5)
        for part in ("per_horizon", "average"):
            np.testing.assert_allclose(got["report"][part],
                                       want["report"][part], rtol=1e-4)
        _assert_close(got["state"], want["state"], f"rank {r} param")
    _assert_ranks_equal(results, key, "state")


def test_trainer_chunks_across_processes_match_jax_and_one_process(steps):
    kw = child.TRAIN_K4
    jcfg = jax_default_config("PEMS08", **kw)
    jds = jax_build_dataset(jcfg, num_steps=child.NUM_STEPS, seed=jcfg.seed)
    jm = jmesh.make_mesh(2, graph_axis_size=1)
    _, forward = jbuild.build_model(jcfg, mesh=jm)
    net = build_model(default_config("PEMS08", **kw), device="cpu",
                      seed=4).predictor.net
    jtr = JTrainer(forward=forward, params=state_dict_to_flax(
        net.state_dict()), cfg=jcfg, dataset=jds, seed=jcfg.seed, mesh=jm)
    assert jtr._indexed_step is not None
    jlosses = []
    for name in ("_run_indexed", "_run_chunk"):
        def recording(*a, _fn=getattr(jtr, name)):
            out = _fn(*a)
            jlosses.extend(total for total, _ in out)
            return out
        setattr(jtr, name, recording)
    jres = jtr.train()
    want = _one_process_k4(kw, 4)
    np.testing.assert_allclose(want["epoch_losses"], jlosses, rtol=1e-4)
    results = steps.results("train_k4")
    _assert_chunked_runs(results, "train_k4", want, len(jres["history"]))
    for res in results:
        got = res["train_k4"]
        np.testing.assert_allclose(got["epoch_losses"], jlosses, rtol=1e-4)
        np.testing.assert_allclose(got["history"], jres["history"],
                                   rtol=1e-4)
        for part in ("per_horizon", "average"):
            np.testing.assert_allclose(got["report"][part],
                                       jres["report"][part], rtol=1e-4)


def test_gwn_chunks_across_processes_read_nothing_on_the_host(steps):
    t = torch.ones(2)
    for read in (lambda: t.sum().item(), lambda: float(t[0]),
                 lambda: torch.nonzero(t)):
        with pytest.raises(RuntimeError, match="host read"), \
                child.NoHostReads():
            read()
    want = _one_process_k4(child.GWN_K4, 0)
    _assert_chunked_runs(steps.results("gwn_k4"), "gwn_k4", want,
                         child.GWN_K4["epochs"])


# --- (e) a failing process --------------------------------------------------

def test_a_failing_process_fails_its_peer(steps):
    steps.results("gwn_k4")         # (b) to (g) ran before it
    rcs = steps.wait()
    assert "rank 1 fails" in steps.log(1)
    # rank 0 failed in the gather of the outputs, where it waited
    assert "rank 1 fails" not in steps.log(0) and "all_gather" in steps.log(0)
    assert rcs[0] != 0 and rcs[1] != 0, rcs
    assert steps.seconds < DEADLINE
