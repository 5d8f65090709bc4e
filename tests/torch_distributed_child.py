"""One process of `tests/test_torch_distributed.py`'s multi-process runs:
gloo on the CPU, the process group joined through a FileStore.

    python tests/torch_distributed_child.py CASES RANK WORLD STORE OUT

It imports `gptst_tpu_torch` and never JAX, as on a GPU host, runs the
comma-separated CASES in order on `global_mesh(...)` and writes what
they computed to OUT/rank<RANK>.pt after each. The test module imports
the same functions to run the one-process side.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gptst_tpu_torch.config.config import default_config  # noqa: E402
from gptst_tpu_torch.core.distributed import (  # noqa: E402
    global_mesh, initialize_distributed,
)
from gptst_tpu_torch.data.pipeline import build_dataset  # noqa: E402
from gptst_tpu_torch.models.build import build_model  # noqa: E402
from gptst_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from gptst_tpu_torch.parallel.spmd import run_one_step  # noqa: E402
from gptst_tpu_torch.train.loss import build_loss  # noqa: E402
from gptst_tpu_torch.train.step import (  # noqa: E402
    make_loss_terms, model_forwards, train_step,
)
from gptst_tpu_torch.train.trainer import ClippedAdam, Trainer  # noqa: E402

# (b): `tests/test_torch_spmd.py`'s tiny GPT-ST pretrain (every point
# masked), its x from numpy
PRETRAIN = dict(mode="pretrain", model="STGCN", num_nodes=16, batch_size=8,
                epochs=20, change_epoch=1, mask_ratio=1.0, log_dir=None)
# (c): name -> (dataset, mode, model, overrides, nodes, batch, each
# process's (data, graph) mesh)
STEPS = {
    "gwn": ("PEMS08", "ori", "GWN", (("nhid", "4"),), 12, 8, (1, 2)),
    "tgcn_sharded": ("PEMS08", "ori", "TGCN", (("rnn_units", "8"),), 130,
                     8, (1, 2)),
    # two data rows in each process: GPT-ST's mask (adaptive branch, KL
    # term) from the global guide
    "gptst_rows": ("PEMS08", "pretrain", "STGCN", (), 12, 8, (2, 1)),
}
GPTST_SMALL = dict(hidden_dim=16, embed_dim=8, embed_dim_spa=4, HS=4, HT=6,
                   HT_Tem=4, change_epoch=1, epochs=4)
# (d): TGCN at 20 nodes; 109 training windows, so batch 16 leaves a
# ragged tail of 13 that runs whole on every process. From the weights
# of seed 4 the validation loss rises at epoch 3 (20.83, then 21.04):
# the run stops early there, one epoch before its last
TRAIN = dict(mode="ori", model="TGCN", num_nodes=20, batch_size=16,
             epochs=4, lr_init=0.03, lr_decay=False, early_stop=True,
             early_stop_patience=1, ckpt_every_epochs=1, debug=False,
             log_step=1000, predictor_overrides=(("rnn_units", "8"),))
NUM_STEPS = 220
# (f): TRAIN at K = 4: each epoch's one chunk of 4 full batches goes
# through the runner (`StepGraph`, its body eager on the CPU), the 2
# full batches left and the ragged tail one step at a time
TRAIN_K4 = dict(TRAIN, scan_steps=4)
# (g): GWN (batch statistics, dropout) at K = 4, 2 epochs
GWN_K4 = dict(mode="ori", model="GWN", num_nodes=12, batch_size=16,
              epochs=2, scan_steps=4, lr_decay=False, early_stop=False,
              debug=False, log_step=1000, predictor_overrides=(("nhid", "4"),))


def pretrain_model():
    cfg = default_config("PEMS08", **PRETRAIN)
    return cfg, build_model(cfg, device="cpu", seed=0, scaler_zeros=0.0)


def pretrain_input() -> np.ndarray:
    return np.random.default_rng(3).standard_normal(
        (8, 12, 16, 3)).astype(np.float32)


def pretrain_step(mesh) -> dict:
    """(b) `run_one_step` of the tiny GPT-ST under `mesh`: the losses,
    the step's gradients and the parameters after it."""
    cfg, model = pretrain_model()
    x = pretrain_input()
    total, flow = run_one_step(cfg, mesh, model, x, x)
    return {"losses": (total, flow),
            "grads": {k: p.grad for k, p in model.gptst.named_parameters()},
            "params": model.gptst.state_dict()}


def step_mesh(name: str):
    """Each process's global mesh of STEPS[name]."""
    d, g = STEPS[name][-1]
    return global_mesh(g, devices=["cpu"] * (d * g))


def one_step(name: str, mesh) -> dict:
    """(c) One `ClippedAdam` step of STEPS[name] under `mesh` (dropout
    and batch statistics for GWN, a node-sharded support for TGCN,
    GPT-ST's mask at epoch 3), the generator seeded 11: the losses,
    gradients and parameters."""
    ds, mode, model_name, ov, n, b, _ = STEPS[name]
    pretrain = mode == "pretrain"
    cfg = default_config(ds, mode=mode, model=model_name, num_nodes=n,
                         batch_size=b, predictor_overrides=ov,
                         **(GPTST_SMALL if pretrain else {}))
    model = build_model(cfg, device="cpu", seed=0, scaler_zeros=-0.5,
                        mesh=mesh)
    rng = np.random.default_rng(1)
    x, y = (torch.tensor(rng.standard_normal(
        (b, 12, n, cfg.input_base_dim + 2)).astype(np.float32))
        for _ in range(2))
    terms = make_loss_terms(model, build_loss(cfg.loss_func, 0.0, 1.0,
                                              cfg.mape_thresh, pretrain),
                            cfg, forward=model_forwards(model, cfg, mesh)[1])
    opt = ClippedAdam(model.parameters(), lambda count: cfg.lr_init)
    total, flow = train_step(terms, opt, x, y, 3,
                             generator=torch.Generator().manual_seed(11),
                             **({"epoch": 3} if pretrain else {}))
    return {"losses": (float(total), float(flow)),
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "params": model.state_dict()}


class NoHostReads(TorchDispatchMode):
    """Raises on an op that reads the device on the host or sizes its
    output by the data (what a CUDA graph capture refuses)."""

    READS = {"_local_scalar_dense", "nonzero", "bincount", "unique",
             "masked_select"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.READS:
            raise RuntimeError(f"a host read inside a chunk: {func}")
        return func(*args, **(kwargs or {}))


def train(mesh, log_dir: str | None, kw: dict = TRAIN, seed: int = 4,
          watch: bool = False) -> dict:
    """(d), (f), (g) The trainer of `kw` under `mesh`: every one-step
    batch's loss (`_train_batch`), every step's losses as the epochs
    staged them (`_losses`), the history (its length the early-stop
    epoch), the test report, the final parameters, the files written
    to `log_dir`, whether the chunks went through the runner and the
    steps they took there. With `watch`, every chunk runs under
    `NoHostReads`."""
    cfg = default_config("PEMS08", **kw)
    ds = build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    model = build_model(cfg, device="cpu", seed=seed, mesh=mesh)
    tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                 log_dir=log_dir, device="cpu", mesh=mesh)
    losses, epochs, chunks = [], [], []
    batch, train_epoch, train_steps = (tr._train_batch, tr.train_epoch,
                                       tr._train_steps)

    def recording(*a):
        out = batch(*a)
        losses.append(out[0])
        return out

    def epoch(e):
        out = train_epoch(e)
        epochs.append(tr._losses[:, 0].clone())
        return out

    def steps(batches, *a):
        chunks.append(len(batches))
        with NoHostReads() if watch else contextlib.nullcontext():
            return train_steps(batches, *a)

    tr._train_batch, tr.train_epoch, tr._train_steps = recording, epoch, steps
    res = tr.train()
    return {"losses": [float(v) for v in losses],
            "epoch_losses": [float(v) for e in epochs for v in e],
            "history": res["history"], "report": res["report"],
            "state": model.state_dict(), "chunked": tr.chunked,
            "chunks": chunks,
            "files": sorted(os.listdir(log_dir)) if log_dir else []}


def case_steps(rank: int, out: str) -> dict:
    mesh = global_mesh(1, devices=["cpu"])
    log_dir = os.path.join(out, f"log{rank}")
    os.makedirs(log_dir)
    res = {"pretrain": pretrain_step(mesh), "train": train(mesh, log_dir),
           "train_k4": train(mesh, None, TRAIN_K4),
           "gwn_k4": train(mesh, None, GWN_K4, seed=0, watch=True)}
    for name in STEPS:
        m = step_mesh(name)
        res[name] = {**one_step(name, m), "mesh": (m.shape, m.data_offset)}
    res["mesh"] = (mesh.shape, mesh.data_offset)
    return res


def case_oom(rank: int, out: str) -> dict:
    """(h) TRAIN's trainer for one epoch on a global (2, 2) mesh (each
    process one data row of two graph ranks): with the train split
    resident, each rank holding its nodes, then with rank 1's devices
    out of memory where the split is placed. Whether each run was
    resident, and its per-step losses."""
    cfg = default_config("PEMS08", **dict(TRAIN, epochs=1))
    ds = build_dataset(cfg, num_steps=NUM_STEPS, seed=cfg.seed)
    resident, losses, put = [], [], tmesh.put_array

    def short(a, device):
        raise torch.OutOfMemoryError("out of memory")

    for oom in (False, True):
        mesh = global_mesh(2, devices=["cpu"] * 2)
        model = build_model(cfg, device="cpu", seed=4, mesh=mesh)
        if oom and rank == 1:
            tmesh.put_array = short
        try:
            tr = Trainer(model=model, cfg=cfg, dataset=ds, seed=cfg.seed,
                         device="cpu", mesh=mesh)
        finally:
            tmesh.put_array = put
        tr.train_epoch(1)
        resident.append(tr.train_split is not None)
        losses.append(tr._losses[:, 0].tolist())
    return {"oom": {"resident": resident, "losses": losses}}


def case_fail(rank: int, out: str) -> dict:
    """Rank 1 raises in its forward; rank 0 waits for it in the
    gather of the outputs until the process group fails."""
    mesh = global_mesh(1, devices=["cpu"])
    _, _, model_name, ov, n, b, _ = STEPS["tgcn_sharded"]
    cfg = default_config("PEMS08", mode="ori", model=model_name,
                         num_nodes=n, batch_size=b, predictor_overrides=ov)
    model = build_model(cfg, device="cpu", seed=0, mesh=mesh)
    if rank == 1:
        def boom(*_):
            raise FloatingPointError("rank 1 fails")
        model.register_forward_pre_hook(boom)
    _, forward = model_forwards(model, cfg, mesh)
    forward(torch.zeros(b, 12, n, 3))
    return {}


CASES = {"steps": case_steps, "oom": case_oom, "fail": case_fail}


def main(cases: str, rank: int, world: int, store: str, out: str) -> int:
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, backend="gloo",
                           timeout=60)
    result = {}
    for case in cases.split(","):
        result.update(CASES[case](rank, out))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    assert not {m.split(".")[0] for m in sys.modules} & {"jax", "gptst_tpu"}
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    cases, rank, world, store, out = sys.argv[1:]
    sys.exit(main(cases, int(rank), int(world), store, out))
