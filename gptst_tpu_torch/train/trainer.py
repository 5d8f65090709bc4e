"""Training loop for the ori, eval and pretrain modes (and the test
report of `-mode test`).

The JAX package's `train/trainer.py` behaviour, step for step:
  - batch order: the permutation
    `np.random.default_rng(seed * 10_000 + epoch).shuffle(arange(n))`
    cut into consecutive `batch_size` slices, ragged tail last (the
    JAX trainer's indexed, scan-fused and host paths all give this
    sequence);
  - the device-resident train split: with `cfg.device_data` and K
    above 1 (K = `cfg.scan_steps`, 16 where it is 0: the defaults),
    the train split's x and y are put on the trainer's device once, at
    construction (`train_split`), and each step gathers its batch from
    them with `index_select` by the epoch's order, copied to the device
    once per epoch, so no train batch crosses from the host. Otherwise
    (`scan_steps` 1, `device_data` False, or a split the device cannot
    hold: a `torch.OutOfMemoryError` at placement, logged with the
    split's bytes) every train batch is gathered on the host and
    copied at its step. Both paths give the same batches, values and
    order; validation and test always batch on the host. Unlike the
    JAX trainer's K steps per dispatch, every step is one dispatch;
  - optimizer: `optax.chain(clip_by_global_norm(max_grad_norm),
    adam(schedule, eps=1e-8))`, written out (`ClippedAdam`), with the
    MultiStepLR milestones as a piecewise-constant schedule on the
    optimizer's step count;
  - validation every epoch, best parameters by val loss, `up_epoch`
    watermark resets, divergence abort at a train loss above 1e6,
    early stopping, and the per-horizon test report
    (`model/BasicTrainer.py:130-248`);
  - pretrain (GPT-ST): each epoch's mask draws come from a generator
    seeded with `seed * 10_000 + epoch`; no validation pass, the best
    epoch is the one with the lowest mean train flow loss; the final
    report is on the train split, the mask drawn at epoch `cfg.epochs`
    (the adaptive branch) from a generator seeded with `seed + 777`,
    predictions and labels multiplied by it;
  - ori and eval: each epoch's generator (seeded the same way) reaches
    the predictor for its dropout, ST_WA's latent draws and CCRNN's
    teacher-forcing coins; validation passes none; the test report
    passes one generator seeded with `seed + 777` in every mode (the
    JAX trainer splits a key of that seed once per batch and hands it
    to the forward in every mode), so GWN's and MTGNN's dropout and
    ST_WA's draws run at test, as in the JAX package;
  - the step count a predictor reads (CCRNN's scheduled sampling):
    batch by batch the count the JAX trainer's default dispatch passes
    (`jax_step_counts`), not the number of steps taken.

With a `mesh` (`parallel/mesh.make_mesh`) the trainer is data-parallel,
as the JAX trainer is under GSPMD: the parameters and the optimizer
stay whole on `mesh.root` (`shard_params`), and every train, val and
test batch is split over the data rows (`shard_batch`; a ragged tail
runs whole on row 0) by `parallel/spmd.DataParallel`, whose step is the
one-device step's math. The test report gathers the predictions in
batch order. The generators, the batch order and the step counts do not
change, and checkpoints hold the root's parameters, so they load into a
one-device trainer and back.

With a mesh whose 'data' axis spans processes (`core/distributed.
global_mesh`), every process runs this loop on the same dataset and
batch order, its rows taking their slice of each global batch; every
process's train step, validation and test see the global batch's
outputs (`parallel/spmd.DataParallel` gathers them), and the epoch's
decisions (best model, early stop, divergence) use the coordinator's
losses, broadcast, so every process decides alike. Only the coordinator
logs and writes `best_model.pt` and `full_ckpt.pt`; every process waits
at a barrier after a write and before `resume` reads, so every process
must be given the same `log_dir` (a shared file system across hosts).

Best parameters are saved with `torch.save` to `<log_dir>/best_model.pt`
when `log_dir` is set. Every `ckpt_every_epochs` epochs the full state
(the model's `state_dict`, `ClippedAdam`'s state and step count, the
best state and `{epoch, batch_seen, best_loss, not_improved}`) goes to
`<log_dir>/full_ckpt.pt` in one `torch.save`; `train(resume=True)`
restarts from it at the next epoch. The batch order and the generators
are seeded per epoch, so a resumed run reproduces the uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.core.distributed import is_coordinator
from gptst_tpu_torch.data.pipeline import STDataset
from gptst_tpu_torch.eval.metrics import all_metrics
from gptst_tpu_torch.parallel import collectives
from gptst_tpu_torch.parallel.mesh import normalize_device
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import (
    make_loss_terms, model_forwards, train_step,
)
from gptst_tpu_torch.utils.device import resolve_device
from gptst_tpu_torch.utils.logger import get_logger
from gptst_tpu_torch.utils.observability import StepTimer


def make_lr_schedule(cfg: FrameworkConfig,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR as optax's `piecewise_constant_schedule`: the rate
    multiplies in once the step count reaches `m * steps_per_epoch`
    (in f32, as optax computes it)."""
    milestones = (sorted(int(m) * steps_per_epoch for m in cfg.lr_decay_step)
                  if cfg.lr_decay and cfg.lr_decay_step else [])
    rate = np.float32(cfg.lr_decay_rate)

    def schedule(count: int) -> float:
        v = np.float32(cfg.lr_init)
        for b in milestones:
            if count >= b:
                v = np.float32(v * rate)
        return float(v)

    return schedule


class ClippedAdam(torch.optim.Optimizer):
    """`optax.chain(clip_by_global_norm(max_norm), adam(lr, b1, b2,
    eps))`: scale every gradient by max_norm / norm only when the global
    norm is at least max_norm (no epsilon in the divisor), then Adam
    with bias correction and eps outside the square root. The learning
    rate is `lr_fn(count)`, count being the number of steps taken."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr_fn: Callable[[int], float],
                 max_norm: float | None = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        self.lr_fn = lr_fn
        self.max_norm = max_norm
        self.count = 0

    def state_dict(self) -> dict:
        """torch's optimizer state (per-parameter `mu`, `nu`) plus the
        step count that drives the schedule and the bias correction."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        norm = None
        if self.max_norm is not None:
            norm = torch.stack([
                (p.grad * p.grad).sum() for g in self.param_groups
                for p in g["params"] if p.grad is not None]).sum().sqrt()
        lr = self.lr_fn(self.count)
        self.count += 1
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if norm is not None:
                    g = torch.where(norm < self.max_norm, g,
                                    g / norm * self.max_norm)
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["mu"] = mu = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = nu = (1 - b2) * (g * g) + b2 * st["nu"]
                p.add_((mu / bc1) / ((nu / bc2).sqrt() + eps) * -lr)


def make_optimizer(cfg: FrameworkConfig, params: Iterable[torch.Tensor],
                   steps_per_epoch: int) -> ClippedAdam:
    return ClippedAdam(params, make_lr_schedule(cfg, steps_per_epoch),
                       max_norm=cfg.max_grad_norm if cfg.grad_norm else None)


def jax_step_counts(n_samples: int, batch_size: int, scan_steps: int,
                    device_data: bool, batch_seen: int) -> list[int]:
    """The step count each batch of an epoch gets in the JAX package's
    trainer (`train/trainer.py:train_epoch`), from `batch_seen` batches
    before the epoch, for `n_samples` training windows.

    `scan_steps` 0 means 16 there. Batches dispatched K at a time
    (the device-resident indexed path for full chunks of full batches,
    or a scan over a chunk of equal shapes) see batch_seen + 0 .. K - 1,
    0-based; the one-step path (scan_steps 1, a chunk of one, or a
    chunk with the ragged tail beside full batches) sees batch_seen + 1,
    1-based. With `device_data` the leftover batches after the full
    chunks go as one chunk; without it, every chunk of K comes from the
    batch iterator, ragged tail last."""
    k = 16 if scan_steps == 0 else scan_steps
    full, tail = divmod(n_samples, batch_size)
    sizes = [batch_size] * full + ([tail] if tail else [])
    counts: list[int] = []
    seen = batch_seen

    def dispatch(chunk: list[int]):
        nonlocal seen
        if k > 1 and len(chunk) > 1 and len(set(chunk)) == 1:
            counts.extend(range(seen, seen + len(chunk)))
            seen += len(chunk)
        else:
            for _ in chunk:
                seen += 1
                counts.append(seen)

    if k > 1 and device_data:
        usable = (full // k) * k
        for _ in range(0, usable, k):
            counts.extend(range(seen, seen + k))
            seen += k
        if sizes[usable:]:
            dispatch(sizes[usable:])
    else:
        for c in range(0, len(sizes), k):
            dispatch(sizes[c:c + k])
    return counts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Trainer:
    """Drives a `ModelOutput` module (`models/build.build_model`) over
    an STDataset on `device`."""

    model: nn.Module
    cfg: FrameworkConfig
    dataset: STDataset
    seed: int = 0
    log_dir: Optional[str] = None
    device: str | torch.device = "cuda"
    # a (data, graph) mesh: data-parallel train, val and test steps
    # with the parameters on the mesh's root, which must be `device`
    mesh: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.logger = get_logger("trainer", debug=self.cfg.debug)
        if self.mesh is not None:
            if normalize_device(self.device) != self.mesh.root:
                raise ValueError(f"Trainer on {self.device} with a mesh "
                                 f"rooted at {self.mesh.root}")
            self.device = self.mesh.root
        # the processes the data axis spans; only the coordinator logs
        # and writes files
        self.processes = 1 if self.mesh is None else self.mesh.processes
        self.coordinator = self.processes == 1 or is_coordinator()
        if not self.coordinator:
            self.logger.setLevel(logging.WARNING)
        # the forward of evaluation (f32) and of the train step
        self._eval_forward, forward = model_forwards(self.model, self.cfg,
                                                     self.mesh)
        self.pretrain = self.cfg.mode == "pretrain"
        self.steps_per_epoch = self.dataset.num_batches(
            "train", self.cfg.batch_size)
        self.optimizer = make_optimizer(
            self.cfg, self.model.parameters(), self.steps_per_epoch)
        s = self.dataset.scaler_data
        self.loss_fn = build_loss(
            self.cfg.loss_func, self._stat(s.mean), self._stat(s.std),
            self.cfg.mape_thresh, self.pretrain)
        self._loss_terms = make_loss_terms(self.model, self.loss_fn,
                                           self.cfg, forward)
        self.batch_seen = 0
        self._step_kw: dict = {}
        k = 16 if self.cfg.scan_steps == 0 else self.cfg.scan_steps
        # (x, y) of the train split on the device, or None: the host path
        self.train_split = (self._place_split()
                            if self.cfg.device_data and k > 1 else None)

    def _stat(self, v):
        """A scaler statistic: a float, or a tensor on the device for
        column-wise stats."""
        if np.ndim(v) == 0:
            return float(v)
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def _put(self, arr) -> torch.Tensor:
        """A numpy array copied to the device, or a tensor moved there
        (no copy where it lies there already, as the resident split's
        batches do)."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _place_split(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The train split's (x, y) on the device (under a mesh, its
        root: the data rows take their slices of each gathered batch
        there); None, with a warning, where the device runs out of
        memory. Any other error propagates."""
        try:
            return (self._put(self.dataset.x_train),
                    self._put(self.dataset.y_train))
        except torch.OutOfMemoryError:
            if self.device.type == "cuda":    # x, if placed, is freed
                torch.cuda.empty_cache()
            self.logger.warning(
                "The train split (%d bytes) does not fit on %s; its "
                "batches go from the host",
                self.dataset.x_train.nbytes + self.dataset.y_train.nbytes,
                self.device)
            return None

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # --- epoch loops ----------------------------------------------------
    def _train_batch(self, xb, yb):
        """One optimizer step on a batch (numpy from the host path,
        tensors on the device from the resident split) with the epoch's
        generator (and pretrain's epoch), the predictor reading the
        batch's step count; returns (total, flow) as device scalars."""
        self.batch_seen += 1
        return train_step(self._loss_terms, self.optimizer, self._put(xb),
                          self._put(yb), next(self._step_counts),
                          **self._step_kw)

    def train_epoch(self, epoch: int) -> float:
        """Mean train loss of the epoch: the total in ori and eval mode,
        the flow loss in pretrain (`BasicTrainer.py:120-121`)."""
        self.model.train()
        self._step_kw = dict(
            generator=self._generator(self.seed * 10_000 + epoch))
        if self.pretrain:
            self._step_kw["epoch"] = epoch
        it = self._train_batches(self.seed * 10_000 + epoch)
        # the counts of the JAX trainer's path: indexed where the split
        # is resident (it too falls back where the split does not fit)
        self._step_counts = iter(jax_step_counts(
            self.dataset.x_train.shape[0], self.cfg.batch_size,
            self.cfg.scan_steps, self.train_split is not None,
            self.batch_seen))
        # losses stay on the device until the epoch ends: one sync
        steps = [self._train_batch(xb, yb) for xb, yb in it]
        totals, flows = torch.stack([torch.stack(s) for s in steps]).T.tolist()
        for i, loss in enumerate(totals):
            if i % self.cfg.log_step == 0:
                self.logger.info("Train Epoch %d: %d/%d Loss: %.6f",
                                 epoch, i, self.steps_per_epoch, loss)
        losses = flows if self.pretrain else totals
        return sum(losses) / max(len(losses), 1)

    def _train_batches(self, seed: int):
        """The epoch's train batches in the dataset's shuffled order:
        gathered by `index_select` from the resident split (the order
        copied to the device once), else the host's numpy batches."""
        bs = self.cfg.batch_size
        if self.train_split is None:
            return self.dataset.batches("train", bs, shuffle=True, seed=seed)
        x, y = self.train_split
        order = torch.from_numpy(self.dataset.order(
            "train", shuffle=True, seed=seed)).to(self.device)
        return ((x.index_select(0, sel), y.index_select(0, sel))
                for sel in order.split(bs))

    @torch.no_grad()
    def val_epoch(self, epoch: int, split: str = "val") -> float:
        self.model.eval()
        total, nb = 0.0, 0
        for xb, yb in self.dataset.batches(split, self.cfg.batch_size):
            pred = self._eval_forward(self._put(xb)).pred.float()
            loss = float(self.loss_fn(
                pred, self._put(yb)[..., : self.cfg.output_dim], None))
            if not np.isnan(loss):
                total += loss
            nb += 1
        val = total / max(nb, 1)
        self.logger.info("**********Val Epoch %d: average Loss: %.6f",
                         epoch, val)
        return val

    def train(self, resume: bool = False) -> dict:
        """Train from epoch 1, or with `resume` from the epoch after the
        one `<log_dir>/full_ckpt.pt` was written at (when it exists).
        The history holds the epochs this call ran."""
        best_loss = float("inf")
        best_state = self._snapshot()
        not_improved = 0
        start_epoch = 1
        ckpt = os.path.join(self.log_dir, "full_ckpt.pt") if self.log_dir \
            else None
        if resume and ckpt:
            self._barrier()       # the coordinator's writes are done
        if resume and ckpt and os.path.exists(ckpt):
            start_epoch = self.restore_full_checkpoint(ckpt)
            best_loss, best_state = self._best_loss, self._best_state
            not_improved = self._not_improved
            self.logger.info("Resumed from %s at epoch %d", ckpt, start_epoch)
        history: list[float] = []
        epoch_seconds: list[float] = []
        start = time.time()
        val_split = "val" if self.dataset.x_val.shape[0] > 0 else "test"
        timer = StepTimer(warmup=0)
        n_train = self.dataset.x_train.shape[0]
        for epoch in range(start_epoch, self.cfg.epochs + 1):
            timer.start()
            train_loss = self.train_epoch(epoch)
            _sync(self.device)
            dt = timer.tick(n_train)
            epoch_seconds.append(dt)
            if epoch % 10 == 0 or epoch == 1:
                self.logger.info("Epoch %d wall %.2fs (%.0f samples/s)",
                                 epoch, dt, n_train / dt)
            if epoch in set(self.cfg.up_epoch):
                best_loss = float("inf")  # watermark reset
            cur = (train_loss if self.pretrain
                   else self.val_epoch(epoch, val_split))
            if self.processes > 1:    # every process decides alike
                train_loss, cur = collectives.broadcast_floats(
                    [train_loss, cur], self.device)
            if cur < best_loss:
                best_loss = cur
                not_improved = 0
                best_state = self._snapshot()
                self.logger.info("*********Current best model saved!")
            else:
                not_improved += 1
            history.append(train_loss)
            if train_loss > 1e6:
                self.logger.warning("Gradient explosion detected. Ending...")
                break
            if (self.cfg.early_stop
                    and not_improved == self.cfg.early_stop_patience):
                self.logger.info("No improvement for %d epochs; stopping.",
                                 self.cfg.early_stop_patience)
                break
            if (ckpt and self.cfg.ckpt_every_epochs
                    and epoch % self.cfg.ckpt_every_epochs == 0):
                if self.coordinator:
                    self.save_full_checkpoint(ckpt, epoch, best_state,
                                              best_loss, not_improved)
                self._barrier()
                self.logger.info("Periodic checkpoint at epoch %d", epoch)
        self.logger.info("Total training time: %.4f min, best loss: %.6f",
                         (time.time() - start) / 60, best_loss)
        self.model.load_state_dict(best_state)
        if self.log_dir:
            if self.coordinator:
                self.save_checkpoint(os.path.join(self.log_dir,
                                                  "best_model.pt"))
            self._barrier()
        report = self.test("train" if self.pretrain else "test")
        return {"best_loss": best_loss, "history": history,
                "epoch_seconds": epoch_seconds,
                "steps_per_epoch": self.steps_per_epoch, "report": report}

    def _barrier(self) -> None:
        if self.processes > 1:
            collectives.barrier()

    def _snapshot(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    # --- evaluation -------------------------------------------------------
    @torch.no_grad()
    def test(self, split: str = "test") -> dict:
        """Full-split prediction and per-horizon metrics
        (`BasicTrainer.py:210-248`), the forward given a generator
        seeded with `seed + 777` in every mode. In pretrain the label is
        the input and both sides are multiplied by the mask of epoch
        `cfg.epochs`."""
        self.model.eval()
        od = self.cfg.output_dim
        gen = self._generator(self.seed + 777)
        preds, trues = [], []
        for xb, yb in self.dataset.batches(split, self.cfg.batch_size):
            x = self._put(xb)
            if self.pretrain:
                out = self._eval_forward(x, generator=gen,
                                         epoch=self.cfg.epochs)
                mask = out.mask.float()
                pred = out.pred.float() * mask
                label = (x[..., :od] * mask).cpu().numpy()
            else:
                pred = self._eval_forward(x, generator=gen).pred.float()
                label = yb[..., :od]
            preds.append(pred.cpu().numpy())
            trues.append(label)
        s = self.dataset.scaler_data
        y_pred = torch.from_numpy(
            np.asarray(s.inverse_transform(np.concatenate(preds)), np.float32))
        y_true = torch.from_numpy(
            np.asarray(s.inverse_transform(np.concatenate(trues)), np.float32))
        horizons = []
        for t in range(y_true.shape[1]):
            mae, rmse, mape, _, c = (float(v) for v in all_metrics(
                y_pred[:, t], y_true[:, t], self.cfg.mae_thresh,
                self.cfg.mape_thresh))
            horizons.append((mae, rmse, mape, c))
            self.logger.info(
                "Horizon %02d, MAE: %.2f, RMSE: %.2f, MAPE: %.4f%%, "
                "CORR: %.4f", t + 1, mae, rmse, mape * 100, c)
        mae, rmse, mape, _, c = (float(v) for v in all_metrics(
            y_pred, y_true, self.cfg.mae_thresh, self.cfg.mape_thresh))
        self.logger.info(
            "Average Horizon, MAE: %.2f, RMSE: %.2f, MAPE: %.4f%%, "
            "CORR: %.4f", mae, rmse, mape * 100, c)
        return {"per_horizon": horizons, "average": (mae, rmse, mape, c)}

    # --- checkpointing ----------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Best-parameters checkpoint (the reference's best_model.pth)."""
        torch.save(self.model.state_dict(), path)
        self.logger.info("Saved best model to %s", path)

    def load_checkpoint(self, path: str) -> None:
        self.model.load_state_dict(
            torch.load(path, map_location=self.device, weights_only=True))

    def save_full_checkpoint(self, path: str, epoch: int, best_state: dict,
                             best_loss: float, not_improved: int) -> None:
        """The resumable training state after `epoch`, in one
        `torch.save` (the reference defines but never calls an
        equivalent, `BasicTrainer.py:200-207`)."""
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "best_state": best_state,
            "progress": {"epoch": epoch, "batch_seen": self.batch_seen,
                         "best_loss": best_loss,
                         "not_improved": not_improved},
        }, path)

    def restore_full_checkpoint(self, path: str) -> int:
        """Restore the model, the optimizer and the progress; the best
        state and bookkeeping land in `_best_state`, `_best_loss` and
        `_not_improved`. Returns the next epoch."""
        st = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(st["model"])
        self.optimizer.load_state_dict(st["optimizer"])
        prog = st["progress"]
        self._best_state = st["best_state"]
        self._best_loss = float(prog["best_loss"])
        self._not_improved = int(prog["not_improved"])
        self.batch_seen = int(prog["batch_seen"])
        return int(prog["epoch"]) + 1
