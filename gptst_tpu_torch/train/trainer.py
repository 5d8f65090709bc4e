"""Training loop for the ori mode.

The JAX package's `train/trainer.py` behaviour, step for step:
  - batch order: the permutation
    `np.random.default_rng(seed * 10_000 + epoch).shuffle(arange(n))`
    cut into consecutive `batch_size` slices, ragged tail last (the
    JAX trainer's indexed, scan-fused and host paths all give this
    sequence, so `scan_steps` and `device_data` change nothing here);
  - optimizer: `optax.chain(clip_by_global_norm(max_grad_norm),
    adam(schedule, eps=1e-8))`, written out (`ClippedAdam`), with the
    MultiStepLR milestones as a piecewise-constant schedule on the
    optimizer's step count;
  - validation every epoch, best parameters by val loss, `up_epoch`
    watermark resets, divergence abort at a train loss above 1e6,
    early stopping, and the per-horizon test report
    (`model/BasicTrainer.py:130-248`).

Best parameters are saved with `torch.save` when `log_dir` is set.
Periodic checkpoints and resume come with the eval/test-mode slice.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.data.pipeline import STDataset
from gptst_tpu_torch.eval.metrics import all_metrics
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import make_loss_terms, train_step
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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.logger = get_logger("trainer", debug=self.cfg.debug)
        if self.cfg.mode != "ori":
            raise NotImplementedError(
                f"the Trainer of gptst_tpu_torch runs -mode ori; -mode "
                f"{self.cfg.mode} comes with a later slice")
        if self.cfg.ckpt_every_epochs:
            raise NotImplementedError(
                "periodic checkpoints and resume come with the "
                "eval/test-mode slice")
        self.steps_per_epoch = self.dataset.num_batches(
            "train", self.cfg.batch_size)
        self.optimizer = make_optimizer(
            self.cfg, self.model.parameters(), self.steps_per_epoch)
        s = self.dataset.scaler_data
        self.loss_fn = build_loss(
            self.cfg.loss_func, self._stat(s.mean), self._stat(s.std),
            self.cfg.mape_thresh, False)
        self._loss_terms = make_loss_terms(self.model, self.loss_fn,
                                           self.cfg)
        self.batch_seen = 0

    def _stat(self, v):
        """A scaler statistic: a float, or a tensor on the device for
        column-wise stats."""
        if np.ndim(v) == 0:
            return float(v)
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # --- epoch loops ----------------------------------------------------
    def _train_batch(self, xb: np.ndarray, yb: np.ndarray):
        """One optimizer step; returns (total, flow) as device scalars."""
        self.batch_seen += 1
        return train_step(self._loss_terms, self.optimizer, self._put(xb),
                          self._put(yb), self.batch_seen)

    def train_epoch(self, epoch: int) -> float:
        self.model.train()
        it = self.dataset.batches("train", self.cfg.batch_size, shuffle=True,
                                  seed=self.seed * 10_000 + epoch)
        # losses stay on the device until the epoch ends: one sync
        totals = [self._train_batch(xb, yb)[0] for xb, yb in it]
        losses = torch.stack(totals).tolist()
        for i, loss in enumerate(losses):
            if i % self.cfg.log_step == 0:
                self.logger.info("Train Epoch %d: %d/%d Loss: %.6f",
                                 epoch, i, self.steps_per_epoch, loss)
        return sum(losses) / max(len(losses), 1)

    @torch.no_grad()
    def val_epoch(self, epoch: int, split: str = "val") -> float:
        self.model.eval()
        total, nb = 0.0, 0
        for xb, yb in self.dataset.batches(split, self.cfg.batch_size):
            pred = self.model(self._put(xb)).pred.float()
            loss = float(self.loss_fn(
                pred, self._put(yb)[..., : self.cfg.output_dim], None))
            if not np.isnan(loss):
                total += loss
            nb += 1
        val = total / max(nb, 1)
        self.logger.info("**********Val Epoch %d: average Loss: %.6f",
                         epoch, val)
        return val

    def train(self) -> dict:
        best_loss = float("inf")
        best_state = self._snapshot()
        not_improved = 0
        history: list[float] = []
        epoch_seconds: list[float] = []
        start = time.time()
        val_split = "val" if self.dataset.x_val.shape[0] > 0 else "test"
        timer = StepTimer(warmup=0)
        n_train = self.dataset.x_train.shape[0]
        for epoch in range(1, self.cfg.epochs + 1):
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
            cur = self.val_epoch(epoch, val_split)
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
        self.logger.info("Total training time: %.4f min, best loss: %.6f",
                         (time.time() - start) / 60, best_loss)
        self.model.load_state_dict(best_state)
        if self.log_dir:
            self.save_checkpoint(os.path.join(self.log_dir, "best_model.pt"))
        report = self.test()
        return {"best_loss": best_loss, "history": history,
                "epoch_seconds": epoch_seconds,
                "steps_per_epoch": self.steps_per_epoch, "report": report}

    def _snapshot(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    # --- evaluation -------------------------------------------------------
    @torch.no_grad()
    def test(self, split: str = "test") -> dict:
        """Full-split prediction and per-horizon metrics
        (`BasicTrainer.py:210-248`)."""
        self.model.eval()
        preds, trues = [], []
        for xb, yb in self.dataset.batches(split, self.cfg.batch_size):
            pred = self.model(self._put(xb)).pred
            preds.append(pred.float().cpu().numpy())
            trues.append(yb[..., : self.cfg.output_dim])
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
