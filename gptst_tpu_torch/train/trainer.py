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
    order; validation and test always batch on the host;
  - K steps per dispatch: the epoch is cut into the JAX trainer's
    chunks (K full batches from the resident split, then the leftover
    batches as one chunk; on the host path, chunks of K in batch
    order). A chunk of two or more full batches runs through
    `train/step.StepGraph`: on the card the train step is captured
    once in a CUDA graph and replayed for each of its steps (the
    resident path gathers the batch inside the graph by the slot; the
    host path copies each batch from page-locked memory into static
    buffers with `non_blocking` before the replay); on the CPU the same
    step runs eagerly through the same buffers. `scan_steps` 1, a chunk
    of one and a chunk that holds the ragged tail take one step at a
    time (`_train_batch`), as the JAX trainer's one-step path does.
    Every path reads its learning rate, bias corrections and step input
    from the same staged buffers (`ClippedAdam.stage`, `_stage`) and
    writes its losses into one device buffer, read once when the epoch
    ends;
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
    (`jax_step_counts`), not the number of steps taken; the forward is
    handed the step input staged for it (`train/step.step_inputs`: the
    count, or CCRNN's teacher-forcing threshold of it).

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

Which meshes take K steps per dispatch is decided at construction
(`chunked`, `captured`) and logged once: no mesh, and a mesh of which
this process holds one data row on one device (a (1, 1) mesh, or
`global_mesh(1)` with one process per card under torchrun), take the
chunks through `StepGraph`; across processes each process captures its
own data-parallel step, the collectives of its rows' meetings, of the
outputs' gather and of the gradients' sum included, and every process
replays in the same order. Every other mesh steps one at a time: its
data rows are host threads, or its graph ranks several devices of this
process, which one capture on one stream does not span. On the card
under a gloo process group the chunks run eagerly (gloo's collectives
go through host memory and cannot be captured).

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
import functools
import logging
import os
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.core.distributed import is_coordinator
from gptst_tpu_torch.data.pipeline import STDataset
from gptst_tpu_torch.eval.metrics import all_metrics
from gptst_tpu_torch.parallel import collectives
from gptst_tpu_torch.parallel.mesh import GRAPH_AXIS, normalize_device
from gptst_tpu_torch.train.loss import build_loss
from gptst_tpu_torch.train.step import (
    StepGraph, make_loss_terms, model_forwards, step_inputs, train_step,
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
    rate is `lr_fn(count)`, count being the number of steps taken.

    The step reads its scalars from the device, so that a step captured
    in a CUDA graph reads each replay's own: `stage(n)` computes, on the
    host in double, -lr(c) and the reciprocals of the bias corrections
    1 - b1^(c + 1) and 1 - b2^(c + 1) for the next n step counts c,
    rounds them once to the parameters' dtype and copies the rows into
    a device buffer; each step reads the row at `slot` (a 0-dim device
    counter) and advances it. The moments are multiplied by the
    reciprocals, as CUDA applies a Python-scalar divisor. `mu` and `nu`
    are updated in place. `count` stays a host int: `step()` advances
    it, and whoever replays a captured step advances it by the steps
    the replays took. A step outside the staged rows (after
    `load_state_dict`, or without `stage`) stages the next
    `STAGE_AHEAD` first."""

    STAGE_AHEAD = 256

    def __init__(self, params: Iterable[torch.Tensor],
                 lr_fn: Callable[[int], float],
                 max_norm: float | None = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        self.lr_fn = lr_fn
        self.max_norm = max_norm
        self.count = 0
        # per group {dtype: (rows, 3)} buffers, the count of row 0, the
        # rows staged, and the slot: made at the first `stage`
        self._rows: list[dict[torch.dtype, torch.Tensor]] = []
        self._base = self._staged = 0
        self.slot: torch.Tensor | None = None

    def state_dict(self) -> dict:
        """torch's optimizer state (per-parameter `mu`, `nu`) plus the
        step count that drives the schedule and the bias correction."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        """As torch's, but the moments are copies (torch keeps a given
        tensor whose dtype and device fit, and the steps update the
        moments in place), and moments that exist already are
        overwritten in place (a captured step keeps reading them)."""
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        state_dict["state"] = {
            k: {n: v.clone() if isinstance(v, torch.Tensor) else v
                for n, v in st.items()}
            for k, st in state_dict["state"].items()}
        held = {p: dict(st) for p, st in self.state.items()}
        super().load_state_dict(state_dict)
        for p, old in held.items():
            for k, t in old.items():
                if k in self.state[p]:
                    self.state[p][k] = t.copy_(self.state[p][k])
        self._staged = 0

    def stage(self, steps: int) -> None:
        """Stage the scalars of the next `steps` step counts (from
        `count`) and restart `slot` at 0, in place where the buffers
        hold that many rows (`staged_buffers` tells a capture whether
        they moved)."""
        counts = range(self.count, self.count + steps)
        device = self.param_groups[0]["params"][0].device
        for gi, group in enumerate(self.param_groups):
            b1, b2 = group["b1"], group["b2"]
            # taken in double and rounded once
            rows64 = torch.tensor(
                [[-self.lr_fn(c), 1 / (1.0 - b1 ** (c + 1)),
                  1 / (1.0 - b2 ** (c + 1))] for c in counts],
                dtype=torch.float64)
            if gi == len(self._rows):
                self._rows.append({})
            bufs = self._rows[gi]
            for dt in {p.dtype for p in group["params"]}:
                rows = rows64.to(dt)
                if dt not in bufs or bufs[dt].shape[0] < steps:
                    bufs[dt] = torch.empty(steps, 3, dtype=dt, device=device)
                bufs[dt][:steps].copy_(rows)
        if self.slot is None:
            self.slot = torch.zeros((), dtype=torch.long, device=device)
        else:
            self.slot.zero_()
        self._base, self._staged = self.count, steps

    def staged_buffers(self) -> list[torch.Tensor]:
        """The device tensors a step reads besides the parameters and
        their moments: the staged rows and the slot."""
        return [b for bufs in self._rows for b in bufs.values()] + [self.slot]

    @torch.no_grad()
    def step(self, closure=None):
        if not self._base <= self.count < self._base + self._staged:
            self.stage(self.STAGE_AHEAD)
        norm = None
        if self.max_norm is not None:
            norm = torch.stack([
                (p.grad * p.grad).sum() for g in self.param_groups
                for p in g["params"] if p.grad is not None]).sum().sqrt()
        at = self.slot.view(1)
        for group, bufs in zip(self.param_groups, self._rows):
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            # (-lr, 1 / (1 - b1^count), 1 / (1 - b2^count)) as 0-dim
            # tensors, by dtype
            rows = {dt: b.index_select(0, at).view(3).unbind()
                    for dt, b in bufs.items()}
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
                mu = st["mu"].mul_(b1).add_((1 - b1) * g)
                nu = st["nu"].mul_(b2).add_((1 - b2) * (g * g))
                neg_lr, inv1, inv2 = rows[p.dtype]
                p.add_(mu * inv1 / ((nu * inv2).sqrt() + eps) * neg_lr)
        self.count += 1
        self.slot.add_(1)


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


class HostBatches:
    """The host path's batches for replayed steps: each is gathered by
    numpy into one of `depth` staging slots (page-locked on CUDA) and
    copied with `non_blocking` into the static buffers `static` (x, y)
    that the step reads, on the current stream, so the copy waits for
    the previous step and the next replay waits for the copy. A slot is
    written again only once its copy has run (its event): with `depth`
    K, never within a chunk of K."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 depth: int, device: torch.device):
        self.src = (x, y)
        self.pinned = device.type == "cuda"
        self.static = tuple(
            torch.empty((batch_size, *a.shape[1:]),
                        dtype=torch.from_numpy(a[:0]).dtype, device=device)
            for a in self.src)
        self.slots = [tuple(torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=self.pinned)
                            for t in self.static) for _ in range(depth)]
        self.events: list = [None] * depth
        self.next = 0

    def feed(self, sel: np.ndarray) -> None:
        """Put the batch of windows `sel` into `static`."""
        k = self.next
        self.next = (k + 1) % len(self.slots)
        if self.events[k] is not None:
            self.events[k].synchronize()
        for a, buf, dst in zip(self.src, self.slots[k], self.static):
            np.take(a, sel, axis=0, out=buf.numpy())
            dst.copy_(buf, non_blocking=True)
        if self.pinned:
            self.events[k] = torch.cuda.Event()
            self.events[k].record()


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
        self.k = 16 if self.cfg.scan_steps == 0 else self.cfg.scan_steps
        # (x, y) of the train split on the device, or None: the host path
        self.train_split = (self._place_split()
                            if self.cfg.device_data and self.k > 1 else None)
        # the epoch's generator, re-seeded in place every epoch (a
        # captured step draws from this object), and the device buffers
        # of `_stage`, made at the first epoch
        self._train_gen = self._generator(0)
        self._step_kw: dict = {}
        self._step_in = self._losses = self._order = None
        self._host = None
        self._runner = None
        self.chunked, self.captured = self._dispatch()

    def _dispatch(self) -> tuple[bool, bool]:
        """(chunks of full batches go through `StepGraph`, and it captures
        them), decided before the first step; where a mesh or a gloo
        process group on the card rules either out, logged once with
        the reason."""
        mesh, why = self.mesh, None
        if mesh is not None and mesh.local_rows > 1:
            why = f"{mesh.local_rows} data rows are host threads here"
        elif mesh is not None and mesh.shape[GRAPH_AXIS] > 1:
            why = f"{mesh.shape[GRAPH_AXIS]} graph ranks are devices here"
        if why is not None:
            if self.k > 1:
                self.logger.info("K steps per dispatch: one step at a time "
                                 "under this mesh (%s)", why)
            return False, False
        captured = self.device.type == "cuda"
        if captured and self.processes > 1 and dist.get_backend() != "nccl":
            captured = False
            if self.k > 1:
                self.logger.info("K steps per dispatch: chunks run eagerly "
                                 "over %s (its collectives go through host "
                                 "memory and cannot be captured)",
                                 dist.get_backend())
        return True, captured

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
    def _step(self, x: torch.Tensor, y: torch.Tensor):
        """One optimizer step on a batch on the device, with the epoch's
        generator (and pretrain's epoch), the forward handed the step
        input staged at the optimizer's slot; (total, flow) go into the
        epoch's losses at that slot. Returns them as device scalars."""
        opt = self.optimizer
        at = opt.slot.clone().view(1)
        step = self._step_in.index_select(0, at).view(())
        total, flow = train_step(self._loss_terms, opt, x, y, step,
                                 **self._step_kw)
        self._losses.index_copy_(
            0, at, torch.stack([total, flow]).double()[None])
        return total, flow

    def _train_batch(self, xb, yb):
        """One step on a batch (numpy from the host path, tensors on the
        device from the resident split): the one-step path."""
        self.batch_seen += 1
        return self._step(self._put(xb), self._put(yb))

    def _one_steps(self, batches: range, order: np.ndarray) -> None:
        """The batches one step at a time (`_train_batch`): gathered on
        the host, or from the resident split by the order on the
        device."""
        bs = self.cfg.batch_size
        for b in batches:
            if self.train_split is None:
                sel = order[b * bs:(b + 1) * bs]
                xb, yb = self.dataset.x_train[sel], self.dataset.y_train[sel]
            else:
                sel = self._order[b * bs:(b + 1) * bs]
                xb, yb = (t.index_select(0, sel) for t in self.train_split)
            self._train_batch(xb, yb)

    def _gathered_step(self):
        """A step on the resident split's batch at the optimizer's slot,
        gathered by the epoch's order on the device."""
        bs = self.cfg.batch_size
        full = self.dataset.x_train.shape[0] // bs
        sel = self._order[: full * bs].view(full, bs).index_select(
            0, self.optimizer.slot.view(1)).view(-1)
        x, y = self.train_split
        return self._step(self._put(x.index_select(0, sel)),
                          self._put(y.index_select(0, sel)))

    def _train_steps(self, batches: range, order: np.ndarray, epoch: int):
        """A chunk of full batches through `StepGraph` (one replay a step
        on the card). The capture is keyed by pretrain's epoch and the
        storage of the buffers the step reads."""
        if self._runner is None:
            if self.train_split is None:
                self._host = HostBatches(self.dataset.x_train,
                                         self.dataset.y_train,
                                         self.cfg.batch_size, self.k,
                                         self.device)
            body = (self._gathered_step if self.train_split is not None
                    else lambda: self._step(*map(self._put,
                                                 self._host.static)))
            self._runner = StepGraph(
                body, self.optimizer, self._train_gen, self.device,
                capture=self.captured,
                agree=(functools.partial(collectives.any_process,
                                         device=self.device)
                       if self.processes > 1 else None))
        feed = None
        if self._host is not None:
            bs = self.cfg.batch_size

            def feed(i: int) -> None:
                b = batches[i]
                self._host.feed(order[b * bs:(b + 1) * bs])
        key = (epoch if self.pretrain else None,
               *(t.data_ptr() for t in (*self.optimizer.staged_buffers(),
                                        self._step_in, self._losses)))
        self.batch_seen += len(batches)
        self._runner.run(len(batches), key, feed)

    def _stage(self, counts: list[int], order: np.ndarray) -> None:
        """The epoch's buffers, in place: the optimizer's scalars, the
        step inputs of `counts`, the losses and (resident) the order."""
        n = len(counts)
        self.optimizer.stage(n)
        table = step_inputs(self.model, counts)
        if self._step_in is None:
            self._step_in = torch.empty(n, dtype=table.dtype,
                                        device=self.device)
            self._losses = torch.zeros(n, 2, dtype=torch.float64,
                                       device=self.device)
        self._step_in.copy_(table)
        if self.train_split is not None:
            if self._order is None:
                self._order = torch.empty(order.shape, dtype=torch.long,
                                          device=self.device)
            self._order.copy_(torch.from_numpy(order))

    def _chunks(self) -> list[range]:
        """The epoch's batches (by index in the epoch's order) in the
        JAX trainer's dispatches: K full batches at a time from the
        resident split, then the rest as one chunk; on the host path,
        chunks of K."""
        bs, k = self.cfg.batch_size, self.k
        n = self.dataset.x_train.shape[0]
        nb = -(-n // bs)
        if self.train_split is not None:      # placed only with K > 1
            usable = (n // bs) // k * k
            return ([range(c, c + k) for c in range(0, usable, k)]
                    + ([range(usable, nb)] if usable < nb else []))
        return [range(c, min(c + k, nb)) for c in range(0, nb, k)]

    def train_epoch(self, epoch: int) -> float:
        """Mean train loss of the epoch: the total in ori and eval mode,
        the flow loss in pretrain (`BasicTrainer.py:120-121`)."""
        self.model.train()
        seed = self.seed * 10_000 + epoch
        self._train_gen.manual_seed(seed)
        self._step_kw = dict(generator=self._train_gen)
        if self.pretrain:
            self._step_kw["epoch"] = epoch
        bs = self.cfg.batch_size
        n = self.dataset.x_train.shape[0]
        order = self.dataset.order("train", shuffle=True, seed=seed)
        # the counts of the JAX trainer's path: indexed where the split
        # is resident (it too falls back where the split does not fit)
        self._stage(jax_step_counts(n, bs, self.cfg.scan_steps,
                                    self.train_split is not None,
                                    self.batch_seen), order)
        for chunk in self._chunks():
            if (self.k > 1 and len(chunk) > 1 and self.chunked
                    and chunk[-1] < n // bs):
                self._train_steps(chunk, order, epoch)
            elif self._runner is None:
                self._one_steps(chunk, order)
            else:         # beside the captured step's pool: make room
                with self._runner.beside():
                    self._one_steps(chunk, order)
        # losses stay on the device until the epoch ends: one sync
        totals, flows = self._losses.T.tolist()
        for i, loss in enumerate(totals):
            if i % self.cfg.log_step == 0:
                self.logger.info("Train Epoch %d: %d/%d Loss: %.6f",
                                 epoch, i, self.steps_per_epoch, loss)
        losses = flows if self.pretrain else totals
        return sum(losses) / max(len(losses), 1)

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
        self.release_graph()
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

    def release_graph(self) -> None:
        """Drop the captured train step and its memory (`train` does when
        its epochs end); a later epoch captures again."""
        if self._runner is not None:
            self._runner.release()
            self._runner = None

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
