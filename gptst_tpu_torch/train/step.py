"""Loss assembly and one optimizer step.

Mirrors the JAX package's `train/step.py` (`model/BasicTrainer.py:81-97`):
ori mode is the flow loss on the labels; pretrain mode is the flow loss
on the input itself under the model's mask, plus 0.1 * KL(mask policy ||
routing) once the epoch passes `change_epoch`.
`cfg.compute_dtype == "bfloat16"` runs the forward on a bf16 cast of
the parameters and inputs while the master parameters, the optimizer
state and the loss stay f32; gradients flow back through the cast and
arrive in f32.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from gptst_tpu_torch.config.config import FrameworkConfig
from gptst_tpu_torch.parallel.mesh import Mesh, shard_params
from gptst_tpu_torch.parallel.spmd import DataParallel
from gptst_tpu_torch.train.loss import kl_div_sum


def _cast_bf16(t):
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.to(torch.bfloat16)
    return t


def model_forwards(model: nn.Module, cfg: FrameworkConfig,
                   mesh: Mesh | None = None) -> tuple[Callable, Callable]:
    """(eval_forward, train_forward) of `model`, each `forward(x, **kw)
    -> ModelOutput`. The eval forward is f32; the train step's runs,
    with `cfg.compute_dtype == "bfloat16"`, on a bf16 cast of the
    trainable parameters, of x and of a tensor `y`. With a `mesh` both
    run over its data rows (`parallel/spmd.DataParallel`), the
    parameters placed on its root (`shard_params`), and the train
    forward's `reduce_gradients()` sums the gradients over the processes
    a data axis spans (`make_loss_terms` hands it to `train_step`)."""
    if mesh is None:
        run = model

        def call(params, x, kw):
            return functional_call(model, params, (x,), kw)
    else:
        shard_params(model, mesh, cfg.num_nodes)
        run = DataParallel(model, mesh)

        def call(params, x, kw):
            return run(x, params=params, **kw)
    if cfg.compute_dtype != "bfloat16":
        return run, run

    def forward(x, **kw):
        params = {k: _cast_bf16(p) for k, p in model.named_parameters()}
        return call(params, _cast_bf16(x),
                    {k: _cast_bf16(v) for k, v in kw.items()})

    if mesh is not None:       # the f32 master gradients, summed
        forward.reduce_gradients = run.reduce_gradients
    return run, forward


def make_loss_terms(model: nn.Module, loss_fn: Callable,
                    cfg: FrameworkConfig,
                    forward: Callable | None = None) -> Callable:
    """Returns loss_terms(x, y, step=None, epoch=None, generator=None)
    -> (total, flow), running `model` (a `ModelOutput` module,
    `models/build.build_model`) through `forward` (default the
    one-device train forward of `model_forwards`; the data-parallel
    step passes its own). `generator` draws pretrain's mask (and
    a predictor's dropout in the other modes); `epoch` is pretrain's.
    In eval mode the cast reaches only the trainable parameters: the
    frozen encoder, outside them, stays f32. `loss_terms.reduce_gradients`
    is the forward's (None on one process)."""
    pretrain = cfg.mode == "pretrain"
    if forward is None:
        forward = model_forwards(model, cfg)[1]

    def loss_terms(x, y, step=None, epoch=None, generator=None):
        label = x if pretrain else y
        kw = {"y": y, "step": step, "generator": generator}
        if pretrain:
            kw["epoch"] = epoch
        out = forward(x, **kw)
        pred = out.pred.float()
        mask = None if out.mask is None else out.mask.float()
        flow = loss_fn(pred, label[..., : cfg.output_dim], mask)
        if pretrain and epoch > cfg.change_epoch:
            log_prob = out.probability.float().clamp_min(1e-38).log()
            return flow + 0.1 * kl_div_sum(log_prob, out.routing), flow
        return flow, flow

    loss_terms.reduce_gradients = getattr(forward, "reduce_gradients", None)
    return loss_terms


def train_step(loss_terms: Callable, optimizer: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor, step=None, **kw
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on a batch (`kw`: pretrain's epoch and
    generator), the gradients summed over processes before it where the
    data axis spans them; returns the (total, flow) losses as detached
    tensors (reading them synchronizes the device)."""
    optimizer.zero_grad(set_to_none=True)
    total, flow = loss_terms(x, y, step, **kw)
    total.backward()
    reduce = getattr(loss_terms, "reduce_gradients", None)
    if reduce is not None:
        reduce()
    optimizer.step()
    return total.detach(), flow.detach()
