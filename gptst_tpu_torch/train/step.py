"""Loss assembly and one optimizer step.

Mirrors the JAX package's `train/step.py` for the ported modes: the
loss is the flow loss on the labels (`model/BasicTrainer.py:81-97`).
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


def _cast_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def make_loss_terms(model: nn.Module, loss_fn: Callable,
                    cfg: FrameworkConfig) -> Callable:
    """Returns loss_terms(x, y, step=None) -> (total, flow), running
    `model` (a `ModelOutput` module, `models/build.build_model`)."""
    if cfg.mode == "pretrain":
        raise NotImplementedError(
            "pretrain loss terms come with the GPT-ST pretrain slice")
    bf16 = cfg.compute_dtype == "bfloat16"

    def loss_terms(x, y, step=None):
        label = y
        if bf16:
            params = {k: _cast_bf16(p) for k, p in model.named_parameters()}
            out = functional_call(model, params, (_cast_bf16(x),),
                                  {"y": _cast_bf16(y), "step": step})
        else:
            out = model(x, y=y, step=step)
        pred = out.pred.float()
        flow = loss_fn(pred, label[..., : cfg.output_dim], None)
        return flow, flow

    return loss_terms


def train_step(loss_terms: Callable, optimizer: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor, step=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on a batch; returns the (total, flow) losses
    as detached tensors (reading them synchronizes the device)."""
    optimizer.zero_grad(set_to_none=True)
    total, flow = loss_terms(x, y, step)
    total.backward()
    optimizer.step()
    return total.detach(), flow.detach()
