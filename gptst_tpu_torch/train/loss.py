"""Loss factories.

Functional equivalents of the closures in the reference's
`model/Run.py:91-113`: losses act on z-normalized predictions/labels,
inverse-transform with the data scaler's scalar stats, optionally
multiply by the pretrain mask before the threshold mask, and reduce
with the masked-MAE / huber semantics of `lib/metrics.py`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gptst_tpu_torch.eval.metrics import masked_huber, masked_mae

LossFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                  torch.Tensor]


def make_scaler_mae_loss(mean: float, std: float,
                         mask_value: float | None,
                         pretrain: bool = False) -> LossFn:
    """`scaler_mae_loss` (`model/Run.py:91-101`)."""

    def loss(preds, labels, mask=None):
        preds = preds * std + mean
        labels = labels * std + mean
        if pretrain and mask is not None:
            preds = preds * mask
            labels = labels * mask
        return masked_mae(preds, labels, mask_value)

    return loss


def make_scaler_huber_loss(mean: float, std: float,
                           mask_value: float | None,
                           pretrain: bool = False,
                           delta: float = 1.0) -> LossFn:
    """`scaler_huber_loss` (`model/Run.py:103-113`)."""

    def loss(preds, labels, mask=None):
        preds = preds * std + mean
        labels = labels * std + mean
        if pretrain and mask is not None:
            preds = preds * mask
            labels = labels * mask
        return masked_huber(preds, labels, mask_value, delta)

    return loss


def build_loss(loss_func: str, mean: float, std: float,
               mask_value: float | None, pretrain: bool) -> LossFn:
    """Loss selection of `model/Run.py:115-131` (pretrain always falls
    back to masked MAE even when huber is requested)."""
    if loss_func == "mask_mae" or (loss_func == "mask_huber" and pretrain):
        return make_scaler_mae_loss(mean, std, mask_value, pretrain)
    if loss_func == "mask_huber":
        return make_scaler_huber_loss(mean, std, mask_value, pretrain)
    if loss_func == "mae":
        return lambda p, l, m=None: (p - l).abs().mean()
    if loss_func == "mse":
        return lambda p, l, m=None: ((p - l) ** 2).mean()
    raise ValueError(f"unknown loss_func {loss_func!r}")
