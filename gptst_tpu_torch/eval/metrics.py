"""Masked evaluation metrics, in torch.

Re-derivation of the reference's `lib/metrics.py`, written as
where/sum/count like the JAX package's `eval/metrics.py` (numerically
the same as masked selection for mean-type reductions).

Threshold semantics (`lib/metrics.py:11-18`): a threshold of ``None``
disables masking; a numeric threshold keeps entries with
``true > thresh``.
"""

from __future__ import annotations

import torch


def _mask(true: torch.Tensor, thresh: float | None) -> torch.Tensor:
    if thresh is None:
        return torch.ones_like(true, dtype=torch.float32)
    return (true > thresh).float()


def _masked_mean(vals: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return (vals * m).sum() / m.sum().clamp(min=1.0)


def masked_mae(pred, true, thresh: float | None = None):
    return _masked_mean((pred - true).abs(), _mask(true, thresh))


def masked_mse(pred, true, thresh: float | None = None):
    return _masked_mean((pred - true) ** 2, _mask(true, thresh))


def masked_rmse(pred, true, thresh: float | None = None):
    return masked_mse(pred, true, thresh).sqrt()


def masked_mape(pred, true, thresh: float | None = None):
    m = _mask(true, thresh)
    safe_true = torch.where(m > 0, true, torch.ones_like(true))
    return _masked_mean(((true - pred) / safe_true).abs(), m)


def masked_rrse(pred, true, thresh: float | None = None):
    """Root relative squared error (`lib/metrics.py:47-52`), with the
    mean of `true` over the masked values as the reference takes it."""
    m = _mask(true, thresh)
    t_mean = (true * m).sum() / m.sum().clamp(min=1.0)
    num = ((pred - true) ** 2 * m).sum().sqrt()
    den = ((true - t_mean) ** 2 * m).sum().sqrt()
    return num / den


def masked_huber(pred, true, thresh: float | None = None,
                 delta: float = 1.0):
    m = _mask(true, thresh)
    r = (pred - true).abs()
    small = 0.5 * r ** 2
    large = delta * r - 0.5 * delta ** 2
    return _masked_mean(torch.where(r <= delta, small, large), m)


def corr(pred, true):
    """Per-node Pearson correlation averaged over nodes with nonzero
    std (`CORR_torch`, `lib/metrics.py:54-76`); std with Bessel's
    correction, as torch.std."""
    if pred.dim() == 2:          # (B, N)
        pred = pred[:, None, :, None]
        true = true[:, None, :, None]
    elif pred.dim() == 3:        # (B, N, D) -> (B, 1, D, N)
        pred = pred.transpose(1, 2)[:, None]
        true = true.transpose(1, 2)[:, None]
    elif pred.dim() == 4:        # (B, T, N, D) -> (B, T, D, N)
        pred = pred.transpose(2, 3)
        true = true.transpose(2, 3)
    else:
        raise ValueError(f"corr: unsupported rank {pred.dim()}")
    dims = (0, 1, 2)
    n = pred.shape[0] * pred.shape[1] * pred.shape[2]
    p_mean = pred.mean(dim=dims)
    t_mean = true.mean(dim=dims)
    p_std = (((pred - p_mean) ** 2).sum(dim=dims) / (n - 1)).sqrt()
    t_std = (((true - t_mean) ** 2).sum(dim=dims) / (n - 1)).sqrt()
    c = ((pred - p_mean) * (true - t_mean)).mean(dim=dims) / (p_std * t_std)
    valid = (t_std != 0).float()
    return (torch.where(valid > 0, c, torch.zeros_like(c)).sum()
            / valid.sum().clamp(min=1.0))


def all_metrics(pred, true, mae_thresh: float | None,
                mape_thresh: float | None):
    """(mae, rmse, mape, rrse, corr) — `lib/metrics.py:206-228`."""
    return (
        masked_mae(pred, true, mae_thresh),
        masked_rmse(pred, true, mae_thresh),
        masked_mape(pred, true, mape_thresh),
        masked_rrse(pred, true, mae_thresh),
        corr(pred, true),
    )
