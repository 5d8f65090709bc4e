from gptst_tpu_torch.train.loss import build_loss, make_scaler_mae_loss
from gptst_tpu_torch.train.trainer import (
    ClippedAdam, Trainer, make_lr_schedule, make_optimizer,
)

__all__ = [
    "build_loss", "make_scaler_mae_loss", "ClippedAdam", "Trainer",
    "make_lr_schedule", "make_optimizer",
]
