from gptst_tpu_torch.eval.metrics import (
    all_metrics, corr, masked_huber, masked_mae, masked_mape, masked_mse,
    masked_rmse, masked_rrse,
)

__all__ = [
    "all_metrics", "corr", "masked_huber", "masked_mae", "masked_mape",
    "masked_mse", "masked_rmse", "masked_rrse",
]
