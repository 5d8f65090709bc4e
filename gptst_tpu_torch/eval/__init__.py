from gptst_tpu_torch.eval.metrics import (
    all_metrics, corr, masked_huber, masked_mae, masked_mape, masked_mare,
    masked_mse, masked_opnbi, masked_pnbi, masked_rmse, masked_rrse,
    masked_smape,
)

__all__ = [
    "all_metrics", "corr", "masked_huber", "masked_mae", "masked_mape",
    "masked_mare", "masked_mse", "masked_opnbi", "masked_pnbi",
    "masked_rmse", "masked_rrse", "masked_smape",
]
