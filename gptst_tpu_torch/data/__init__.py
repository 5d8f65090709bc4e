from gptst_tpu_torch.data.pipeline import (
    STDataset, build_dataset, load_raw_series, split_by_days, split_by_ratio,
)
from gptst_tpu_torch.data.scalers import (
    MinMax01Scaler, MinMax11Scaler, NScaler, StandardScaler,
    fit_channel_scalers, fit_standard_scaler,
)
from gptst_tpu_torch.data.synthetic import synthesize_raw_series
from gptst_tpu_torch.data.timefeat import attach_time_channels, time_features
from gptst_tpu_torch.data.window import add_window_horizon

__all__ = [
    "STDataset", "build_dataset", "load_raw_series", "split_by_days",
    "split_by_ratio", "MinMax01Scaler", "MinMax11Scaler", "NScaler",
    "StandardScaler", "fit_channel_scalers", "fit_standard_scaler",
    "synthesize_raw_series", "attach_time_channels", "time_features",
    "add_window_horizon",
]
