from gptst_tpu_torch.config.config import FrameworkConfig, default_config, from_ini
from gptst_tpu_torch.config.datasets import DATASETS, DatasetSpec, get_dataset_spec

__all__ = [
    "FrameworkConfig", "default_config", "from_ini",
    "DATASETS", "DatasetSpec", "get_dataset_spec",
]
