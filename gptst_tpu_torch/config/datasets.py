"""Dataset registry.

Mirrors the per-dataset constants scattered through the reference
(`lib/load_dataset.py:43-89` and `conf/GPTST_pretrain/*.conf`): node
counts, measurement interval, week phase at the start of recording,
holiday indices, and channel counts.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    # number of base signal channels (1 flow/speed, 2 pick+drop)
    input_base_dim: int
    # minutes per timestep
    interval: int
    # weekday (1..7) of the first recorded day
    week_start: int
    # day indices (1-based) that are forced to "holiday"
    holiday_list: Sequence[int]
    # days per week cycle
    week_day: int = 7
    # chronological split ratios
    val_ratio: float = 0.2
    test_ratio: float = 0.2
    # masked-metric thresholds (reference conf [test] sections)
    mae_thresh: float | None = None
    mape_thresh: float = 0.0
    # typical total number of timesteps (used by the synthetic generator)
    typical_length: int = 17856

    @property
    def steps_per_day(self) -> int:
        return 24 * 60 // self.interval


# Values from the reference's `lib/load_dataset.py:44-89` and
# `conf/GPTST_pretrain/{PEMS08,METR_LA,NYC_BIKE,NYC_TAXI}.conf`.
DATASETS: dict[str, DatasetSpec] = {
    "PEMS08": DatasetSpec(
        name="PEMS08", num_nodes=170, input_base_dim=1, interval=5,
        week_start=5, holiday_list=(4,), val_ratio=0.2, test_ratio=0.2,
        mae_thresh=None, mape_thresh=0.0, typical_length=17856,
    ),
    "METR_LA": DatasetSpec(
        name="METR_LA", num_nodes=207, input_base_dim=1, interval=5,
        week_start=4, holiday_list=(88,), val_ratio=0.1, test_ratio=0.2,
        mae_thresh=0.0, mape_thresh=0.0, typical_length=34272,
    ),
    "NYC_BIKE": DatasetSpec(
        name="NYC_BIKE", num_nodes=250, input_base_dim=2, interval=30,
        week_start=5, holiday_list=(), val_ratio=0.2, test_ratio=0.2,
        mae_thresh=None, mape_thresh=0.001, typical_length=4368,
    ),
    "NYC_TAXI": DatasetSpec(
        name="NYC_TAXI", num_nodes=266, input_base_dim=2, interval=30,
        week_start=5, holiday_list=(), val_ratio=0.2, test_ratio=0.2,
        mae_thresh=None, mape_thresh=0.001, typical_length=4368,
    ),
}


def get_dataset_spec(name: str) -> DatasetSpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; known: {sorted(DATASETS)}"
        ) from None
