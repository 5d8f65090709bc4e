"""Model API: the typed replacement for the reference's 5-tuple contract.

Every top-level reference model returns `(out, out_time, mask,
probability, eb)` (`model/BasicTrainer.py:82,90`). Here the contract is
an explicit struct; fields beyond `pred` are None except in pretrain
mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ModelOutput(NamedTuple):
    pred: torch.Tensor                        # (B, T_out, N, D_out)
    out_time: Optional[torch.Tensor] = None   # decoder hidden (pretrain)
    mask: Optional[torch.Tensor] = None       # 1 on masked-out points (pretrain)
    probability: Optional[torch.Tensor] = None  # mask-policy softmax (pretrain)
    routing: Optional[torch.Tensor] = None    # capsule assignment HS_cat (pretrain)
