"""Carry TGCN weights between the JAX package's flax tree and the
port's `state_dict`.

The flax tree (numpy arrays):
  {'params': {'ScanGraphGRUCell_0': {'weights_0': (D+U, 2U), 'bias_0',
                                     'weights_1': (D+U, U), 'bias_1'},
              'Dense_0': {'kernel': (U, H*D_out), 'bias'}}}

The GRU weights keep flax's (in, out) layout (the cell computes
`x @ W`); the Dense kernel is transposed into `nn.Linear.weight`.
Keys of the returned state dict are those of `TGCN` (`cell.*`,
`dense.*`); pass `prefix` for a wrapping module's keys.
"""

from __future__ import annotations

import numpy as np
import torch

_CELL = "ScanGraphGRUCell_0"
_GRU = ("weights_0", "bias_0", "weights_1", "bias_1")


def flax_to_state_dict(params: dict, prefix: str = "") -> dict:
    p = params.get("params", params)
    sd = {f"{prefix}cell.{k}": torch.as_tensor(np.array(p[_CELL][k]))
          for k in _GRU}
    sd[f"{prefix}dense.weight"] = torch.as_tensor(
        np.array(p["Dense_0"]["kernel"]).T.copy())
    sd[f"{prefix}dense.bias"] = torch.as_tensor(np.array(p["Dense_0"]["bias"]))
    return sd


def state_dict_to_flax(sd: dict, prefix: str = "") -> dict:
    def get(k):
        return sd[prefix + k].detach().cpu().numpy()

    return {"params": {
        _CELL: {k: get(f"cell.{k}") for k in _GRU},
        "Dense_0": {"kernel": get("dense.weight").T.copy(),
                    "bias": get("dense.bias")},
    }}
