"""TGCN — temporal graph convolutional network (graph-GRU).

Counterpart of the JAX package's `models/predictors/tgcn.py` (and of the
reference's `model/TGCN/TGCN.py`): a GRU whose gates are graph
convolutions over D^-1/2 (A+I) D^-1/2, followed by a linear readout of
all horizons from the final state. The time loop is a Python loop over
the node-major cell (`ops/recurrent.GraphGRUCellNM`). Defaults follow
`conf/TGCN/*.conf` (rnn_units=100).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gptst_tpu_torch.ops.recurrent import (
    GraphGRUCellNM, remat_cell, resolve_remat, variance_scaling_,
)


@dataclasses.dataclass(frozen=True)
class TGCNConfig:
    num_nodes: int
    rnn_units: int = 100
    lam: float = 0.0015  # L2 weight used by the reference's lreg variant
    # activation remat for the GRU cell: auto|none|full|dots
    # (`ops/recurrent.remat_cell`); "auto" resolves to "full" only from
    # 131072 nodes, as in the JAX package
    remat: str = "auto"


class TGCN(nn.Module):
    """x: (B, T, N, dim_in) -> (B, horizon, N, dim_out).

    Parameters: `cell` (flax's `ScanGraphGRUCell_0`) and `dense`
    (flax's `Dense_0`, as an `nn.Linear`); `convert.py` maps the trees.
    """

    def __init__(self, cfg: TGCNConfig, dim_in: int, dim_out: int,
                 horizon: int, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.dim_out, self.horizon = dim_out, horizon
        u = cfg.rnn_units
        self.cell = GraphGRUCellNM(dim_in, u, generator=generator)
        self.dense = nn.Linear(u, horizon * dim_out)
        # flax Dense: lecun_normal kernel, zero bias
        variance_scaling_(self.dense.weight, u, generator)
        nn.init.zeros_(self.dense.bias)

    def forward(self, x: torch.Tensor, support) -> torch.Tensor:
        B, T, N, _ = x.shape
        step = remat_cell(self.cell,
                          resolve_remat(self.cfg.remat, N, threshold=131072))
        xt = x.permute(1, 2, 0, 3).contiguous()           # (T, N, B, D)
        h = x.new_zeros(N, B, self.cfg.rnn_units)
        for t in range(T):
            h = step(h, xt[t], support)
        out = self.dense(h.transpose(0, 1))               # (B, N, T_out*D)
        out = out.reshape(B, N, self.horizon, self.dim_out)
        return out.permute(0, 2, 1, 3)
