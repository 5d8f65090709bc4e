"""Eval mode: frozen GPT-ST encoder + gated fusion + predictor.

Counterpart of the JAX package's `models/enhance.py` (the reference's
`model/Model.py`). The pretrained encoder's embedding is fused with a
linear projection of the raw input through a gated unit (`Fusion`,
`Model.py:5-18`) and handed to the predictor at `dim_in = hidden_dim`.

Freezing is structural, as in the JAX package (where the pretrain
parameters live outside the trainable tree): `EnhancedModel` holds the
encoder outside its registered submodules, so `parameters()`, the
optimizer, the global-norm clip and `state_dict()` see `head.*` and
`predictor.*` only, while `.to(device)` still moves the encoder. The
encoder runs under `torch.no_grad()` (JAX's `stop_gradient`) and in
f32 whatever the trainable tree's dtype (the bf16 cast of
`train/step.py` reaches only the trainable parameters, as in JAX;
a model moved to float64 as a whole runs its encoder in float64).
Under a mesh (`models/build.build_enhanced(mesh=...)`) the encoder runs
node-sharded over the calling data row's graph ranks. Where the
predictor runs node-sharded over the same ranks (STGCN, GWN, MTGNN,
CCRNN: `models/build.GraphPredictor.shards`), the embedding stays on
them: each rank runs the node-local head on its shard and hands the
predictor its shard, with no gather. Else the encoder gathers its
(B, T, N, hidden) embedding on the row's first device, where the head
and the predictor (its aggregation through its own sharded support)
read it.

State-dict keys of `EnhancedModel` (`best_model.pt` in eval mode):
  head.proj.{weight,bias}            (hidden, base)   flax head Dense_0
  head.fusion.dense.{0,1,2}.*        (hidden, hidden) Fusion_0/Dense_0..2
  predictor.net.*                    the predictor's own keys
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gptst_tpu_torch.models.api import ModelOutput
from gptst_tpu_torch.ops.dtypes import linear
from gptst_tpu_torch.parallel.mesh import module_on, per_rank


def torch_linear(din: int, dout: int,
                 generator: torch.Generator | None = None) -> nn.Linear:
    """`nn.Linear`'s own init law, weight and bias U(+-1/sqrt(fan_in)),
    drawn from `generator` (the JAX package's `_torch_linear`: the
    reference's eval-mode head keeps torch's default init)."""
    lin = nn.Linear(din, dout)
    bound = 1.0 / math.sqrt(din)
    with torch.no_grad():
        for p in (lin.weight, lin.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound)
                    - bound)
    return lin


class Fusion(nn.Module):
    """Gated fusion: z = sigmoid(W_s f + W_t t);
    H = W_o(z * f + (1 - z) * t) (`Model.py:5-18`)."""

    def __init__(self, dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.dense = nn.ModuleList(
            [torch_linear(dim, dim, generator) for _ in range(3)])

    def forward(self, flow_eb: torch.Tensor,
                time_eb: torch.Tensor) -> torch.Tensor:
        w_s, w_t, w_o = self.dense
        z = torch.sigmoid(linear(w_s, flow_eb) + linear(w_t, time_eb))
        return linear(w_o, z * flow_eb + (1.0 - z) * time_eb)


class EnhanceHead(nn.Module):
    """The trainable glue of eval mode: a projection of the base
    channels `source[..., :base]` to `hidden_dim`, fused with the
    encoder's embedding (`Model.py:43-44, 106-109`)."""

    def __init__(self, hidden_dim: int, input_base_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_base_dim = input_base_dim
        self.proj = torch_linear(input_base_dim, hidden_dim, generator)
        self.fusion = Fusion(hidden_dim, generator)

    def forward(self, source: torch.Tensor,
                pretrain_eb: torch.Tensor) -> torch.Tensor:
        x_t1 = linear(self.proj, source[..., : self.input_base_dim])
        return self.fusion(pretrain_eb, x_t1)


class EnhancedModel(nn.Module):
    """Eval mode in the `ModelOutput` contract: the frozen `encoder` (a
    GPT-ST, unregistered) reads the full (B, T, N, base+2) input, its
    calendar channels included; the head reads the base channels and
    the embedding; the predictor sees only the fused embedding."""

    def __init__(self, encoder: nn.Module, head: EnhanceHead,
                 predictor: nn.Module):
        super().__init__()
        self.head = head
        self.predictor = predictor
        encoder.requires_grad_(False).eval()
        # a plain attribute, not a submodule: outside parameters(),
        # state_dict() and the optimizer
        object.__setattr__(self, "encoder", encoder)

    def _apply(self, fn, recurse=True):
        # `.to()`, `.cuda()` and the like move the encoder too
        self.encoder._apply(fn)
        return super()._apply(fn, recurse)

    def train(self, mode: bool = True):
        super().train(mode)
        self.encoder.eval()
        return self

    def _encoder_dtype(self) -> torch.dtype:
        """The frozen encoder's own dtype: f32, unless the whole model
        was moved to another (`.double()`)."""
        return next(self.encoder.parameters()).dtype

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The frozen embedding (B, T, N, hidden), in the encoder's dtype
        (f32) and detached."""
        with torch.no_grad():
            return self.encoder.encode(x.to(self._encoder_dtype()))

    def fused_shards(self, x) -> list | None:
        """The head's output on each graph rank's node shard, from the
        encoder's shards left on their ranks, where the predictor runs
        node-sharded over the encoder's ranks; else None. x is the row's
        input, whole or as its ranks' node shards (the resident split's
        batch, which then stays on its ranks)."""
        lead = x[0] if isinstance(x, list) else x
        shards = getattr(self.predictor, "shards", lambda _: None)(
            lead.device)
        if shards is None or self.encoder.shards(x) != shards:
            return None
        dtype = self._encoder_dtype()
        with torch.no_grad():
            _, emb = self.encoder.encode_shards(
                per_rank(lambda t: t.to(dtype), x))
        return [module_on(self.head, e.device)(xg, e)
                for xg, e in zip(shards.split(x), emb)]

    def forward(self, x: torch.Tensor, y=None, step=None,
                generator: torch.Generator | None = None) -> ModelOutput:
        fused = self.fused_shards(x)
        if fused is None:
            fused = self.head(x, self.encode(x))
        return ModelOutput(pred=self.predictor(fused, y=y, step=step,
                                               generator=generator))
