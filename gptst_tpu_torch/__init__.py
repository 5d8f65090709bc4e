"""gptst_tpu_torch — the PyTorch/CUDA port of `gptst_tpu`.

The same spatio-temporal GNN framework on one NVIDIA Hopper card: the
numpy config, data and graph-artifact pipeline, the sparse graph
aggregation behind hand-written CUDA kernels (`csrc/`), and the
predictors and trainer as `torch.nn.Module`s and a plain training loop.
Entry points run on `cuda` unless the caller asks for the CPU.

Ported so far: `-mode ori -model TGCN` (see `run.py`).
"""

__version__ = "0.1.0"
