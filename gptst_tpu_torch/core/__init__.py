from gptst_tpu_torch.core.distributed import (
    global_mesh, initialize_distributed, is_coordinator,
)

__all__ = ["global_mesh", "initialize_distributed", "is_coordinator"]
