"""The data-parallel Train gang: bucketed DDP and ZeRO (``train.ddp``),
sharded checkpoints (``train.sharded_checkpoint``) and the Train backend
that brings the gang's group up (``train.backend_executor``)."""
from ray_tpu_torch.train.backend_executor import (  # noqa: F401
    Backend,
    TorchBackend,
    TorchConfig,
)
from ray_tpu_torch.train.sharded_checkpoint import (  # noqa: F401
    CheckpointError,
    PendingSnapshot,
    prune_generations,
    restore_sharded,
    save_sharded,
    summarize_checkpoints,
    verify_generation,
)
