"""Stage-state checkpoints (``repro.checkpoint`` for the port)."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointError,
    FunctionManager,
    pack_state,
    restore_checkpoint,
    save_checkpoint,
    unpack_state,
)
