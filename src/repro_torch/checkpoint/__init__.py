"""Checkpoints of parameter trees in the reference's msgpack layout."""
from repro_torch.checkpoint.msgpack_ckpt import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
