"""FedS3A on PyTorch: the trainer with its sequential and batched round
engines, its config, and the versioned base store, under the reference's
names (``repro/core/__init__.py``). What is not ported yet (the paged
client store, faults, baselines, the sharded engine) is not exported."""
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: F401
from repro_torch.core.base_store import VersionedBaseStore  # noqa: F401
