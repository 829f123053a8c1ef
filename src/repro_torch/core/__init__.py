"""FedS3A on PyTorch: the trainer with its sequential and batched round
engines, its config, the versioned base store, the chunk layout, the paged client store,
and the paper's comparison baselines, under the reference's names
(``repro/core/__init__.py``), with the chunked parameter axis's
``ParamLayout``. What is not ported yet (faults and fleet checkpoints, the
sharded engine) is not exported."""
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: F401
from repro_torch.core.base_store import VersionedBaseStore  # noqa: F401
from repro_torch.core.client_store import PagedClientStore  # noqa: F401
from repro_torch.core.param_layout import ParamLayout  # noqa: F401
from repro_torch.core.baselines import (FedAsyncSSL, FedAvgSSL,  # noqa: F401
                                        LocalSSL)
