"""FedS3A on PyTorch: the trainer with its sequential and batched round
engines, its config, the versioned and dense base stores, the chunk
layout, the paged client store, the fault layer (``TrafficModel``,
``REFERENCE_CHURN``, ``FleetStalledError``, ``WireIntegrityError``) and the
paper's comparison baselines, under the reference's names
(``repro/core/__init__.py``), with the chunked parameter axis's
``ParamLayout`` and ``make_adapter`` (the CNN or a model-zoo LM behind one
closure contract; ``FedS3AConfig(model=...)`` federates the LM). Fleet checkpoints are the
trainer's ``save_checkpoint`` / ``restore`` (``core/fleet_ckpt.py``). The
sharded engine is not ported, and not exported."""
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: F401
from repro_torch.core.base_store import (DenseBaseStore,  # noqa: F401
                                         VersionedBaseStore)
from repro_torch.core.client_store import PagedClientStore  # noqa: F401
from repro_torch.core.model_adapter import make_adapter  # noqa: F401
from repro_torch.core.param_layout import ParamLayout  # noqa: F401
from repro_torch.core.scheduler import FleetStalledError  # noqa: F401
from repro_torch.core.sparse_comm import (MALFORM_KINDS,  # noqa: F401
                                          WireIntegrityError)
from repro_torch.core.traffic import REFERENCE_CHURN, TrafficModel  # noqa: F401
from repro_torch.core.baselines import (FedAsyncSSL, FedAvgSSL,  # noqa: F401
                                        LocalSSL)
