from repro_torch.data.synthetic_cicids import (  # noqa: F401
    BALANCED_SCENARIO,
    BASIC_SCENARIO,
    CLASS_NAMES,
    make_dataset,
    make_fleet_dataset,
    shannon_entropy,
)
from repro_torch.data.synthetic_lm import make_lm_dataset  # noqa: F401
