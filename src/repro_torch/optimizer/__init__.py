from repro_torch.optimizer.adam import (  # noqa: F401
    adam_init, adam_init_rows, adam_update, adam_update_rows)
