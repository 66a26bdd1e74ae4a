from repro_torch.optim.adamw import (AdamWConfig,  # noqa: F401
                                     adamw_update, global_norm,
                                     init_opt_state, schedule)
