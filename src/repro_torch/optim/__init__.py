from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, opt_state_specs)
from repro_torch.optim.schedules import cosine_schedule  # noqa: F401
