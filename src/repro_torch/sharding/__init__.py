from repro_torch.sharding.policy import (NULL_POLICY, Policy,  # noqa: F401
                                         make_policy)
