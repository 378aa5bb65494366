"""Fault tolerance of the port: the serving fault and crash injectors,
the chaos harness, and the fault-tolerant trainer."""
from repro_torch.ft.faults import ServingFaultInjector  # noqa
from repro_torch.ft.crash import (CrashInjector, POLICY_REPLAY,  # noqa
                                  POLICY_SNAPSHOT, policy_of)
from repro_torch.ft.chaos import (ChaosReport, build_stack,  # noqa
                                  crash_anywhere_sweep, drive,
                                  random_schedule)
from repro_torch.ft.manager import (FaultTolerantTrainer, FTConfig,  # noqa
                                   FTStats)
