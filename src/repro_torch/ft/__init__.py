"""Serving-side fault tolerance of the port: the fault and crash
injectors and the chaos harness (the reference's training-side manager
is not ported)."""
from repro_torch.ft.faults import ServingFaultInjector  # noqa
from repro_torch.ft.crash import (CrashInjector, POLICY_REPLAY,  # noqa
                                  POLICY_SNAPSHOT, policy_of)
from repro_torch.ft.chaos import (ChaosReport, build_stack,  # noqa
                                  crash_anywhere_sweep, drive,
                                  random_schedule)
