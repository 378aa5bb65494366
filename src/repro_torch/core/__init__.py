"""JingZhao core: the paper's building blocks, in PyTorch.

- pipeline:    PPU/Stage/Pipeline dataflow model (Fig. 4)
- multiqueue:  Dynamic MultiQueue building block (Table 1, Fig. 9)
- primitives:  Append/Remove Header, Scatter/Gather Data (Table 1)
- resource:    Resource Subsystem: two-tier store, VoQ non-blocking misses
- transport:   Transport Subsystem: GBN/SR reliability policies
- simulation:  system-level event simulation (host/bus/cache)
"""
from repro_torch.core.multiqueue import (HostMultiQueue, MQState,  # noqa
                                         batched_enqueue, mq_init, mq_pop,
                                         mq_push, mq_sizes)
from repro_torch.core.pipeline import PPU, Pipeline, Stage, measure_ppu  # noqa
from repro_torch.core.resource import (BusModel, PagePool,  # noqa
                                       VoQResourceStore)
from repro_torch.core.simulation import (SimConfig,  # noqa
                                         miss_overhead_model, simulate)
from repro_torch.core.transport import (simulate_reliability,  # noqa
                                        simulate_training_goodput)
