"""System-level event simulation (paper C4): host/bus/cache interaction
(drives the Fig-12 analogue, DESIGN.md §5). Copied from
``repro.core.simulation``, as it is: its defaults are the paper's NIC
settings (§6.2: a PCIe bus, 100 Gbps, a 95 Mops slowest PPU), not a
chip's figures.

A discrete-event simulator for the Resource Subsystem's behavior under
cache misses — the piece the paper argues network simulators can't give
you. Components: a request stream over N connections, a fast-tier cache,
a PCIe-like bus (transfer occupancy + fixed latency + transaction-rate
cap), and a processing pipeline. Resource fetches *compete with payload
DMA for the same bus* — the root cause of the paper's Fig-12 throughput
collapse at 100 % miss.

Two miss policies:
  "blocking" — one outstanding miss stalls every connection (Fig 6);
  "voq"      — a miss parks only its own connection; fetches for other
               connections issue out-of-order (Fig 7).

The reference's benchmarks/resource_miss.py reproduces Fig 12 with it,
and the tests hold the paper's headline claims (VoQ bandwidth loss at
100 % miss ≈ metadata/payload ratio; blocking collapses by the
latency/occupancy ratio).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class SimConfig:
    n_connections: int = 256
    payload_bytes: int = 4096
    metadata_bytes: int = 108          # QPC+CQC+MPT+MTT (paper §6.2)
    miss_rate: float = 0.0
    policy: str = "voq"                # voq | blocking
    bus_latency_s: float = 350e-9
    bus_bandwidth_Bps: float = 12.5e9  # 100 Gbps
    bus_ops_per_s: float = 200e6
    pipeline_ops_per_s: float = 95e6   # slowest PPU (Table 3)
    n_requests: int = 20_000
    seed: int = 0


def simulate(cfg: SimConfig) -> Dict[str, float]:
    """Run the event simulation; returns bandwidth/throughput/latency.

    Bus semantics: occupancy = bytes/bandwidth + 1/ops_rate (the engine is
    busy for the transfer); a fixed fabric latency is added to completions
    (transactions pipeline through the fabric). Under "voq" the bus serves
    whichever connection's transfer is ready (out-of-order across
    connections — Fig 7); under "blocking" requests are admitted strictly
    in order, so one miss at the head stalls every connection (Fig 6).
    """
    import heapq
    rng = random.Random(cfg.seed)
    op_dt = 1.0 / cfg.bus_ops_per_s
    pipe_dt = 1.0 / cfg.pipeline_ops_per_s
    occ_meta = cfg.metadata_bytes / cfg.bus_bandwidth_Bps + op_dt
    occ_pay = cfg.payload_bytes / cfg.bus_bandwidth_Bps + op_dt

    misses = [rng.random() < cfg.miss_rate for _ in range(cfg.n_requests)]
    arrivals = [i * pipe_dt for i in range(cfg.n_requests)]
    done = [0.0] * cfg.n_requests

    bus_free = 0.0
    pipe_free = 0.0

    if cfg.policy == "voq":
        # event heap: (ready_time, order, req, phase)  phase: 0=fetch 1=pay
        heap = []
        for i in range(cfg.n_requests):
            heapq.heappush(heap, (arrivals[i], i, 0 if misses[i] else 1))
        while heap:
            t_ready, i, phase = heapq.heappop(heap)
            start = max(t_ready, bus_free)
            if phase == 0:
                bus_free = start + occ_meta
                heapq.heappush(
                    heap, (start + occ_meta + cfg.bus_latency_s, i, 1))
            else:
                bus_free = start + occ_pay
                arrive_chip = start + occ_pay + cfg.bus_latency_s
                t_pipe = max(arrive_chip, pipe_free)
                pipe_free = t_pipe + pipe_dt
                done[i] = t_pipe + pipe_dt
    else:  # blocking: strict in-order admission
        stall = 0.0
        for i in range(cfg.n_requests):
            t = max(arrivals[i], stall)
            if misses[i]:
                start = max(t, bus_free)
                bus_free = start + occ_meta
                t = start + occ_meta + cfg.bus_latency_s
                stall = t              # head-of-line: all wait
            start = max(t, bus_free)
            bus_free = start + occ_pay
            arrive_chip = start + occ_pay + cfg.bus_latency_s
            t_pipe = max(arrive_chip, pipe_free)
            pipe_free = t_pipe + pipe_dt
            done[i] = t_pipe + pipe_dt

    last_done = max(done)
    lats = sorted(d - a for d, a in zip(done, arrivals))
    total_payload = cfg.n_requests * cfg.payload_bytes
    return {
        "bandwidth_Gbps": total_payload * 8 / last_done / 1e9,
        "throughput_Mops": cfg.n_requests / last_done / 1e6,
        "mean_latency_us": sum(lats) / cfg.n_requests * 1e6,
        "p99_latency_us": lats[int(0.99 * len(lats))] * 1e6,
    }


def miss_overhead_model(payload_bytes: int, metadata_bytes: int = 108
                        ) -> float:
    """Paper §6.2 analytic claim: bandwidth loss at 100 % miss ≈
    metadata/(metadata+payload) when fetches share the DMA path."""
    return metadata_bytes / (metadata_bytes + payload_bytes)
