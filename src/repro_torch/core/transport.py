"""Transport Subsystem — reliability policies (paper §4.4, GBN vs SR;
DESIGN.md §2 Transport row). The port's copy of
``repro.core.transport``, which has no JAX: the same code, kept apart so
that the port imports nothing of the reference package.

Two layers:

1. A packet-level reliability simulator reproducing the paper's §6.1
   experiment (bandwidth vs loss rate: Selective Repeat degrades
   gracefully; Go-Back-N falls off a cliff near 1e-3).

2. The training-side analogue used by ft/manager.py: a worker failure is a
   "lost packet" of work. GBN = roll back to the last checkpoint and replay
   every step since (retransmit the window); SR = recompute only the failed
   microbatch and splice it in (needs the in-flight window buffered — the
   paper's extra reorder memory).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class LinkModel:
    bandwidth_Gbps: float = 100.0
    rtt_us: float = 3.0               # end-to-end, paper-scale
    packet_bytes: int = 4096
    window_packets: int = 64          # BDP-sized send window


def simulate_reliability(policy: str, loss_rate: float,
                         n_packets: int = 50_000,
                         link: LinkModel = LinkModel(),
                         seed: int = 0) -> Dict[str, float]:
    """Event-count simulation of GBN vs SR goodput under random loss.

    Returns {"goodput_Gbps", "sent_packets", "efficiency"}. Modeling
    choices mirror the paper: the sender keeps a full window in flight;
    on loss, GBN retransmits the whole outstanding window, SR retransmits
    exactly the lost packet (reorder buffer assumed adequate, its cost is
    reported by benchmarks/module_footprint.py).
    """
    rng = random.Random(seed)
    sent = 0
    delivered = 0
    i = 0
    window = link.window_packets
    while delivered < n_packets:
        # one "flight" of `window` packets
        flight = min(window, n_packets - delivered)
        losses = [k for k in range(flight) if rng.random() < loss_rate]
        sent += flight
        if not losses:
            delivered += flight
            continue
        if policy == "gbn":
            # everything after the first loss is retransmitted
            delivered += losses[0]
            sent += 0  # retransmissions counted on subsequent iterations
        elif policy == "sr":
            delivered += flight - len(losses)
            # lost packets retransmitted individually until through
            for _ in losses:
                tries = 1
                while rng.random() < loss_rate:
                    tries += 1
                sent += tries
                delivered += 1
        else:
            raise ValueError(policy)
    efficiency = n_packets / max(sent, 1)
    return {
        "goodput_Gbps": link.bandwidth_Gbps * efficiency,
        "sent_packets": float(sent),
        "efficiency": efficiency,
    }


# --------------------------------------------------------------------------
# training-step reliability (used by ft/manager.py)
# --------------------------------------------------------------------------

@dataclass
class RecoveryCost:
    steps_replayed: int = 0
    microbatches_recomputed: int = 0
    checkpoints_restored: int = 0


def gbn_recovery_plan(failed_step: int, last_checkpoint_step: int
                      ) -> RecoveryCost:
    """Go-Back-N: restore the checkpoint, replay every step since."""
    return RecoveryCost(steps_replayed=failed_step - last_checkpoint_step,
                        checkpoints_restored=1)


def sr_recovery_plan(failed_microbatches: List[int]) -> RecoveryCost:
    """Selective Repeat: recompute only the failed microbatches; the
    surviving workers' grads stay buffered (reorder-buffer analogue)."""
    return RecoveryCost(microbatches_recomputed=len(failed_microbatches))


def simulate_training_goodput(policy: str, failure_rate_per_step: float,
                              n_steps: int = 10_000,
                              checkpoint_every: int = 100,
                              microbatches_per_step: int = 8,
                              step_cost: float = 1.0,
                              ckpt_restore_cost: float = 5.0,
                              seed: int = 0) -> Dict[str, float]:
    """Useful-steps / total-work under random worker failures."""
    rng = random.Random(seed)
    work = 0.0
    step = 0
    last_ckpt = 0
    while step < n_steps:
        work += step_cost
        if rng.random() < failure_rate_per_step:
            if policy == "gbn":
                plan = gbn_recovery_plan(step, last_ckpt)
                work += ckpt_restore_cost + plan.steps_replayed * step_cost
                step = last_ckpt  # replayed internally; step counter resumes
                # replay happens at full speed; account and fast-forward
                step += plan.steps_replayed
            elif policy == "sr":
                plan = sr_recovery_plan([rng.randrange(
                    microbatches_per_step)])
                work += (plan.microbatches_recomputed
                         / microbatches_per_step) * step_cost
            else:
                raise ValueError(policy)
        step += 1
        if step % checkpoint_every == 0:
            last_ckpt = step
    return {"goodput": n_steps * step_cost / work, "total_work": work}
