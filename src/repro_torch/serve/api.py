"""Pluggable serving subsystem API of the port.

The same frame as ``repro.serve.api``: ``ServingEngine`` (serve/engine.py)
drives subsystems behind protocols, selected by name from
``EngineConfig``:

  Scheduler        <- Queue Subsystem: admission order over QoS classes
  StateBackend     <- Resource Subsystem: page accounting + the decode
                      state layout (per-slot dense slabs, the paged KV
                      pool behind page tables, or per-slot recurrent
                      carries)
  ParkingTransport <- Transport Subsystem: host-tier park/restore moves
  Sampler          <- per-token selection on the device

The port keeps its own registries, so its parts never collide with the
JAX package's names. The protocols list what this slice implements:
crash snapshots, chunked prefill and prefix sharing join them with their
slices (ROADMAP queue A). ``EngineConfig`` refuses the settings that are
not ported yet, naming the slice that brings each.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Protocol, Tuple, Type, runtime_checkable)

import numpy as np

from repro_torch.core.resource import BusModel
from repro_torch.core.timing import DEFAULT_CLOCK


@dataclass
class SamplingParams:
    """Per-request token-selection parameters. The port serves the
    defaults only (exact greedy, no logprobs); stochastic sampling waits
    for ROADMAP item A5."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    logprobs: bool = False


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    qos: int = 0                  # QoS class; 0 = highest priority
    arrived_at: float = 0.0
    tokens_out: List[int] = field(default_factory=list)
    finished_at: Optional[float] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)


@dataclass
class EngineConfig:
    slots: int = 4
    cache_len: int = 256
    page_size: int = 16
    n_pages: int = 256            # device page budget (admission control)
    prefix_cache_entries: int = 0  # must stay 0 until the prefix cache slice
    prefill_chunk: int = 0        # must stay 0 (monolithic prefill)
    decode_span: int = 8          # decode steps between host syncs
    eos_token: int = 0
    host_offload: bool = True     # VoQ overflow tier
    kv_layout: str = "dense"      # StateBackend name
    scheduler: str = "fcfs"       # Scheduler name
    sampler: str = "greedy"       # Sampler name
    qos_classes: int = 4
    queue_capacity: int = 1 << 12
    bus: BusModel = field(default_factory=BusModel)
    # the one time source: arrival and completion stamps, eviction
    # tie-breaks and bus-timed park/restore readiness all read it
    clock: Callable[[], float] = field(default=DEFAULT_CLOCK, repr=False,
                                       compare=False)

    def __post_init__(self):
        if self.kv_layout not in ("dense", "paged", "recurrent"):
            raise ValueError(
                f"kv_layout {self.kv_layout!r} is not ported yet: the port "
                f"serves 'dense' (every ported config), 'paged' (plain "
                f"attention) and 'recurrent' (RWKV); the 'latent' backend "
                f"waits for ROADMAP item A8")
        if self.sampler != "greedy":
            raise ValueError(
                f"sampler {self.sampler!r} is not ported yet: the port "
                f"serves 'greedy' only; stochastic sampling waits for "
                f"ROADMAP item A5")
        if self.prefill_chunk != 0:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk}: chunked prefill is "
                f"not ported yet (the chunked-prefill and prefix-cache "
                f"slice, ROADMAP queue A4); use 0 for monolithic prefill")
        if self.prefix_cache_entries != 0:
            raise ValueError(
                f"prefix_cache_entries={self.prefix_cache_entries}: the "
                f"prefix cache is not ported yet (the chunked-prefill and "
                f"prefix-cache slice, ROADMAP queue A4); use 0")


class ParkMeta(NamedTuple):
    """Restore metadata a StateBackend attaches to parked slot state."""
    length: int
    position: int
    slot: int
    n_pages: int


# --------------------------------------------------------------------------
# protocols
# --------------------------------------------------------------------------

@runtime_checkable
class Scheduler(Protocol):
    """Admission order over QoS class queues; `requeue` keeps a
    request's class."""
    n_classes: int

    def class_of(self, req: Request) -> int: ...
    def submit(self, req: Request) -> bool: ...
    def next(self) -> Optional[Request]: ...
    def requeue(self, req: Request) -> bool: ...
    @property
    def pending(self) -> int: ...
    @property
    def space(self) -> int: ...


@runtime_checkable
class StateBackend(Protocol):
    """A slot's decode-state layout + page accounting. `append` is
    alloc-on-append growth, `reserve_span` claims a decode span's pages
    up front, `sync` re-exports the page tables into the decode state
    when they changed. Capability flags route the engine instead of
    config sniffing: `needs_growth` gates span reservation, pool growth
    and prefix-cache eviction; `supports_chunked_prefill` and
    `supports_prefix_share` gate streaming prefill and the block prefix
    cache (both off in the port until ROADMAP A4b)."""
    needs_growth: bool            # True if capacity can run out mid-decode
    supports_chunked_prefill: bool  # slot state extends a chunk at a time
    supports_prefix_share: bool   # per-token blocks can back a PrefixCache
    pool: Any

    def init_state(self) -> dict: ...
    def footprint(self, req: Request) -> int: ...
    def admission_error(self, req: Request) -> Optional[str]: ...
    def append(self, req_id: int, n_tokens: int) -> bool: ...
    def reserve_span(self, req_id: int, n_tokens: int) -> bool: ...
    def held(self, req_id: int) -> int: ...
    def prefill_into_slot(self, state: dict, slot: int, req_id: int,
                          caches, length: int) -> dict: ...
    def park(self, state: dict, slot: int,
             req_id: int) -> Tuple[Any, ParkMeta]: ...
    def unpark(self, state: dict, slot: int, req: Request, caches,
               meta: ParkMeta) -> Tuple[bool, dict]: ...
    def release(self, req_id: int) -> None: ...
    def mark_dirty(self) -> None: ...
    def sync(self, state: dict,
             slot_req_ids: List[Optional[int]]) -> dict: ...


@runtime_checkable
class Sampler(Protocol):
    """On-device token selection: `sample(logits [B,V], keys, params)`
    picks one token per row without reading the device."""
    needs_rng: bool

    def slot_params(self, req: Optional[Request]) -> Tuple[Any, ...]: ...
    def sample(self, logits, keys, params): ...


@runtime_checkable
class ParkingTransport(Protocol):
    """The host-tier move/restore channel for parked slot state."""

    def begin(self, req_id: int, caches, meta: ParkMeta) -> None: ...
    def ready(self, now: Optional[float] = None) -> List[int]: ...
    def peek(self, req_id: int) -> Tuple[Any, ParkMeta]: ...
    def complete(self, req_id: int) -> None: ...
    @property
    def in_flight(self) -> int: ...


# --------------------------------------------------------------------------
# registries — parts plug in by name
# --------------------------------------------------------------------------

SCHEDULERS: Dict[str, Type] = {}
STATE_BACKENDS: Dict[str, Type] = {}
SAMPLERS: Dict[str, Type] = {}


def _positional_shape(fn) -> Optional[Tuple[int, int]]:
    """(min, max) positional arity after self/cls; max = -1 for *args."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    params = list(sig.parameters.values())
    pos = [p for p in params
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if pos and pos[0].name in ("self", "cls"):
        pos = pos[1:]
    required = sum(1 for p in pos if p.default is p.empty)
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return (required, -1)
    return (required, len(pos))


def _conformance_errors(cls: Type, proto: Type) -> List[str]:
    """Methods and properties `proto` declares must exist on `cls` with
    call-compatible positional arity."""
    errors: List[str] = []
    for pname, member in sorted(vars(proto).items()):
        if pname.startswith("_"):
            continue
        if isinstance(member, property):
            if not hasattr(cls, pname):
                errors.append(f"missing property `{pname}`")
        elif inspect.isfunction(member):
            impl = getattr(cls, pname, None)
            if impl is None or not callable(impl):
                errors.append(f"missing method `{pname}`")
                continue
            want, have = _positional_shape(member), _positional_shape(impl)
            if want is None or have is None:
                continue
            if have[0] > want[0]:
                errors.append(f"`{pname}` requires {have[0]} positional "
                              f"arg(s) but the protocol passes as few as "
                              f"{want[0]}")
            elif have[1] != -1 and have[1] < want[1]:
                errors.append(f"`{pname}` accepts at most {have[1]} "
                              f"positional arg(s) but the protocol "
                              f"declares {want[1]}")
    return errors


def _checked_register(kind: str, proto: Type, registry: Dict[str, Type]
                      ) -> Callable[[str], Callable[[Type], Type]]:
    def register(name: str) -> Callable[[Type], Type]:
        def deco(cls: Type) -> Type:
            errors = _conformance_errors(cls, proto)
            if errors:
                raise TypeError(
                    f"cannot register {kind} {name!r}: class "
                    f"`{cls.__name__}` does not satisfy "
                    f"`{proto.__name__}`: " + "; ".join(errors))
            cls.name = name
            registry[name] = cls
            return cls
        return deco
    return register


register_scheduler = _checked_register("scheduler", Scheduler, SCHEDULERS)
register_state_backend = _checked_register(
    "state backend", StateBackend, STATE_BACKENDS)
register_sampler = _checked_register("sampler", Sampler, SAMPLERS)


def make_scheduler(name: str, n_classes: int = 4,
                   capacity: int = 1 << 12) -> Scheduler:
    from repro_torch.serve import schedulers  # noqa: F401 (built-ins)
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"registered: {sorted(SCHEDULERS)}")
    return SCHEDULERS[name](n_classes=n_classes, capacity=capacity)


def make_state_backend(name: str, cfg, ecfg: EngineConfig,
                       device) -> StateBackend:
    from repro_torch.serve import state_backends  # noqa: F401 (built-ins)
    if name not in STATE_BACKENDS:
        raise ValueError(f"unknown kv layout {name!r}; "
                         f"registered: {sorted(STATE_BACKENDS)}")
    return STATE_BACKENDS[name](cfg, ecfg, device)


def make_sampler(name: str) -> Sampler:
    from repro_torch.serve import samplers  # noqa: F401 (built-ins)
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; "
                         f"registered: {sorted(SAMPLERS)}")
    return SAMPLERS[name]()


def default_page_budget(slots: int, cache_len: int, page_size: int,
                        slack_slots: int = 1) -> int:
    """Device page budget backing `slots` worst-case sequences, plus
    `slack_slots` slots of headroom so an unpark never deadlocks against
    a fully committed pool."""
    per_slot = -(-cache_len // page_size)
    return (slots + slack_slots) * per_slot
