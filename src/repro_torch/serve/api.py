"""Pluggable serving subsystem API of the port.

The same frame as ``repro.serve.api``: ``ServingEngine`` (serve/engine.py)
drives subsystems behind protocols, selected by name from
``EngineConfig``:

  Scheduler        <- Queue Subsystem: admission order over QoS classes
  StateBackend     <- Resource Subsystem: page accounting + the decode
                      state layout (per-slot dense slabs, the paged KV
                      pool behind page tables, MLA latent pages, or
                      per-slot recurrent carries)
  ParkingTransport <- Transport Subsystem: host-tier park/restore moves
  Sampler          <- per-token selection on the device
  Frontend         <- the client side: continuous arrivals, per-token
                      streaming, SLO-graded admission

The port keeps its own registries, so its parts never collide with the
JAX package's names. The protocols carry the crash-recovery members
(`export`/`import_`, `export_state`/`import_state`, the payload codec,
`reattach`), and `request_to_state`/`request_from_state` are the
requests' snapshot codec. ``EngineConfig`` refuses a layout other than
the four built-ins. ``make_engine`` wires an engine from an
``EngineConfig`` and ``make_frontend`` a front end over it.
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
    """Per-request token-selection parameters.

    The defaults are exact greedy: ``temperature <= 0`` returns the argmax
    of the raw logits. ``top_k <= 0`` and ``top_p >= 1`` disable their
    filters. ``seed`` names the replayable stream (folded into the key
    modulo 2^32): a request's keys are a pure function of ``(seed,
    req_id)`` and the token's index in its emitted stream, so the stream
    does not depend on batching, span length, prefill chunking or
    parking wherever the logits are bit-equal, and equals the JAX
    reference's wherever a draw is not within a few ulp of a tie.
    ``logprobs`` records each chosen token's log-probability under the
    raw logits in ``Request.logprobs_out``."""
    temperature: float = 0.0
    top_k: int = 0                # 0 = full vocab
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
    logprobs_out: List[float] = field(default_factory=list)
    # streaming hooks: the engine calls `on_tokens(req, toks)` with the
    # tokens just appended, at its existing host syncs (one per finished
    # prefill, one per decode span), and `on_done(req)` once when the
    # request completes. A preempt-restart replays the stream from index
    # 0; the front end's handle drops what it already delivered.
    on_tokens: Optional[Callable[["Request", List[int]], None]] = \
        field(default=None, repr=False, compare=False)
    on_done: Optional[Callable[["Request"], None]] = \
        field(default=None, repr=False, compare=False)


@dataclass
class EngineConfig:
    slots: int = 4
    cache_len: int = 256
    page_size: int = 16
    n_pages: int = 256            # device page budget (admission control)
    prefix_cache_entries: int = 32
    prefill_chunk: int = 0        # tokens per prefill chunk; 0 = monolithic
    prefill_budget: int = 0       # prefill tokens per engine step, spent
                                  # in whole chunks (min. one chunk/step);
                                  # 0 derives it from prefill_chunk
    decode_span: int = 8          # decode steps between host syncs
    eos_token: int = 0
    host_offload: bool = True     # VoQ overflow tier
    kv_layout: str = "dense"      # StateBackend name
    scheduler: str = "fcfs"       # Scheduler name
    sampler: str = "greedy"       # Sampler name: "greedy" | "stochastic"
    frontend: str = "local"       # Frontend name
    qos_classes: int = 4
    queue_capacity: int = 1 << 12
    bus: BusModel = field(default_factory=BusModel)
    # the one time source: arrival and completion stamps, eviction
    # tie-breaks, bus-timed park/restore readiness and SLO accounting all
    # read it (tests and the launcher's live mode inject a VirtualClock)
    clock: Callable[[], float] = field(default=DEFAULT_CLOCK, repr=False,
                                       compare=False)
    # front-end admission control
    admit_capacity: int = 64      # bounded wait pool (all classes)
    feed_depth: int = 0           # scheduler backlog the front end keeps
                                  # fed; 0 derives it from `slots`
    slo_ttft: Tuple[float, ...] = ()   # per-class TTFT budgets, clock units
                                       # (a shorter tuple broadcasts its
                                       # last entry; () or <= 0 = none)
    slo_tpot: Tuple[float, ...] = ()   # per-class per-token budgets
    degrade_max_new: int = 0      # > 0: under pressure, lower classes are
                                  # admitted with max_new_tokens clamped to
                                  # this instead of queued at full length

    def __post_init__(self):
        if self.kv_layout not in ("dense", "paged", "latent", "recurrent"):
            raise ValueError(
                f"kv_layout {self.kv_layout!r} is not ported yet: the port "
                f"serves 'dense' (every config), 'paged' (plain attention), "
                f"'latent' (all-MLA) and 'recurrent' (RWKV)")


class ParkMeta(NamedTuple):
    """Restore metadata a StateBackend attaches to parked slot state."""
    length: int
    position: int
    slot: int
    n_pages: int


def request_to_state(req: Request) -> dict:
    """JSON-able snapshot of a Request.

    The streaming hooks are dropped: they are process-local callables
    that `Frontend.reattach` re-wires after a restore. The anchors of the
    key derivation, `sampling.seed` and `len(tokens_out)` (the emitted
    index folded into each key), are carried verbatim, so a restored
    request re-derives its key stream exactly.
    """
    s = req.sampling
    return {
        "req_id": int(req.req_id),
        "prompt": [int(t) for t in np.asarray(req.prompt).reshape(-1)],
        "max_new_tokens": int(req.max_new_tokens),
        "qos": int(req.qos),
        "arrived_at": float(req.arrived_at),
        "tokens_out": [int(t) for t in req.tokens_out],
        "finished_at": (None if req.finished_at is None
                        else float(req.finished_at)),
        "sampling": [float(s.temperature), int(s.top_k), float(s.top_p),
                     int(s.seed), bool(s.logprobs)],
        "logprobs_out": [float(x) for x in req.logprobs_out],
    }


def request_from_state(d: dict) -> Request:
    temp, top_k, top_p, seed, logprobs = d["sampling"]
    return Request(
        req_id=int(d["req_id"]),
        prompt=np.asarray(d["prompt"], dtype=np.int32),
        max_new_tokens=int(d["max_new_tokens"]),
        qos=int(d["qos"]),
        arrived_at=float(d["arrived_at"]),
        tokens_out=[int(t) for t in d["tokens_out"]],
        finished_at=(None if d["finished_at"] is None
                     else float(d["finished_at"])),
        sampling=SamplingParams(float(temp), int(top_k), float(top_p),
                                int(seed), bool(logprobs)),
        logprobs_out=[float(x) for x in d["logprobs_out"]])


# --------------------------------------------------------------------------
# protocols
# --------------------------------------------------------------------------

@runtime_checkable
class Scheduler(Protocol):
    """Admission order over QoS class queues; `requeue` keeps a
    request's class. `export` returns the queued work without disturbing
    it, as (per-class request lists in pop order, JSON-able aux state
    such as a round-robin cursor); `import_` loads that into a fresh
    scheduler, preserving pop order exactly."""
    n_classes: int

    def class_of(self, req: Request) -> int: ...
    def submit(self, req: Request) -> bool: ...
    def next(self) -> Optional[Request]: ...
    def requeue(self, req: Request) -> bool: ...
    def export(self) -> Tuple[List[List[Request]], dict]: ...
    def import_(self, queues: List[List[Request]], aux: dict) -> None: ...
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
    cache. Chunked prefill stages a slot as a dense cache
    (`slot_caches`) and writes a chunk's rows back (`store_chunk`); the
    prefix cache takes one page-aligned block of a slot
    (`block_payload`), pins and unpins it (`cache_retain`,
    `cache_release`) and installs cached blocks in a new slot
    (`share_prefix`). For crash recovery, `export_state` captures the
    pool bookkeeping and the device state as host tensors and JSON-able
    scalars, `import_state` writes such a snapshot back into a fresh
    decode state, and `snapshot_payload`/`restore_payload` are the
    layout's codec for prefix-cache payloads (page ids on `paged`, host
    copies of K/V rows on `dense`)."""
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
    def slot_caches(self, state: dict, slot: int, req_id: int) -> Any: ...
    def store_chunk(self, state: dict, slot: int, req_id: int, caches,
                    start: int, n_tokens: int) -> dict: ...
    def share_prefix(self, state: dict, slot: int, req_id: int,
                     payloads, n_tokens: int) -> dict: ...
    def block_payload(self, state: dict, slot: int, req_id: int,
                      block: int) -> Any: ...
    def cache_retain(self, payload: Any) -> None: ...
    def cache_release(self, payload: Any) -> None: ...
    def park(self, state: dict, slot: int,
             req_id: int) -> Tuple[Any, ParkMeta]: ...
    def unpark(self, state: dict, slot: int, req: Request, caches,
               meta: ParkMeta) -> Tuple[bool, dict]: ...
    def release(self, req_id: int) -> None: ...
    def mark_dirty(self) -> None: ...
    def sync(self, state: dict,
             slot_req_ids: List[Optional[int]]) -> dict: ...
    def export_state(self, state: dict) -> dict: ...
    def import_state(self, snap: dict) -> dict: ...
    def snapshot_payload(self, payload: Any) -> Any: ...
    def restore_payload(self, data: Any) -> Any: ...


@runtime_checkable
class Sampler(Protocol):
    """On-device token selection: `sample(logits [B,V], keys, params)`
    picks one token per row without reading the device. `slot_params(req)`
    gives a request's parameters as a fixed-arity tuple of numpy scalars
    (defaults for `req is None`), which the engine stacks into per-slot
    tensors; with `needs_rng`, `keys` are per-slot keys from `(seed,
    req_id, token_index)` (kernels/sampling.derive_keys), else None."""
    needs_rng: bool

    def slot_params(self, req: Optional[Request]) -> Tuple[Any, ...]: ...
    def sample(self, logits, keys, params): ...


@runtime_checkable
class Frontend(Protocol):
    """The client side: `submit` accepts a request at any time (between
    engine steps too), applies SLO-graded admission over bounded
    per-class wait queues and returns a handle that streams tokens and
    ends in an explicit outcome (completed | rejected | shed); `step`
    pumps one engine step; `run` drives a timed arrival trace;
    `reattach` rebinds live handles to an engine restored from a
    snapshot (requests the snapshot lost replay from zero, and handles
    dedupe by emitted index, so client streams stay byte-identical)."""

    def submit(self, req: Request,
               on_token: Optional[Callable] = None) -> Any: ...
    def step(self) -> None: ...
    def run(self, arrivals=None, max_steps: int = 100_000,
            drain: bool = True) -> List[Any]: ...
    def reattach(self, engine) -> None: ...
    @property
    def live(self) -> bool: ...


@runtime_checkable
class ParkingTransport(Protocol):
    """The host-tier move/restore channel for parked slot state. Parked
    payloads are engine state too: `export_state`/`import_state` carry
    them across a crash, since a parked payload is the only copy."""

    def begin(self, req_id: int, caches, meta: ParkMeta) -> None: ...
    def ready(self, now: Optional[float] = None) -> List[int]: ...
    def peek(self, req_id: int) -> Tuple[Any, ParkMeta]: ...
    def complete(self, req_id: int) -> None: ...
    def export_state(self) -> dict: ...
    def import_state(self, snap: dict) -> None: ...
    @property
    def in_flight(self) -> int: ...


# --------------------------------------------------------------------------
# registries — parts plug in by name
# --------------------------------------------------------------------------

SCHEDULERS: Dict[str, Type] = {}
STATE_BACKENDS: Dict[str, Type] = {}
SAMPLERS: Dict[str, Type] = {}
FRONTENDS: Dict[str, Type] = {}


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
register_frontend = _checked_register("frontend", Frontend, FRONTENDS)


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


def make_frontend(name: str, engine, **kw) -> Frontend:
    from repro_torch.serve import frontend  # noqa: F401 (built-ins)
    if name not in FRONTENDS:
        raise ValueError(f"unknown frontend {name!r}; "
                         f"registered: {sorted(FRONTENDS)}")
    return FRONTENDS[name](engine, **kw)


def slo_budget(cls: int, budgets: Tuple[float, ...]) -> Optional[float]:
    """A class's SLO budget: a shorter tuple broadcasts its last entry to
    the lower classes; `()` or a non-positive entry means none."""
    if not budgets:
        return None
    b = budgets[cls] if cls < len(budgets) else budgets[-1]
    return float(b) if b > 0 else None


def make_engine(cfg, params, ecfg: EngineConfig, device=None,
                scheduler: Optional[Scheduler] = None,
                kv_backend: Optional[StateBackend] = None,
                transport: Optional[ParkingTransport] = None,
                sampler: Optional[Sampler] = None):
    """A ServingEngine with parts resolved by name from `ecfg`, or
    injected directly; on ``cuda`` unless `device` says otherwise."""
    from repro_torch.serve.engine import ServingEngine
    return ServingEngine(cfg, params, ecfg, device=device,
                         scheduler=scheduler, kv_backend=kv_backend,
                         transport=transport, sampler=sampler)


def default_page_budget(slots: int, cache_len: int, page_size: int,
                        slack_slots: int = 1) -> int:
    """Device page budget backing `slots` worst-case sequences, plus
    `slack_slots` slots of headroom so an unpark never deadlocks against
    a fully committed pool."""
    per_slot = -(-cache_len // page_size)
    return (slots + slack_slots) * per_slot
