"""Built-in StateBackends of the port (Resource Subsystem): ``dense``,
``paged``, ``latent`` and ``recurrent``, the reference's four.

- `DenseKV` ("dense") keeps per-slot `[slots, cache_len, KV, hd]`
  attention slabs (with a sliding window W, rings of `min(W, cache_len)`
  rows) and per-slot Mamba/RWKV carries, with no indirection
  tables: admission reserves a request's worst case, `min(len(prompt) +
  max_new_tokens, cache_len)` tokens, so capacity never runs out
  mid-decode, and park/unpark moves the slot's rows. It serves every
  ported config, and is the only layout for hybrids such as jamba and
  for sliding-window models such as h2o-danube-3-4b.
- `PagedKV` ("paged") keeps a shared `[n_pages, page_size, KV, hd]` pool
  per layer behind per-slot page tables, the MTT made into the memory
  layout, with the `PagePool` doing the accounting. Admission charges the
  prompt footprint only, growth happens at page boundaries, park moves
  exactly a sequence's pages to host tensors, and `sync` re-exports the
  tables into the decode state only when park/admit/growth dirtied them.
- `LatentPagedKV` ("latent") is a `PagedKV` over MLA's latent pools,
  `[n_pages, page_size, kv_lora_rank]` and `[n_pages, page_size,
  qk_rope_dim]` per layer, for all-MLA stacks (deepseek-v2-lite-16b).
- `RecurrentState` ("recurrent") holds pure RWKV stacks' constant-size
  carries (`[H, hd, hd]` wkv state + two token-shift rows per layer) in
  per-slot slabs: footprint 1, no growth, park/unpark moves the carry.

`dense` and `paged` take chunked prefill and back the block prefix cache
for full-attention stacks (`transformer.chunked_prefill_supported`):
`slot_caches` stages a slot's rows as the dense cache a chunk extends,
`store_chunk` writes the chunk's rows back, `block_payload` hands the
prefix cache one page-aligned block (a page id on `paged`, pinned by
refcount through `cache_retain`/`cache_release`; a copy of the block's
rows on `dense`) and `share_prefix` installs cached blocks in a slot.
`latent` and `recurrent` decline both.

State tensors are written in place, by a restore too: `export_state`
copies a backend's state to host tensors and JSON-able pairs (the whole
slabs on `dense` and `recurrent`, only the referenced pages on `paged`
and `latent`), and `import_state` writes them back into the engine's own
device tensors, pages at the same ids. `snapshot_payload` and
`restore_payload` are the layouts' codec for prefix-cache payloads.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core.resource import PagePool
from repro_torch.kernels.paged_attention import live_table_width
from repro_torch.models import lm
from repro_torch.models import transformer as tf
from repro_torch.serve.api import (EngineConfig, ParkMeta, Request,
                                   register_state_backend)


class _PooledKV:
    """Shared plumbing: the PagePool (MTT accounting) + growth helpers."""

    def __init__(self, cfg, ecfg: EngineConfig, device):
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = device
        self.pool = PagePool(ecfg.n_pages, ecfg.page_size)
        # capability flags (StateBackend protocol): chunked prefill and
        # the block prefix cache extend per-token attention rows, which
        # only plain-attention caches expose
        self.supports_chunked_prefill = tf.chunked_prefill_supported(cfg)
        self.supports_prefix_share = tf.chunked_prefill_supported(cfg)

    def admission_error(self, req: Request) -> Optional[str]:
        """A single request needing more pages than the whole pool can
        never complete — it would park/preempt-cycle forever."""
        worst = min(len(req.prompt) + req.max_new_tokens,
                    self.ecfg.cache_len)
        if -(-worst // self.ecfg.page_size) > self.ecfg.n_pages:
            return (f"request needs {worst} KV tokens but the pool holds "
                    f"only {self.ecfg.n_pages * self.ecfg.page_size}")
        return None

    def append(self, req_id: int, n_tokens: int) -> bool:
        """Alloc-on-append: grow req's page claim to cover n_tokens."""
        return self.pool.ensure_capacity(req_id, n_tokens)

    def reserve_span(self, req_id: int, n_tokens: int) -> bool:
        """Claim pages covering `n_tokens` total tokens before a decode
        span runs: no page can be allocated inside the span."""
        return self.pool.ensure_capacity(req_id, n_tokens)

    def held(self, req_id: int) -> int:
        return len(self.pool.pages_of(req_id))

    def release(self, req_id: int) -> None:
        self.pool.release(req_id)

    # prefix-cache payload pinning: only payloads that live in the pool
    # (paged) need real refcounts
    def cache_retain(self, payload) -> None:
        pass

    def cache_release(self, payload) -> None:
        pass

    # -- crash recovery ---------------------------------------------------
    # Pool bookkeeping travels as JSON-able pairs, never as int-keyed
    # dicts: a JSON round trip through the Checkpointer manifest would
    # turn int keys into strings.
    def _export_pool(self) -> dict:
        p = self.pool
        return {
            "free": [int(x) for x in p.free],
            "tables": [[int(r), [int(x) for x in pages]]
                       for r, pages in p.tables.items()],
            "refcnt": [[int(g), int(c)] for g, c in p.refcnt.items()],
            "peak": int(p.peak),
        }

    def _import_pool(self, snap: dict) -> None:
        p = self.pool
        p.free = [int(x) for x in snap["free"]]
        p.tables = {int(r): [int(x) for x in pages]
                    for r, pages in snap["tables"]}
        p.refcnt = {int(g): int(c) for g, c in snap["refcnt"]}
        p.peak = int(snap["peak"])

    def _export_counters(self, state: dict) -> dict:
        return {"pool": self._export_pool(),
                "lengths": _to_host(state["lengths"]),
                "positions": _to_host(state["positions"])}

    def _import_counters(self, snap: dict, state: Optional[dict]) -> dict:
        """The pool bookkeeping, and `lengths`/`positions` written into
        `state` (a fresh `init_state()` when None)."""
        self._import_pool(snap["pool"])
        if state is None:
            state = self.init_state()
        for k in ("lengths", "positions"):
            state[k].copy_(snap[k])
        return state

    # Default payload codec: payloads are device K/V trees (the dense
    # layout), copied to host tensors and back. Layouts with pool
    # indirection override it with their handle type.
    def snapshot_payload(self, payload):
        return _tree_to_host(payload)

    def restore_payload(self, data):
        return [{k: torch.as_tensor(t).to(self.device) for k, t in
                 layer.items()} for layer in data]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy (on the CPU too, where `.cpu()` would alias)."""
    return t.detach().to("cpu", copy=True)


def _tree_to_host(tree):
    return [{k: _to_host(t) for k, t in layer.items()} for layer in tree]


@register_state_backend("paged")
class PagedKV(_PooledKV):
    """Shared page pool + per-slot page tables."""

    needs_growth = True

    def __init__(self, cfg, ecfg: EngineConfig, device):
        if ecfg.cache_len % ecfg.page_size:
            raise ValueError("cache_len must be a page_size multiple")
        super().__init__(cfg, ecfg, device)
        self.max_pages = ecfg.cache_len // ecfg.page_size
        self._dirty = False

    def init_state(self) -> dict:
        return lm.init_paged_serve_state(
            self.cfg, self.ecfg.slots, self.ecfg.n_pages,
            self.ecfg.page_size, self.max_pages, device=self.device)

    def footprint(self, req: Request) -> int:
        return len(req.prompt) + 1

    def prefill_into_slot(self, state: dict, slot: int, req_id: int,
                          caches, length: int) -> dict:
        pages = self.pool.pages_of(req_id)
        chunks = tf.dense_to_pages(caches, len(pages), self.ecfg.page_size)
        tf.scatter_pages(state["caches"], chunks, pages)
        self._dirty = True
        return state

    def slot_caches(self, state: dict, slot: int, req_id: int):
        """Stage the slot's pages (token order, a shared prefix included)
        as the batch-1 dense cache a prefill chunk extends (a copy)."""
        pages = self.pool.pages_of(req_id)
        return tf.pages_to_dense(tf.gather_pages(state["caches"], pages),
                                 self.ecfg.cache_len, self.ecfg.page_size)

    def store_chunk(self, state: dict, slot: int, req_id: int, caches,
                    start: int, n_tokens: int) -> dict:
        """Scatter exactly the pages the chunk touched back into the
        pool. ``start`` is page-aligned and at or past the shared-prefix
        extent, so a chunk never writes a page that another sequence or
        the prefix cache also holds."""
        ps = self.ecfg.page_size
        p0, p1 = start // ps, -(-(start + n_tokens) // ps)
        pages = self.pool.pages_of(req_id)[p0:p1]
        data = [{k: t[0, p0 * ps:p1 * ps].reshape(
                    (len(pages), ps) + tuple(t.shape[2:]))
                 for k, t in layer.items()} for layer in caches]
        tf.scatter_pages(state["caches"], data, pages)
        self._dirty = True
        return state

    def share_prefix(self, state: dict, slot: int, req_id: int,
                     payloads, n_tokens: int) -> dict:
        # zero-copy: the cached pages join this sequence's table (one new
        # ref each); the pool already holds the prefix's K/V
        self.pool.share(req_id, list(payloads))
        self._dirty = True
        return state

    def block_payload(self, state: dict, slot: int, req_id: int,
                      block: int) -> Any:
        return self.pool.pages_of(req_id)[block]

    def cache_retain(self, payload) -> None:
        self.pool.addref([payload])

    def cache_release(self, payload) -> None:
        self.pool.decref([payload])

    def park(self, state: dict, slot: int,
             req_id: int) -> Tuple[Any, ParkMeta]:
        """Copy the slot's pages to host memory, then free them."""
        page_ids = self.pool.pages_of(req_id)
        caches = [{k: t.cpu() for k, t in layer.items()}
                  for layer in tf.gather_pages(state["caches"], page_ids)]
        meta = ParkMeta(int(state["lengths"][slot]),
                        int(state["positions"][slot]), slot, len(page_ids))
        self.pool.release(req_id)
        self._dirty = True
        return caches, meta

    def unpark(self, state: dict, slot: int, req: Request, caches,
               meta: ParkMeta) -> Tuple[bool, dict]:
        pages = self.pool.alloc(req.req_id, meta.n_pages)
        if pages is None:
            return False, state
        tf.scatter_pages(state["caches"], caches, pages)
        self._dirty = True
        return True, state

    def mark_dirty(self) -> None:
        self._dirty = True

    def sync(self, state: dict,
             slot_req_ids: List[Optional[int]]) -> dict:
        if self._dirty:
            # export the tables at the batch's live width (pow2-bucketed),
            # not max_pages: decode walks every exported entry
            live = max((len(self.pool.tables.get(r, []))
                        for r in slot_req_ids if r is not None), default=0)
            width = live_table_width(live, self.max_pages)
            state["page_table"] = torch.as_tensor(
                self.pool.table_matrix(slot_req_ids, width),
                device=self.device)
            self._dirty = False
        return state

    # -- crash recovery ---------------------------------------------------
    # Prefix-cache payloads are pool page ids: a plain int round-trips.
    def snapshot_payload(self, payload):
        return int(payload)

    def restore_payload(self, data):
        return int(data)

    def export_state(self, state: dict) -> dict:
        """Only the referenced pages (tables and cache-held), in sorted-id
        order: free pages hold stale bytes that no table reaches."""
        used = sorted(int(g) for g in self.pool.refcnt)
        snap = self._export_counters(state)
        snap["page_ids"] = used
        snap["pages"] = (_tree_to_host(tf.gather_pages(state["caches"],
                                                       used))
                         if used else None)
        return snap

    def import_state(self, snap: dict,
                     state: Optional[dict] = None) -> dict:
        """The pool contents back at the SAME page ids, into `state`'s
        own pools (zeroed first, as a fresh pool is); tables, refcounts
        and the free stack verbatim, so allocation after the restore
        (and so every table) follows the crashed process exactly. The
        tables are re-exported at the next `sync`."""
        state = self._import_counters(snap, state)
        for layer in state["caches"]:
            for pool in layer.values():
                pool.zero_()
        page_ids = [int(g) for g in snap["page_ids"]]
        if page_ids:
            tf.scatter_pages(state["caches"], snap["pages"], page_ids)
        self._dirty = True
        return state


@register_state_backend("latent")
class LatentPagedKV(PagedKV):
    """MLA's latent cache behind the paged page table.

    The pool mechanics of `PagedKV` (page tables, alloc-on-append growth,
    page-granular park/unpark), with pool leaves that hold the absorbed
    decode's cache of `models/mla.py`: `[n_pages, page, kv_lora_rank]` and
    `[n_pages, page, qk_rope_dim]` per layer. Decode runs the absorbed
    path through the table (`transformer.mla_decode_paged`).

    Chunked prefill and prefix sharing are declined, as in the reference:
    MLA prefill is monolithic (no per-chunk latent extension), and the
    capability flags, not a config sniff, tell the engine.
    """

    def __init__(self, cfg, ecfg: EngineConfig, device):
        if not tf.latent_paged_stack_supported(cfg):
            kinds = sorted(set(cfg.layer_kinds()))
            raise ValueError(
                f"latent-paged serving needs every layer to be MLA "
                f"attention (cfg.mla set, no SWA ring); {cfg.name} has "
                f"layer kinds {kinds} with mla={cfg.mla is not None}, "
                f"swa_window={cfg.swa_window} — use 'dense' (any config) "
                f"or 'paged' (plain-attention configs)")
        super().__init__(cfg, ecfg, device)
        self.supports_chunked_prefill = False
        self.supports_prefix_share = False


# -- per-slot slabs: insert / extract / restore ------------------------
#
# Per-slot state is a list with one dict of [slots, ...] tensors per
# layer (the port holds one block per layer, so there is no group axis to
# pick around). These write the slot's rows in place.

def _slot_restore(dst, src, slot: int):
    """Insert a batch-free cache list (from _slot_extract) into slot
    ``slot`` of ``dst``."""
    for d_layer, s_layer in zip(dst, src):
        for k, d in d_layer.items():
            d[slot].copy_(s_layer[k])
    return dst


def _slot_insert(dst, src, slot: int):
    """Insert a batch-1 cache list ``src`` (a prefill's) into slot
    ``slot`` of ``dst``."""
    return _slot_restore(dst, [{k: t[0] for k, t in layer.items()}
                               for layer in src], slot)


def _slot_extract(tree, slot: int):
    """Pull slot ``slot`` out of every layer (host copies)."""
    return [{k: t[slot].cpu() for k, t in layer.items()} for layer in tree]


def _slot_view(tree, slot: int):
    """Batch-1 view of one slot (it keeps the batch axis)."""
    return [{k: t[slot:slot + 1] for k, t in layer.items()}
            for layer in tree]


def _slot_range_view(tree, slot: int, t0: int, t1: int):
    """Batch-1 view of one slot's token positions [t0, t1)."""
    return [{k: t[slot:slot + 1, t0:t1] for k, t in layer.items()}
            for layer in tree]


def _cloned(tree):
    return [{k: t.clone() for k, t in layer.items()} for layer in tree]


def _cat_blocks(blocks):
    """Concatenate per-block payloads along the token axis."""
    if len(blocks) == 1:
        return blocks[0]
    return [{k: torch.cat([b[i][k] for b in blocks], dim=1)
             for k in blocks[0][i]} for i in range(len(blocks[0]))]


def _slot_write_range(dst, src, slot: int, t0: int, length: int):
    """Write the batch-1 list ``src`` (token extent ``length``) into slot
    ``slot`` of ``dst`` at token positions [t0, t0 + length), in place."""
    for d_layer, s_layer in zip(dst, src):
        for k, d in d_layer.items():
            d[slot, t0:t0 + length].copy_(s_layer[k][0])
    return dst


@register_state_backend("dense")
class DenseKV(_PooledKV):
    """Per-slot contiguous slabs; worst-case reservation at admission.

    No indirection tables, so `sync` is a no-op and capacity never runs
    out mid-decode (`needs_growth = False`): the footprint reserved up
    front covers every token the request may write. The slabs are
    kind-generic (`transformer.init_block_cache` allocates what each
    layer kind declares), so dense serves every ported config, at
    worst-case bytes per slot."""

    needs_growth = False

    def init_state(self) -> dict:
        return lm.init_serve_state(self.cfg, self.ecfg.slots,
                                   self.ecfg.cache_len, device=self.device)

    def footprint(self, req: Request) -> int:
        return min(len(req.prompt) + req.max_new_tokens,
                   self.ecfg.cache_len)

    def prefill_into_slot(self, state: dict, slot: int, req_id: int,
                          caches, length: int) -> dict:
        _slot_insert(state["caches"], caches, slot)
        return state

    def slot_caches(self, state: dict, slot: int, req_id: int):
        # a copy, not a view: the chunk also writes its padding rows,
        # which must not land in the slab (store_chunk writes back only
        # the valid rows, as the reference does)
        return _cloned(_slot_view(state["caches"], slot))

    def store_chunk(self, state: dict, slot: int, req_id: int, caches,
                    start: int, n_tokens: int) -> dict:
        # only the rows the chunk produced: the slab past the valid
        # length stays as it was (zero in a fresh slot, as after a
        # monolithic prefill)
        _slot_write_range(state["caches"],
                          _slot_range_view(caches, 0, start,
                                           start + n_tokens),
                          slot, start, n_tokens)
        return state

    def share_prefix(self, state: dict, slot: int, req_id: int,
                     payloads, n_tokens: int) -> dict:
        # no indirection to share through: copy the cached blocks' rows
        # into the slot's slab
        _slot_write_range(state["caches"], _cat_blocks(payloads), slot, 0,
                          n_tokens)
        return state

    def block_payload(self, state: dict, slot: int, req_id: int,
                      block: int) -> Any:
        # a copy: the prefix cache outlives the slot, whose slab the next
        # request overwrites in place
        ps = self.ecfg.page_size
        return _cloned(_slot_range_view(state["caches"], slot, block * ps,
                                        (block + 1) * ps))

    def park(self, state: dict, slot: int,
             req_id: int) -> Tuple[Any, ParkMeta]:
        caches = _slot_extract(state["caches"], slot)
        meta = ParkMeta(int(state["lengths"][slot]),
                        int(state["positions"][slot]), slot, 0)
        self.pool.release(req_id)
        return caches, meta

    def unpark(self, state: dict, slot: int, req: Request, caches,
               meta: ParkMeta) -> Tuple[bool, dict]:
        # clamped to cache_len as `footprint` is: a request admitted with
        # a clamped footprint must not need more at unpark than submit
        # validated, or it re-parks forever
        need = min(meta.length + req.max_new_tokens - len(req.tokens_out),
                   self.ecfg.cache_len)
        if not self.pool.ensure_capacity(req.req_id, need):
            return False, state
        _slot_restore(state["caches"], caches, slot)
        return True, state

    def mark_dirty(self) -> None:
        pass

    def sync(self, state: dict,
             slot_req_ids: List[Optional[int]]) -> dict:
        return state

    # -- crash recovery ---------------------------------------------------
    def export_state(self, state: dict) -> dict:
        """The whole slabs (ring slabs and recurrent carries included)."""
        snap = self._export_counters(state)
        snap["caches"] = _tree_to_host(state["caches"])
        return snap

    def import_state(self, snap: dict,
                     state: Optional[dict] = None) -> dict:
        state = self._import_counters(snap, state)
        for d_layer, s_layer in zip(state["caches"], snap["caches"]):
            for k, d in d_layer.items():
                d.copy_(s_layer[k])
        return state


@register_state_backend("recurrent")
class RecurrentState(DenseKV):
    """Constant-size recurrent carries for pure RWKV stacks.

    The state a slot decodes from is the scan carry itself (RWKV's
    `[H, hd, hd]` wkv matrix + token-shift rows), which never grows with
    sequence length. So: `footprint()` is 1 (one accounting page pins the
    slot), `needs_growth = False` (the engine never reserves spans or
    grows), park/unpark moves the carry with no page movement
    (`ParkMeta.n_pages = 0`), and prefill runs the chunked scan (kernel
    B4) and hands the final carry to the slot through `_slot_insert`.

    Prefix sharing and chunked prefill are declined: a recurrent carry
    folds the whole prefix into one tensor, so there are no per-token
    blocks to share or to extend chunk-wise.
    """

    def __init__(self, cfg, ecfg: EngineConfig, device):
        if not tf.recurrent_state_supported(cfg):
            kinds = sorted(set(cfg.layer_kinds()))
            raise ValueError(
                f"recurrent state serving needs every mixer to carry a "
                f"constant-size recurrence (mamba/rwkv); {cfg.name} has "
                f"layer kinds {kinds}: attention layers grow per token, "
                f"use the 'dense' or 'paged' layout")
        super().__init__(cfg, ecfg, device)
        self.supports_chunked_prefill = False
        self.supports_prefix_share = False

    def footprint(self, req: Request) -> int:
        # one accounting page marks the slot resident in the MTT; the
        # carry's bytes are fixed at init and never grow
        return 1

    def admission_error(self, req: Request) -> Optional[str]:
        return None               # constant-size state always fits a slot

    def slot_caches(self, state: dict, slot: int, req_id: int):
        raise NotImplementedError(
            "recurrent state has no per-token rows to stage: chunked "
            "prefill is unsupported (supports_chunked_prefill = False)")

    def store_chunk(self, state: dict, slot: int, req_id: int, caches,
                    start: int, n_tokens: int) -> dict:
        raise NotImplementedError(
            "recurrent state has no per-token rows to extend: chunked "
            "prefill is unsupported (supports_chunked_prefill = False)")

    def share_prefix(self, state: dict, slot: int, req_id: int,
                     payloads, n_tokens: int) -> dict:
        raise NotImplementedError(
            "a recurrent carry folds the whole prefix into one tensor: "
            "no per-token blocks to share (supports_prefix_share = False)")

    def block_payload(self, state: dict, slot: int, req_id: int,
                      block: int) -> Any:
        raise NotImplementedError(
            "a recurrent carry folds the whole prefix into one tensor: "
            "no per-token blocks to export (supports_prefix_share = False)")

    def unpark(self, state: dict, slot: int, req: Request, caches,
               meta: ParkMeta) -> Tuple[bool, dict]:
        if not self.pool.ensure_capacity(req.req_id, 1):
            return False, state
        _slot_restore(state["caches"], caches, slot)
        return True, state
