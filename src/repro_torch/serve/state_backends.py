"""Built-in StateBackends of the port (Resource Subsystem): ``dense``,
``paged`` and ``recurrent``.

- `DenseKV` ("dense") keeps per-slot `[slots, cache_len, KV, hd]`
  attention slabs and per-slot Mamba/RWKV carries, with no indirection
  tables: admission reserves a request's worst case, `min(len(prompt) +
  max_new_tokens, cache_len)` tokens, so capacity never runs out
  mid-decode, and park/unpark moves the slot's rows. It serves every
  ported config, and is the only layout for hybrids such as jamba.
- `PagedKV` ("paged") keeps a shared `[n_pages, page_size, KV, hd]` pool
  per layer behind per-slot page tables, the MTT made into the memory
  layout, with the `PagePool` doing the accounting. Admission charges the
  prompt footprint only, growth happens at page boundaries, park moves
  exactly a sequence's pages to host tensors, and `sync` re-exports the
  tables into the decode state only when park/admit/growth dirtied them.
- `RecurrentState` ("recurrent") holds pure RWKV stacks' constant-size
  carries (`[H, hd, hd]` wkv state + two token-shift rows per layer) in
  per-slot slabs: footprint 1, no growth, park/unpark moves the carry.

State tensors are written in place. The ``latent`` backend of the JAX
package waits for its slice (ROADMAP A8), and sliding-window ring slabs
for A6.
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

    # capability flags (StateBackend protocol): chunked prefill and the
    # block prefix cache are not ported yet (ROADMAP A4b)
    supports_chunked_prefill = False
    supports_prefix_share = False

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

    supports_chunked_prefill = False     # never, whatever A4b brings
    supports_prefix_share = False

    def __init__(self, cfg, ecfg: EngineConfig, device):
        if not tf.recurrent_state_supported(cfg):
            kinds = sorted(set(cfg.layer_kinds()))
            raise ValueError(
                f"recurrent state serving needs every mixer to carry a "
                f"constant-size recurrence (mamba/rwkv); {cfg.name} has "
                f"layer kinds {kinds}: attention layers grow per token, "
                f"use the 'dense' or 'paged' layout")
        super().__init__(cfg, ecfg, device)

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
