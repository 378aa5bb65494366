"""Built-in StateBackend of the port (Resource Subsystem): ``paged``.

`PagedKV` keeps a shared `[n_pages, page_size, KV, hd]` pool per layer
behind per-slot page tables, the MTT made into the memory layout, with
the `PagePool` doing the accounting. Admission charges the prompt
footprint only, growth happens at page boundaries, park moves exactly a
sequence's pages to host tensors, and `sync` re-exports the tables into
the decode state only when park/admit/growth dirtied them. Pool tensors
are written in place. The ``dense``, ``latent`` and ``recurrent``
backends of the JAX package wait for their slices (ROADMAP queue A).
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
