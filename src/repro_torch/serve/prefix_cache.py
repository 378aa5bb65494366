"""Prefix cache: a longest-prefix block cache over page-aligned prompt
blocks, keyed by a hash chain, with LRU eviction.

Copied from ``repro.serve.prefix_cache`` (without its crash-snapshot
codec). In this slice the engine holds it at capacity 0: it is inert,
and its `evict_one` is the first of the engine's page-reclaim valves.
The chunked-prefill slice turns it on (ROADMAP queue A4).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Set, Tuple

import numpy as np


def prompt_key(tokens: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(tokens).tobytes()).hexdigest()


def block_key(parent: str, block: np.ndarray) -> str:
    """Chain hash: the key of block b commits to every block before it."""
    h = hashlib.sha256()
    h.update(parent.encode())
    h.update(np.ascontiguousarray(block).tobytes())
    return h.hexdigest()


class _Entry:
    __slots__ = ("payload", "parent", "children")

    def __init__(self, payload: Any, parent: Optional[str]):
        self.payload = payload
        self.parent = parent
        self.children: Set[str] = set()


class PrefixCache:
    """Longest-prefix block cache with LRU eviction and hit accounting.

    - `match(tokens)` walks the block hash-chain and returns the longest
      cached page-aligned prefix, always leaving >= 1 prompt token to
      compute (the tail prefill produces the first-token logits, so no
      logits need to be cached — the vLLM rule).
    - `insert(tokens, n_blocks, payload_fn)` donates a prefilled prompt's
      full blocks; `payload_fn(b)` supplies the backend payload for block
      b only when it is not cached yet.
    - `retain`/`release` hooks pin and unpin payloads (page refcounts for
      the paged backend); eviction cascades to descendants so a chain
      never dangles below an evicted parent.

    LRU detail: walks refresh deepest-block-first so a parent is always
    at least as recent as any matched child — eviction takes leaves (or
    whole stale chains) before the shared roots.
    """

    def __init__(self, capacity: int = 64, block: int = 16,
                 n_hash_units: int = 1,
                 retain: Optional[Callable[[Any], None]] = None,
                 release: Optional[Callable[[Any], None]] = None):
        self.capacity = capacity
        self.block = max(1, int(block))
        self.n_hash_units = n_hash_units
        self._retain = retain or (lambda payload: None)
        self._release = release or (lambda payload: None)
        self._d: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hash_ops = 0
        self.tokens_reused = 0

    def __len__(self) -> int:
        return len(self._d)

    # -- lookup ----------------------------------------------------------
    def match(self, tokens: np.ndarray) -> Tuple[int, List[Any]]:
        """Longest cached page-aligned prefix of `tokens`.

        Returns (matched_token_count, [payload per matched block]);
        matched_token_count is a multiple of `block` and < len(tokens).
        """
        tokens = np.asarray(tokens)
        limit = max(0, (len(tokens) - 1) // self.block)
        keys: List[str] = []
        payloads: List[Any] = []
        parent = ""
        for b in range(limit):
            key = block_key(parent, tokens[b * self.block:(b + 1) * self.block])
            self.hash_ops += 1
            entry = self._d.get(key)
            if entry is None:
                break
            keys.append(key)
            payloads.append(entry.payload)
            parent = key
        for k in reversed(keys):          # root refreshed last = most recent
            self._d.move_to_end(k)
        if keys:
            self.hits += 1
            self.tokens_reused += len(keys) * self.block
        else:
            self.misses += 1
        return len(keys) * self.block, payloads

    def unrecord(self, matched_tokens: int) -> None:
        """Roll back one `match`'s accounting — the caller could not use
        the result (e.g. admission bounced on page pressure and the
        request will be re-matched on retry)."""
        if matched_tokens:
            self.hits -= 1
            self.tokens_reused -= matched_tokens
        else:
            self.misses -= 1

    # -- donation --------------------------------------------------------
    def insert(self, tokens: np.ndarray, n_blocks: int,
               payload_fn: Callable[[int], Any]) -> int:
        """Cache the first `n_blocks` full blocks of a prefilled prompt.

        Returns the number of *new* entries created. `payload_fn(b)` is
        called only for blocks not already cached.
        """
        if self.capacity <= 0 or n_blocks <= 0:
            return 0
        tokens = np.asarray(tokens)
        parent = ""
        touched: List[str] = []
        created = 0
        for b in range(n_blocks):
            key = block_key(parent, tokens[b * self.block:(b + 1) * self.block])
            self.hash_ops += 1
            entry = self._d.get(key)
            if entry is None:
                payload = payload_fn(b)
                self._retain(payload)
                entry = _Entry(payload, parent or None)
                self._d[key] = entry
                parent_entry = self._d.get(parent)
                if parent_entry is not None:
                    parent_entry.children.add(key)
                created += 1
            touched.append(key)
            parent = key
        for k in reversed(touched):
            self._d.move_to_end(k)
        while len(self._d) > self.capacity:
            if not self.evict_one():
                break
        return created

    # -- eviction --------------------------------------------------------
    def evict_one(self) -> bool:
        """Evict the LRU entry (and its descendants). Returns True if an
        entry was removed — the engine's page-pressure release valve."""
        if not self._d:
            return False
        self._evict(next(iter(self._d)))
        return True

    def _evict(self, key: str) -> None:
        entry = self._d.pop(key, None)
        if entry is None:
            return
        for child in list(entry.children):
            self._evict(child)
        if entry.parent is not None:
            parent_entry = self._d.get(entry.parent)
            if parent_entry is not None:
                parent_entry.children.discard(key)
        self._release(entry.payload)

    def clear(self) -> None:
        """Release every cached block (drops all payload references)."""
        while self.evict_one():
            pass

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0
