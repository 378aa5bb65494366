"""Deterministic, shardable, checkpointable training data
(``repro.data.pipeline``).

Documents are a pure function of (seed, doc_id), drawn from numpy's
Philox generator as the reference draws them, framed and packed into
fixed-width rows (``core/primitives.py``), so any (step, rank) batch is
the reference's bit for bit and can be regenerated at any time: the
basis of the fault-tolerant trainer's recomputation (SR) and replay
(GBN). The state is one integer, the step counter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.primitives import pack_documents


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32000
    seed: int = 1234
    mean_doc_len: int = 512
    dp_rank: int = 0
    dp_size: int = 1


class SyntheticPackedDataset:
    """Packed-LM batches as host int32 arrays; O(1) state (the step)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.dp_size:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of dp_size {cfg.dp_size}")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.dp_size
        self.step = 0

    def _doc(self, doc_id: int) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(
            key=self.cfg.seed, counter=[0, 0, 0, doc_id]))
        n = int(rng.integers(self.cfg.mean_doc_len // 2,
                             self.cfg.mean_doc_len * 2))
        return rng.integers(1, self.cfg.vocab_size,
                            size=n, dtype=np.int64).astype(np.int32)

    def batch_at(self, step: int, rank: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens [local_batch, S], segments) of any (step, rank): a pure
        function. Documents are consumed rank-major, four ids reserved
        per row."""
        cfg = self.cfg
        rank = cfg.dp_rank if rank is None else rank
        rows = self.local_batch
        base = (step * cfg.global_batch + rank * rows) * 4
        docs, total = [], 0
        while total < rows * cfg.seq_len * 1.05 + cfg.mean_doc_len:
            d = self._doc(base + len(docs))
            docs.append(d)
            total += len(d)
        tokens, segs = pack_documents(docs, cfg.seq_len)
        return tokens[:rows], segs[:rows]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        out = self.batch_at(self.step)
        self.step += 1
        return out

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict):
        self.step = int(state["step"])
