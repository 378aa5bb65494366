"""The assigned input shapes of the LM architectures
(``repro.configs.shapes``), with the rows one card takes.

``train_4k`` walks ``train_step``; ``prefill_32k`` walks ``prefill``;
``decode_32k`` and ``long_500k`` walk ``decode_step`` (one new token
against a KV cache or recurrent state of ``seq_len``).

``global_batch`` is the reference's, over its 16 x 16 pod mesh.
``CARD_BATCH`` is the rows one card takes by default: that batch over the
mesh's data axis of 16 (at least one row). ``TRAIN_MICROBATCH`` is the
reference's gradient accumulation for the largest configs
(``repro.launch.dryrun``); the port's dry run takes 2 for the others.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                   LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}

# Archs with sub-quadratic sequence handling (SSM / hybrid / sliding-window)
# run long_500k; pure full-attention archs skip it.
LONG_CONTEXT_ARCHS = frozenset({"rwkv6-1.6b", "jamba-v0.1-52b",
                                "h2o-danube-3-4b"})

# the data axis of the reference's 16 x 16 pod mesh
POD_DATA_AXIS = 16
CARD_BATCH: Dict[str, int] = {
    s.name: max(1, s.global_batch // POD_DATA_AXIS) for s in SHAPES}

TRAIN_MICROBATCH: Dict[str, int] = {
    "jamba-v0.1-52b": 8,
    "chameleon-34b": 4,
    "nemotron-4-15b": 2,
}
DEFAULT_MICROBATCH = 2


def applicable_shapes(arch_name: str) -> Tuple[ShapeConfig, ...]:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch_name in LONG_CONTEXT_ARCHS:
        out.append(LONG_500K)
    return tuple(out)
