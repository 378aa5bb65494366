"""The cost walk of one eager step: the port's counterpart of the
reference's ``repro.launch.hlo_analysis``.

The reference parses the compiled HLO of a whole step. The port runs
eagerly, so ``CostWalk`` is a ``TorchDispatchMode``: entered as a context
manager around one step, it sees every aten op the step dispatches (the
backward and remat's replays included) and every port kernel's call, and
counts on the step's device (``meta`` for the dry run, ``cuda`` to check
it; host tensors are left out):

- FLOPs of every aten op by the formulas of ``torch.utils.flop_counter``
  (products and attention: elementwise ops count none), under the type of
  the op's first input;
- HBM bytes of every op that is not a view: its operands read and its
  outputs written (each eager op is a top-level kernel, so nothing is
  "inside a fusion"), a broadcast operand at its distinct elements; a
  gather reads the rows it writes, an in-place indexed update moves its
  values and indices (the reference's dynamic-slice and scatter rules),
  ``copy_`` reads its source and writes its destination;
- each port kernel's work (``kernels/work.py``), reported by its wrapper;
- live device bytes and their peak: each storage counted once across its
  views, from the op that made it (or ``track`` for the step's
  arguments) until its last tensor dies;
- kernel calls by wrapper; breakdowns by class (``products``,
  ``elementwise``, ``reductions``, ``copies``, each kernel by name) and
  the 10 ops with the largest bound;
- collective bytes: 0. The walk runs one rank (a mesh's collectives are
  not walked, ROADMAP A13b-5b), and the record says so;
- the largest host tensor an op made (a dry run on ``meta`` should make
  none larger than a few constants).
"""
from __future__ import annotations

import heapq
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work as kwork

# ops that move no bytes: views and metadata, and allocations whose
# contents nothing has written yet
_NO_BYTES = {"_unsafe_view", "detach", "alias", "lift_fresh", "empty",
             "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "_reshape_alias", "set_", "resize_"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
               "_log_softmax", "_softmax", "_log_softmax_backward_data",
               "_softmax_backward_data", "linalg_vector_norm", "norm",
               "cumsum", "cumprod", "argmax", "argmin", "var_mean", "var",
               "std", "prod", "all", "any", "topk", "sort", "logcumsumexp",
               "_cummax_helper", "nll_loss_forward", "nll_loss_backward"}
# reads the rows it writes (and its indices)
_GATHERS = {"index", "_unsafe_index", "index_select", "embedding", "gather"}
# in place through indices: moves its values and indices, not the target
_SCATTERS = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
             "scatter_reduce_", "index_copy_", "index_add_", "index_fill_",
             "masked_scatter_"}
_COPIES = _GATHERS | _SCATTERS | {
    "copy_", "_to_copy", "clone", "cat", "stack", "index_put", "scatter",
    "scatter_add", "index_copy", "index_add", "repeat",
    "repeat_interleave", "flip", "roll", "constant_pad_nd", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "fill_", "zero_", "arange", "masked_fill",
    "masked_fill_", "slice_scatter", "select_scatter", "_to_dense"}
TOP_OPS = 10


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements: a dim of stride 0 (a
    broadcast) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _on_device(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


def device_tensors(tree):
    """The tensors of ``tree`` that are not on the host."""
    return [t for t in _tensors(tree) if _on_device(t)]


def op_class(name: str) -> str:
    if name in _REDUCTIONS:
        return "reductions"
    if name in _COPIES:
        return "copies"
    return "elementwise"


def _op_bytes(name: str, ins, outs) -> int:
    if name in ("copy_",):
        return sum(tensor_bytes(t) for t in ins[:2])
    if name in ("fill_", "zero_"):
        return sum(tensor_bytes(t) for t in outs)
    if name in _GATHERS:
        idx = [t for t in ins[1:] if not t.is_floating_point()]
        return (2 * sum(tensor_bytes(t) for t in outs)
                + sum(tensor_bytes(t) for t in idx))
    if name in _SCATTERS:
        rest = ins[1:]
        idx = [t for t in rest if not t.is_floating_point()]
        vals = [t for t in rest if t.is_floating_point()]
        return (2 * sum(tensor_bytes(t) for t in vals)
                + sum(tensor_bytes(t) for t in idx))
    return (sum(tensor_bytes(t) for t in ins)
            + sum(tensor_bytes(t) for t in outs))


class CostWalk(TorchDispatchMode):
    """Counts one step's work and memory; ``record()`` gives the JSON
    record. ``track(tree)`` counts tensors made before the walk (the
    step's arguments) as live; ``argument_bytes`` is their sum."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.hbm_bytes = 0.0
        self.op_bound_s = 0.0
        self.n_ops = 0
        self.by_class: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"ops": 0, "flops": 0.0, "bytes": 0.0})
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.kernel_work: Dict[str, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.host_max_bytes = 0
        self._live: Dict[int, tuple] = {}
        self._top = []          # a min-heap of (bound s, seq, description)

    # ---- live storages -------------------------------------------------
    def _track_storage(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live if it is new; returns the bytes
        it added."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        n = st.nbytes()

        def freed(_, key=key, n=n, walk=weakref.ref(self)):
            w = walk()
            if w is not None and w._live.pop(key, None) is not None:
                w.live_bytes -= n
        self._live[key] = (weakref.ref(st, freed), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def track(self, tree) -> int:
        """Count the device tensors of ``tree`` as live arguments; returns
        their bytes, each storage once."""
        added = sum(self._track_storage(t) for t in device_tensors(tree))
        self.argument_bytes += added
        return added

    # ---- ops and kernels -----------------------------------------------
    def _add(self, cls: str, flops: float, nbytes: float, dtype: str,
             what: str) -> None:
        self.flops_by_dtype[dtype] += flops
        self.hbm_bytes += nbytes
        c = self.by_class[cls]
        c["ops"] += 1
        c["flops"] += flops
        c["bytes"] += nbytes
        t = kwork.bound_s(kwork.Work(flops, nbytes, dtype))
        self.op_bound_s += t
        self.n_ops += 1
        item = (t, self.n_ops, what)
        if len(self._top) < TOP_OPS:
            heapq.heappush(self._top, item)
        elif t > self._top[0][0]:
            heapq.heapreplace(self._top, item)

    def _kernel(self, name: str, w: kwork.Work) -> None:
        self.kernel_calls[name] += 1
        k = self.kernel_work.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "dtype": w.dtype,
                   "bound_s": 0.0})
        k["calls"] += 1
        k["flops"] += w.flops
        k["bytes"] += w.nbytes
        k["bound_s"] += kwork.bound_s(w)
        self._add(f"kernel:{name}", w.flops, w.nbytes, w.dtype,
                  f"{name} (port kernel)")

    def __enter__(self):
        kwork.observe(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kwork.unobserve(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = device_tensors((args, kwargs))
        outs = device_tensors(out)
        if not outs and not ins:
            self.host_max_bytes = max([self.host_max_bytes] + [
                tensor_bytes(t) for t in _tensors(out)])
            return out
        for t in outs:
            self._track_storage(t)
        name = func._overloadpacket.__name__
        if func.is_view or name in _NO_BYTES:
            return out
        formula = flop_registry.get(func._overloadpacket)
        flops = (float(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0.0)
        first = (ins or outs)[0]
        dtype = kwork.dtype_name(first)
        if dtype not in kwork.PEAK_FLOPS:
            dtype = "float32"
        cls = "products" if formula is not None else op_class(name)
        shapes = [tuple(t.shape) for t in outs]
        self._add(cls, flops, _op_bytes(name, ins, outs), dtype,
                  f"{func} -> {shapes}")
        return out

    # ---- the record ----------------------------------------------------
    def record(self) -> dict:
        flops = sum(self.flops_by_dtype.values())
        compute_s = sum(f / kwork.PEAK_FLOPS[d]
                        for d, f in self.flops_by_dtype.items())
        memory_s = self.hbm_bytes / kwork.HBM_BYTES_PER_S
        return {
            "flops": flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": 0.0,
            "ranks": 1,
            "compute_s": compute_s,
            "memory_s": memory_s,
            "bound_s": max(compute_s, memory_s),
            "op_bound_s": self.op_bound_s,
            "n_ops": self.n_ops,
            "by_class": {k: dict(v) for k, v in sorted(
                self.by_class.items(), key=lambda kv: -kv[1]["bytes"])},
            "kernel_calls": dict(self.kernel_calls),
            "kernel_work": {k: dict(v) for k, v in self.kernel_work.items()},
            "top_ops": [f"{t * 1e3:.4f} ms {d}"
                        for t, _, d in sorted(self._top, reverse=True)],
            "argument_bytes": self.argument_bytes,
            "peak_bytes": self.peak_bytes,
            "host_max_bytes": self.host_max_bytes,
            "card": kwork.CARD,
        }
