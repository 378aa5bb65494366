"""Asynchronous checkpointing of nested tensor trees, in the reference's
file layout (``repro.checkpoint.checkpointer``).

- Save: the tree's leaves are copied to host arrays, then written on a
  background thread, so the caller never blocks on disk. Each step goes
  to ``step_<8 digits>/``: ``shards.npz`` holds ``leaf_<i>`` in flatten
  order and ``manifest.json`` the step, the caller's ``extra`` and each
  leaf's name, shape and dtype. bf16 leaves are upcast to float32 for
  npz, losslessly; `restore(template)` and `unpack_tree` give the same
  bits back.
- Restore: `restore(template)` rebuilds the template's structure with
  torch tensors of the template's dtypes and devices; `load` is the
  template-free read for payloads whose structure rides in the
  manifest's ``extra`` (`pack_tree`, the engine-snapshot path).
- Reshard: `reshard_tree` lays a restored tree out on (new) shardings,
  the elastic rescale: every rank holds the whole restored tree and keeps
  its own shard of each leaf.

Trees are dicts (flattened in sorted key order), lists and tuples; None
holds no leaf; everything else is a leaf.
"""
from __future__ import annotations

import atexit
import json
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _dtype_name(dtype) -> str:
    """numpy's name for a torch or numpy dtype ("bfloat16", "int32")."""
    return str(dtype).replace("torch.", "")


def _flatten_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in flatten order; a path joins dict keys and
    sequence indices with "/"."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (i,))
        return out
    return [("/".join(str(p) for p in prefix), tree)]


def _unflatten(template, leaves):
    """`template`'s structure with its leaves taken from the iterator
    `leaves`, in `_flatten_with_paths` order."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array npz can hold (bf16 upcast to float32).

    Always a copy, never a view: the writer thread reads it after `save`
    has returned, while the caller may already be updating the tree in
    place (`adamw_update` does), and a CPU tensor's ``.cpu().numpy()``
    shares the tensor's storage."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.last_saved_step: Optional[int] = None
        # flush at interpreter exit: the writer thread is a daemon, so
        # without this the last async save could die mid-write and leave
        # the newest step truncated (atexit runs before daemon threads
        # are killed)
        atexit.register(self.wait)

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False):
        """Copy the tree to host, then write it on a background thread.

        Serialized end to end: the writer in flight (if any) is joined
        before the next host copy starts, and concurrent callers queue
        on a lock, so two writes never interleave on disk, and a failed
        background write is raised by the next save or wait instead of
        vanishing with its thread.
        """
        with self._lock:
            self._join_writer()          # one save in flight at a time
            host = [(name, _to_host(leaf))
                    for name, leaf in _flatten_with_paths(tree)]
            meta = {
                "step": step,
                "extra": extra or {},
                "leaves": [{"name": n, "shape": list(a.shape),
                            "dtype": str(a.dtype)} for n, a in host],
            }

            def _write():
                d = self.dir / f"step_{step:08d}"
                tmp = self.dir / f".tmp_step_{step:08d}"
                tmp.mkdir(parents=True, exist_ok=True)
                np.savez(tmp / "shards.npz",
                         **{f"leaf_{i}": a for i, (_, a) in enumerate(host)})
                (tmp / "manifest.json").write_text(json.dumps(meta))
                if d.exists():  # a re-save of the same step replaces it
                    for f in d.iterdir():
                        f.unlink()
                    d.rmdir()
                tmp.rename(d)
                self.last_saved_step = step
                self._gc()

            def _guarded():
                try:
                    _write()
                except BaseException as e:  # raised at the next save/wait
                    self._error = e

            if blocking:
                _write()
            else:
                self._thread = threading.Thread(target=_guarded, daemon=True)
                self._thread.start()

    def _join_writer(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self):
        with self._lock:
            self._join_writer()

    def _gc(self):
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[: max(0, len(steps) - self.keep)]:
            for f in old.iterdir():
                f.unlink()
            old.rmdir()

    # -- restore ----------------------------------------------------------
    def load(self, step: Optional[int] = None) -> Tuple[Dict, list]:
        """Template-free read: (manifest dict, host arrays in shard
        order), for payloads whose structure the manifest's ``extra``
        records (`pack_tree`)."""
        self.wait()  # never read past an in-flight write of this step
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "manifest.json").read_text())
        with np.load(d / "shards.npz") as data:
            leaves = [data[f"leaf_{i}"]
                      for i in range(len(meta["leaves"]))]
        return meta, leaves

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """The checkpoint in the structure of `template`: every leaf a
        torch tensor of the template leaf's dtype and device (a leaf
        that is not a tensor gives a CPU tensor of the stored dtype)."""
        meta, leaves = self.load(step)
        flat = [leaf for _, leaf in _flatten_with_paths(template)]
        if len(flat) != len(leaves):
            raise ValueError(
                f"template has {len(flat)} leaves, the checkpoint "
                f"{len(leaves)}")
        out = [torch.as_tensor(a).to(dtype=t.dtype, device=t.device)
               if isinstance(t, torch.Tensor) else torch.as_tensor(a)
               for a, t in zip(leaves, flat)]
        return _unflatten(template, iter(out)), meta


# -- JSON skeleton <-> tensor leaves (engine snapshots) ---------------------

def pack_tree(obj: Any) -> Tuple[list, Any]:
    """Split a nested snapshot (dicts with str keys, lists/tuples,
    scalars, None, tensors, arrays) into (tensor leaves, JSON-able
    skeleton): every tensor or array is replaced by a `{"__leaf__": i,
    "dtype": ...}` placeholder, so the skeleton rides in a manifest's
    ``extra`` and the leaves in the npz shard. `unpack_tree` inverts it
    (tuples come back as lists, the dtype is restored, so the npz
    bf16 -> float32 upcast round-trips bit for bit)."""
    leaves: list = []

    def enc(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            leaves.append(x)
            return {"__leaf__": len(leaves) - 1,
                    "dtype": _dtype_name(x.dtype)}
        if isinstance(x, np.generic):
            return x.item()
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if not isinstance(k, str):
                    raise TypeError(
                        f"pack_tree requires str dict keys, got {k!r}")
                out[k] = enc(v)
            return out
        if isinstance(x, (list, tuple)):
            return [enc(v) for v in x]
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        raise TypeError(f"pack_tree cannot encode {type(x).__name__}")

    return leaves, enc(obj)


def unpack_tree(meta: Any, leaves: list) -> Any:
    """The snapshot `pack_tree` split, with every leaf a CPU tensor of
    its recorded dtype."""
    def dec(x):
        if isinstance(x, dict):
            if "__leaf__" in x:
                t = torch.as_tensor(leaves[x["__leaf__"]])
                want = x.get("dtype")
                if want and _dtype_name(t.dtype) != want:
                    t = t.to(getattr(torch, want))
                return t
            return {k: dec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [dec(v) for v in x]
        return x

    return dec(meta)


def latest_step(directory) -> Optional[int]:
    steps = sorted(Path(directory).glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` laid out on its ``(mesh, placements)`` in
    ``shardings`` (``Policy.named``, ``train_shardings``) by
    ``distribute_tensor``: this rank's local shard, on the mesh's device
    type. Every rank holds the whole tree (a restored checkpoint), so
    each cuts its own shard with no collective (``src_data_rank=None``);
    on a one-rank mesh the shard is the whole leaf, bit for bit."""
    from torch.distributed.tensor import distribute_tensor

    def walk(x, sh):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: walk(x[k], sh[k]) for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(a, b) for a, b in zip(x, sh))
        mesh, placements = sh
        return distribute_tensor(torch.as_tensor(x), mesh, list(placements),
                                 src_data_rank=None).to_local()

    return walk(tree, shardings)
