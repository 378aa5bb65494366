"""Logical-axis sharding policy (``repro.sharding.policy``).

Tensors are named by *logical* axes; the policy maps those to the axes
of a ``torch.distributed`` device mesh. The same model code runs on a
single-pod (data, model) mesh, a two-pod (pod, data, model) mesh or a
one-rank smoke mesh by swapping the rule table: the JingZhao split of
the Semantics Subsystem (the model's math) from the Transport Subsystem
(how data moves).

Logical axes:
  batch      global batch                      -> (pod,) data
  act_seq    the residual stream's sequence dim; over `model` with
             sequence parallelism (sp), else unsharded
  kv_seq     KV-cache sequence dim; over the data axes for long context
  mla_seq    MLA's latent cache along the sequence -> model
  heads      attention query heads               -> model
  kv_heads   attention KV heads                  -> model
  ff         MLP hidden                          -> model
  vocab      embedding and logits vocab          -> model
  experts    MoE expert dim                      -> model
  inner      Mamba d_inner, RWKV channel blocks  -> model
  pages      KV page-pool dim                    -> the data axes

``spec`` gives the reference's ``PartitionSpec`` entries as a plain
tuple (``tuple(P)``), ``placements`` one ``Shard(dim)`` or
``Replicate()`` for each mesh dim (a tuple of mesh axes on one tensor
dim shards that dim over each of them, in mesh order), and ``named`` the
pair ``(mesh, placements)``, the port's ``NamedSharding``. The model's
bodies run on each rank's local shards with explicit collectives
(``sharding/collectives.py``), so ``constrain`` returns its tensor as it
is. A mesh of more than one rank trains plain-attention, RWKV-6, Mamba
and hybrid stacks on ``("data", "model")`` or ``("pod", "data",
"model")``, with or without sequence parallelism; the entry points
refuse the rest (``require_supported``; ROADMAP A13b-5b).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]

MULTI_RANK = ("a mesh of more ranks trains plain-attention stacks (dense, "
              "and MoE with or without shared experts), RWKV-6, Mamba and "
              "jamba (inner) over (data, model) or (pod, data, model), "
              "with or without sequence parallelism; MLA (mla_seq), "
              "shard_kv_seq, serving and the dry run under a mesh wait "
              "for ROADMAP A13b-5b")

# the mesh axes and the rules the multi-rank bodies are written for: the
# batch over every axis but ``model``, the residual stream's sequence
# whole or over ``model`` (sp)
_TRAIN_AXES = (("data", "model"), ("pod", "data", "model"))
_TRAIN_RULES = {"heads": "model", "kv_heads": "model", "ff": "model",
                "vocab": "model", "experts": "model"}


def _base_rules(multi_pod: bool, sp: bool, shard_kv_seq: bool
                ) -> Dict[str, Axes]:
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    return {
        # long-context decode (batch < data axis) re-purposes the data
        # axes for KV sequence sharding; batch is then replicated
        "batch": None if shard_kv_seq else dp,
        "act_seq": "model" if sp else None,
        "kv_seq": dp if shard_kv_seq else None,
        "mla_seq": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "inner": "model",
        "pages": dp,
        "lora": None,
        "state": None,
    }


def is_axes(v) -> bool:
    """A leaf of a spec tree: a tuple of logical axis names or None."""
    return isinstance(v, tuple) and all(a is None or isinstance(a, str)
                                        for a in v)


def map_specs(fn, tree, *rest):
    """``fn`` over the axis tuples of a spec tree (dicts and lists of
    tuples) and the matching leaves of ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_specs(fn, *xs) for xs in zip(tree, *rest)]
    if not is_axes(tree):
        raise TypeError(f"not a tuple of logical axes: {tree!r}")
    return fn(tree, *rest)


def zero1_axes(axes: Tuple, shape: Tuple[int, ...], dp_size: int,
               dp_name: str = "data") -> Tuple:
    """Put the data axis on the largest free dim that ``dp_size``
    divides (ZeRO-1); ``axes`` as they are when none does."""
    best, best_dim = None, -1
    for i, (ax, n) in enumerate(zip(axes, shape)):
        if ax is None and n % dp_size == 0 and n > best_dim:
            best, best_dim = i, n
    if best is None:
        return axes
    out = list(axes)
    out[best] = dp_name
    return tuple(out)


def fsdp_specs(specs, shapes, d_model: int, dp_size: int):
    """A param spec tree with FSDP's data axis added, as the reference's
    ``train_shardings`` places it, given the params' shapes (a tree of
    tensors): on an expert tensor its d_model dim (when ``dp_size``
    divides it), on any other leaf ``zero1_axes``' dim. A leaf with no
    such dim stays whole over ``data``. A new tree."""
    def place(ax, sh):
        if "experts" in ax and len(sh.shape) >= 3:
            out = list(ax)
            for i, (a, n) in enumerate(zip(ax, sh.shape)):
                if a is None and n == d_model and n % dp_size == 0:
                    out[i] = "data"
                    return tuple(out)
            return ax
        return zero1_axes(ax, tuple(sh.shape), dp_size)
    return map_specs(place, specs, shapes)


@dataclass
class Policy:
    mesh: Optional[object]    # torch.distributed.device_mesh.DeviceMesh
    rules: Dict[str, Axes] = field(default_factory=dict)

    # ---- mesh facts ---------------------------------------------------
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        r = self.rules.get("batch") or ()
        return r if isinstance(r, tuple) else (r,)

    @property
    def tp_axis(self) -> str:
        return "model"

    def _names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None \
            else ()

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape[self._names().index(name)])

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.axis_size(a)
        return n

    @property
    def tp_size(self) -> int:
        return self.axis_size("model") if self.mesh is not None else 1

    @property
    def n_ranks(self) -> int:
        return int(self.mesh.size()) if self.mesh is not None else 1

    def require_supported(self, where: str, cfg=None, *,
                          train: bool = False,
                          seq_len: Optional[int] = None) -> None:
        """Refuse what a mesh of more than one rank does not run yet:
        anything but training (``train``) a ``cfg`` without MLA (plain
        attention, RWKV-6, Mamba or a hybrid of them) on a
        ``("data", "model")`` or ``("pod", "data", "model")`` mesh under
        the base rules, the batch over every axis but ``model``, with or
        without sequence parallelism, without a sharded KV sequence. Under
        sequence parallelism ``seq_len`` must be a multiple of the model
        axis (``ValueError``). One rank runs everything."""
        if self.n_ranks <= 1:
            return
        why = []
        names = self._names()
        if not train:
            why.append("serving")
        if names not in _TRAIN_AXES:
            why.append(f"mesh axes {names}")
        elif self.dp_axes != names[:-1]:
            why.append(f"the batch over {self.dp_axes} (make_policy's "
                       f"multi_pod picks ('pod', 'data'))")
        if self.rules.get("kv_seq"):
            why.append("shard_kv_seq")
        if self.rules.get("act_seq") not in (None, "model") or any(
                self.rules.get(k) != v for k, v in _TRAIN_RULES.items()):
            why.append("rule overrides")
        if cfg is not None and cfg.mla is not None:
            why.append("MLA (mla_seq)")
        if why:
            raise NotImplementedError(
                f"{where}: a {tuple(self.mesh.shape)} mesh over "
                f"{names} has {self.n_ranks} ranks, and "
                f"{', '.join(why)} on it is not ported; {MULTI_RANK}")
        if self.rules.get("act_seq") and seq_len is not None \
                and seq_len % self.tp_size:
            raise ValueError(
                f"{where}: sequence parallelism cuts the sequence over the "
                f"model axis, and a sequence of {seq_len} tokens does not "
                f"divide over {self.tp_size} model ranks")

    # ---- specs --------------------------------------------------------
    def spec(self, *logical: Optional[str]) -> tuple:
        """The mesh axes of each tensor dim: a rule's axes, a raw mesh
        axis name as it is (ZeRO-1's "data"), else None. A tuple of one
        axis is that axis, as ``PartitionSpec`` holds it."""
        parts = []
        mesh_axes = set(self._names())
        for name in logical:
            if name is None:
                parts.append(None)
            elif name in self.rules:
                axes = self.rules[name]
                parts.append(axes[0] if isinstance(axes, tuple)
                             and len(axes) == 1 else axes)
            elif name in mesh_axes:
                parts.append(name)
            else:
                parts.append(None)
        return tuple(parts)

    def placements(self, *logical: Optional[str]) -> tuple:
        """One ``Shard(dim)`` or ``Replicate()`` for each mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        names = self._names()
        dims = [None] * len(names)
        for dim, axes in enumerate(self.spec(*logical)):
            axes = () if axes is None else (
                axes if isinstance(axes, tuple) else (axes,))
            where = [names.index(a) for a in axes if a in names]
            if where != sorted(where):
                raise ValueError(f"{axes} on dim {dim} are not in the "
                                 f"mesh's order {names}")
            for i in where:
                if dims[i] is not None:
                    raise ValueError(f"mesh axis {names[i]!r} shards "
                                     f"dims {dims[i]} and {dim}")
                dims[i] = dim
        return tuple(Replicate() if d is None else Shard(d) for d in dims)

    def named(self, *logical: Optional[str]) -> tuple:
        """``(mesh, placements)``: the port's ``NamedSharding``."""
        assert self.mesh is not None
        return (self.mesh, self.placements(*logical))

    def constrain(self, x, *logical: Optional[str]):
        """``x`` as it is: the bodies that run under a mesh produce each
        rank's local shard, already laid out."""
        return x

    def tree_named(self, spec_tree):
        """A spec tree of logical-axis tuples -> a tree of ``named``
        pairs."""
        return map_specs(lambda axes: self.named(*axes), spec_tree)


def make_policy(mesh, *, multi_pod: bool = False, sp: bool = False,
                shard_kv_seq: bool = False, fsdp: bool = False,
                overrides: Optional[Dict[str, Axes]] = None) -> Policy:
    rules = _base_rules(multi_pod, sp, shard_kv_seq)
    if overrides:
        rules.update(overrides)
    if mesh is None:
        rules = {k: None for k in rules}
    rules["fsdp_params"] = fsdp and mesh is not None
    return Policy(mesh=mesh, rules=rules)


NULL_POLICY = make_policy(None)
