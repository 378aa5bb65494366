"""Device meshes (``repro.launch.mesh``) over ``torch.distributed``.

Functions, not module constants, so importing touches no process group.
The production meshes are the reference's: one pod of 16 x 16 ranks
``("data", "model")``, or two pods ``(2, 16, 16)`` ``("pod", "data",
"model")``, the ``pod`` axis pure data parallelism across the pods. Each
needs a world of exactly that many ranks; the process group is the
caller's (``torch.distributed.init_process_group`` with its own address,
size and rank). The smoke mesh is ``(1, 1)`` over a one-rank world, which
it starts itself on a ``torch.distributed.HashStore`` when no process
group is up: no network and no environment variables. On ``cuda`` that
group is ``cpu:gloo,cuda:nccl``; on the CPU ``gloo``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

_ONE_RANK_BACKEND = {"cpu": "gloo", "cuda": "cpu:gloo,cuda:nccl"}


def _device_type(device) -> str:
    return torch.device(device).type


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) or (2, 16, 16) production mesh; ``ValueError`` when
    the world has another number of ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), _world_size()
    if have != need:
        raise ValueError(
            f"the production mesh {shape} over {axes} needs {need} ranks; "
            f"found {have} (a process group of {have} rank"
            f"{'s' if have != 1 else ''})")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_smoke_mesh(device="cuda"):
    """A (1, 1) ("data", "model") mesh over a one-rank world, started on
    a HashStore if no process group is up."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_smoke_mesh: CUDA is not available; pass "
                           "device='cpu'")
    if not dist.is_initialized():
        dist.init_process_group(_ONE_RANK_BACKEND[kind],
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if _world_size() != 1:
        raise ValueError(f"the smoke mesh is one rank; the process group "
                         f"has {_world_size()}")
    return init_device_mesh(kind, (1, 1), mesh_dim_names=("data", "model"))
