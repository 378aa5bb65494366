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

``make_mesh`` builds a mesh of any shape over a world of exactly that
many ranks, the reference's ``_make_mesh``, on a process group whose
backend the caller names: ``gloo`` (on the CPU, or ranks sharing one
card: gloo moves CUDA tensors through the host), or ``cpu:gloo,cuda:nccl``
with one GPU per rank. ``spawn`` starts such a world of processes on a
``FileStore``, the counterpart of JAX's one controller over N devices.
"""
from __future__ import annotations

import math
import multiprocessing
import os
import queue as queue_mod
import tempfile
import traceback

import torch
import torch.distributed as dist

from repro_torch.core.timing import Timer

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


def make_mesh(shape, axes=("data", "model"), *, device="cuda",
              backend="gloo", store=None, rank=None):
    """A ``shape`` mesh over ``axes`` on a world of ``prod(shape)``
    ranks. Starts the process group on ``store`` as ``rank`` when none
    is up (``backend`` names it), else checks the one that is up has
    that many ranks. ``nccl`` needs a GPU for each rank: ranks that
    share a card raise here, and use ``gloo``. On ``cuda`` rank r runs
    on card ``r % device_count``."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    need = math.prod(shape)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "device='cpu'")
        cards = torch.cuda.device_count()
        if "nccl" in backend and need > cards:
            raise ValueError(
                f"make_mesh: backend {backend!r} with {need} ranks on "
                f"{cards} card{'s' if cards != 1 else ''}: NCCL takes one "
                f"GPU per rank; ranks that share a card use 'gloo'")
    if not dist.is_initialized():
        if store is None or rank is None:
            raise ValueError("make_mesh: no process group is up; give "
                             "store= and rank= (spawn gives both)")
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=need)
    have = _world_size()
    if have != need:
        raise ValueError(f"the mesh {shape} over {axes} needs {need} "
                         f"ranks; found {have}")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def _rank_main(fn, rank, world, path, args, results):
    """One rank of ``spawn`` (one torch thread: the ranks share the
    host): its result or its traceback onto ``results``, then the process
    group down."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    try:
        out = fn(rank, dist.FileStore(path, world), *args)
        results.put((rank, True, out))
    except BaseException:                         # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 600.0):
    """Run ``fn(rank, store, *args)`` in ``world`` fresh processes that
    share one ``FileStore`` (``fn`` passes it to ``make_mesh``); returns
    the ranks' results in rank order. ``fn`` and ``args`` must pickle
    (``fn`` at a module's top level). A rank that raises or dies, or a
    world still running after ``timeout`` seconds, ends every rank and
    raises here with what the failing rank printed."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, path, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, clock = {}, Timer()
        try:
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"spawn: rank {dead[0]} of {world} exited with "
                            f"code {procs[dead[0]].exitcode}")
                    if clock.elapsed() > timeout:
                        raise TimeoutError(
                            f"spawn: {world - len(got)} of {world} ranks "
                            f"still running after {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} of {world} "
                                       f"failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=max(1.0, timeout - clock.elapsed()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [got[r] for r in range(world)]
