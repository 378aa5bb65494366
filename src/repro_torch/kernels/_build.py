"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``. The
build runs at first use, into ``build/repro_torch/<hash>/`` at the root
of the checkout, keyed by a hash of every source and the compiler flags,
so an edited source never loads a stale library. ``build_all`` starts
one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("paged_attention", "flash_attention", "wkv6", "moe_dispatch",
           "linear_scan", "ssm_decode")


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build from source")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _source_hash()


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _start(name: str) -> subprocess.Popen:
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temp name and rename: concurrent builders never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.cmd = tmp, out, cmd
    return proc


def _finish(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(proc.tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(proc.cmd)}\n{log}")
    os.replace(proc.tmp, proc.out)
    return log


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns nvcc's output
    (registers, shared memory, spills from ``-Xptxas -v``) per source."""
    procs: List[subprocess.Popen] = [
        _start(n) for n in names if not _lib_path(n).exists()]
    logs = {}
    try:
        for p in procs:
            logs[p.out.stem[3:]] = _finish(p)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing. One
    handle per process: a library never changes once built. Every source
    exports ``cuda_error_string`` beside its entry points."""
    if not _lib_path(name).exists():
        build_all((name,))
    lib = ctypes.CDLL(str(_lib_path(name)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
