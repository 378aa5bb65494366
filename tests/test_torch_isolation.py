"""The port stands alone: no JAX and nothing of ``repro`` in
``src/repro_torch``, ``examples_torch/`` or ``chip_smoke.py``, and a
missing card is an error unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
EXAMPLES = REPO / "examples_torch"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_no_jax_or_repro_imports():
    files = (sorted(PORT.rglob("*.py")) + sorted(EXAMPLES.glob("*.py"))
             + [REPO / "chip_smoke.py"])
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), line, root)
           for f in files for line, root in _imported_roots(f)
           if root in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_engine_and_launcher_import_without_jax_or_repro():
    code = ("import sys\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs.registry import SMOKE_CONFIGS
    from repro_torch.models import lm
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert params["embed"].device.type == "cpu"
    assert len(params["blocks"]) == cfg.n_layers


def test_rwkv_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs.registry import SMOKE_CONFIGS
    from repro_torch.models import lm
    from repro_torch.serve.api import EngineConfig
    from repro_torch.serve.engine import ServingEngine
    cfg = SMOKE_CONFIGS["rwkv6-1.6b"]
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_serve_state(cfg, 2, 64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, EngineConfig(kv_layout="recurrent"))
    state = lm.init_serve_state(cfg, 2, 64, device="cpu")
    assert state["caches"][0]["wkv"].device.type == "cpu"


def test_moe_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    import numpy as np
    from repro_torch.configs.registry import SMOKE_CONFIGS
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.api import EngineConfig, Request
    from repro_torch.serve.engine import ServingEngine
    cfg = SMOKE_CONFIGS["moonshot-v1-16b-a3b"]
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_paged_serve_state(cfg, 2, 8, 8, 4)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert params["blocks"][1]["moe"]["w_up"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, EngineConfig(cache_len=64, page_size=8,
                                                n_pages=16, kv_layout="paged"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke"])
    eng = ServingEngine(cfg, params, EngineConfig(
        cache_len=64, page_size=8, n_pages=16, kv_layout="paged"),
        device="cpu")
    eng.submit(Request(0, np.arange(1, 9, dtype=np.int32), max_new_tokens=3))
    done = eng.run_until_done()
    assert len(done) == 1 and len(done[0].tokens_out) == 3


def test_jamba_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    import numpy as np
    from repro_torch.configs.registry import SMOKE_CONFIGS
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.api import EngineConfig, Request
    from repro_torch.serve.engine import ServingEngine
    cfg = SMOKE_CONFIGS["jamba-v0.1-52b"]
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_serve_state(cfg, 2, 64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert params["blocks"][0]["mamba"]["A_log"].device.type == "cpu"
    ecfg = EngineConfig(cache_len=64, page_size=8, n_pages=32)
    assert ecfg.kv_layout == "dense"
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, ecfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "jamba-v0.1-52b", "--kv-layout", "dense",
                    "--smoke"])
    serve.main(["--arch", "jamba-v0.1-52b", "--kv-layout", "dense",
                "--smoke", "--device", "cpu", "--requests", "2",
                "--max-new", "3"])
    eng = ServingEngine(cfg, params, ecfg, device="cpu")
    eng.submit(Request(0, np.arange(1, 9, dtype=np.int32), max_new_tokens=3))
    done = eng.run_until_done()
    assert len(done) == 1 and len(done[0].tokens_out) == 3


def test_crash_recovery_imports_without_jax_or_repro():
    """The checkpointer and the ft package (fault and crash injectors,
    the chaos harness) stand alone too."""
    code = ("import sys\n"
            "import repro_torch.checkpoint, repro_torch.ft\n"
            "import repro_torch.checkpoint.checkpointer\n"
            "import repro_torch.ft.chaos, repro_torch.ft.crash\n"
            "import repro_torch.ft.faults\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (PORT / "checkpoint" / "checkpointer.py").exists()
    assert sorted(p.name for p in (PORT / "ft").glob("*.py")) == [
        "__init__.py", "chaos.py", "crash.py", "faults.py", "manager.py"]


def test_chaos_drive_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    import numpy as np
    from repro_torch.configs.registry import SMOKE_CONFIGS
    from repro_torch.ft import build_stack, drive
    from repro_torch.models import lm
    from repro_torch.serve.api import Request
    cfg = SMOKE_CONFIGS["qwen3-8b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    kw = dict(slots=2, cache_len=64, page_size=8, n_pages=16,
              kv_layout="paged", eos_token=-1, decode_span=1)

    def trace():
        return [(0.0, Request(0, np.arange(1, 9, dtype=np.int32),
                              max_new_tokens=3))]

    with pytest.raises(RuntimeError, match="CUDA"):
        drive(cfg, params, kw, trace())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_stack(cfg, params, kw)
    r = drive(cfg, params, kw, trace(), crash_at=(1,), device="cpu")
    assert r.outcomes == {0: "completed"} and len(r.streams[0]) == 3
    assert r.crash_log[0]["step"] == 1


def test_training_imports_without_jax_or_repro():
    """The training modules (data, optimizer, train step, compression,
    the fault-tolerant trainer, the launcher, their core helpers) stand
    alone."""
    code = ("import sys\n"
            "import repro_torch.core.primitives, repro_torch.core.transport\n"
            "import repro_torch.core.tree, repro_torch.data\n"
            "import repro_torch.optim, repro_torch.optim.schedules\n"
            "import repro_torch.train.train_step\n"
            "import repro_torch.train.grad_compress\n"
            "import repro_torch.ft.manager, repro_torch.launch.train\n"
            "import repro_torch.models.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_training_needs_cuda_unless_asked_for_cpu(tmp_path):
    """The train launcher and the fault-tolerant trainer run on the card
    unless asked for the CPU; make_train_step runs where the params
    are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.ft import FaultTolerantTrainer, FTConfig
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                    str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="CUDA"):
        FaultTolerantTrainer(None, None, None, Checkpointer(str(tmp_path)),
                             FTConfig())
    out = train.main(["--smoke", "--device", "cpu", "--steps", "1", "--seq",
                      "16", "--batch", "2", "--ckpt-dir",
                      str(tmp_path / "b")])
    assert out["params"]["embed"].device.type == "cpu"
    assert len(out["steps"]) == 1


def test_examples_import_without_jax_or_repro():
    """The six scripts of examples_torch/, the reference's examples'
    counterparts by name, load by path without pulling in JAX or
    ``repro``."""
    names = sorted(p.name for p in EXAMPLES.glob("*.py"))
    assert names == sorted(p.name for p in (REPO / "examples").glob("*.py"))
    code = ("import importlib.util, sys\n"
            f"for name in {[n[:-3] for n in names]!r}:\n"
            f"    spec = importlib.util.spec_from_file_location(\n"
            f"        name, {str(EXAMPLES)!r} + '/' + name + '.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
