"""What tests/test_torch_multirank.py and
tests/test_torch_multirank_inner.py share, in a module pytest does not
collect: the per-rank bodies, which the spawned ranks import with torch
and the port only (no JAX; each body is ``fn(rank, store, ...)`` for
``repro_torch.launch.mesh.spawn``, rank 0 returns what the test
compares, the other ranks None); the reference's script (``REFERENCE``,
run in a subprocess of its own); ``reference_and_ranks``, which runs
both on a list of cases; and the checks of a port run against the
reference's values."""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.registry import SMOKE_CONFIGS
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import collectives as col
from repro_torch.sharding import make_policy
from repro_torch.train import train_step as ts
from repro_torch.train.grad_compress import init_residuals


def case_config(case):
    return SMOKE_CONFIGS[case["arch"]].scaled(dtype="float32",
                                              **case.get("scale", {}))


REFERENCE = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[5])
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.registry import SMOKE_CONFIGS
    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init
    from repro.sharding.policy import NULL_POLICY, make_policy
    from repro.train.grad_compress import init_residuals
    from repro.train.train_step import make_train_step, train_shardings

    cases = json.load(open(sys.argv[1]))
    data = np.load(sys.argv[2])
    lr = float(sys.argv[4])
    at = getattr(jax.sharding, "AxisType", None)

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def flat(prefix, tree, out):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + key(path)] = np.asarray(x, np.float32)

    out = {}
    for c in cases:
        cfg = SMOKE_CONFIGS[c["arch"]].scaled(dtype="float32",
                                              **c.get("scale", {}))
        src = c.get("params_of", c["key"])
        toks = jnp.asarray(data[src + ":tokens"])
        if c["mesh"] is None:
            mesh, pol, tp = None, NULL_POLICY, c["tp"]
        else:
            axes = tuple(c["axes"])
            mesh = jax.make_mesh(tuple(c["mesh"]), axes,
                                 **({"axis_types": (at.Auto,) * len(axes)}
                                    if at else {}))
            pol = make_policy(mesh, multi_pod="pod" in axes,
                              sp=c.get("sp", False),
                              fsdp=True in c["fsdp"])
            tp = pol.tp_size
        shape = lm.abstract_params(cfg, tp=tp)
        leaves, tdef = jax.tree_util.tree_flatten_with_path(shape)
        params = jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(data[src + ":params/" + key(p)])
                   for p, _ in leaves])

        def run():
            (l, met), g = jax.jit(jax.value_and_grad(
                lambda p, t: lm.forward_loss(p, t, cfg, pol),
                has_aux=True))(params, toks)
            k = c["key"]
            out[k + ":loss"] = np.float64(l)
            for n, v in met.items():
                out[k + ":" + n] = np.float64(v)
            flat(k + ":grads/", g, out)
            if c.get("step"):
                (p_sh, o_sh, tok_sh), out_sh = train_shardings(cfg, pol)
                step = jax.jit(make_train_step(
                    cfg, pol, AdamWConfig(lr=lr, warmup_steps=1),
                    microbatch=c.get("microbatch", 0)),
                    in_shardings=(p_sh, o_sh, tok_sh),
                    out_shardings=out_sh)
                p2, _, m2 = step(params, adamw_init(params), toks)
                for n in ("loss", "grad_norm"):
                    out[k + ":step_" + n] = np.float64(m2[n])
                flat(k + ":params/", p2, out)
            if c.get("compress"):
                res_sh = o_sh["master"]
                step8 = jax.jit(make_train_step(
                    cfg, pol, AdamWConfig(lr=lr, warmup_steps=1),
                    grad_compression=True),
                    in_shardings=(p_sh, o_sh, tok_sh, res_sh),
                    out_shardings=(p_sh, o_sh, None, res_sh))
                p8, _, m8, _ = step8(params, adamw_init(params), toks,
                                     init_residuals(params))
                for n in ("loss", "grad_norm"):
                    out[k + ":int8_" + n] = np.float64(m8[n])
                flat(k + ":int8_params/", p8, out)
        if mesh is None:
            run()
        else:
            with mesh:
                run()
    np.savez(sys.argv[3], **out)
    print("OK")
''')


def flat(tree, prefix=""):
    """{path: array} of a params_to_numpy tree, in the reference's path
    format (dict keys and list indices joined by '/')."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat(t, f"{prefix}{i}/"))
        return out
    if tree is None:
        return {}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def reference_and_ranks(tmp, cases, lr, token_seed, launch=None,
                        extra=()):
    """The reference's values (one subprocess: ``REFERENCE`` on the cases
    without ``ref=False``, then ``extra``) and the port's (a spawn of
    ranks per world size, every mesh of that size inside it, meanwhile),
    on the same weights and tokens: case i's weights made by the port
    from seed i, its 32-token rows from ``token_seed`` + i, a case with
    ``params_of`` on another's. ``launch``: the mesh shape and axes of
    ``launcher_run``, then its arguments after the checkpoint directory
    (the world of that mesh's spawn runs it). Each case gets its
    ``params`` (a params_to_numpy tree) and ``tokens``. Returns {"ref",
    "port", "weights"}."""
    inputs, weights = {}, {}
    for i, case in enumerate(cases):
        cfg = case_config(case)
        if "params_of" in case:
            src = next(c for c in cases if c["key"] == case["params_of"])
            case["tokens"], case["params"] = src["tokens"], src["params"]
            continue
        params = lm.init_params(cfg, torch.Generator().manual_seed(i),
                                device="cpu", tp=case["mesh"][-1])
        weights[case["key"]] = params_to_numpy(params, cfg)
        case["params"] = weights[case["key"]]
        case["tokens"] = np_tokens(case.get("batch", 4), 32, cfg.vocab_size,
                                   seed=token_seed + i)
        inputs[case["key"] + ":tokens"] = case["tokens"]
        for k, v in flat(weights[case["key"]]).items():
            inputs[f"{case['key']}:params/{k}"] = v
    np.savez(tmp / "inputs.npz", **inputs)
    meta = [{k: v for k, v in c.items() if k not in ("params", "tokens")}
            for c in cases if c.get("ref", True)] + list(extra)
    (tmp / "cases.json").write_text(json.dumps(meta))
    t0 = time.monotonic()
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "cases.json"),
         str(tmp / "inputs.npz"), str(tmp / "ref.npz"), str(lr),
         str(Path(__file__).resolve().parents[1] / "src")], cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for world in dict.fromkeys(int(np.prod(c["mesh"])) for c in cases):
            mine = [c for c in cases if np.prod(c["mesh"]) == world]
            run = None
            if launch is not None and np.prod(launch[0]) == world:
                run = launch[:2] + (str(tmp / "launch"),) + launch[2:]
            port.update(spawn(train_cases, world, mine, lr, run,
                              timeout=300)[0])
        out, err = ref.communicate(timeout=480)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    print(f"reference and ranks: {time.monotonic() - t0:.1f} s")
    return {"ref": dict(np.load(tmp / "ref.npz")), "port": port,
            "weights": weights}


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_errs(got: dict, ref: dict, prefix: str):
    """{path: |got - ref| max over |ref| max} for every leaf."""
    errs = {}
    for k, v in got.items():
        r = ref[prefix + k]
        assert v.shape == r.shape, (k, v.shape, r.shape)
        errs[k] = float(np.abs(v - r).max()) / max(float(np.abs(r).max()),
                                                   1e-30)
    assert len(errs) == sum(1 for k in ref if k.startswith(prefix))
    return errs


# the checks: ``rec`` a port run's record (``train_cases``), ``ref`` the
# reference's values, ``key`` the case

def check_loss_and_stats(rec, ref, key):
    for name in ("loss", "ce", "moe_aux", "moe_dropped"):
        want = float(ref[f"{key}:{name}"])
        assert rel(rec[name], want) <= 1e-5 or (
            want == 0 and rec[name] == 0), (name, rec[name], want)


def check_gradients(rec, ref, key):
    errs = leaf_errs(flat(rec["grads"]), ref, f"{key}:grads/")
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def check_train_step(rec, ref, key, before, lr):
    """``before``: the case's params (a params_to_numpy tree)."""
    for name in ("loss", "grad_norm"):
        want = float(ref[f"{key}:step_{name}"])
        assert rel(rec["step_metrics"][name], want) <= 1e-5, (name, want)
    got = flat(rec["params"])
    assert len(got) == sum(1 for k in ref if k.startswith(f"{key}:params/"))
    before = flat(before)
    for k, v in got.items():
        want = ref[f"{key}:params/{k}"]
        tol = max(1e-4 * float(np.abs(want).max()), 0.1 * lr)
        err = float(np.abs(v - want).max())
        assert err <= tol, (k, err, tol)
        moved = float(np.abs(v - before[k]).max())
        assert moved > 0.5 * lr, (k, moved)


def check_int8_step(rec, ref, key, lr):
    m = rec["int8_metrics"]
    assert rel(m["loss"], float(ref[f"{key}:int8_loss"])) <= 1e-5
    assert rel(m["grad_norm"], float(ref[f"{key}:int8_grad_norm"])) <= 2e-5
    got = flat(rec["int8_params"])
    n_out = n_all = 0
    for k, v in got.items():
        want = ref[f"{key}:int8_params/{k}"]
        tol = max(1e-4 * float(np.abs(want).max()), 0.1 * lr)
        err = np.abs(v - want)
        n_out += int((err > tol).sum())
        n_all += err.size
        assert float(err.max()) <= lr, (k, float(err.max()))
    assert n_out <= 1e-4 * n_all, (n_out, n_all)
    # compression moved the step: not the uncompressed one
    plain = flat(rec["params"])
    assert max(float(np.abs(got[k] - plain[k]).max()) for k in got) > 0


def check_same_run(got, want):
    """Two port runs on the same weights and tokens."""
    for name in ("loss", "ce", "moe_aux", "moe_dropped"):
        assert rel(got[name], want[name]) <= 1e-5 or (
            want[name] == got[name] == 0), (name, got[name], want[name])
    g, w = flat(got["grads"]), flat(want["grads"])
    assert g.keys() == w.keys()
    for k in g:
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= 1e-4 * max(float(np.abs(w[k]).max()), 1e-30), (k, err)


def train_cases(rank, store, cases, lr, launch=None):
    """Every case of one world size, each on its mesh (shape and axes)
    of that many ranks: forward_loss's metrics and the gathered
    gradients, FSDP off and on, and, where the case asks, one
    make_train_step step's gathered params; with ``launch`` (mesh shape,
    axes, checkpoint directory) ``launcher_run`` under "launcher".
    Returns {(key, fsdp): record} on rank 0."""
    meshes, out = {}, {}

    def mesh_of(shape, axes):
        where = (tuple(shape), tuple(axes))
        if where not in meshes:
            meshes[where] = make_mesh(*where, device="cpu", backend="gloo",
                                      store=store, rank=rank)
        return meshes[where]
    for case in cases:
        mesh = mesh_of(case["mesh"], case["axes"])
        cfg = case_config(case)
        toks = torch.from_numpy(case["tokens"])
        for fsdp in case["fsdp"]:
            # the pod axis's batch rules on a pod mesh, SP as the case says
            pol = make_policy(mesh, multi_pod="pod" in case["axes"],
                              sp=case.get("sp", False), fsdp=fsdp)
            mg = col.MeshGroups.of(pol)
            whole = params_from_numpy(case["params"], cfg, device="cpu")
            params, opt = ts.place_train_state(whole, cfg, pol)
            b = toks.shape[0] // mg.batch_size
            (loss, metrics), grads = ts.value_and_grad(
                params, toks[mg.batch_rank * b:(mg.batch_rank + 1) * b],
                cfg, policy=pol)
            grads = ts.gathered_grads(grads, cfg, pol)
            rec = {"loss": float(loss),
                   **{k: float(v) for k, v in metrics.items()},
                   "grads": params_to_numpy(grads, cfg)}
            if case.get("step"):
                step = ts.make_train_step(
                    cfg, AdamWConfig(lr=lr, warmup_steps=1),
                    microbatch=case.get("microbatch", 0), policy=pol)
                (p_sh, _, _), _ = ts.train_shardings(cfg, pol, fsdp=fsdp)
                if case.get("compress"):
                    p8, o8 = ts.place_train_state(whole, cfg, pol)
                    step8 = ts.make_train_step(
                        cfg, AdamWConfig(lr=lr, warmup_steps=1),
                        grad_compression=True, policy=pol)
                    p8, _, m8, _ = step8(p8, o8, toks,
                                         init_residuals(o8["master"]))
                    rec["int8_metrics"] = {k: float(v)
                                           for k, v in m8.items()}
                    rec["int8_params"] = params_to_numpy(
                        ts.unshard_tree(p8, p_sh), cfg)
                params, opt, m = step(params, opt, toks)
                rec["step_metrics"] = {k: float(v) for k, v in m.items()}
                rec["params"] = params_to_numpy(
                    ts.unshard_tree(params, p_sh), cfg)
            out[(case["key"], fsdp)] = rec
    if launch is not None:
        out["launcher"] = launcher_run(mesh_of(*launch[:2]), *launch[2:])
    return out if rank == 0 else None


def launcher_run(mesh, ckpt_dir, steps=2, seq=32, batch=4,
                 arch="qwen3-8b"):
    """The train launcher on ``mesh`` (SMOKE ``arch`` on the CPU,
    ``--smoke``'s policy), and make_train_step on the same mesh, weights
    (seed 0), data and schedule: each step's loss and grad norm of
    both."""
    from repro_torch.data import DataConfig, SyntheticPackedDataset
    from repro_torch.launch import train as launcher
    from repro_torch.models import lm
    got = launcher.main(["--smoke", "--arch", arch, "--device", "cpu",
                         "--steps", str(steps), "--seq", str(seq),
                         "--batch", str(batch), "--ckpt-dir", ckpt_dir],
                        mesh=mesh)
    cfg = SMOKE_CONFIGS[arch]
    pol = make_policy(mesh, multi_pod="pod" in mesh.mesh_dim_names)
    params, opt = ts.place_train_state(
        lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       tp=pol.tp_size), cfg, pol)
    step = ts.make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=10,
                                               total_steps=steps),
                              policy=pol)
    data = SyntheticPackedDataset(DataConfig(
        seq_len=seq, global_batch=batch, vocab_size=cfg.vocab_size))
    want = []
    for _ in range(steps):
        params, opt, m = step(params, opt,
                              torch.from_numpy(data.next_batch()[0]))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    return {"launcher": [(r["loss"], r["grad_norm"]) for r in got["steps"]],
            "make_train_step": want}


def collectives(rank, store):
    """psum, copy_in, psum_inside, pmean, pmax, all_gather and all_to_all
    (parts of 2 and 2 elements, and of 1 and 3) on a (1, 2) mesh over
    gloo, values and gradients: rank r holds x = r + 1 + arange(4)."""
    mesh = make_mesh((1, 2), device="cpu", backend="gloo", store=store,
                     rank=rank)
    pol = make_policy(mesh)
    g = col.group(pol, "model")
    col.reset_counts()
    out = {"axis_index": col.axis_index(pol, "model")}
    uneven = ((1, 3), (1, 3)) if rank == 0 else ((3, 1), (3, 1))
    for name, fn in (("psum", lambda x: col.psum(x, g)),
                     ("copy_in", lambda x: col.copy_in(x, g)),
                     ("psum_inside", lambda x: col.psum_inside(x, g)),
                     ("pmean", lambda x: col.pmean(x, g)),
                     ("all_gather", lambda x: col.all_gather(x, g, 0)),
                     ("all_to_all",
                      lambda x: col.all_to_all(x, g, 0, (2, 2), (2, 2))),
                     ("all_to_all_uneven",
                      lambda x: col.all_to_all(x, g, 0, *uneven))):
        x = (torch.arange(4.0) + rank + 1).requires_grad_(True)
        y = fn(x)
        # a rank-dependent cotangent: (rank + 1) * index
        w = torch.arange(float(y.numel())) * (rank + 1)
        (gx,) = torch.autograd.grad((y * w).sum(), [x])
        out[name] = (y.detach().numpy(), gx.numpy())
    out["pmax"] = col.pmax(torch.arange(4.0) * (1 - 2 * rank), g).numpy()
    out["bf16_psum"] = col.psum(torch.tensor([1.0, 2.0 ** -9],
                                             dtype=torch.bfloat16),
                                g).float().numpy()
    # a bf16 gather travels as raw bytes, along the last dim too
    h = torch.tensor([[1.5, -2.0 ** -9]], dtype=torch.bfloat16) * (rank + 1)
    out["bf16_gather"] = col.gather(h, g, 1).float().numpy()
    # and a bf16 reduce-scatter: raw bytes out, the parts summed in fp32
    h = torch.tensor([[1.0, 2.0], [3.0, 2.0 ** -9]],
                     dtype=torch.bfloat16) * (rank + 1)
    out["bf16_scatter"] = col.reduce_scatter(h, g, 0).float().numpy()
    out["counts"] = col.counts()
    return out


def rank_halves(rank, store, tp):
    """``mamba._rank_halves`` on a (1, tp) mesh over gloo: rank r holds
    its contiguous 1/tp of the columns of xz = arange as [2, 2 Di], Di =
    6 tp, as ``reshard_tree`` cuts in_proj; returns its output and the
    gradient of its columns under the cotangent (r + 1) * index along the
    output's last dim."""
    from repro_torch.models.mamba import _rank_halves
    mesh = make_mesh((1, tp), device="cpu", backend="gloo", store=store,
                     rank=rank)
    mg = col.MeshGroups.of(make_policy(mesh))
    di = 6 * tp
    cols = 2 * di // tp
    xz = torch.arange(2.0 * 2 * di).reshape(2, 2 * di)
    x = xz[:, rank * cols:(rank + 1) * cols].clone().requires_grad_(True)
    y = _rank_halves(x, mg)
    w = torch.arange(float(y.shape[-1])) * (rank + 1)
    (gx,) = torch.autograd.grad((y * w).sum(), [x])
    return y.detach().numpy(), gx.numpy()


def np_tokens(batch, seq, vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, seq)).astype(np.int32)
