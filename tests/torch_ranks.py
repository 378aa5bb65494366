"""The per-rank bodies of tests/test_torch_multirank.py, in a module of
their own so that the spawned ranks import torch and the port only (no
JAX). Each body is ``fn(rank, store, ...)`` for
``repro_torch.launch.mesh.spawn``; rank 0 returns what the test
compares, the other ranks None."""
import numpy as np
import torch

from repro_torch.configs.registry import SMOKE_CONFIGS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import collectives as col
from repro_torch.sharding import make_policy
from repro_torch.train import train_step as ts
from repro_torch.train.grad_compress import init_residuals


def case_config(case):
    return SMOKE_CONFIGS[case["arch"]].scaled(dtype="float32",
                                              **case.get("scale", {}))


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


def launcher_run(mesh, ckpt_dir, steps=2, seq=32, batch=4):
    """The train launcher on ``mesh`` (SMOKE qwen3-8b on the CPU,
    ``--smoke``'s policy), and make_train_step on the same mesh, weights
    (seed 0), data and schedule: each step's loss and grad norm of
    both."""
    from repro_torch.data import DataConfig, SyntheticPackedDataset
    from repro_torch.launch import train as launcher
    from repro_torch.models import lm
    got = launcher.main(["--smoke", "--device", "cpu", "--steps", str(steps),
                         "--seq", str(seq), "--batch", str(batch),
                         "--ckpt-dir", ckpt_dir], mesh=mesh)
    cfg = SMOKE_CONFIGS["qwen3-8b"]
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
    """psum, copy_in, pmean, pmax and all_gather on a (1, 2) mesh over
    gloo, values and gradients: rank r holds x = r + 1 + arange(4)."""
    mesh = make_mesh((1, 2), device="cpu", backend="gloo", store=store,
                     rank=rank)
    pol = make_policy(mesh)
    g = col.group(pol, "model")
    col.reset_counts()
    out = {"axis_index": col.axis_index(pol, "model")}
    for name, fn in (("psum", lambda x: col.psum(x, g)),
                     ("copy_in", lambda x: col.copy_in(x, g)),
                     ("pmean", lambda x: col.pmean(x, g)),
                     ("all_gather", lambda x: col.all_gather(x, g, 0))):
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


def np_tokens(batch, seq, vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, seq)).astype(np.int32)
