"""Sharding on one device in the port against the JAX package: the policy's
specs, the head alignment to tp ranks, tp-padded params and their loss,
the spec trees of params, serving state and optimizer state, the mesh
against the null policy, elastic resharding through the Checkpointer,
the production mesh's world-size error, and a two-rank placement.

The reference's specs are ``PartitionSpec``s, compared as ``tuple(P)``;
its spec and shape trees hold the stacked layout, which
``convert.unstack_layers`` orders by layer as the port holds them. The
port runs on the CPU, on a one-rank gloo group over a HashStore (the
smoke mesh); the two-rank test spawns two gloo ranks on a FileStore over
loopback. Tolerances: forward_loss within 1e-5 of max(1, |loss|), the
port's forward-loss tolerance (tests/test_torch_train.py); everything
else exact.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCH_NAMES  # noqa: E402
from repro.configs.registry import SMOKE_CONFIGS as J_SMOKE  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as j_smoke_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.transformer import eff_heads as j_eff_heads  # noqa: E402
from repro.optim import opt_state_specs as j_opt_state_specs  # noqa: E402
from repro.sharding.policy import NULL_POLICY as J_NULL  # noqa: E402
from repro.sharding.policy import make_policy as j_make_policy  # noqa: E402
from repro_torch.checkpoint import Checkpointer, reshard_tree  # noqa: E402
from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        unstack_layers)
from repro_torch.models.transformer import eff_heads  # noqa: E402
from repro_torch.optim import adamw_init, opt_state_specs  # noqa: E402
from repro_torch.sharding import NULL_POLICY, make_policy  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are small and several test workers
    share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_layout(tree, cfg, take):
    """A reference tree of the stacked layout ({embed, stack, ...}) in the
    port's ({embed, blocks, ...}): ``take(leaf, g)`` reads group g."""
    out = {k: v for k, v in tree.items() if k != "stack"}
    out["blocks"] = unstack_layers(tree["stack"], cfg, take)
    return out


def _spec_layout(tree, cfg):
    return _port_layout(tree, cfg, lambda axes, g: axes[1:])


def _state_layout(tree, cfg):
    """serve_state_specs: its caches are the stack."""
    out = dict(tree)
    out["caches"] = unstack_layers(tree["caches"], cfg,
                                   lambda axes, g: axes[1:])
    return out


# ---------------------------------------------------------------------------
# the policy's specs
# ---------------------------------------------------------------------------

# every logical axis, the raw mesh axes (ZeRO-1's fallback), an unknown
# name and None, singly and in the reference test's combinations
QUERIES = ([(n,) for n in ("batch", "act_seq", "kv_seq", "mla_seq",
                           "heads", "kv_heads", "ff", "vocab", "experts",
                           "inner", "pages", "lora", "state", "data",
                           "model", "pod", "nonesuch")]
           + [(None,), (), ("batch", None, "ff"), ("data", "vocab"),
              ("batch", "kv_seq", "kv_heads", None),
              ("pages", None, "kv_heads", None), ("experts", None, None)])

RULE_SETS = {
    "mesh_none": (False, {}),
    "smoke_mesh": (True, {}),
    "multi_pod": (True, {"multi_pod": True}),
    "sp": (True, {"sp": True}),
    "shard_kv_seq": (True, {"shard_kv_seq": True}),
    "fsdp": (True, {"fsdp": True}),
    "overrides": (True, {"overrides": {"ff": None, "vocab": ("data",),
                                       "state": "model"}}),
}


def _meshes(with_mesh, multi_pod):
    """(reference mesh, port mesh): None, the smoke mesh, or for the two
    pods' rules a (1, 1, 1) ("pod", "data", "model") mesh."""
    if not with_mesh:
        return None, None
    if not multi_pod:
        return j_smoke_mesh(), make_smoke_mesh("cpu")
    from torch.distributed.device_mesh import init_device_mesh
    make_smoke_mesh("cpu")                  # the one-rank group
    axes = ("pod", "data", "model")
    return (jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                              axes),
            init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=axes))


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
def test_spec_equals_reference(rules):
    with_mesh, kw = RULE_SETS[rules]
    jmesh, mesh = _meshes(with_mesh, kw.get("multi_pod", False))
    jpol = j_make_policy(jmesh, **kw)
    pol = make_policy(mesh, **kw)
    for q in QUERIES:
        assert pol.spec(*q) == tuple(jpol.spec(*q)), q
    assert pol.rules == jpol.rules
    assert (pol.dp_axes, pol.tp_axis, pol.dp_size, pol.tp_size) == (
        jpol.dp_axes, jpol.tp_axis, jpol.dp_size, jpol.tp_size)


def test_placements_and_constrain():
    from torch.distributed.tensor import Replicate, Shard
    pol = make_policy(make_smoke_mesh("cpu"))
    assert pol.spec("batch", None, "ff") == ("data", None, "model")
    assert pol.placements("batch", None, "ff") == (Shard(0), Shard(2))
    assert pol.placements(None, "vocab") == (Replicate(), Shard(1))
    assert pol.placements() == (Replicate(), Replicate())
    mesh, pl = pol.named("data", "vocab")
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert pl == (Shard(0), Shard(1))
    x = torch.ones(2, 3)
    assert pol.constrain(x, "batch", "vocab") is x
    assert NULL_POLICY.constrain(x, "batch", "vocab") is x
    assert NULL_POLICY.spec("batch", "ff") == (None, None)


class TwoRanks:
    """A stand-in two-rank mesh: the refusals read only its shape, axis
    names and size."""
    mesh_dim_names = ("data", "model")
    shape = (1, 2)

    def size(self):
        return 2


class PodRanks(TwoRanks):
    """A stand-in (2, 1, 2) mesh over ("pod", "data", "model")."""
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 1, 2)

    def size(self):
        return 4


def _refusal_call(what):
    """(the call, the phrase its refusal must name) for one path a mesh
    of more ranks does not run yet (ROADMAP A13b-5b)."""
    arch, opts, phrase = {
        # RWKV-6, Mamba and jamba train on a mesh; serving them does not
        "rwkv6": ("rwkv6-1.6b", {}, "serving"),
        "jamba": ("jamba-v0.1-52b", {}, "serving"),
        "mla": ("deepseek-v2-lite-16b", {}, "MLA"),
        "sp": ("deepseek-v2-lite-16b", {"sp": True}, "MLA"),
        "shard_kv_seq": ("qwen3-8b", {"shard_kv_seq": True}, "shard_kv_seq"),
        "prefill": ("qwen3-8b", {}, "serving"),
        "decode_step": ("qwen3-8b", {}, "serving"),
        "pod_prefill": ("qwen3-8b", {"multi_pod": True, "sp": True},
                        "serving"),
        "pod_no_pod_rules": ("qwen3-8b", {}, "the batch over ('data',)"),
    }[what]
    mesh = PodRanks() if what.startswith("pod") else TwoRanks()
    pol = make_policy(mesh, **opts)
    cfg = SMOKE_CONFIGS[arch].scaled(n_layers=1, dtype="float32")
    toks = torch.zeros(1, 8, dtype=torch.int32)
    if what in ("prefill", "pod_prefill", "rwkv6"):
        return (lambda: lm.prefill(None, toks, cfg, policy=pol)), phrase
    if what in ("decode_step", "jamba"):
        return (lambda: lm.decode_step(None, toks[:, 0], {}, cfg,
                                       policy=pol)), phrase
    return (lambda: lm.forward_loss(None, toks, cfg, policy=pol)), phrase


@pytest.mark.parametrize("what", ["rwkv6", "jamba", "mla", "sp",
                                  "shard_kv_seq", "prefill", "decode_step",
                                  "pod_prefill", "pod_no_pod_rules"])
def test_entry_points_refuse_a_mesh_of_more_ranks(what):
    """On a policy whose mesh has two ranks, training an MLA stack (with
    sequence parallelism too), a sharded KV sequence and every serving
    entry point (an RWKV-6 stack's prefill and a jamba stack's decode
    step among them: those stacks train on a mesh, and are not served
    on one) raise, naming ROADMAP A13b-5b and what is missing; on a (2,
    1, 2) pod mesh, serving under SP and a policy made without the pod
    axis's batch rules (a stand-in mesh: the refusal reads only its size
    and axes)."""
    call, phrase = _refusal_call(what)
    with pytest.raises(NotImplementedError, match="A13b-5b") as e:
        call()
    assert phrase in str(e.value)


@pytest.mark.parametrize("mesh,seq", [(TwoRanks, 7), (PodRanks, 31)])
def test_sp_refuses_a_sequence_tp_does_not_divide(mesh, seq):
    """Sequence parallelism cuts the sequence over the model axis: a
    sequence of an odd length on 2 model ranks raises, naming both
    numbers, before anything runs; the same policies take the plain
    stack's training on any length (``require_supported`` passes)."""
    pol = make_policy(mesh(), multi_pod=mesh is PodRanks, sp=True)
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(n_layers=1, dtype="float32")
    toks = torch.zeros(2, seq, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"{seq} tokens") as e:
        lm.forward_loss(None, toks, cfg, policy=pol)
    assert "over 2 model ranks" in str(e.value)
    pol.require_supported("lm.forward_loss", cfg, train=True)


def test_constrain_is_the_identity_on_a_mesh():
    """``constrain`` returns its tensor on a mesh of any size: the bodies
    that run under a mesh produce each rank's local shard."""
    x = torch.ones(2, 3)
    assert make_policy(TwoRanks()).constrain(x, "batch", "vocab") is x


# ---------------------------------------------------------------------------
# head alignment, tp-padded params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_eff_heads_equals_reference(arch):
    for tp in (1, 2, 4, 8, 16):
        assert eff_heads(get_config(arch), tp) == j_eff_heads(
            j_get_config(arch), tp), tp


def test_eff_heads_padding_rules():
    """The reference test's cases."""
    assert eff_heads(get_config("qwen3-8b"), 16) == (32, 16)
    assert eff_heads(get_config("qwen1.5-4b"), 16) == (32, 32)
    assert eff_heads(get_config("qwen3-8b"), 1) == (32, 8)
    assert eff_heads(get_config("moonshot-v1-16b-a3b"), 16) == (16, 16)


@pytest.mark.parametrize("arch", sorted(SMOKE_CONFIGS))
def test_init_params_tp_shapes_equal_reference(arch):
    """init_params(tp=4) and abstract_params(tp=4) against the
    reference's abstract_params(tp=4), leaf for leaf: shapes, and the
    dtypes of the reference's."""
    cfg = SMOKE_CONFIGS[arch]
    ref = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                       jlm.abstract_params(J_SMOKE[arch], tp=4))
    want = _port_layout(ref, cfg, lambda s, g: (s[0][1:], s[1]))
    got = lm.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", tp=4)
    meta = lm.abstract_params(cfg, tp=4)
    assert all(t.device.type == "meta" for t in leaves(meta))
    for tree in (got, meta):
        assert _shape_tree(tree) == want


def _shape_tree(tree):
    """(shape, dtype name) of each leaf, as the reference's."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape_tree(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _pairs(tree):
    """The (mesh, placements) leaves of a shardings tree."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k])]
    if isinstance(tree, list):
        return [p for t in tree for p in _pairs(t)]
    return [tree]


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen1.5-4b", "nemotron-4-15b",
                                  "moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_forward_loss_on_tp_padded_params(arch):
    """The reference's tp=4 params (padded query heads, duplicated KV
    heads) bridged into the port: the same loss."""
    jcfg = J_SMOKE[arch].scaled(dtype="float32")
    cfg = SMOKE_CONFIGS[arch].scaled(dtype="float32")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32, tp=4))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 48)).astype(np.int32)
    want, _ = jlm.forward_loss(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(toks), jcfg, J_NULL)
    params = params_from_numpy(tree, cfg, device="cpu")
    H, KV = eff_heads(cfg, 4)
    attn = [b["attn"] for b in params["blocks"] if "attn" in b]
    assert attn and all(a["wq"].shape[1] == H * cfg.head_dim
                        and a["wk"].shape[1] == KV * cfg.head_dim
                        for a in attn)
    with torch.no_grad():
        got, _ = lm.forward_loss(params, torch.from_numpy(toks), cfg)
    assert abs(float(got) - float(want)) <= 1e-5 * max(1, abs(float(want)))


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(SMOKE_CONFIGS))
def test_spec_trees_equal_reference(arch):
    """param_specs, serve_state_specs and opt_state_specs (with ZeRO-1 at
    dp 2 and without) in the port's layout."""
    cfg, jcfg = SMOKE_CONFIGS[arch], J_SMOKE[arch]
    jp = jlm.param_specs(jcfg)
    assert lm.param_specs(cfg) == _spec_layout(jp, cfg)
    assert lm.serve_state_specs(cfg) == _state_layout(
        jlm.serve_state_specs(jcfg), cfg)
    jshape = jlm.abstract_params(jcfg)
    for zero1 in (False, True):
        want = j_opt_state_specs(jp, jshape, zero1=zero1, dp_size=2)
        got = opt_state_specs(lm.param_specs(cfg), lm.abstract_params(cfg),
                              zero1=zero1, dp_size=2)
        assert got["step"] == want["step"] == ()
        for k in ("master", "m", "v"):
            assert got[k] == _spec_layout(want[k], cfg), (zero1, k)


def test_shardings_trees_match_the_params():
    """train_shardings and serve_shardings give a (mesh, placements) pair
    for every leaf the params, the optimizer state, the serving state and
    the tokens have; FSDP puts expert tensors on their d_model dim."""
    from torch.distributed.tensor import Shard
    cfg = SMOKE_CONFIGS["moonshot-v1-16b-a3b"]
    pol = make_policy(make_smoke_mesh("cpu"), fsdp=True)
    (p_sh, o_sh, tok_sh), (p_out, o_out, m_sh) = ts.train_shardings(cfg, pol)
    assert p_out is p_sh and o_out is o_sh and m_sh is None
    params = lm.abstract_params(cfg)
    assert len(_pairs(p_sh)) == len(leaves(params))
    for k in ("master", "m", "v"):
        assert len(_pairs(o_sh[k])) == len(leaves(params))
    moe = params["blocks"][-1]["moe"]
    w_up = p_sh["blocks"][-1]["moe"]["w_up"][1]
    d_dim = list(moe["w_up"].shape).index(cfg.d_model)
    assert w_up[0] == Shard(d_dim) and w_up[1] == Shard(0)
    assert o_sh["step"][1] == pol.placements()
    assert tok_sh[1] == pol.placements("batch", None)
    (sp_sh, stok, sstate), (slog, sstate2) = ts.serve_shardings(cfg, pol)
    assert sstate is sstate2 and slog[1] == pol.placements("batch", "vocab")
    assert len(sstate["caches"]) == cfg.n_layers


# ---------------------------------------------------------------------------
# mesh against the null policy, elastic reshard, the production mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b",
                                  "rwkv6-1.6b", "jamba-v0.1-52b"])
def test_mesh_equals_null_policy(arch):
    """The reference test's archs and shapes, on a (1, 1) CPU mesh: the
    port's loss under the mesh's policy is its null-policy loss, bit for
    bit."""
    cfg = SMOKE_CONFIGS[arch]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 48)).astype(np.int32))
    pol = make_policy(make_smoke_mesh("cpu"))
    with torch.no_grad():
        l0, m0 = lm.forward_loss(params, toks, cfg)
        l1, m1 = lm.forward_loss(params, toks, cfg, policy=pol)
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_elastic_reshard(tmp_path):
    """A checkpoint written without a layout restores onto the smoke
    mesh's param shardings, and (params, AdamW state) onto
    train_shardings' with ZeRO-1 and FSDP: every leaf bit for bit."""
    cfg = SMOKE_CONFIGS["qwen1.5-4b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, (params, opt), blocking=True)
    pol = make_policy(make_smoke_mesh("cpu"), fsdp=True)
    (restored, ropt), _ = ck.restore((params, opt))
    placed = reshard_tree(restored, pol.tree_named(lm.param_specs(cfg)))
    for a, b in zip(leaves(params), leaves(placed)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    (p_sh, o_sh, _), _ = ts.train_shardings(cfg, pol)
    p2, o2 = reshard_tree((restored, ropt), (p_sh, o_sh))
    for a, b in zip(leaves((params, opt)), leaves((p2, o2))):
        assert torch.equal(a, b)


def test_production_mesh_needs_its_world():
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} ranks; found 1"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_train_step_under_the_smoke_mesh_equals_null_policy():
    """Two train steps through make_train_step with the smoke mesh's
    policy (params placed on train_shardings) give the null policy's
    metrics and params, bit for bit."""
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(n_layers=2, dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32))
    pol = make_policy(make_smoke_mesh("cpu"), fsdp=True, sp=True)
    (p_sh, o_sh, tok_sh), _ = ts.train_shardings(cfg, pol)
    runs = []
    for policy in (NULL_POLICY, pol):
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        opt = adamw_init(params)
        t = toks
        if policy is pol:
            params, opt = reshard_tree((params, opt), (p_sh, o_sh))
            t = reshard_tree(toks, tok_sh)
        step = ts.make_train_step(cfg, microbatch=2, policy=policy)
        ms = []
        for _ in range(2):
            params, opt, m = step(params, opt, t)
            ms.append(m)
        runs.append((ms, params))
    for m0, m1 in zip(runs[0][0], runs[1][0]):
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(runs[0][1]),
                                                 leaves(runs[1][1])))


def test_serving_steps_under_the_smoke_mesh_equal_null_policy():
    """make_prefill_step and make_decode_step under the smoke mesh's
    policy give lm.prefill's and lm.decode_step's logits and state."""
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(n_layers=2, dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 20)).astype(np.int32))
    pol = make_policy(make_smoke_mesh("cpu"))
    with torch.no_grad():
        lg0, st0 = lm.prefill(params, toks, cfg, cache_len=32)
        lg1, st1 = ts.make_prefill_step(cfg, pol, cache_len=32)(params, toks)
        assert torch.equal(lg0, lg1)
        nxt = torch.argmax(lg0, dim=-1).to(torch.int32)
        d0, s0 = lm.decode_step(params, nxt, st0, cfg)
        d1, s1 = ts.make_decode_step(cfg, pol)(params, nxt, st1)
    assert torch.equal(d0, d1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(s0), leaves(s1)))


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_engine_under_the_smoke_mesh_equals_null_policy(layout):
    """make_engine(policy=) on SMOKE qwen3-8b: the same streams and
    counters as NULL_POLICY's engine; a mesh of two ranks is refused
    (serving under a mesh is ROADMAP A13b-5b)."""
    from repro_torch.serve import api
    cfg = SMOKE_CONFIGS["qwen3-8b"].scaled(n_layers=2, dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 40, 9)]
    ecfg = api.EngineConfig(slots=2, cache_len=64, page_size=8, n_pages=20,
                            decode_span=4, eos_token=-1, kv_layout=layout)
    runs = []
    for policy in (None, make_policy(make_smoke_mesh("cpu"))):
        eng = api.make_engine(cfg, params, ecfg, device="cpu",
                              policy=policy)
        assert eng.policy is (policy or NULL_POLICY)
        for i, p in enumerate(prompts):
            eng.submit(api.Request(i, p.copy(), max_new_tokens=6))
        done = eng.run_until_done()
        runs.append(({r.req_id: r.tokens_out for r in done},
                     dict(eng.stats)))
    assert runs[0] == runs[1]
    with pytest.raises(NotImplementedError, match="A13b-5b"):
        api.make_engine(cfg, params, ecfg, device="cpu",
                        policy=make_policy(TwoRanks()))


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

TWO_RANKS = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.checkpoint import reshard_tree
    from repro_torch.configs.registry import SMOKE_CONFIGS
    from repro_torch.core.tree import leaves
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import make_policy
    from repro_torch.train.train_step import train_shardings

    rank, path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                            rank=rank, world_size=2)
    torch.set_num_threads(1)
    cfg = SMOKE_CONFIGS["qwen1.5-4b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = adamw_init(params)

    def check(tree, shardings, what):
        placed = reshard_tree(tree, shardings)
        n_split = 0
        for x, loc, (mesh, pl) in zip(leaves(tree), leaves(placed),
                                      _pairs(shardings)):
            want = x
            for i, p in enumerate(pl):
                if isinstance(p, Shard):
                    n = mesh.shape[i]
                    want = torch.chunk(want, n, dim=p.dim)[
                        mesh.get_coordinate()[i]]
                    n_split += n > 1
            assert torch.equal(loc, want), what
            full = DTensor.from_local(loc, mesh, list(pl), shape=x.shape,
                                      stride=x.stride()).full_tensor()
            assert torch.equal(full, x), what
        return n_split

    def _pairs(tree):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in _pairs(tree[k])]
        if isinstance(tree, list):
            return [p for t in tree for p in _pairs(t)]
        return [tree]

    # FSDP params over a (1, 2) mesh: the model axis splits
    tp = make_policy(init_device_mesh("cpu", (1, 2),
                                      mesh_dim_names=("data", "model")),
                     fsdp=True)
    (p_sh, _, _), _ = train_shardings(cfg, tp)
    n_p = check(params, p_sh, "params over (1, 2)")
    # ZeRO-1 state over a (2, 1) mesh: the data axis splits
    dp = make_policy(init_device_mesh("cpu", (2, 1),
                                      mesh_dim_names=("data", "model")),
                     fsdp=True)
    (_, o_sh, _), _ = train_shardings(cfg, dp)
    n_o = check({k: opt[k] for k in ("master", "m", "v")},
                {k: o_sh[k] for k in ("master", "m", "v")},
                "ZeRO-1 state over (2, 1)")
    dist.barrier()
    print("OK", rank, n_p, n_o)
    dist.destroy_process_group()
''')


@pytest.mark.slow
def test_two_ranks_place_train_state(tmp_path):
    """Two gloo ranks on a FileStore over loopback: qwen1.5-4b's SMOKE
    params placed with train_shardings over a (1, 2) mesh and its ZeRO-1
    state over (2, 1); each rank's local shard is its slice of the whole
    leaf and full_tensor() gives the leaf back."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=str(ROOT / "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", TWO_RANKS, str(r), store],
                              env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    for r, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith("OK")][-1]
        _, rank, n_p, n_o = line.split()
        assert int(rank) == r and int(n_p) > 0 and int(n_o) > 0
