"""The per-rank side of ``tests/test_torch_parallel_families.py``: what each
process of a ``repro_torch.launch.mesh.spawn`` world runs.  It imports torch
and the port only (a spawned process starts from nothing).

:func:`families_suite` runs every case in one world of four CPU processes
over gloo, as ``_torch_tp_worker.tp_suite`` does: each case at world 4
(every rank), then at world 2 (ranks 0 and 1, a subgroup), then at world 1
on rank 0.  A case that raises returns its traceback instead of its result,
and the other cases still run."""
import dataclasses
import traceback

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.configs import get
from repro_torch.core import ttq_policy
from repro_torch.launch.mesh import make_ctx, make_mesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, MoECfg
from repro_torch.parallel.rules import (bind, col_align, shard_lowrank,
                                        shard_params, shard_stats)
from repro_torch.quant.api import FusedRequantPlan
from repro_torch.serving import EngineConfig, TTQEngine
from _torch_tp_worker import qt_numpy

ARCHS = ("recurrentgemma_9b", "mamba2_1p3b", "whisper_medium",
         "deepseek_v2_lite_16b", "llama4_scout_17b_a16e")
# (arch, moe_impl): the MoE family under both of the reference's forms
ENGINES = [(a, "dense") for a in ARCHS] + [
    ("deepseek_v2_lite_16b", "a2a"), ("llama4_scout_17b_a16e", "a2a")]
PROMPTS = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12, 6, 3, 7, 9, 2, 4]]
BUDGETS = [6, 4, 7]
POLICY = dict(bits=4, group_size=16, packed=True)
A2A_CF = 8.0            # the engines' a2a capacity: nothing is dropped
# the reference's MoE test config (tests/test_sharding.py:27)
REF_MOE = ModelConfig(name="t", family="moe", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=0, vocab=128,
                      moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=64,
                                 n_shared=1, capacity_factor=8.0))
REF_CFS = (1.0, 8.0)


def family_cfg(arch, impl="dense"):
    """The smoke config; under ``a2a`` at capacity factor :data:`A2A_CF`."""
    cfg = get(arch, smoke=True)
    if impl == "a2a":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=A2A_CF))
    return cfg


def family_params(cfg):
    return lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


def frames(cfg, i):
    return torch.randn((cfg.encdec.n_frames, cfg.d_model),
                       generator=torch.Generator().manual_seed(100 + i))


def engine_run(cfg, params, pctx):
    """Tokens per request and the engine: int4 g16 packed weights, int8 KV,
    4 slots, blocks of 2 steps."""
    eng = TTQEngine(cfg, params, ttq_policy(**POLICY),
                    EngineConfig(max_slots=4, max_len=64, decode_chunk=2,
                                 kv_dtype="int8", use_kernels=True),
                    device="cpu", generator=torch.Generator().manual_seed(7),
                    pctx=pctx)
    rids = []
    for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        kw = dict(frames=frames(cfg, i)) if cfg.family == "encdec" else {}
        rids.append(eng.submit(p, max_new=b, **kw))
    eng.run_all()
    return [list(eng.scheduler.results()[r]) for r in rids], eng


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16
                else tree).numpy().copy()
    return tree


def from_np(tree):
    if isinstance(tree, dict):
        return {k: from_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_np(v) for v in tree)
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def world1_stats(cfg, params):
    """The statistics of a pctx=None prefill of the longest prompt (the
    requant cases' fixed statistics)."""
    batch = {"tokens": torch.tensor([PROMPTS[2]])}
    if cfg.family == "encdec":
        batch["frames"] = frames(cfg, 2)[None]
    return lm.prefill(cfg, params, batch, 64)[2]


def requant(arch, fixed, pctx):
    """The shard-local plan on the rank's slices of the weights, of the
    fixed statistics and of the whole weights' low-rank factors (bf16, the
    weights' dtype)."""
    cfg = family_cfg(arch)
    policy = ttq_policy(**POLICY)
    pctx = bind(pctx, cfg, col_align(policy))
    lp = shard_params(family_params(cfg), pctx)
    ls = shard_stats(from_np(fixed["stats"]), pctx)
    lr = shard_lowrank(tree_map(
        lambda t: None if t is None else t.to(torch.bfloat16),
        from_np(fixed["lowrank"])), pctx)
    return qt_numpy(FusedRequantPlan(lp, ls, policy, lowrank_tree=lr,
                                     pctx=pctx).run(lp, ls, 10.0, lr))


def tokens(arch, impl, pctx, world1=False):
    cfg = family_cfg(arch, impl)
    toks, eng = engine_run(cfg, family_params(cfg), pctx)
    out = dict(tokens=toks, layout=eng.pctx.layout)
    if world1:                          # held bit for bit to pctx=None
        out.update(tree=qt_numpy(eng.decode_params), state=to_np(eng.state))
    return out


def a2a_layer(ref, pctx):
    """The port's ``moe_apply_a2a`` on the reference's MoE layer and input
    at each capacity factor (through ``moe_a2a``, the reference's entry):
    the whole output, the count statistics (gathered whole), and the
    rank's chunk's dropped assignments."""
    p = from_np(ref["params"])
    El = REF_MOE.moe.n_experts // pctx.world
    r = pctx.rank
    p = {"router": p["router"],
         "experts": {k: v[r * El:(r + 1) * El].to(torch.bfloat16)
                     for k, v in p["experts"].items()}}
    x = torch.from_numpy(ref["x"]).to(torch.bfloat16)
    out = {}
    for cf in REF_CFS:
        cfg = dataclasses.replace(REF_MOE, moe=dataclasses.replace(
            REF_MOE.moe, capacity_factor=cf))
        y, stats = L.moe_a2a(cfg, p, x, True, "", pctx)
        x2 = x.reshape(-1, x.shape[-1])
        Tc, C = L.moe_capacity(cfg, x2.shape[0], pctx.world)
        _, top_i = L._router(cfg, p, x2[r * Tc:(r + 1) * Tc], None, "")
        _, valid = L.a2a_slots(top_i, cfg.moe.n_experts, C)
        out[cf] = dict(y=y.float().numpy(), valid=valid.numpy(),
                       stats={k: v.numpy() for k, v in stats.items()})
    return out


def ssd_gate(pctx):
    """The SSD gated norm at f32 on the rank's channels: with the Σy²
    all-reduce, and without it (the local-only norm)."""
    g = torch.Generator().manual_seed(3)
    di = 64
    y, z = (torch.randn((2, 5, di), generator=g) for _ in range(2))
    p = {"norm": {"gamma": 0.1 * torch.randn((di,), generator=g)}}
    k = di // pctx.world
    sl = slice(pctx.rank * k, (pctx.rank + 1) * k)
    loc = {"norm": {"gamma": p["norm"]["gamma"][sl]}}
    return dict(
        whole=L._ssd_gate(p, y, z, torch.float32).numpy(),
        tp=L._ssd_gate(loc, y[..., sl], z[..., sl], torch.float32,
                       pctx).numpy(),
        local_only=L._ssd_gate(loc, y[..., sl], z[..., sl],
                               torch.float32).numpy())


def _run(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except Exception:                       # noqa: BLE001 — reported
        return {"error": traceback.format_exc()}


def families_suite(fixed, ref):
    """Every case at worlds 4, 2, 1 (see the module docstring): {world:
    {case: result}}.  ``fixed``: {arch: {'stats', 'lowrank'}}, the fixed
    statistics and the whole weights' factors, numpy;
    ``ref``: the reference's MoE layer (params, input), numpy."""
    res = {}
    for world in (4, 2, 1):
        pctx = make_ctx(make_mesh(1, world, device="cpu"))
        if pctx.rank < 0:
            continue
        w = res[world] = {}
        for arch in ARCHS:
            w[f"requant-{arch}"] = _run(requant, arch, fixed[arch], pctx)
        for arch, impl in ENGINES:
            w[f"tokens-{arch}-{impl}"] = _run(
                tokens, arch, impl, dataclasses.replace(pctx, moe_impl=impl),
                world1=world == 1 and impl == "dense")
        w["a2a"] = _run(a2a_layer, ref, pctx)
        w["ssd_gate"] = _run(ssd_gate, pctx)
    return res
