"""The per-rank side of ``tests/test_torch_parallel.py``: what each process
of a ``repro_torch.launch.mesh.spawn`` world runs.  It imports torch and
the port only (a spawned process starts from nothing).

:func:`tp_suite` runs every tensor-parallel case in one world of four CPU
processes over gloo: each case at world 4 (every rank), then at world 2
(ranks 0 and 1, a subgroup; ranks 2 and 3 skip it), and the world-1
context case on rank 0 alone, so the test module pays for one spawn.  A
case that raises returns its traceback instead of its result, and the
other cases still run."""
import traceback

import torch

from repro_torch import bridge
from repro_torch.core import ttq_policy
from repro_torch.core.ttq import QuantizedTensor
from repro_torch.launch.mesh import make_ctx, make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.rules import (bind, col_align, shard_lowrank,
                                        shard_params, shard_stats)
from repro_torch.quant.api import FusedRequantPlan
from repro_torch.serving import EngineConfig, TTQEngine

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=4, d_ff=128, vocab=128)
PROMPTS = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12, 6, 3, 7, 9, 2, 4]]
BUDGETS = [6, 4, 7]
KV_CASES = (("bf16", False), ("int8", True), ("int4", False))
POLICY = dict(bits=4, group_size=16, packed=True)


def engine_run(params, pctx, *, kv="bf16", paged=False, policy=None,
               **ecfg):
    """The reference's ``_SETUP.run`` (``tests/test_mesh_serving.py``) on
    the port: tokens per request, the layer-0 cache and the engine."""
    policy = policy or ttq_policy(**POLICY)
    kw = dict(max_slots=4, max_len=64, decode_chunk=2, kv_dtype=kv,
              kv_paged=paged, kv_block_size=16, use_kernels=True)
    kw.update(ecfg)
    eng = TTQEngine(CFG, params, policy, EngineConfig(**kw), device="cpu",
                    generator=torch.Generator().manual_seed(7), pctx=pctx)
    rids = [eng.submit(p, max_new=b) for p, b in zip(PROMPTS, BUDGETS)]
    eng.run_all()
    toks = [list(eng.scheduler.results()[r]) for r in rids]
    return toks, eng


def layer0_cache(eng):
    """Layer 0's cache leaves (its k/v are row-parallel outputs of the
    exact embedding), as numpy."""
    u0 = eng.state["stack"][0]["u0"]
    return {k: v[0].float().numpy() if v.dtype == torch.bfloat16
            else v[0].numpy() for k, v in u0.items()}


def qt_numpy(tree):
    """{path: {field: array}} of every QuantizedTensor of a tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif isinstance(t, QuantizedTensor):
            out[".".join(map(str, path))] = {
                f: getattr(t, f).numpy() for f in
                ("wint", "packed", "scale", "zero", "dinv")
                if getattr(t, f) is not None}
    walk(tree, ())
    return out


def _requant(params, stats, lowrank, pctx):
    """The shard-local plan on the rank's slices of the weights, the
    statistics and the whole weights' factors."""
    policy = ttq_policy(**POLICY)
    pctx = bind(pctx, CFG, col_align(policy))
    lp, ls = shard_params(params, pctx), shard_stats(stats, pctx)
    lr = shard_lowrank(lowrank, pctx)
    plan = FusedRequantPlan(lp, ls, policy, lowrank_tree=lr, pctx=pctx)
    return qt_numpy(plan.run(lp, ls, 10.0, lr))


def _tokens(params, pctx):
    out = {}
    for kv, paged in KV_CASES:
        toks, eng = engine_run(params, pctx, kv=kv, paged=paged)
        out[f"{kv}-{paged}"] = dict(tokens=toks, cache=layer0_cache(eng),
                                    graph_mode=eng.runner.graph_mode)
    return out


def _spec(params, pctx):
    toks, eng = engine_run(params, pctx, policy=ttq_policy(bits=8,
                                                           group_size=16),
                           speculate_k=2, decode_chunk=1, use_kernels=None)
    return dict(tokens=toks, windows=eng.spec_windows)


def _default(params, pctx):
    """The reference's default policy (rank 16, delta gate 0.05, guards
    on) and the layers each requant wrote."""
    toks, eng = engine_run(params, pctx, policy=ttq_policy(),
                           requant_threshold=0.05, decode_chunk=2,
                           use_kernels=None)
    return dict(tokens=toks, paths=eng.qmodel.requant_paths,
                requantized=eng.layers_requantized,
                skipped=eng.layers_skipped)


CASES = {"requant": _requant, "tokens": _tokens, "spec": _spec,
         "default": _default}


def _run(name, fn, *args):
    try:
        return fn(*args)
    except Exception:                       # noqa: BLE001 — reported
        return {"error": traceback.format_exc()}


def tp_suite(params_np, stats_np, lowrank_np, cases):
    """Every case of ``cases`` at worlds 4 and 2 (see the module
    docstring), then the world-1 context on rank 0: {world: {case:
    result}}.  ``params_np``/``stats_np``/``lowrank_np``: the JAX
    package's parameters, statistics and low-rank factors as numpy."""
    params = bridge.params_from_jax(params_np, device="cpu")
    stats = bridge.params_from_jax(stats_np, device="cpu")
    lowrank = bridge.lowrank_from_jax(lowrank_np, device="cpu")
    res = {}
    for world in (4, 2, 1):
        pctx = make_ctx(make_mesh(1, world, device="cpu"))
        if pctx.rank < 0:
            continue
        res[world] = {}
        for name in cases:
            args = (params, stats, lowrank, pctx) if name == "requant" \
                else (params, pctx)
            res[world][name] = _run(name, CASES[name], *args)
    return res
