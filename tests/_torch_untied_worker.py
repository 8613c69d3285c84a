"""The per-rank side of ``tests/test_torch_untied_head.py``: what each
process of a ``repro_torch.launch.mesh.spawn`` world runs.  It imports
torch and the port only (a spawned process starts from nothing).

:func:`untied_suite` runs in one world of four CPU processes over gloo:
serving an untied-head model at world 4 (every rank) and world 2 (ranks
0 and 1, a subgroup), then step 1's f32 gradients of a trainer on the
(1,2) mesh.  A case that raises returns its traceback instead of its
result, and the other cases still run."""
import dataclasses
import traceback

from repro_torch import bridge
from repro_torch.core import KVCacheConfig, ttq_policy
from repro_torch.launch.mesh import make_ctx, make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.rules import (bind, col_align, shard_params,
                                        shard_stats)
from repro_torch.quant.api import FusedRequantPlan
from repro_torch.serving import EngineConfig, TTQEngine

import _torch_tp_worker as TP
import _torch_train_worker as TR

# the dense CFG of tests/test_fused_path.py:20, untied (held to JAX)
CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
                  tie_embeddings=False)
# tests/test_torch_parallel.py's serving model, untied
TP_CFG = dataclasses.replace(TP.CFG, tie_embeddings=False)
# the reference training tests' dense model (tests/test_training.py:15),
# untied
TRAIN_CFG = dataclasses.replace(TR.CFG, tie_embeddings=False)
POLICY = dict(TP.POLICY, rank=0)


def serve(params, pctx, *, kv="int8", paged=False):
    """Greedy tokens of ``tests/_torch_tp_worker.py``'s requests, the head
    and embedding the engine holds (the rank's rows) and whether its
    decode tree reads that head."""
    policy = ttq_policy(**POLICY, kvcache=KVCacheConfig(dtype=kv))
    eng = TTQEngine(TP_CFG, params, policy, EngineConfig(
        max_slots=4, max_len=64, decode_chunk=2, kv_paged=paged,
        kv_block_size=16, use_kernels=True, guards=False), device="cpu",
        pctx=pctx)
    rids = [eng.submit(p, max_new=b) for p, b in zip(TP.PROMPTS, TP.BUDGETS)]
    eng.run_all()
    return dict(tokens=[list(eng.scheduler.results()[r]) for r in rids],
                lm_head=eng.params["lm_head"].float().numpy(),
                embed=eng.params["embed"].float().numpy(),
                head_in_tree=eng.qparams["lm_head"] is eng.params["lm_head"])


def serving(params, stats, pctx):
    """Both KV cases' serving, and the shard-local requant of fixed
    statistics (an engine's own statistics are the rank's prefill's,
    whose split products may round otherwise than world 1's)."""
    out = {f"{kv}-{paged}": serve(params, pctx, kv=kv, paged=paged)
           for kv, paged in (("int8", False), ("int4", True))}
    policy = ttq_policy(**POLICY)
    if pctx is not None:
        pctx = bind(pctx, TP_CFG, col_align(policy))
        params, stats = shard_params(params, pctx), shard_stats(stats, pctx)
    plan = FusedRequantPlan(params, stats, policy, pctx=pctx)
    out["codes"] = TP.qt_numpy(plan.run(params, stats, 10.0))
    return out


def training(pctx):
    """Step 1's f32 gradients (whole, leaf order) and loss of a fresh
    Trainer of :data:`TRAIN_CFG` on ``pctx``."""
    loss, grads = TR.first_grads(TR.trainer(TRAIN_CFG, pctx), f32=True)
    return dict(loss1=loss, grads32=grads)


def _run(fn, *args):
    try:
        return fn(*args)
    except Exception:                       # noqa: BLE001 — reported
        return {"error": traceback.format_exc()}


def untied_suite(params_np, stats_np):
    """{world: {case: result}} of this rank: serving at worlds 4 and 2,
    training at (1,2).  ``params_np``/``stats_np``: the JAX package's
    untied parameters (:data:`TP_CFG`) and a prefill's statistics, as
    numpy."""
    params = bridge.params_from_jax(params_np, device="cpu")
    stats = bridge.params_from_jax(stats_np, device="cpu")
    res = {}
    for world in (4, 2):
        pctx = make_ctx(make_mesh(1, world, device="cpu"))
        if pctx.rank < 0:
            continue
        res[world] = {"serve": _run(serving, params, stats, pctx)}
        if world == 2:
            res[world]["train"] = _run(training, pctx)
    return res


def world1(params, stats):
    """The cases at world 1 (``pctx=None``), in the calling process."""
    return dict(serve=serving(params, stats, None), train=training(None))

