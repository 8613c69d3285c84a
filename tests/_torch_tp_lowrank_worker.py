"""The per-rank side of ``tests/test_torch_tp_lowrank.py``: what each
process of a ``repro_torch.launch.mesh.spawn`` world runs, and world 1 in
the calling process.  It imports torch and the port only.

:func:`lowrank_suite` runs in one world of four CPU processes over gloo,
each case at world 4 (every rank), then at world 2 (ranks 0 and 1, a
subgroup), as ``_torch_tp_worker.tp_suite`` does.  Each engine first
requantizes from fixed statistics (sliced to the rank) and never again
(its cadence never fires), then serves ``tests/_torch_tp_worker.py``'s
requests on those trees, so that its trees and tokens can be held to
world 1's: an engine's own statistics are its rank's prefills', whose
split products may round otherwise than world 1's."""
import traceback

import torch

from repro_torch import bridge
from repro_torch.core import ttq_policy
from repro_torch.core.lowrank import svd_factors
from repro_torch.core.ttq import QuantizedTensor
from repro_torch.launch.mesh import make_ctx, make_mesh
from repro_torch.parallel.rules import shard_stats
from repro_torch.serving import EngineConfig, TTQEngine

import _torch_tp_worker as TP

CFG = TP.CFG
# the verify tree of the speculative case, and its rank-16 draft
VERIFY = dict(bits=8, group_size=16, rank=0, packed=True)
DRAFT = dict(bits=4, group_size=16, rank=16, packed=True)
# the rank-16 policy served without factors (lowrank=None) and with them
RANKED = dict(bits=4, group_size=16, rank=16, packed=True)
# the weights whose own slice's SVD the negative control takes: a row
# split and a column split
CONTROL = ("stack.0.u0.mix.wq", "stack.0.u0.mlp.wd")
NEVER = 10 ** 9                 # a requant cadence that never fires
FIELDS = ("packed", "scale", "zero", "dinv", "B", "A")


def fields(tree) -> dict:
    """{path: {field: array}} of every QuantizedTensor of ``tree``, its
    factors included."""
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
                f: getattr(t, f).float().numpy() for f in FIELDS
                if getattr(t, f) is not None}
    walk(tree, ())
    return out


def _engine(params, stats, pctx, policy, **kw):
    """An engine whose trees are quantized once from ``stats`` (whole,
    sliced to its rank), then its tokens over the requests."""
    ecfg = dict(max_slots=4, max_len=64, decode_chunk=1, guards=False,
                recalibrate_tokens=NEVER)
    ecfg.update(kw.pop("ecfg", {}))
    eng = TTQEngine(CFG, params, ttq_policy(**policy), EngineConfig(**ecfg),
                    device="cpu", generator=torch.Generator().manual_seed(7),
                    pctx=pctx, **kw)
    eng.qmodel.calibrate(stats if eng.pctx is None
                         else shard_stats(stats, eng.pctx), 10.0)
    eng.qmodel.requantize()
    rids = [eng.submit(p, max_new=b) for p, b in zip(TP.PROMPTS, TP.BUDGETS)]
    eng.run_all()
    assert eng.n_requants == 1
    return eng, [list(eng.scheduler.results()[r]) for r in rids]


def draft_case(params, stats, pctx):
    """W = 2 self-speculation with a rank-16 int4 draft tree: the tokens,
    the windows and the draft tree."""
    eng, toks = _engine(params, stats, pctx, VERIFY,
                        ecfg=dict(speculate_k=2),
                        draft_policy=ttq_policy(**DRAFT))
    return dict(tokens=toks, windows=eng.spec_windows,
                draft=fields(eng.qmodel.draft_qparams))


def no_factors_case(params, stats, pctx):
    """The rank-16 policy served with ``lowrank=None`` (split weights'
    factors from their whole weights, computed when the plan is built)
    and with the default factors: both engines' tokens and trees, and the
    control's own-slice factors."""
    eng, toks = _engine(params, stats, pctx, RANKED, lowrank=None)
    eng_d, toks_d = _engine(params, stats, pctx, RANKED)
    none, dflt = fields(eng.qparams), fields(eng_d.qparams)
    own = {}
    for ps in CONTROL:
        w = eng.params
        for k in ps.split("."):
            w = w[int(k)] if isinstance(w, list) else w[k]
        B, A = svd_factors(w[0], RANKED["rank"])
        own[ps] = dict(B=B.float().numpy(), A=A.float().numpy())
    return dict(tokens=toks, tokens_default=toks_d, none=none, default=dflt,
                own=own)


CASES = {"draft": draft_case, "none": no_factors_case}


def _run(fn, *args):
    try:
        return fn(*args)
    except Exception:                       # noqa: BLE001 — reported
        return {"error": traceback.format_exc()}


def lowrank_suite(params_np, stats_np):
    """{world: {case: result}} of this rank at worlds 4 and 2.
    ``params_np``/``stats_np``: the JAX package's parameters of
    :data:`CFG` and a prefill's statistics, as numpy."""
    params = bridge.params_from_jax(params_np, device="cpu")
    stats = bridge.params_from_jax(stats_np, device="cpu")
    res = {}
    for world in (4, 2):
        pctx = make_ctx(make_mesh(1, world, device="cpu"))
        if pctx.rank < 0:
            continue
        res[world] = {k: _run(fn, params, stats, pctx)
                      for k, fn in CASES.items()}
    return res


def world1(params, stats):
    """Every case at world 1 (``pctx=None``), in the calling process."""
    return {k: fn(params, stats, None) for k, fn in CASES.items()}
