"""The port's chunked prefill and SLO scheduling against the JAX package's,
on the CPU: the cases of tests/test_chunked_prefill.py.

Equality: chunked ingestion is a pure scheduling change.  On the CPU the
port's chunked prefill gives its unchunked run's tokens bit for bit in all
12 cases of the grid (paged × KV dtype × speculation), held here; each of
the 12 is also held to the JAX engine by the near-tie rule of
tests/test_torch_robustness.py (``hold``: equal, or equal up to a first
disagreement whose two tokens' JAX logits lie within 0.05).  The JAX
reference of a case is its dense, unchunked, non-speculative run at the
case's KV dtype: the JAX package's own tests hold its chunked, paged and
speculative runs bit for bit to that one.  Scheduling (interleaving, the
prefill budget, priority and EDF admission, eviction classes, max_queue,
cancellation mid-ingestion, prefix sharing) is compared with the JAX
engine's counts and orders exactly.  Inputs are seeded."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import NO_QUANT as T_NO_QUANT
from repro_torch.models import lm as tlm
from repro_torch.models.config import HybridCfg
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import QueueFull, Request, Scheduler
from repro_torch.serving import TTQEngine as TEngine

from test_torch_robustness import NEAR_TIE, hold
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LONG = [((7 * i + 3) % 126) + 1 for i in range(40)]     # > chunk: chunked
SHORT = [((11 * i + 5) % 126) + 1 for i in range(8)]    # <= chunk: a group


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import NO_QUANT, KVCacheConfig
    from repro.models import ModelConfig, lm
    from repro.serving import EngineConfig, TTQEngine
    return dict(jax=jax, jnp=jnp, NO_QUANT=NO_QUANT, MCfg=ModelConfig, lm=lm,
                ECfg=EngineConfig, Eng=TTQEngine, KV=KVCacheConfig)


@pytest.fixture(scope="module")
def bridged(jx):
    jcfg = jx["MCfg"](name="t", family="dense", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    jp = jx["lm"].init_params(jcfg, jx["jax"].random.PRNGKey(0))
    tp = params_from_jax(jx["jax"].tree.map(np.asarray, jp), device="cpu")
    tcfg = TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TCfg)})
    return jcfg, jp, tcfg, tp


class _JX:
    """``hold``'s view of the JAX names (attribute access)."""

    def __init__(self, jx):
        self.jnp, self.lm, self.KV = jx["jnp"], jx["lm"], jx["KV"]


BASE = dict(max_slots=2, max_len=96, decode_chunk=1, temperature=0.0,
            recalibrate_tokens=10**9, prompt_buckets=(16, 32, 64))


def _tengine(bridged, **kw):
    _, _, tcfg, tp = bridged
    return TEngine(tcfg, tp, T_NO_QUANT, TECfg(**{**BASE, **kw}),
                   device="cpu")


def _jengine(jx, bridged, **kw):
    jcfg, jp, _, _ = bridged
    return jx["Eng"](jcfg, jp, jx["NO_QUANT"], jx["ECfg"](**{**BASE, **kw}))


def _run(eng, prompts, max_new=6):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    outs = eng.run_all()
    if eng.allocator is not None:
        eng.allocator.assert_quiescent()
    return [list(outs[r]) for r in rids]


@pytest.fixture(scope="module")
def jax_ref(jx, bridged):
    cache = {}

    def get(kv):
        if kv not in cache:
            cache[kv] = _run(_jengine(jx, bridged, kv_dtype=kv),
                             [LONG, SHORT])
        return cache[kv]
    return get


# ------------------------------------------------------------------ equality

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("spec", [0, 2], ids=["nospec", "spec2"])
def test_chunked_matches_unchunked(jx, bridged, jax_ref, paged, kv, spec):
    """Bit for bit the port's unchunked run; the JAX engine's by the
    near-tie rule."""
    kw = dict(kv_dtype=kv, speculate_k=spec)
    if paged:
        kw.update(kv_paged=True, kv_block_size=16)
    ref = _run(_tengine(bridged, **kw), [LONG, SHORT])
    eng = _tengine(bridged, prefill_chunk=16, **kw)
    got = _run(eng, [LONG, SHORT])
    assert got == ref
    assert eng.prefill_chunks == 3          # 40 tokens: 16 + 16 + 8
    hold(_JX(jx), bridged, [LONG, SHORT], jax_ref(kv), got, kv)


def test_chunking_lifts_bucket_cap(jx, bridged):
    """A prompt past the largest bucket is admitted with chunking on (as in
    the JAX engine, whose tokens it holds to) and refused with it off."""
    long100 = [((5 * i + 1) % 126) + 1 for i in range(100)]
    got = _run(_tengine(bridged, max_len=128, prefill_chunk=16), [long100],
               max_new=4)
    want = _run(_jengine(jx, bridged, max_len=128, prefill_chunk=16),
                [long100], max_new=4)
    hold(_JX(jx), bridged, [long100], want, got)
    with pytest.raises(ValueError):
        _tengine(bridged, max_len=128).submit(long100, max_new=4)


def test_chunking_lifts_bucket_cap_matches_forward(bridged):
    """The same 100-token prompt in chunks of 16, held to the port's own
    ``lm.forward``: greedy continuation by full recomputation, equal to the
    engine's tokens up to a first disagreement whose two tokens' forward
    logits lie within the near-tie bound of ``hold``."""
    _, _, tcfg, tp = bridged
    long100 = [((5 * i + 1) % 126) + 1 for i in range(100)]
    got = _run(_tengine(bridged, max_len=128, prefill_chunk=16), [long100],
               max_new=4)[0]
    seq = list(long100)
    for t, tok in enumerate(got):
        lg, _, _ = tlm.forward(tcfg, tp, {"tokens": torch.tensor([seq])})
        lg = lg[0, -1]
        want = int(lg.argmax())
        if want != tok:
            assert abs(float(lg[want]) - float(lg[tok])) <= NEAR_TIE, \
                (t, want, tok)
            break
        seq.append(tok)


# -------------------------------------------------------------- interleaving

def _interleave(eng):
    """Short decoding, long arrives: the short stream's token counts per
    step while the long one is ingested."""
    r_short = eng.submit(SHORT, max_new=12)
    eng.step()
    r_long = eng.submit(LONG, max_new=4)
    eng.step()
    assert eng.scheduler.prefilling
    short_req = next(r for r in eng.scheduler.slot_req
                     if r and r.rid == r_short)
    seen = []
    while eng.scheduler.prefilling:
        eng.step()
        seen.append(len(short_req.out))
    outs = eng.run_all()
    return seen, len(outs[r_short]), len(outs[r_long])


def test_decode_interleaves_with_chunked_prefill(jx, bridged):
    got = _interleave(_tengine(bridged, prefill_chunk=16))
    assert got == _interleave(_jengine(jx, bridged, prefill_chunk=16))
    seen = got[0]
    assert any(b > a for a, b in zip(seen, seen[1:])) and got[1:] == (12, 4)


def _budget(eng):
    eng.submit(LONG, max_new=2)             # 40 tokens → 5 chunks of 8
    eng.step()                              # admission parks the lane
    per, prev = [], eng.prefill_chunks
    while eng.scheduler.prefilling:
        eng.step()
        per.append(eng.prefill_chunks - prev)
        prev = eng.prefill_chunks
    eng.run_all()
    return per, eng.prefill_chunks


@pytest.mark.parametrize("budget,per_round", [(0, 1), (16, 2), (40, 5)])
def test_prefill_budget_bounds_chunks_per_round(jx, bridged, budget,
                                                per_round):
    got, total = _budget(_tengine(bridged, prefill_chunk=8,
                                  prefill_budget=budget))
    if budget == 16:                        # the JAX engine's rounds
        assert (got, total) == _budget(_jengine(jx, bridged, prefill_chunk=8,
                                                prefill_budget=budget))
    assert max(got, default=0) <= per_round and total == 5


# ------------------------------------------------- cancellation / leak checks

def _cancel_mid(eng):
    rid = eng.submit(LONG, max_new=4)
    eng.step()                              # admit + first chunk
    mid = bool(eng.scheduler.prefilling)
    eng.cancel(rid)
    r2 = eng.submit(SHORT, max_new=3)
    outs = eng.run_all()
    if eng.allocator is not None:
        eng.allocator.assert_quiescent()
    return (mid, not eng.scheduler.prefilling, outs[rid].cancelled,
            outs[rid].unfinished, len(outs[r2]))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cancel_mid_chunked_prefill_releases_blocks(jx, bridged, paged):
    kw = dict(kv_paged=True, kv_block_size=16) if paged else {}
    got = _cancel_mid(_tengine(bridged, prefill_chunk=16, **kw))
    assert got == _cancel_mid(_jengine(jx, bridged, prefill_chunk=16, **kw))
    assert got == (True, True, True, True, 3)


def test_chunked_prefix_sharing(jx, bridged):
    """Only blocks whose rows were written enter the trie; a second pass of
    the same prompt hits them and gives the first pass's tokens."""
    kw = dict(kv_paged=True, kv_block_size=16, prefill_chunk=16)
    eng = _tengine(bridged, **kw)
    first = _run(eng, [LONG])
    second = _run(eng, [LONG])
    assert second == first and eng.allocator.prefix_hits > 0
    jeng = _jengine(jx, bridged, **kw)
    _run(jeng, [LONG])
    _run(jeng, [LONG])
    a, b = eng.allocator, jeng.allocator
    assert (a.prefix_hits, a.prefix_misses) == (b.prefix_hits,
                                                b.prefix_misses)


# ----------------------------------------------------------- SLO scheduling

def _order(eng, subs):
    blocker = eng.submit(SHORT, max_new=2)
    eng.step()
    rids = [eng.submit(p, max_new=2, **kw) for p, kw in subs]
    eng.run_all()
    fin = eng.scheduler.finished
    return sorted([blocker] + rids, key=lambda r: fin[r].admit_seq)


@pytest.mark.parametrize("case", ["priority", "deadline"])
def test_admission_order_matches_jax(jx, bridged, case):
    """Priority classes dominate; within a class the earliest absolute
    deadline admits first, no deadline last."""
    subs = {"priority": [([1, 2, 3], dict(priority=5)),
                         ([4, 5, 6], dict(priority=0))],
            "deadline": [([1, 2, 3], {}),
                         ([4, 5, 6], dict(deadline_s=1000.0)),
                         ([7, 8, 9], dict(deadline_s=500.0))]}[case]
    got = _order(_tengine(bridged, max_slots=1), subs)
    assert got == _order(_jengine(jx, bridged, max_slots=1), subs)
    assert got == ([0, 2, 1] if case == "priority" else [0, 3, 2, 1])


def test_priority_eviction_classes(jx):
    """The victim: least urgent class first, youngest within it; never a
    lane more urgent than the requester; equal classes allowed."""
    from repro.serving import Request as JRequest
    from repro.serving import Scheduler as JScheduler
    picks = []
    for Sch, Req, E in ((Scheduler, Request, TECfg),
                        (JScheduler, JRequest, jx["ECfg"])):
        sched = Sch(E(max_slots=3, max_len=32))
        for slot, (pri, seq) in enumerate([(0, 0), (2, 1), (2, 2)]):
            r = Req(rid=slot, prompt=[1], max_new=1, admit_seq=seq)
            r.priority = pri
            sched.slot_req[slot] = r
        picks.append([sched._pick_victim(set(), limit_priority=0),
                      sched._pick_victim({2}, limit_priority=0),
                      sched._pick_victim(set(), limit_priority=5),
                      sched._pick_victim(set(), limit_priority=2)])
    assert picks[0] == picks[1] == [2, 1, None, 2]


def _queue_bound(eng):
    eng.submit(SHORT, max_new=2)
    eng.step()
    eng.submit([1, 2], max_new=1)
    eng.submit([3, 4], max_new=1)
    with pytest.raises(Exception) as e:
        eng.submit([5, 6], max_new=1)
    n = eng.queue_rejections
    eng.run_all()
    return type(e.value).__name__, n, eng.queue_rejections


def test_max_queue_rejects(jx, bridged):
    got = _queue_bound(_tengine(bridged, max_slots=1, max_queue=2))
    assert got == _queue_bound(_jengine(jx, bridged, max_slots=1,
                                        max_queue=2))
    assert got == ("QueueFull", 1, 1)
    with pytest.raises(QueueFull):
        eng = _tengine(bridged, max_slots=1, max_queue=1)
        eng.submit(SHORT)
        eng.submit(SHORT)


# ----------------------------------------------------------------- validation

def test_prefill_chunk_rejects_non_attention_family():
    cfg = TCfg(name="h", family="hybrid", n_layers=3, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
               hybrid=HybridCfg(pattern=("rec", "attn"), window=32))
    with pytest.raises(ValueError, match="prefill_chunk"):
        TEngine(cfg, {}, T_NO_QUANT, TECfg(prefill_chunk=16), device="cpu")


def test_prefill_chunk_must_divide_block_size(bridged):
    with pytest.raises(ValueError, match="block"):
        _tengine(bridged, kv_paged=True, kv_block_size=16, prefill_chunk=12)


def test_latency_percentiles_shape(bridged):
    eng = _tengine(bridged, prefill_chunk=16)
    _run(eng, [LONG, SHORT], max_new=5)
    lat = eng.latency_percentiles()
    assert set(lat) >= {"ttft_p50", "ttft_p99", "itl_p50", "itl_p99",
                        "n_streams", "n_itl"}
    assert lat["n_streams"] == 2 and lat["n_itl"] == 2 * 4
    assert lat["ttft_p99"] >= lat["ttft_p50"] >= 0.0


def test_chunk_stats_sum_to_the_prompt(bridged):
    """The statistics of a prompt's chunks, folded into the session, are
    the padded chunks' Σx²: their sum over the real rows equals the one
    prefill's (each chunk sees the rows before it as context)."""
    from repro_torch.models import lm as tlm
    from repro_torch.serving.scheduler import ChunkPlan
    _, _, tcfg, tp = bridged
    eng = _tengine(bridged, prefill_chunk=16)
    rid = eng.submit(LONG[:32], max_new=1)
    eng.scheduler.plan_admissions()
    eng._flush_releases()
    req = eng.scheduler.prefilling[0]
    total = None
    for start in (0, 16):
        plan = ChunkPlan(0, req, start, 16, final=start == 16)
        _, _, st = eng.runner.prefill_chunk(eng.params, plan)
        s = st["stack"][0]
        total = s if total is None else {k: total[k] + s[k] for k in s}
    whole = tlm.prefill(tcfg, tp, {"tokens": torch.tensor([LONG[:32]])},
                        96)[2]["stack"][0]
    for k in whole:
        torch.testing.assert_close(total[k], whole[k], rtol=1e-5, atol=1e-4)
    assert rid == req.rid
    assert list(itertools.islice(eng.runner.pos.tolist(), 1)) == [32]
