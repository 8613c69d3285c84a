"""The port's robustness layer against the JAX package's, on the CPU.

The scenarios of tests/test_robustness.py, each run through both engines
on the same bridged weights (2 layers, d 64): the session guard
(quarantine, outlier gate, rollback ring), the requant health gate
(transient and sustained corruption), the guarded ``decode_many``, and the
engine-level fault scenarios driven by each package's ``FaultInjector``
(lane faults with and without retry, deadlines on a virtual clock, the
admission-attempt cap, the degradation ladder, ``drop_cached``, guards off,
cancellation, the harness boundary).  Compared: error strings,
``lane_faults``, ``quarantine`` records (reason, update index, provenance),
``requant_rejections``, ``deadline_expirations``, ``admission_failures``,
``degrade_events``, pool quiescence, exactly; tokens by :func:`hold`.

Tolerance for tokens (the near-tie rule): equal to the JAX engine's, or
equal up to a first disagreement where the JAX model's teacher-forced
logits of the two tokens lie within ``NEAR_TIE`` (bf16 logits of this
model tie exactly at some steps; any rounding breaks such a tie either
way).  Within the port, a faulted run's unaffected tokens are held bit for
bit to its fault-free run's.  Inputs are seeded."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import NO_QUANT as T_NO_QUANT
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.quant import CalibrationSession as TSession
from repro_torch.quant import GuardConfig as TGuard
from repro_torch.quant import QuantizedModel as TQM
from repro_torch.quant import QuarantineRecord as TRecord
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import Fault as TFault
from repro_torch.serving import FaultInjector as TInjector
from repro_torch.serving import TTQEngine as TEngine
from repro_torch.serving import VirtualClock as TClock
from repro_torch.serving.faults import demo_injector as t_demo
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPTS = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12], [7, 7, 7, 2]]
NEAR_TIE = 0.05


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import KVCacheConfig, NO_QUANT, ttq_policy
    from repro.models import ModelConfig, lm
    from repro.quant import CalibrationSession, GuardConfig, QuantizedModel
    from repro.serving import (EngineConfig, Fault, FaultInjector, TTQEngine,
                               VirtualClock)
    from repro.serving.faults import demo_injector
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, KV=KVCacheConfig, NO_QUANT=NO_QUANT, pol=ttq_policy,
        MCfg=ModelConfig, lm=lm, Session=CalibrationSession,
        Guard=GuardConfig, QM=QuantizedModel, ECfg=EngineConfig, Fault=Fault,
        Injector=FaultInjector, Engine=TTQEngine, Clock=VirtualClock,
        demo=demo_injector)


@pytest.fixture(scope="module")
def bridged(jx):
    jcfg = jx.MCfg(name="t", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0))
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TCfg)})
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def sides(jx, bridged):
    """Each package's names under one vocabulary, so a scenario is written
    once and run on both."""
    jcfg, jp, tcfg, tp = bridged
    J = types.SimpleNamespace(
        name="jax", cfg=jcfg, params=jp, NO_QUANT=jx.NO_QUANT, ECfg=jx.ECfg,
        Guard=jx.Guard, Fault=jx.Fault, Injector=jx.Injector,
        Clock=jx.Clock, Session=jx.Session, QM=jx.QM, pol=jx.pol,
        engine=lambda *a, **k: jx.Engine(*a, **k))
    T = types.SimpleNamespace(
        name="port", cfg=tcfg, params=tp, NO_QUANT=T_NO_QUANT, ECfg=TECfg,
        Guard=TGuard, Fault=TFault, Injector=TInjector, Clock=TClock,
        Session=TSession, QM=TQM, pol=t_policy,
        engine=lambda *a, **k: TEngine(*a, device="cpu", **k))
    return J, T


def hold(jx, bridged, prompts, out_j, out_t, kv="bf16"):
    """The near-tie rule: ``out_t`` equals ``out_j`` request by request, or
    up to a first disagreement where the JAX model's teacher-forced logits
    of the two tokens differ by at most NEAR_TIE.  Lengths always equal."""
    jcfg, jp, _, _ = bridged
    for p, a, b in zip(prompts, out_j, out_t):
        assert len(a) == len(b), (p, a, b)
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        seq = jx.jnp.asarray([list(p) + list(a[:t])], jx.jnp.int32)
        lg, _, _ = jx.lm.prefill(jcfg, jp, {"tokens": seq},
                                 max_len=seq.shape[1] + 1, full_logits=True,
                                 kvcfg=jx.KV(dtype=kv))
        lg = np.asarray(lg)[0, -1]
        assert abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE, \
            (p, t, a[t], b[t], float(lg[a[t]]), float(lg[b[t]]))


def _ecfg(S, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("decode_chunk", 2)
    return S.ECfg(**kw)


def _engine(S, policy=None, faults=(), clock=None, **kw):
    return S.engine(S.cfg, S.params, policy or S.NO_QUANT, _ecfg(S, **kw),
                    faults=S.Injector(faults, clock=clock))


def _serve(eng, prompts, max_new, **sub):
    rids = [eng.submit(p, max_new=max_new, **sub) for p in prompts]
    out = eng.run_all()
    return [out[r] for r in rids]


def _report(eng, outs):
    a = eng.allocator
    quiet = None
    if a is not None:
        quiet = not a.ref and len(a.free) + len(a.cached) == a.capacity
    return dict(tokens=[list(o) for o in outs],
                errors=[o.error for o in outs],
                unfinished=[o.unfinished for o in outs],
                cancelled=[o.cancelled for o in outs],
                lane_faults=eng.lane_faults,
                deadline_expirations=eng.deadline_expirations,
                admission_failures=eng.admission_failures,
                degrade_events=eng.degrade_events,
                calib_rejections=eng.calib_rejections,
                requant_rejections=eng.requant_rejections,
                quarantine=[(q.reason, q.update_idx, q.provenance)
                            for q in eng.quarantine],
                quiescent=quiet)


def _both(jx, bridged, sides, scenario, prompts=PROMPTS, kv="bf16"):
    """Run ``scenario(S) -> report`` on both engines; everything but the
    tokens equal, the tokens by :func:`hold`.  Returns the port's report."""
    J, T = sides
    rj, rt = scenario(J), scenario(T)
    tj, tt = rj.pop("tokens"), rt.pop("tokens")
    assert rt == rj
    hold(jx, bridged, prompts, tj, tt, kv)
    rt["tokens"] = tt
    return rt


# --------------------------------------------------- calibration-session guard

def _stats(scale=1.0):
    return {"w": torch.full((8,), float(scale))}


def _jstats(jx, scale=1.0):
    return {"w": jx.jnp.full((8,), float(scale), jx.jnp.float32)}


def _records(s):
    return [(r.reason, r.update_idx, r.provenance, r.tokens
             if np.isfinite(r.tokens) else "nan") for r in s.quarantine]


def _session_script(S, mk):
    """The session cases of tests/test_robustness.py, in one script."""
    g = S.Guard()
    out = {}
    s = S.Session(guard=g)                          # non-finite
    s.update(mk(1.0), tokens=4)
    s.update(mk(float("nan")), tokens=4, provenance=(7, 9))
    s.update(mk(float("inf")), tokens=4)
    out["nonfinite"] = (s.n_updates, s.n_rejected, s.count, _records(s))
    s = S.Session(guard=g)                          # bad token counts
    for bad in (0, -3, float("nan")):
        s.update(mk(), tokens=bad)
    out["tokens"] = (s.n_updates, s.n_rejected, _records(s))
    s = S.Session(guard=g)                          # the outlier gate
    s.update(mk(1.0), tokens=4)
    s.update(mk(1e6), tokens=4)
    s.update(mk(2.0), tokens=4)
    out["outlier"] = (s.n_updates, s.n_rejected, _records(s))
    s = S.Session(guard=S.Guard(calib_warmup_updates=3))
    for scale in (1.0, 50.0, 0.1):
        s.update(mk(scale), tokens=4)
    out["warmup"] = (s.n_updates, s.n_rejected)
    s = S.Session(guard=S.Guard(snapshot_ring=2))   # the rollback ring
    for _ in range(4):
        s.update(mk(1.0), tokens=2)
    out["ring"] = (s.rollback(5), s.n_updates, s.count, s.rollback())
    s = S.Session()                                 # unguarded
    s.update(mk(float("nan")), tokens=4)
    out["unguarded"] = (s.n_updates, s.n_rejected, s.rollback())
    s = S.Session(guard=S.Guard(quarantine_max=3))
    for _ in range(6):
        s.update(mk(), tokens=0)
    out["bounded"] = (s.n_rejected, len(s.quarantine))
    return out


def test_session_guard_matches_jax(jx):
    """Every session case: the same accept/reject decisions, counts and
    quarantine records (reason, update index, provenance, tokens)."""
    got = _session_script(types.SimpleNamespace(Session=TSession,
                                                Guard=TGuard), _stats)
    want = _session_script(types.SimpleNamespace(Session=jx.Session,
                                                 Guard=jx.Guard),
                           lambda sc=1.0: _jstats(jx, sc))
    assert got == want
    assert got["nonfinite"][:2] == (1, 2) and got["ring"][0] == 2
    assert isinstance(TSession(guard=TGuard()).quarantine.maxlen, int)


def test_session_rejects_and_keeps_running_stats_finite():
    s = TSession(guard=TGuard())
    s.update(_stats(1.0), tokens=4)
    s.update(_stats(float("nan")), tokens=4, provenance=(7, 9))
    rec = s.quarantine[-1]
    assert isinstance(rec, TRecord) and rec.reason == "non-finite-stats"
    assert rec.provenance == (7, 9)
    assert bool(torch.isfinite(s.stats["w"]).all())


# ------------------------------------------------------- requant health gate

def _nan_tree(tree):
    from repro_torch.serving.faults import _nan_floats
    return _nan_floats(tree)


def _gate_script(S, params, stats_fn, nan_fn):
    """The three health-gate cases, each a fresh model."""
    g = S.Guard()
    pol = S.pol(bits=8, group_size=32, rank=0)
    out = {}
    qm = S.QM(params, pol, session=S.Session(guard=g), health_gate=g)
    qm.calibrate(stats_fn(), tokens=4.0)
    qm._fault_hook = nan_fn
    sustained = qm.requantize()
    out["sustained"] = (sustained is None, qm.requant_rejections,
                        qm.n_requants, qm.session.n_updates,
                        qm.decode_params is params)
    qm._fault_hook = None
    qm.calibrate(stats_fn(), tokens=4.0)
    out["recovered"] = (qm.requantize() is not None, qm.n_requants)
    qm = S.QM(params, pol, session=S.Session(guard=g), health_gate=g)
    qm.calibrate(stats_fn(), tokens=4.0)
    calls = {"n": 0}

    def once(tree):
        calls["n"] += 1
        return nan_fn(tree) if calls["n"] == 1 else tree
    qm._fault_hook = once
    out["transient"] = (qm.requantize() is not None, qm.requant_rejections,
                        qm.session.n_updates)
    qm = S.QM(params, pol)
    qm.calibrate(stats_fn(), tokens=4.0)
    qm._fault_hook = nan_fn
    out["ungated"] = (qm.requantize() is not None, qm.requant_rejections)
    return out


def test_health_gate_matches_jax(jx, bridged):
    """Sustained corruption: two rejections, the newest update rolled back,
    nothing swapped, clean recovery; transient: one rejection, retried in
    the same requant; ungated: the corruption passes."""
    jcfg, jp, tcfg, tp = bridged
    toks = [[5, 9, 17, 3]]

    def jstats():
        return jx.lm.prefill(jcfg, jp, {"tokens": jx.jnp.asarray(
            toks, jx.jnp.int32)}, max_len=32)[2]

    def tstats():
        return tlm.prefill(tcfg, tp, {"tokens": torch.tensor(toks)}, 32)[2]

    def jnan(tree):
        return jx.jax.tree.map(
            lambda x: x * float("nan")
            if np.issubdtype(x.dtype, np.floating) else x, tree)

    want = _gate_script(types.SimpleNamespace(
        Guard=jx.Guard, pol=jx.pol, QM=jx.QM, Session=jx.Session), jp,
        jstats, jnan)
    got = _gate_script(types.SimpleNamespace(
        Guard=TGuard, pol=t_policy, QM=TQM, Session=TSession), tp, tstats,
        _nan_tree)
    assert got == want
    assert got["sustained"] == (True, 2, 0, 0, True)


def _draft_script(S, params, stats_fn, nan_fn):
    """A verify and a draft tree under the gate: the second requant's draft
    candidates (the hook's calls 2 and 3) are corrupted, so the verify tree
    swaps in and the draft keeps its old tree."""
    g = S.Guard()
    qm = S.QM(params, S.pol(bits=8, group_size=32, rank=0),
              session=S.Session(guard=g), health_gate=g,
              draft_policy=S.pol(bits=4, group_size=32, rank=0))
    qm.calibrate(stats_fn(), tokens=4.0)
    qm.requantize()
    old_v, old_d = qm.decode_params, qm.draft_params
    calls = {"n": 0}

    def draft_bad(tree):
        calls["n"] += 1
        return nan_fn(tree) if calls["n"] >= 2 else tree
    qm._fault_hook = draft_bad
    qm.calibrate(stats_fn(), tokens=4.0)
    out = qm.requantize() is not None
    return (out, qm.requant_rejections, qm.n_requants, calls["n"],
            qm.decode_params is not old_v, qm.draft_params is old_d)


def test_rejected_draft_keeps_its_old_draft(jx, bridged):
    jcfg, jp, tcfg, tp = bridged
    toks = [[5, 9, 17, 3]]

    def jnan(tree):
        return jx.jax.tree.map(
            lambda x: x * float("nan")
            if np.issubdtype(x.dtype, np.floating) else x, tree)
    want = _draft_script(
        types.SimpleNamespace(Guard=jx.Guard, pol=jx.pol, QM=jx.QM,
                              Session=jx.Session), jp,
        lambda: jx.lm.prefill(jcfg, jp, {"tokens": jx.jnp.asarray(
            toks, jx.jnp.int32)}, max_len=32)[2], jnan)
    got = _draft_script(
        types.SimpleNamespace(Guard=TGuard, pol=t_policy, QM=TQM,
                              Session=TSession), tp,
        lambda: tlm.prefill(tcfg, tp, {"tokens": torch.tensor(toks)}, 32)[2],
        _nan_tree)
    assert got == want == (True, 2, 2, 3, True, True)


def _qt_fields(tree):
    from repro_torch.core.ttq import QuantizedTensor
    from repro_torch.quant.api import _walk
    return {p: [getattr(q, f) for f in ("packed", "wint", "scale", "zero",
                                        "dinv") if getattr(q, f) is not None]
            for p, q in _walk(tree) if isinstance(q, QuantizedTensor)}


def _qt_bytes(tree):
    return {p: [t.clone() for t in v] for p, v in _qt_fields(tree).items()}


@pytest.mark.parametrize("faults", [1, 2], ids=["transient", "sustained"])
def test_requant_fault_leaves_the_served_tree(bridged, faults):
    """After a ``requant.tree`` NaN fault every byte of the tree decode
    reads, its storage, and the ``qt_by_path``/``last_D`` snapshots equal
    those from before the requant: a candidate is written into the tree
    decode is not reading, validated, and only then swapped in."""
    _, _, tcfg, tp = bridged
    eng = TEngine(tcfg, tp, t_policy(bits=4, group_size=32, rank=0,
                                     packed=True),
                  TECfg(max_slots=2, max_len=64, decode_chunk=2,
                        recalibrate_every=1), device="cpu",
                  faults=TInjector([TFault("requant.tree", at=2,
                                           count=faults)]))
    eng.submit(PROMPTS[0], max_new=4)
    eng.step()                                      # requant 1 (site 0)
    eng.submit(PROMPTS[1], max_new=4)
    eng.step()                                      # requant 2 (site 1)
    qm = eng.qmodel
    served = qm.decode_params
    before = _qt_bytes(served)
    ptrs = {p: [t.data_ptr() for t in v]
            for p, v in _qt_fields(served).items()}
    snaps = ({k: q for k, q in qm._qt_by_path.items()},
             {k: v.clone() for k, v in qm._last_D.items()})
    n0 = qm.n_requants
    eng.submit(PROMPTS[2], max_new=4)
    eng.admit()                                     # requant 3: the fault
    assert qm.requant_rejections == faults
    if faults == 2:                                 # rolled back, kept
        assert qm.n_requants == n0 and qm.decode_params is served
        now = _qt_fields(qm.decode_params)
        assert now.keys() == before.keys()
        for p in before:
            assert all(torch.equal(a, b) for a, b in zip(now[p], before[p]))
            assert [t.data_ptr() for t in now[p]] == ptrs[p]
        assert all(qm._qt_by_path[k] is q for k, q in snaps[0].items())
        assert all(torch.equal(qm._last_D[k], v) for k, v in snaps[1].items())
    else:                                           # retried: a clean swap
        assert qm.n_requants == n0 + 1 and qm.decode_params is not served
        assert qm._spare is served                  # the last good, intact
        now = _qt_bytes(served)
        assert all(torch.equal(a, b) for p in before
                   for a, b in zip(now[p], before[p]))
    assert all(torch.isfinite(t).all() for v in _qt_bytes(
        qm.decode_params).values() for t in v if t.is_floating_point())
    out = eng.run_all()
    assert all(len(o) == 4 and not o.error for o in out.values())


# ------------------------------------------------- guarded decode_many program

def test_decode_many_detect_faults_isolates_lane(jx, bridged):
    """A poisoned lane faults alone and emits nothing; the other lane's
    tokens equal an unpoisoned run's (the port's and the JAX program's);
    poison None keeps the unguarded two-output program."""
    jcfg, jp, tcfg, tp = bridged
    toks = [[5, 9, 17, 3], [100, 50, 25, 12]]
    outs = {}
    for poison in ([False, False], [False, True]):
        _, st, _ = tlm.prefill(tcfg, tp, {"tokens": torch.tensor(toks)}, 32)
        (t, v, f), carry = tlm.decode_many(
            tcfg, tp, st, torch.full((2, 1), 7, dtype=torch.int32),
            torch.tensor([4, 4], dtype=torch.int32),
            torch.zeros((2,), dtype=torch.bool),
            torch.full((2,), 100, dtype=torch.int32), None,
            torch.tensor(poison), K=4, max_len=32, detect_faults=True)
        outs[tuple(poison)] = (t.numpy(), v.numpy(), f.numpy(), carry)
    t0, v0, f0, _ = outs[(False, False)]
    t1, v1, f1, carry = outs[(False, True)]
    assert not f0.any() and v0.all()
    assert list(f1) == [False, True] and not v1[1].any()
    assert np.array_equal(t1[0], t0[0]) and bool(carry[3][1])
    jtok = jx.jnp.asarray(toks, jx.jnp.int32)
    _, jst, _ = jx.lm.prefill(jcfg, jp, {"tokens": jtok}, max_len=32)
    (jt, jv, jf), _ = jx.lm.decode_many(
        jcfg, jp, jst, jx.jnp.full((2, 1), 7, jx.jnp.int32),
        jx.jnp.asarray([4, 4], jx.jnp.int32), jx.jnp.zeros((2,), bool),
        jx.jnp.full((2,), 100, jx.jnp.int32), jx.jax.random.PRNGKey(1),
        jx.jnp.asarray([False, True]), K=4, max_len=32, detect_faults=True)
    assert list(np.asarray(jf)) == list(f1)
    assert np.array_equal(np.asarray(jv), v1)
    hold(jx, bridged, [toks[0] + [7]], [list(np.asarray(jt)[0])],
         [list(t1[0])])
    _, st, _ = tlm.prefill(tcfg, tp, {"tokens": torch.tensor(toks[:1])}, 32)
    ys, _ = tlm.decode_many(tcfg, tp, st,
                            torch.full((1, 1), 7, dtype=torch.int32),
                            torch.tensor([4], dtype=torch.int32),
                            torch.zeros((1,), dtype=torch.bool),
                            torch.full((1,), 100, dtype=torch.int32),
                            K=4, max_len=32)
    assert len(ys) == 2


# ----------------------------------------------------- engine-level scenarios

def _lane_fault(retries, paged=False):
    def run(S):
        kw = dict(guard_cfg=S.Guard(max_retries=retries))
        if paged:
            kw.update(kv_dtype="int8", kv_paged=True, kv_block_size=16)
        eng = _engine(S, faults=[S.Fault("decode.logits", rid=1, count=1)],
                      **kw)
        return _report(eng, _serve(eng, PROMPTS[:2], 6))
    return run


@pytest.mark.parametrize("retries,paged", [(1, False), (0, False), (0, True)],
                         ids=["retried", "failed", "failed paged"])
def test_lane_fault_matches_jax(jx, bridged, sides, retries, paged):
    """decode.logits on request 1: it retries (max_retries 1) or fails
    alone with "non-finite logits"; request 0's tokens equal a fault-free
    run's bit for bit in the port; paged, the pool ends quiescent."""
    kv = "int8" if paged else "bf16"
    rep = _both(jx, bridged, sides, _lane_fault(retries, paged),
                prompts=PROMPTS[:2], kv=kv)
    assert rep["lane_faults"] == 1
    assert rep["errors"] == ["", "" if retries else "non-finite logits"]
    _, T = sides
    kw = dict(kv_dtype="int8", kv_paged=True, kv_block_size=16) if paged \
        else {}
    clean = _serve(_engine(T, **kw), PROMPTS[:2], 6)
    assert rep["tokens"][0] == list(clean[0])
    if retries:
        assert rep["tokens"][1] == list(clean[1])
    assert rep["quiescent"] in (None, True)


def _deadline_running(S):
    clk = S.Clock()
    eng = _engine(S, faults=[S.Fault("clock.skew", at=2, magnitude=5.0)],
                  clock=clk)
    r0 = eng.submit(PROMPTS[0], max_new=20)
    r1 = eng.submit(PROMPTS[1], max_new=20, deadline_s=1.0)
    out = eng.run_all()
    return _report(eng, [out[r0], out[r1]])


def _deadline_queued(S):
    clk = S.Clock()
    eng = _engine(S, faults=[S.Fault("clock.skew", at=1, magnitude=5.0)],
                  clock=clk, max_slots=1)
    r0 = eng.submit(PROMPTS[0], max_new=12)
    r1 = eng.submit(PROMPTS[1], max_new=12, deadline_s=1.0, priority=1)
    out = eng.run_all()
    return _report(eng, [out[r0], out[r1]])


def _deadline_default(S):
    eng = _engine(S, clock=S.Clock(tick=1.0), deadline_s=2.5)
    return _report(eng, _serve(eng, PROMPTS[:1], 50))


@pytest.mark.parametrize("scenario", ["running", "queued", "default"])
def test_deadlines_match_jax(jx, bridged, sides, scenario):
    """Expiry on the virtual clock: a running request keeps its partial
    output, a queued one none, the config's default applies; both engines
    expire the same requests at the same token."""
    fn = {"running": _deadline_running, "queued": _deadline_queued,
          "default": _deadline_default}[scenario]
    prompts = PROMPTS[:1] if scenario == "default" else PROMPTS[:2]
    rep = _both(jx, bridged, sides, fn, prompts=prompts)
    assert rep["deadline_expirations"] == 1
    assert "deadline" in rep["errors"]
    if scenario == "running":
        assert len(rep["tokens"][1]) > 0 and len(rep["tokens"][0]) == 20
    if scenario == "queued":
        assert rep["tokens"][1] == [] and len(rep["tokens"][0]) == 12


def _admission_cap(S):
    inj = S.Injector([S.Fault("pool.steal", at=0, magnitude=64, count=500)])
    eng = S.engine(S.cfg, S.params, S.NO_QUANT,
                   S.ECfg(max_slots=1, max_len=64, decode_chunk=2,
                          kv_dtype="int8", kv_paged=True, kv_block_size=16,
                          guard_cfg=S.Guard(max_admission_attempts=4)),
                   faults=inj)
    outs = _serve(eng, PROMPTS[:1], 4)
    for _, alloc, blocks in inj._stolen:            # give the blocks back
        alloc.free.extend(blocks)
    inj._stolen.clear()
    return _report(eng, outs)


def test_admission_retry_cap_matches_jax(jx, bridged, sides):
    rep = _both(jx, bridged, sides, _admission_cap, prompts=PROMPTS[:1],
                kv="int8")
    assert rep["errors"] == ["admission retries exhausted"]
    assert rep["admission_failures"] == 1 and rep["quiescent"]


def _ladder(S):
    eng = _engine(S, guard_cfg=S.Guard(degrade_pressure=0.2,
                                       recover_pressure=0.05),
                  kv_dtype="int8", kv_paged=True, kv_block_size=16)
    return _report(eng, _serve(eng, PROMPTS, 8))


def test_degradation_ladder_matches_jax(jx, bridged, sides):
    """Pool pressure climbs the ladder (speculation off, K = 1 blocks,
    cached prefix dropped) in both engines alike; tokens equal an
    unpressured run's in the port bit for bit."""
    J, T = sides
    rj, rt = _ladder(J), _ladder(T)
    tj, tt = rj.pop("tokens"), rt.pop("tokens")
    assert rt == rj and rt["degrade_events"] > 0 and rt["quiescent"]
    hold(jx, bridged, PROMPTS, tj, tt, "int8")
    ref = _serve(_engine(T, kv_dtype="int8", kv_paged=True,
                         kv_block_size=16), PROMPTS, 8)
    assert tt == [list(o) for o in ref]


def test_small_chunk_block_is_one_step(bridged):
    """Rung 2's block: one step, the same tokens as the first column of a
    K-step block from the same state."""
    _, _, tcfg, tp = bridged
    outs = []
    for small in (False, True):
        eng = TEngine(tcfg, tp, T_NO_QUANT,
                      TECfg(max_slots=2, max_len=64, decode_chunk=4),
                      device="cpu")
        for p in PROMPTS[:2]:
            eng.submit(p, max_new=8)
        eng.admit()
        outs.append(eng.runner.decode_block(eng.decode_params,
                                            small_chunk=small))
    big, one = outs
    assert one[0].shape == (2, 1) and big[0].shape == (2, 4)
    assert np.array_equal(one[0][:, 0], big[0][:, 0])
    assert one[3] is not None and not one[3].any()


def _drop_cached(S):
    eng = _engine(S, kv_dtype="int8", kv_paged=True, kv_block_size=16,
                  prefix_cache=True)
    sysp = list(range(1, 33))
    o1 = _serve(eng, [sysp + [40]], 2)
    a = eng.allocator
    cached = len(a.cached)
    n = a.drop_cached()
    after = (len(a.cached), len(a.trie))
    o2 = _serve(eng, [sysp + [41]], 2)
    rep = _report(eng, o1 + o2)
    rep.update(cached=cached, dropped=n, after=after)
    return rep


def test_drop_cached_matches_jax(jx, bridged, sides):
    sysp = list(range(1, 33))
    rep = _both(jx, bridged, sides, _drop_cached,
                prompts=[sysp + [40], sysp + [41]], kv="int8")
    assert rep["dropped"] == rep["cached"] > 0 and rep["after"] == (0, 0)
    assert rep["quiescent"]


def _guards_off(S):
    eng = S.engine(S.cfg, S.params, S.NO_QUANT,
                   S.ECfg(max_slots=2, max_len=64, decode_chunk=2,
                          guards=False),
                   faults=S.Injector([S.Fault("decode.logits", rid=0)]))
    rep = _report(eng, _serve(eng, PROMPTS[:1], 6))
    rep["detect"] = (eng.runner.detect_faults, eng.runner._poison is None)
    with pytest.raises(RuntimeError):
        eng.runner.set_poison([0])
    return rep


def test_guards_off_matches_jax(jx, bridged, sides):
    """guards=False: no fault detection, no poison lane, the decode site
    never consulted, counters dark."""
    rep = _both(jx, bridged, sides, _guards_off, prompts=PROMPTS[:1])
    assert rep["detect"] == (False, True) and rep["lane_faults"] == 0
    assert rep["errors"] == [""]


def _cancels(S):
    eng = _engine(S, max_slots=1, kv_dtype="int8", kv_paged=True,
                  kv_block_size=16)
    r0 = eng.submit(PROMPTS[0], max_new=4)
    r1 = eng.submit(PROMPTS[1], max_new=4)          # still queued
    c1 = eng.cancel(r1)
    out = eng.run_all()
    c0, cx = eng.cancel(r0), eng.cancel(10_000)     # finished, unknown
    rep = _report(eng, [out[r0], out[r1]])
    rep.update(calls=(c1, c0, cx),
               after=(list(eng.scheduler.results()[r0]),
                      eng.scheduler.results()[r0].cancelled))
    return rep


def test_cancel_matches_jax(jx, bridged, sides):
    rep = _both(jx, bridged, sides, _cancels, prompts=PROMPTS[:2],
                kv="int8")
    assert rep["calls"] == (True, False, False)
    assert rep["cancelled"] == [False, True] and rep["tokens"][1] == []
    assert rep["after"] == (rep["tokens"][0], False) and rep["quiescent"]


def _calib_faults(S):
    """calib.stats nan / outlier / bad-tokens / drop at successive
    admissions of a quantizing engine: quarantined with provenance."""
    faults = [S.Fault("calib.stats", at=1, kind="nan"),
              S.Fault("calib.stats", at=2, kind="outlier", magnitude=1e6),
              S.Fault("calib.stats", at=3, kind="bad-tokens"),
              S.Fault("calib.stats", at=4, kind="drop")]
    eng = _engine(S, policy=S.pol(bits=8, group_size=32, rank=0),
                  faults=faults, max_slots=1)
    rep = _report(eng, _serve(eng, PROMPTS + [[9, 4, 2]], 3))
    rep["fired"] = [(s, n) for s, n, _ in eng.faults.fired]
    rep["session"] = (eng.qmodel.session.n_updates, eng.n_requants)
    return rep


def test_calibration_faults_match_jax(jx, bridged, sides):
    rep = _both(jx, bridged, sides, _calib_faults,
                prompts=PROMPTS + [[9, 4, 2]])
    assert [q[0] for q in rep["quarantine"]] == [
        "non-finite-stats", "outlier-stats", "bad-token-count"]
    assert [q[2] for q in rep["quarantine"]] == [(1,), (2,), (3,)]
    assert rep["calib_rejections"] == 3


def _determinism(S):
    """Two identical faulted runs of the port agree exactly (the JAX
    package's own test holds its engine to that; here it runs once)."""
    reps = []
    for _ in range(2 if S.name == "port" else 1):
        eng = _engine(S, faults=[S.Fault("decode.logits", rid=1, count=1)])
        rep = _report(eng, _serve(eng, PROMPTS[:2], 6))
        rep["fired"] = list(eng.faults.fired)
        reps.append(rep)
    assert reps[0] == reps[-1]
    return reps[0]


def test_injector_is_deterministic_and_matches_jax(jx, bridged, sides):
    rep = _both(jx, bridged, sides, _determinism, prompts=PROMPTS[:2])
    assert rep["fired"][0][0] == "decode.logits"


def test_injector_swallows_harness_bugs(bridged):
    _, _, tcfg, tp = bridged

    class BadClock(TClock):
        def advance(self, dt):
            raise RuntimeError("broken harness")

    inj = TInjector([TFault("clock.skew", at=0, magnitude=1.0)],
                    clock=BadClock())
    eng = TEngine(tcfg, tp, T_NO_QUANT,
                  TECfg(max_slots=1, max_len=64, decode_chunk=2),
                  device="cpu", faults=inj)
    rid = eng.submit(PROMPTS[0], max_new=4)
    out = eng.run_all()
    assert list(out[rid]) and not out[rid].error
    assert inj.errors and "broken harness" in inj.errors[0]


def test_demo_injector_recipes_match_jax(jx):
    for name in ("nan-stats", "outlier-stats", "bad-requant", "pool-steal",
                 "poison-lane"):
        got = [dataclasses.asdict(f) for f in t_demo(name).faults]
        want = [dataclasses.asdict(f) for f in jx.demo(name).faults]
        assert got == want
    with pytest.raises(ValueError):
        t_demo("nonsense")


def test_engine_config_fields_match_jax(jx):
    """Every EngineConfig and GuardConfig field of the reference, under its
    name, with its default, in its order."""
    for mine, ref in ((TECfg, jx.ECfg), (TGuard, jx.Guard)):
        got = [(f.name, f.default) for f in dataclasses.fields(mine)]
        want = [(f.name, f.default) for f in dataclasses.fields(ref)]
        got = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d)
                else d) for n, d in got]
        want = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d)
                 else d) for n, d in want]
        assert got == want
