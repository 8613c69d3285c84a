"""The hybrid family (recurrentgemma-9b: RG-LRU blocks and local attention)
in the port, against the JAX package, on the CPU.

Config: the reference's recurrentgemma smoke config (6 layers of (rec, rec,
lattn), d 64, d_rnn 64, 4 heads over 1 kv head, window 16).  Weights come
from the JAX package's ``lm.init_params`` carried across by
``params_from_jax``, every norm's gamma moved off its init value from a
numpy seed.  Inputs are seeded.

Held: the config and the stack spec field for field; ``rec_apply`` (the
doubling scan) and ``rec_decode`` against the JAX functions in f32, the
decode updating its state in place; ``lm.forward`` logits and stats at S =
20 > window; prefill + decode against ``forward`` on the appended tokens
past the window; ``TTQEngine`` greedy tokens against the JAX engine's (int4
g32 packed weights, int8 KV, one prompt whose decode wraps the window) by
the near-tie rule; the codes of the ``rec`` families; exact-length prefill;
the refusals of the paged pool, speculation and chunked prefill; the CLI.

Tolerances: f32 layer functions to rtol 1e-5 (the scans associate their
products in different orders).  bf16 model outputs to a relative L2 of
3e-2, as tests/test_torch_families.py, and elementwise to rtol 1e-1 and
atol ATOL = 0.12: on this config the JAX package's jitted ``lm.forward``
differs from its own op-by-op run (``jax.disable_jit``) by up to 0.102 in a
logit (rel-L2 1.8e-2; XLA keeps f32 across fused bf16 ops), while each
layer of the port equals the op-by-op JAX layer bit for bit on the CPU
(its bf16 output and cache rows).
The near-tie bound is twice that gap: a flip needs both logits to move."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as t_get
from repro_torch.core import KernelConfig, NO_QUANT, unpack_bits
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import stack as TS
from repro_torch.models.config import HybridCfg as THyb
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.quant import FusedRequantPlan, quantize_params
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 3e-2
ATOL = 0.12
NEAR_TIE = 0.2
MAX_LEN = 48
PROMPT = [((11 * i + 5) % 500) + 1 for i in range(19)]  # 19 + 12 > window
MAX_NEW = 12


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get
    from repro.core import KVCacheConfig, ttq_policy
    from repro.models import layers as L
    from repro.models import lm
    from repro.models.stack import stack_spec
    from repro.quant.api import FusedRequantPlan as JPlan
    from repro.quant.api import quantize_params as jquant
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get=get, KV=KVCacheConfig, pol=ttq_policy, L=L,
        lm=lm, spec=stack_spec, Plan=JPlan, quant=jquant, ECfg=EngineConfig,
        Eng=TTQEngine)


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TCfg)}
    kw["hybrid"] = THyb(**dataclasses.asdict(jcfg.hybrid))
    return TCfg(**kw)


def _perturb_norms(jx, params, seed):
    """Every norm's gamma moved off its init value by N(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: (jx.jnp.asarray(np.asarray(v) + 0.2 * rng.standard_normal(
                np.shape(v)).astype(np.float32))
                if k in ("gamma", "beta") and not isinstance(v, dict)
                else go(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return t
    return go(params)


@pytest.fixture(scope="module")
def model(jx):
    jcfg = jx.get("recurrentgemma_9b", smoke=True)
    jp = _perturb_norms(jx, jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0)),
                        seed=13)
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, tcfg=_tcfg(jcfg), jp=jp, tp=tp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _layer(tree, i=0):
    """Layer i of a stacked tree (numpy or torch leaves)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_spec_equal_the_reference(jx, smoke):
    """recurrentgemma-9b field for field; its stack spec the reference's
    (full: 12 × (rec, rec, lattn) and 1 × (rec, rec))."""
    assert "recurrentgemma_9b" in ARCH_IDS
    tc, jc = t_get("recurrentgemma_9b", smoke), jx.get("recurrentgemma_9b",
                                                       smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    spec = TS.stack_spec(tc)
    assert spec == [tuple((tuple(k), n)) for k, n in jx.spec(jc)]
    if not smoke:
        assert spec == [(("rec", "rec", "lattn"), 12), (("rec", "rec"), 1)]


def test_init_params_layout_matches_jax(jx, model):
    """The port's own init has the reference's tree (both runs, the rec
    leaves, the windowed attention's), shapes and dtypes."""
    jcfg = dataclasses.replace(model.jcfg, n_layers=5)     # two runs
    jp = jx.jax.eval_shape(lambda k: jx.lm.init_params(jcfg, k),
                           jx.jax.random.PRNGKey(0))
    tp = tlm.init_params(_tcfg(jcfg), torch.Generator().manual_seed(0),
                         device="cpu")

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, path + (i,))
        else:
            yield path, t
    lj, lt = dict(leaves(jp)), dict(leaves(tp))
    assert lj.keys() == lt.keys() and len(tp["stack"]) == 2
    for k, a in lj.items():
        b = lt[k]
        assert tuple(a.shape) == tuple(b.shape), k
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), k
    lam = tp["stack"][0]["u0"]["mix"]["log_lambda"]
    decay = torch.exp(-torch.nn.functional.softplus(lam))
    assert bool(((decay > 0.9 - 1e-6) & (decay < 0.999 + 1e-6)).all())


# ------------------------------------------------------------ the RG-LRU

def _rec_inputs(jx, model, S, seed):
    jp = _layer(jx.jax.tree.map(np.asarray, model.jp["stack"][0]["u0"]["mix"]))
    tp = _layer(model.tp["stack"][0]["u0"]["mix"])
    x = np.random.default_rng(seed).standard_normal(
        (2, S, model.tcfg.d_model)).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("S", [1, 20, 37])
def test_rec_apply_matches_jax_f32(jx, model, S):
    """The sequence-mode block in f32 (x f32: every product f32): output,
    final h and conv history against the JAX ``rec_apply`` (its
    associative scan)."""
    jp, tp, x = _rec_inputs(jx, model, S, seed=S)
    yj, sj = jx.L.rec_apply(model.jcfg, jp, jx.jnp.asarray(x), None, "",
                            return_state=True)
    yt, st = TL.rec_apply(model.tcfg, tp, torch.from_numpy(x), None, "",
                          return_state=True)
    assert yt.dtype == torch.float32 and st["h"].dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    for k in ("h", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   rtol=1e-5, atol=1e-6)


def test_rec_scan_is_the_sequential_recurrence():
    """The doubling scan against h_t = a_t·h_{t-1} + b_t stepped one t at a
    time, in f64, at lengths around powers of two."""
    rng = np.random.default_rng(5)
    for S in (1, 2, 3, 8, 9, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 8)))
        b = torch.from_numpy(rng.standard_normal((2, S, 8)))
        h, want = torch.zeros((2, 8), dtype=torch.float64), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(TL._linear_scan(a, b),
                                   torch.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)


def test_rec_decode_in_place_matches_jax(jx, model):
    """Two decode steps on one state object: h and the conv history change
    in place (same storage), and match the reference's two functional
    steps; outputs too (f32)."""
    jp, tp, x = _rec_inputs(jx, model, 2, seed=7)
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    js = {"h": jx.jnp.asarray(h), "conv": jx.jnp.asarray(conv)}
    ts = {"h": torch.from_numpy(h.copy()), "conv": torch.from_numpy(conv.copy())}
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    for t in range(2):
        pos = np.full((2,), 5 + t, np.int32)
        yj, js = jx.L.rec_decode(model.jcfg, jp, jx.jnp.asarray(x[:, t:t + 1]),
                                 js, jx.jnp.asarray(pos))
        yt, out = TL.rec_decode(model.tcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                ts)
        assert out is ts and {k: v.data_ptr() for k, v in ts.items()} == ptrs
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        for k in ("h", "conv"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-5, atol=1e-6)
    assert not np.allclose(ts["h"].numpy(), h)


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("unit,kind", [("u0", "rec"), ("u2", "lattn")])
def test_layer_equals_jax_op_by_op(jx, model, unit, kind):
    """One layer in sequence mode on bf16 activations at S = 20 > window
    (norm, mixer, MLP; the window mask on ``lattn``): bit for bit the
    reference's ``apply_layer_seq`` run op by op, and so is its decode
    state but for the f32 recurrent h (rtol 1e-5)."""
    from repro.models import stack as JS
    x = np.random.default_rng(3).standard_normal((2, 20, 64)).astype(
        np.float32)
    pj = jx.jax.tree.map(lambda a: a[0], model.jp["stack"][0][unit])
    yj, sj = JS.apply_layer_seq(model.jcfg, kind, pj,
                                jx.jnp.asarray(x).astype(jx.jnp.bfloat16),
                                None, "", want_state=True, max_len=24)
    yt, st = TS.apply_layer_seq(model.tcfg, kind,
                                _layer(model.tp["stack"][0][unit]),
                                torch.from_numpy(x).to(torch.bfloat16), None,
                                "", want_state=True, max_len=24)
    f32 = lambda a: np.asarray(a.astype(jx.jnp.float32))  # noqa: E731
    np.testing.assert_array_equal(yt.float().numpy(), f32(yj))
    assert set(st) == set(sj)
    for k in sj:                # h: f32, the two scans' orders differ
        tol = 1e-5 if st[k].dtype == torch.float32 else 0.0
        np.testing.assert_allclose(st[k].float().numpy(), f32(sj[k]),
                                   rtol=tol, atol=tol * 1e-2)



def test_forward_matches_jax(jx, model):
    """``lm.forward`` logits (B, S, V) and the stats tree at S = 20, past the
    window of 16 (the local attention's window mask bites)."""
    toks = _tokens(model.tcfg, 2, 20, seed=1)
    lj, sj, _ = jx.lm.forward(model.jcfg, model.jp,
                              {"tokens": jx.jnp.asarray(toks)},
                              collect_stats=True)
    lt, st, _ = tlm.forward(model.tcfg, model.tp,
                            {"tokens": torch.from_numpy(toks)},
                            collect_stats=True)
    assert lt.shape == (2, 20, model.tcfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=ATOL)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    sj, st = sj["stack"][0], st["stack"][0]
    assert set(sj) == set(st)
    assert {"u0.mix.w_branch", "u1.mix.w_out", "u2.mix.wq"} <= set(st)
    for k in sj:
        a, b = np.asarray(sj[k]), st[k].numpy()
        assert a.shape == b.shape
        assert _rel_l2(a, b) < REL_L2, k


def test_prefill_decode_matches_forward_past_the_window(model):
    """prefill at S = 20 > window (the rolling layout), then 14 decode
    steps (the window wraps again) against ``forward`` on the appended
    tokens (the reference's tests/test_models_smoke.py:58 tolerance); the
    prefill's last-row logits are forward's."""
    S, n = 20, 14
    toks = torch.from_numpy(_tokens(model.tcfg, 2, S, seed=3))
    last, state, _ = tlm.prefill(model.tcfg, model.tp, {"tokens": toks},
                                 max_len=S + n)
    lat = state["stack"][0]["u2"]["k"]
    assert lat.shape[3] == model.tcfg.hybrid.window
    new = torch.from_numpy(_tokens(model.tcfg, 2, n, seed=4))
    got = []
    for t in range(n):
        lg, _ = tlm.decode_step(model.tcfg, model.tp, state, new[:, t:t + 1],
                                torch.full((2,), S + t, dtype=torch.int32))
        got.append(lg)
    full, _, _ = tlm.forward(model.tcfg, model.tp,
                             {"tokens": torch.cat([toks, new], dim=1)})
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                               rtol=8e-2, atol=8e-2)
    for t in range(n):
        np.testing.assert_allclose(got[t].numpy(), full[:, S + t].numpy(),
                                   rtol=8e-2, atol=8e-2)


# ------------------------------------------------------------------- engine

def _jax_logits_at(jx, model, jeng, prompt, out, t):
    kv = jx.KV(dtype="int8")
    seq = jx.jnp.asarray([list(prompt)], jx.jnp.int32)
    lg, state, _ = jx.lm.prefill(model.jcfg, model.jp, {"tokens": seq},
                                 max_len=MAX_LEN, kvcfg=kv)
    for i in range(t):
        lg, state = jx.lm.decode_step(
            model.jcfg, jeng.qparams, state,
            jx.jnp.asarray([[out[i]]], jx.jnp.int32),
            jx.jnp.asarray([len(prompt) + i], jx.jnp.int32), kvcfg=kv)
    return np.asarray(lg)[0]


def test_engine_matches_jax(jx, model):
    """Greedy tokens of both engines (int4 g32 packed weights, int8 KV, 4
    slots, guards off) on one 19-token prompt and 12 new tokens, past the
    window: equal, or equal up to a near-tie (tests/test_torch_families.py);
    one requant each, prefilled at the exact length."""
    ekw = dict(max_slots=4, max_len=MAX_LEN, decode_chunk=2, guards=False)
    jeng = jx.Eng(model.jcfg, model.jp,
                  jx.pol(bits=4, group_size=32, rank=0, packed=True,
                         kvcache=jx.KV(dtype="int8")), jx.ECfg(**ekw))
    jr = jeng.submit(PROMPT, max_new=MAX_NEW)
    a = list(jeng.run_all()[jr])
    teng = TEngine(model.tcfg, model.tp,
                   t_policy(bits=4, group_size=32, rank=0, packed=True,
                            kvcache=TKV(dtype="int8"),
                            kernel=KernelConfig(use_pallas=True)),
                   TECfg(**ekw), device="cpu")
    tr = teng.submit(PROMPT, max_new=MAX_NEW)
    b = list(teng.run_all()[tr])
    assert jeng.n_requants == teng.n_requants == 1
    assert teng.prefill_tokens == len(PROMPT)
    assert len(a) == len(b) == MAX_NEW
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if t is not None:
        lg = _jax_logits_at(jx, model, jeng, PROMPT, a, t)
        assert abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE, \
            (t, a[t], b[t], float(lg[a[t]]), float(lg[b[t]]))


def test_exact_length_prefill():
    """The hybrid engine prefills at each prompt's own length (a recurrent
    state would absorb pad tokens): the bucket is the length, a prompt past
    the largest bucket is admitted, and two prompts of one length share a
    group."""
    cfg = t_get("recurrentgemma_9b", smoke=True)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = TEngine(cfg, params, NO_QUANT.with_(kvcache=TKV(dtype="int8")),
                  TECfg(max_slots=3, max_len=64, prompt_buckets=(16,),
                        guards=False), device="cpu")
    sch = eng.scheduler
    assert sch.exact_buckets and sch.bucket(5) == 5 and sch.bucket(17) == 17
    assert sch.max_prompt_len == 64
    prompts = [PROMPT[:7], PROMPT[1:8], PROMPT + PROMPT[:11]]
    rids = [eng.submit(p, max_new=3) for p in prompts]
    outs = eng.run_all()
    assert all(len(outs[r]) == 3 for r in rids)
    assert eng.prefill_tokens == 7 + 7 + 30


# -------------------------------------------------------------------- codes

@pytest.fixture(scope="module")
def two_runs(jx):
    """A 5-layer hybrid tree (runs (rec, rec, lattn) × 1 and (rec, rec) ×
    1), its prefill statistics and the JAX plan's quantized tree."""
    jcfg = dataclasses.replace(jx.get("recurrentgemma_9b", smoke=True),
                               n_layers=5)
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0))
    toks = jx.jnp.asarray(_tokens(jcfg, 2, 20, seed=4))
    _, _, stats = jx.lm.prefill(jcfg, jp, {"tokens": toks}, max_len=24)
    count = float(toks.size)
    jplan = jx.Plan(jp, stats, jx.pol(bits=4, group_size=32, rank=0,
                                      packed=True))
    np_tree = lambda t: jx.jax.tree.map(np.asarray, t)  # noqa: E731
    return types.SimpleNamespace(
        jplan=jplan, jq=jplan.run(jp, stats, count), count=count,
        tparams=params_from_jax(np_tree(jp), device="cpu"),
        tstats=params_from_jax(np_tree(stats), device="cpu"))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_rec_codes_match_jax(jx, two_runs, use_kernel):
    """The fused requant plan on the hybrid tree (two runs): the members
    and families are the reference's (w_in joins w_branch's statistics;
    gates, conv and log_lambda stay in full precision), and every member's
    codes equal except ±1 at round-half ties, S, Z and 1/D within f32."""
    jplan, jq, count = two_runs.jplan, two_runs.jq, two_runs.count
    tparams, tstats = two_runs.tparams, two_runs.tstats
    plan = FusedRequantPlan(tparams, tstats, t_policy(
        bits=4, group_size=32, rank=0, packed=True,
        kernel=KernelConfig(use_pallas=use_kernel)))
    fam = lambda p: sorted(sorted(m.path_str for m in ms)  # noqa: E731
                           for ms in p.families.values())
    assert fam(plan) == fam(jplan) and not jplan.eager
    members = {m.path_str for ms in plan.families.values() for m in ms}
    assert "stack.1.u1.mix.w_in" in members
    assert not any(w in p for p in members
                   for w in ("gate", "conv", "lambda", "norm"))
    tq = plan.run(tparams, tstats, count)
    for ps in sorted(members):
        path = [int(x) if x.isdigit() else x for x in ps.split(".")]
        a, b = jq, tq
        for k in path:
            a, b = a[k], b[k]
        a = jx.jax.tree.map(np.asarray, a)
        d = b.in_features
        ca = unpack_bits(torch.from_numpy(np.array(a.packed)), d, 4).numpy()
        cb = unpack_bits(b.packed, d, 4).numpy()
        assert np.abs(ca - cb).max() <= 1 and (ca != cb).mean() <= 2e-3, ps
        np.testing.assert_allclose(b.dinv.numpy(), a.dinv, rtol=1e-6)
        np.testing.assert_allclose(b.scale.numpy(), a.scale, rtol=1e-5)
        np.testing.assert_allclose(b.zero.numpy(), a.zero, rtol=1e-5,
                                   atol=1e-6)


def test_stats_free_method_skips_vectors(jx, model):
    """A stats-free method (rtn) quantizes the reference's leaves and no
    other: the stacked (L, d_rnn) ``log_lambda`` and the gates stay in full
    precision."""
    jq = jx.quant(model.jp, None, jx.pol(rank=0).with_(method="rtn"))
    tq = quantize_params(model.tp, None, t_policy(rank=0).with_(method="rtn"))

    def quantized(t, is_q, path=""):
        if isinstance(t, dict):
            return set().union(*(quantized(v, is_q, f"{path}.{k}")
                                 for k, v in t.items()))
        if isinstance(t, list):
            return set().union(*(quantized(v, is_q, f"{path}.{i}")
                                 for i, v in enumerate(t)))
        return {path} if is_q(t) else set()
    is_q = lambda t: hasattr(t, "bits")  # noqa: E731
    got = quantized(tq, is_q)
    assert got == quantized(jq, is_q)
    assert ".stack.0.u0.mix.w_out" in got
    assert not any("lambda" in p or "gate" in p for p in got)


# ----------------------------------------------------------------- refusals

@pytest.mark.parametrize("kw,match", [
    (dict(kv_paged=True), "paged KV cache supports plain attention"),
    (dict(speculate_k=2), "speculate_k needs a plain-attention family"),
    (dict(prefill_chunk=16), "prefill_chunk needs a plain-attention family"),
], ids=["kv_paged", "speculate_k", "prefill_chunk"])
def test_hybrid_misuse_raises(jx, model, kw, match):
    """The paged pool, speculation and chunked prefill on the hybrid
    family fail with the reference's ValueError, on both engines."""
    with pytest.raises(ValueError, match=match):
        jx.Eng(model.jcfg, model.jp, jx.pol(rank=0), jx.ECfg(**kw))
    with pytest.raises(ValueError, match=match):
        TEngine(model.tcfg, model.tp, t_policy(rank=0), TECfg(**kw),
                device="cpu")


def test_cli_serves_the_hybrid_family(capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma_9b
    --smoke --device cpu`` serves its requests; ``--kv-paged`` fails with
    the reference's message."""
    from repro_torch.launch import serve
    base = ["--arch", "recurrentgemma_9b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--max-len", "48"]
    eng, outs = serve.main(base)
    assert len(outs) == 3 and all(len(v) == 4 for v in outs.values())
    assert eng.scheduler.exact_buckets
    assert "arch=recurrentgemma-smoke requests=3 tokens=12" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="paged KV cache supports plain"):
        serve.main(base + ["--kv-paged"])
