"""The vlm family (chameleon-34b: qk-norm, G = 8) in the port and the
prefill attention's window mask and KV-chunked path, against the JAX
package, on the CPU.

Config: the reference's chameleon smoke config (3 layers, d 96, 6 heads of
16 over 2 kv heads, qk-norm).  Weights come from the JAX package's
``lm.init_params`` carried across by ``params_from_jax``, every norm's gamma
(the qk-norm gammas too) moved off its init value from a numpy seed.
Inputs are seeded.

Held: the config field for field; the qk-norm attention layer bit for bit
the reference's run op by op; ``lm.forward`` logits and stats; prefill +
decode against ``forward``; ``TTQEngine`` greedy tokens against the JAX
engine's (int4 g32 packed weights, int8 KV), dense and paged, by the
near-tie rule of tests/test_torch_families.py; speculation and chunked
prefill bit for bit the plain CPU runs; ``attention``'s dispatch,
``full_attention`` with a window and ``chunked_attention`` against the
reference's.

Tolerances: bf16 model outputs as tests/test_torch_families.py (rtol 1e-1,
atol 8e-2 elementwise; relative L2 3e-2).  The attention functions on f32
inputs to 1e-5 (both sides f32; the online softmax reassociates the sums);
on bf16 inputs to one bf16 rounding of the output (rtol 2^-7, atol 2e-3),
and the chunked path to the full one to atol 2e-2: both round the
probabilities to bf16 before P·V, against different running maxima, and
the reference's own two paths differ by 1.6e-2 on these inputs."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as t_get
from repro_torch.core import KernelConfig, NO_QUANT
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models import common as TC
from repro_torch.models import lm as tlm
from repro_torch.models import stack as TS
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.quant import FusedRequantPlan
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 3e-2
NEAR_TIE = 0.1
PROMPTS = [[5, 9, 17, 3, 40], [8, 8, 1], [100, 50, 25, 12, 6, 3, 77],
           [7, 7, 7, 2]]
LONG = [((7 * i + 3) % 500) + 1 for i in range(40)]
MAX_NEW, MAX_LEN = 6, 48


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get
    from repro.core import KVCacheConfig, ttq_policy
    from repro.models import common as C
    from repro.models import lm
    from repro.models import stack as JS
    from repro.quant.api import FusedRequantPlan as JPlan
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get=get, KV=KVCacheConfig, pol=ttq_policy, C=C,
        lm=lm, JS=JS, Plan=JPlan, ECfg=EngineConfig, Eng=TTQEngine)


def _perturb_norms(jx, params, seed):
    """Every norm's gamma moved off its init value by N(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: (jx.jnp.asarray(np.asarray(v) + 0.2 * rng.standard_normal(
                np.shape(v)).astype(np.float32))
                if k == "gamma" else go(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return t
    return go(params)


@pytest.fixture(scope="module")
def model(jx):
    jcfg = jx.get("chameleon_34b", smoke=True)
    jp = _perturb_norms(jx, jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0)),
                        seed=17)
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TCfg)})
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_the_reference(jx, smoke):
    assert "chameleon_34b" in ARCH_IDS
    assert dataclasses.asdict(t_get("chameleon_34b", smoke)) == \
        dataclasses.asdict(jx.get("chameleon_34b", smoke))
    assert TS.stack_spec(t_get("chameleon_34b", smoke)) == \
        [(("attn",), 48 if not smoke else 3)]


def test_init_params_has_qk_norm(jx, model):
    """The port's own init: the reference's tree, qnorm/knorm gammas (L, hd)
    f32 zeros among them."""
    jp = jx.jax.tree.map(np.asarray, jx.lm.init_params(
        model.jcfg, jx.jax.random.PRNGKey(0)))
    tp = tlm.init_params(model.tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    jm, tm = jp["stack"][0]["u0"]["mix"], tp["stack"][0]["u0"]["mix"]
    assert set(jm) == set(tm) == {"wq", "wk", "wv", "wo", "qnorm", "knorm"}
    for k in ("qnorm", "knorm"):
        g = tm[k]["gamma"]
        assert g.shape == (3, 16) and g.dtype == torch.float32
        assert not bool(g.any())
        assert g.shape == jm[k]["gamma"].shape


def test_qk_norm_layer_equals_jax_op_by_op(jx, model):
    """One qk-norm attention layer in sequence mode on bf16 activations:
    output and cache rows bit for bit the reference's ``apply_layer_seq``
    run op by op (qk-norm per head before RoPE)."""
    x = np.random.default_rng(3).standard_normal((2, 12, 96)).astype(
        np.float32)
    pj = jx.jax.tree.map(lambda a: a[0], model.jp["stack"][0]["u0"])
    yj, sj = jx.JS.apply_layer_seq(model.jcfg, "attn", pj,
                                   jx.jnp.asarray(x).astype(jx.jnp.bfloat16),
                                   None, "", want_state=True, max_len=16)
    pt = TS.layer_slice(model.tp["stack"][0]["u0"], 0)
    yt, st = TS.apply_layer_seq(model.tcfg, "attn", pt,
                                torch.from_numpy(x).to(torch.bfloat16), None,
                                "", want_state=True, max_len=16)
    f32 = lambda a: np.asarray(a.astype(jx.jnp.float32))  # noqa: E731
    np.testing.assert_array_equal(yt.float().numpy(), f32(yj))
    for k in ("k", "v"):
        np.testing.assert_array_equal(st[k].float().numpy(), f32(sj[k]))


# ------------------------------------------------------------------ forward

def test_forward_matches_jax(jx, model):
    toks = _tokens(model.tcfg, 2, 16, seed=1)
    lj, sj, _ = jx.lm.forward(model.jcfg, model.jp,
                              {"tokens": jx.jnp.asarray(toks)},
                              collect_stats=True)
    lt, st, _ = tlm.forward(model.tcfg, model.tp,
                            {"tokens": torch.from_numpy(toks)},
                            collect_stats=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=8e-2)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    sj, st = sj["stack"][0], st["stack"][0]
    assert set(sj) == set(st) == {"u0.mix.wq", "u0.mix.wo", "u0.mlp.wg",
                                  "u0.mlp.wd"}
    for k in sj:
        assert _rel_l2(np.asarray(sj[k]), st[k].numpy()) < REL_L2, k


def test_prefill_decode_matches_forward(model):
    """prefill + two decode steps == forward on the appended tokens
    (tests/test_models_smoke.py:58's tolerance)."""
    S = 12
    toks = torch.from_numpy(_tokens(model.tcfg, 2, S, seed=3))
    last, state, _ = tlm.prefill(model.tcfg, model.tp, {"tokens": toks},
                                 max_len=S + 4)
    new = torch.from_numpy(_tokens(model.tcfg, 2, 2, seed=4))
    lgs = [tlm.decode_step(model.tcfg, model.tp, state, new[:, t:t + 1],
                           torch.full((2,), S + t, dtype=torch.int32))[0]
           for t in range(2)]
    full, _, _ = tlm.forward(model.tcfg, model.tp,
                             {"tokens": torch.cat([toks, new], dim=1)})
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                               rtol=8e-2, atol=8e-2)
    for t in range(2):
        np.testing.assert_allclose(lgs[t].numpy(), full[:, S + t].numpy(),
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


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_jax(jx, model, paged):
    """Greedy tokens of both engines (int4 g32 packed weights, int8 KV, one
    admission round, one requant) under the near-tie rule; the qk-norm
    gammas stay in full precision."""
    ekw = dict(max_slots=4, max_len=MAX_LEN, decode_chunk=2, guards=False,
               kv_paged=paged, kv_block_size=8 if paged else 0)
    jeng = jx.Eng(model.jcfg, model.jp,
                  jx.pol(bits=4, group_size=32, rank=0, packed=True,
                         kvcache=jx.KV(dtype="int8")), jx.ECfg(**ekw))
    jr = [jeng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    jo = jeng.run_all()
    teng = TEngine(model.tcfg, model.tp,
                   t_policy(bits=4, group_size=32, rank=0, packed=True,
                            kvcache=TKV(dtype="int8"),
                            kernel=KernelConfig(use_pallas=True)),
                   TECfg(**ekw), device="cpu")
    tr = [teng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    to = teng.run_all()
    assert jeng.n_requants == teng.n_requants == 1
    mix = teng.qparams["stack"][0]["u0"]["mix"]
    assert isinstance(mix["qnorm"]["gamma"], torch.Tensor)
    assert hasattr(mix["wq"], "bits")
    if paged:
        teng.allocator.assert_quiescent()
    for p, rj, rt in zip(PROMPTS, jr, tr):
        a, b = list(jo[rj]), list(to[rt])
        assert len(a) == len(b) == MAX_NEW
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        lg = _jax_logits_at(jx, model, jeng, p, a, t)
        assert abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE, \
            (p, t, a[t], b[t], float(lg[a[t]]), float(lg[b[t]]))


def test_requant_plan_members_match_jax(jx, model):
    """The fused plan's families on the qk-norm tree: the reference's
    members (the qnorm/knorm gammas are none of them)."""
    toks = jx.jnp.asarray(_tokens(model.jcfg, 2, 16, seed=5))
    _, _, stats = jx.lm.prefill(model.jcfg, model.jp, {"tokens": toks},
                                max_len=20)
    pol = dict(bits=4, group_size=32, rank=0, packed=True)
    jplan = jx.Plan(model.jp, stats, jx.pol(**pol))
    tstats = params_from_jax(jx.jax.tree.map(np.asarray, stats), device="cpu")
    plan = FusedRequantPlan(model.tp, tstats, t_policy(**pol))
    fam = lambda p: sorted(sorted(m.path_str for m in ms)  # noqa: E731
                           for ms in p.families.values())
    assert fam(plan) == fam(jplan)
    assert not any("norm" in m for f in fam(plan) for m in f)


# ------------------------------------------- the serving tier on qk-norm

SPEC_POLICY = t_policy(bits=4, group_size=32, rank=8, packed=True,
                       kernel=KernelConfig(use_pallas=True),
                       kvcache=TKV(dtype="int8"))


def _serve(eng, prompts, max_new=MAX_NEW):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    outs = eng.run_all()
    if eng.allocator is not None:
        eng.allocator.assert_quiescent()
    return [list(outs[r]) for r in rids]


@pytest.fixture(scope="module")
def own():
    cfg = t_get("chameleon_34b", smoke=True)
    return cfg, tlm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def test_speculation_on_qk_norm(own):
    """Rank-8 int4 verify tree with its int4 draft, W = 3: tokens bit for
    bit the non-speculative engine's (the verify window runs qk-norm)."""
    cfg, params = own
    kw = dict(max_slots=2, max_len=32, guards=False)
    base = _serve(TEngine(cfg, params, SPEC_POLICY, TECfg(**kw),
                          device="cpu"), PROMPTS[:2], max_new=4)
    eng = TEngine(cfg, params, SPEC_POLICY, TECfg(speculate_k=3, **kw),
                  device="cpu")
    assert _serve(eng, PROMPTS[:2], max_new=4) == base
    assert eng.spec_windows > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_on_qk_norm(own, paged):
    """A 40-token prompt in chunks of 16 beside a short one: tokens bit for
    bit the unchunked run's."""
    cfg, params = own
    kw = dict(max_slots=2, max_len=96, decode_chunk=1,
              recalibrate_tokens=10 ** 9, prompt_buckets=(16, 32, 64),
              kv_paged=paged, kv_block_size=16 if paged else 0)
    pol = NO_QUANT.with_(kvcache=TKV(dtype="int8"))
    want = _serve(TEngine(cfg, params, pol, TECfg(**kw), device="cpu"),
                  [LONG, PROMPTS[1]])
    eng = TEngine(cfg, params, pol, TECfg(prefill_chunk=16, **kw),
                  device="cpu")
    assert _serve(eng, [LONG, PROMPTS[1]]) == want
    assert eng.prefill_chunks == 3


# ------------------------------------------------- prefill attention

def _qkv(B, H, Hkv, S, Dh, seed, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, h, S, Dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    return q, k, v, [torch.from_numpy(t).to(dtype) for t in (q, k, v)]


@pytest.mark.parametrize("cap", [0.0, 5.0], ids=["no-cap", "soft-cap"])
@pytest.mark.parametrize("window", [0, 24], ids=["causal", "window24"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_chunked_and_windowed_match_jax(jx, dtype, window, cap):
    """At chunk_threshold 32 and kv_chunk 16, 64 keys take the chunked path
    of ``attention`` (the reference's dispatch) and 32 the full one: each
    against the reference's ``chunked_attention`` / ``full_attention``,
    causal and windowed, with and without a soft cap; the two paths agree
    with each other; 72 keys (not whole chunks) fall back to full."""
    jd = jx.jnp.float32 if dtype == torch.float32 else jx.jnp.bfloat16
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2e-3)
    kw = dict(causal=True, window=window, soft_cap=cap)
    for S in (64, 32, 72):
        q, k, v, (tq, tk, tv) = _qkv(2, 6, 2, S, 16, seed=S, dtype=dtype)
        jq, jk, jv = (jx.jnp.asarray(t).astype(jd) for t in (q, k, v))
        chunked = S % 16 == 0 and S > 32
        want = (jx.C.chunked_attention(jq, jk, jv, kv_chunk=16, **kw)
                if chunked else jx.C.full_attention(jq, jk, jv, **kw))
        got = TC.attention(tq, tk, tv, chunk_threshold=32, kv_chunk=16, **kw)
        assert got.dtype == dtype and got.shape == (2, 6, S, 16)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jx.jnp.float32)),
                                   **tol)
        full = TC.full_attention(tq, tk, tv, **kw)
        np.testing.assert_allclose(
            full.float().numpy(),
            np.asarray(jx.C.full_attention(jq, jk, jv, **kw).astype(
                jx.jnp.float32)), **tol)
        np.testing.assert_allclose(got.float().numpy(), full.float().numpy(),
                                   **(tol if dtype == torch.float32
                                      else dict(rtol=2 ** -7, atol=2e-2)))


def test_chunked_attention_rejects_partial_chunks():
    _, _, _, (q, k, v) = _qkv(1, 2, 1, 24, 8, seed=0, dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_chunk"):
        TC.chunked_attention(q, k, v, kv_chunk=16)


def test_windowed_prefill_with_offset_takes_the_full_path(jx):
    """A tail prefill (q_offset > 0) past 32 keys stays on the full path, as
    the reference's, with the window measured from the queries' positions."""
    q, k, v, (tq, tk, tv) = _qkv(1, 4, 2, 64, 8, seed=1, dtype=torch.float32)
    q, tq = q[:, :, -16:], tq[:, :, -16:]
    want = jx.C.attention(*(jx.jnp.asarray(t) for t in (q, k, v)),
                          window=20, q_offset=48, chunk_threshold=32,
                          kv_chunk=16)
    got = TC.attention(tq, tk, tv, window=20, q_offset=48,
                       chunk_threshold=32, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
