"""Low-rank SVD init (paper §2, App. E) in the port against the JAX package,
on the CPU, at the sizes of tests/test_fused_path.py (2 layers, d 64).

SVD signs are ambiguous, so factors are never compared: products B·A are,
on matrices with a planted spectrum whose gap after rank r makes the top-r
subspace well determined (rtol 1e-4, atol 1e-4 of the product's largest
entry: f32 SVDs by two libraries).  Quantized residuals are compared on the
SAME factors, carried across from the JAX package by
``bridge.lowrank_from_jax``: codes equal except ±1 at round-half ties (as
tests/test_ttq_integration.py:84 allows), on at most 2e-3 of them.
Inputs come from numpy generators with a seed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import lowrank_from_jax, params_from_jax
from repro_torch.core import KernelConfig, QuantConfig, override, unpack_bits
from repro_torch.core import lowrank as tlr
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.quant import (FusedRequantPlan, QuantizedModel,
                               quantize_params)
from repro_torch.quant import api as tapi
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import lowrank as jlr
    from repro.models import ModelConfig, lm
    from repro.quant.api import lowrank_tree as jlowrank_tree
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab)
    _, _, stats = lm.prefill(cfg, params, {"tokens": toks}, max_len=20)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(jax=jax, jnp=jnp, jlr=jlr, lm=lm, cfg=cfg, params=params,
                stats=stats, count=float(toks.size),
                jlowrank_tree=jlowrank_tree, np_tree=np_tree,
                tparams=params_from_jax(np_tree(params), device="cpu"),
                tstats=params_from_jax(np_tree(stats), device="cpu"),
                tcfg=TCfg(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(TCfg)}))


def _planted(seed, m, n, r):
    """W (m, n) f32 = U diag(s) Vᵀ with s falling 10 → 5 over the top r and
    0.5 → 0.1 after: a gap of 10 at rank r."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, k)))
    V, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.concatenate([np.linspace(10, 5, r), np.linspace(0.5, 0.1, k - r)])
    return ((U * s) @ V.T).astype(np.float32)


@pytest.mark.parametrize("shape,r", [((48, 64), 4), ((64, 40), 8),
                                     ((96, 64), 16)])
def test_svd_products_match_jax(ref, shape, r):
    W = _planted(sum(shape) + r, *shape, r)
    jB, jA = ref["jlr"].svd_factors(ref["jnp"].asarray(W), r)
    want = np.asarray(jB) @ np.asarray(jA)
    tB, tA = tlr.svd_factors(torch.from_numpy(W), r)
    assert tB.shape == (shape[0], r) and tA.shape == (r, shape[1])
    assert tB.dtype == tA.dtype == torch.float32
    got = (tB @ tA).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # in W's dtype: bf16 weights give bf16 factors of the f32 SVD
    bB, bA = tlr.svd_factors(torch.from_numpy(W).to(torch.bfloat16), r)
    assert bB.dtype == bA.dtype == torch.bfloat16


@pytest.mark.parametrize("r", [1, 8, 40])
def test_residual_reaches_the_eckart_young_optimum(r):
    """On a plain random matrix (tests/test_quant_core.py:125): ‖W − BA‖_F
    equals √(Σ_{i>r} σ_i²) from a float64 SVD (rtol 1e-5), and at full rank
    B·A reconstructs W (atol 1e-3, as the reference holds it)."""
    W = np.random.default_rng(r).standard_normal((40, 64)).astype(np.float32)
    B, A = tlr.svd_factors(torch.from_numpy(W), r)
    s = np.linalg.svd(W.astype(np.float64), compute_uv=False)
    res = np.linalg.norm(W.astype(np.float64) - (B @ A).double().numpy())
    if r == 40:
        np.testing.assert_allclose((B @ A).numpy(), W, atol=1e-3)
    else:
        np.testing.assert_allclose(res, np.sqrt((s[r:] ** 2).sum()),
                                   rtol=1e-5)


def _factors(ref, pol):
    """The JAX package's lowrank tree for ``pol``, and its bridged twin."""
    jt = ref["jlowrank_tree"](ref["params"], pol)
    return jt, lowrank_from_jax(ref["np_tree"](jt), device="cpu")


def test_residual_codes_match_jax(ref):
    """ttq_lowrank_quantize on one layer of every weight, the same bridged
    B, A and the same D: codes ±1 at ties, S and Z to a few ulps."""
    from repro.core import ttq_policy
    from repro.core.awq import diag_from_stats
    from repro.core.qdq import QuantConfig as JQ
    jax, jnp = ref["jax"], ref["jnp"]
    jt, tt = _factors(ref, ttq_policy(bits=4, group_size=32, rank=8))
    qcfg = QuantConfig(bits=4, group_size=32, layout="row")
    jq = JQ(bits=4, group_size=32, layout="row")
    stat_of = {"wq": "wq", "wk": "wq", "wv": "wq", "wo": "wo", "wg": "mlp.wg",
               "wu": "mlp.wg", "wd": "mlp.wd"}
    for grp, names in (("mix", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("wg", "wu", "wd"))):
        for nm in names:
            key = stat_of[nm] if grp == "mlp" else "mix." + stat_of[nm]
            stat = ref["stats"]["stack"][0]["u0." + key][1]
            D = diag_from_stats(stat, jnp.float32(ref["count"]),
                                ttq_policy().acfg)
            W = ref["params"]["stack"][0]["u0"][grp][nm][1]
            ba = jt["stack"][0]["u0"][grp][nm]
            jw, jS, jZ = (np.asarray(x) for x in
                          ref["jlr"].ttq_lowrank_quantize(
                              W, ba["B"][1], ba["A"][1], D, jq))
            tba = tt["stack"][0]["u0"][grp][nm]
            tw, tS, tZ = tlr.ttq_lowrank_quantize(
                ref["tparams"]["stack"][0]["u0"][grp][nm][1], tba["B"][1],
                tba["A"][1], torch.from_numpy(np.array(D)), qcfg)
            d = np.abs(jw.astype(np.int32) - tw.numpy().astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 2e-3, nm
            np.testing.assert_allclose(tS.numpy(), jS, rtol=1e-5)
            np.testing.assert_allclose(tZ.numpy(), jZ, rtol=1e-5, atol=1e-6)
    # the fake-quant closed form, Ŵ = Q[(W−BA)∘D]∘D⁻¹ + BA: within one
    # scale step of JAX's (a tie may round the other way)
    jqd = np.asarray(ref["jlr"].ttq_lowrank_qdq(W, ba["B"][1], ba["A"][1], D,
                                                jq), np.float32)
    tqd = tlr.ttq_lowrank_qdq(ref["tparams"]["stack"][0]["u0"][grp][nm][1],
                              tba["B"][1], tba["A"][1],
                              torch.from_numpy(np.array(D)), qcfg)
    step = np.repeat(np.asarray(jS), 32, axis=1) / np.asarray(D)[None, :]
    assert (np.abs(tqd.float().numpy() - jqd) <= step + 1e-2).all()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_fused_plan_with_factors_matches_jax(ref, use_kernel):
    """The whole plan on the bridged factors: per leaf the codes of the
    residual ±1 at ties, B and A the tree's own tensors; and the eager
    per-leaf path agrees with the plan."""
    from repro.core import QuantizedTensor as JQT
    from repro.core import ttq_policy
    from repro.quant.api import FusedRequantPlan as JPlan
    jax = ref["jax"]
    jpol = ttq_policy(bits=4, group_size=32, rank=8, packed=True)
    jt, tt = _factors(ref, jpol)
    jtree = JPlan(ref["params"], ref["stats"], jpol, lowrank_tree=jt).run(
        ref["params"], ref["stats"], ref["count"], jt)
    pol = t_policy(bits=4, group_size=32, rank=8, packed=True,
                   kernel=KernelConfig(use_pallas=use_kernel))
    plan = FusedRequantPlan(ref["tparams"], ref["tstats"], pol,
                            lowrank_tree=tt)
    tree = plan.run(ref["tparams"], ref["tstats"], ref["count"], tt)
    eager = quantize_params(ref["tparams"], ref["tstats"], pol,
                            count=ref["count"], lowrank_tree=tt)
    n = 0
    for grp, names in (("mix", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("wg", "wu", "wd"))):
        for nm in names:
            jq = jax.tree.map(np.asarray, jtree["stack"][0]["u0"][grp][nm])
            assert isinstance(jtree["stack"][0]["u0"][grp][nm], JQT)
            tq = tree["stack"][0]["u0"][grp][nm]
            eq = eager["stack"][0]["u0"][grp][nm]
            assert tq.B is tt["stack"][0]["u0"][grp][nm]["B"]
            assert tq.A is tt["stack"][0]["u0"][grp][nm]["A"]
            d = tq.in_features
            cj = unpack_bits(torch.from_numpy(np.array(jq.packed)), d, 4)
            for got in (tq, eq):
                ct = unpack_bits(got.packed, d, 4)
                diff = (cj.int() - ct.int()).abs()
                assert diff.max() <= 1 and diff.float().mean() <= 2e-3, nm
                np.testing.assert_allclose(got.scale.numpy(), jq.scale,
                                           rtol=1e-5)
                torch.testing.assert_close(got.B, tq.B, rtol=0, atol=0)
            n += 1
    assert n == 7


def test_plan_refuses_a_rank_without_factors(ref):
    """A rank > 0 weight without factors is no longer refused: as in the
    reference's plan (its eager fallback), each becomes an eager family of
    its own that runs the SVD inline, the members the JAX plan's ``eager``
    list; with the factors there is none.  ``lowrank_tree`` is None where
    no path has rank > 0."""
    from repro.core import ttq_policy as j_policy
    from repro.quant.api import FusedRequantPlan as JPlan
    pol = t_policy(bits=4, group_size=32, rank=8)
    plan = FusedRequantPlan(ref["tparams"], ref["tstats"], pol)
    eager = sorted(k[1] for k in plan.families if k[0] == "eager")
    jplan = JPlan(ref["params"], ref["stats"], j_policy(bits=4, group_size=32,
                                                        rank=8))
    assert eager == sorted(m.path_str for m in jplan.eager)
    assert len(eager) == 7 and len(plan.families) == 7
    with_factors = FusedRequantPlan(ref["tparams"], ref["tstats"], pol,
                                    lowrank_tree=tapi.lowrank_tree(
                                        ref["tparams"], pol))
    assert not any(k[0] == "eager" for k in with_factors.families)
    assert tapi.lowrank_tree(ref["tparams"], t_policy(rank=0)) is None
    lt = tapi.lowrank_tree(ref["tparams"], pol)
    wg = lt["stack"][0]["u0"]["mlp"]["wg"]
    assert wg["B"].shape == (2, 96, 8) and wg["A"].shape == (2, 8, 64)
    assert wg["B"].dtype == torch.bfloat16
    assert lt["embed"] is None and lt["stack"][0]["u0"]["ln1"]["gamma"] is None


@pytest.fixture
def svd_calls(monkeypatch):
    """Counts every SVD the quantization API runs."""
    calls = []
    real = tapi.svd_factors
    monkeypatch.setattr(tapi, "svd_factors",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def test_no_svd_rerun_on_requantize(ref, svd_calls):
    """tests/test_quant_api.py:247: factors computed once (7 stacks × 2
    layers at construction), never again on requant."""
    qm = QuantizedModel(ref["tparams"], t_policy(bits=4, group_size=32,
                                                 rank=8))
    assert qm.lowrank_tree is not None and len(svd_calls) == 14
    for _ in range(3):
        qm.calibrate(ref["tstats"], tokens=ref["count"])
        assert qm.requantize() is not None
    assert len(svd_calls) == 14
    qt = qm.qparams["stack"][0]["u0"]["mlp"]["wg"]
    assert qt.B is not None and qt.A is not None


def test_no_svd_rerun_with_override_rank(ref, svd_calls):
    """tests/test_quant_api.py:266: a rank set only by an override."""
    pol = t_policy(bits=4, group_size=32, rank=0).with_overrides(
        override("*.mlp.*", rank=8))
    qm = QuantizedModel(ref["tparams"], pol)
    assert qm.lowrank_tree is not None and len(svd_calls) == 6
    qm.calibrate(ref["tstats"], tokens=ref["count"])
    qp = qm.requantize()
    assert len(svd_calls) == 6
    assert qp["stack"][0]["u0"]["mlp"]["wg"].B is not None
    assert qp["stack"][0]["u0"]["mix"]["wq"].B is None


def test_engine_requantize_reuses_lowrank(ref, svd_calls):
    """tests/test_quant_api.py:286: the engine's requants reuse the
    factors its model computed once."""
    eng = TEngine(ref["tcfg"], ref["tparams"],
                  t_policy(bits=4, group_size=32, rank=8),
                  TEngineConfig(max_slots=1, max_len=32, guards=False),
                  device="cpu")
    for p in ([3, 1, 4], [1, 5, 9]):
        eng.submit(p, max_new=2)
    eng.run_all()
    assert eng.n_requants >= 2 and len(svd_calls) == 14


def test_engine_greedy_with_bridged_factors_equals_jax(ref):
    """tests/test_fused_path.py:68 and tests/test_serving.py:149: both
    engines serve the packed rank-8 policy on the same (bridged) factors;
    greedy tokens equal."""
    from repro.core import ttq_policy
    from repro.serving import EngineConfig, TTQEngine
    prompts = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12]]
    jeng = TTQEngine(ref["cfg"], ref["params"],
                     ttq_policy(bits=4, group_size=32, rank=8, packed=True),
                     EngineConfig(max_slots=3, max_len=48, decode_chunk=2,
                                  guards=False))
    jr = [jeng.submit(p, max_new=5) for p in prompts]
    jo = jeng.run_all()
    teng = TEngine(ref["tcfg"], ref["tparams"],
                   t_policy(bits=4, group_size=32, rank=8, packed=True,
                            kernel=KernelConfig(use_pallas=True)),
                   TEngineConfig(max_slots=3, max_len=48, decode_chunk=2,
                                 guards=False), device="cpu")
    teng.qmodel.lowrank_tree = lowrank_from_jax(
        ref["np_tree"](jeng.lowrank_tree), device="cpu")
    tr = [teng.submit(p, max_new=5) for p in prompts]
    to = teng.run_all()
    assert [list(jo[r]) for r in jr] == [list(to[r]) for r in tr]
    assert jeng.n_requants == teng.n_requants == 1
    qt = teng.qparams["stack"][0]["u0"]["mlp"]["wd"]
    assert qt.B is teng.lowrank_tree["stack"][0]["u0"]["mlp"]["wd"]["B"]


def test_refinement_and_factor_quantization_match_jax(ref):
    """alternating_refine (eq. 34-35) on a planted spectrum: its B·A near
    JAX's (rtol 1e-3: three rounds of quantize and SVD in f32); and
    quantize_factors' flat-group fake-quant of each factor equal to JAX's
    (within one scale step) on the same factors."""
    from repro.core.qdq import QuantConfig as JQ
    jnp, jlr = ref["jnp"], ref["jlr"]
    W = _planted(5, 96, 64, 8)
    D = np.exp(np.random.default_rng(6).standard_normal(64) * 0.3).astype(
        np.float32)
    jB, jA = jlr.alternating_refine(jnp.asarray(W), jnp.asarray(D),
                                    JQ(bits=4, group_size=32, layout="row"),
                                    8)
    tB, tA = tlr.alternating_refine(torch.from_numpy(W), torch.from_numpy(D),
                                    QuantConfig(bits=4, group_size=32,
                                                layout="row"), 8)
    want = np.asarray(jB) @ np.asarray(jA)
    np.testing.assert_allclose((tB @ tA).numpy(), want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
    for which in ("A", "B", "both"):
        jqB, jqA = jlr.quantize_factors(jB, jA, JQ(bits=4, group_size=8),
                                        which)
        tqB, tqA = tlr.quantize_factors(torch.from_numpy(np.array(jB)),
                                        torch.from_numpy(np.array(jA)),
                                        QuantConfig(bits=4, group_size=8),
                                        which)
        for j, t, f in ((jqB, tqB, jB), (jqA, tqA, jA)):
            f = np.asarray(f)
            g = f.reshape(-1, 8)
            step = ((g.max(1) - g.min(1)) / 15).max()
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=step * 1.01)
