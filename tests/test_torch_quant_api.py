"""The rest of the quantization API in the port against the JAX package's,
on the CPU: the ``awq``/``rtn``/``gptq`` methods of the registry, the
column-serial GPTQ, ``rtn``/``pack_int4``/``unpack_int4``, the activation
statistics helpers, the calibration session's reset/snapshot/fork/merge and
``QuantizedModel``'s fork/adopt and ``fused=False`` path.  Inputs are made
from numpy seeds at smoke size; each test states its tolerance."""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import (AWQConfig, QuantConfig, QuantizedTensor,
                              accumulate_stats, activation_diag, awq_loss,
                              gptq_qdq, pack_int4, quantize, rtn, ttq_policy,
                              unpack_int4)
from repro_torch.models import lm
from repro_torch.quant import (CalibrationSession, QuantizedModel, Quantizer,
                               get_quantizer, quantize_params,
                               registered_methods)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.models import ModelConfig, lm as jlm
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    _, _, stats = jlm.prefill(cfg, params, {"tokens": toks.astype(np.int32)},
                              max_len=20)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(jax=jax, params=params, stats=stats, count=float(toks.size),
                tparams=params_from_jax(np_tree(params), device="cpu"),
                tstats=params_from_jax(np_tree(stats), device="cpu"))


def _rng_w(seed, shape=(32, 128)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _codes_close(cj, ct, share=2e-3):
    """Codes of two libraries: equal but for ±1 at round-half ties, on at
    most ``share`` of them."""
    cj, ct = np.asarray(cj, np.int64), np.asarray(ct, np.int64)
    assert cj.shape == ct.shape
    assert np.abs(cj - ct).max() <= 1 and (cj != ct).mean() <= share


# ------------------------------------------------------------ qdq helpers

@pytest.mark.parametrize("kw", [dict(bits=4, group_size=32),
                                dict(bits=3, group_size=64, layout="row"),
                                dict(bits=8, group_size=32, symmetric=True),
                                dict(bits=4, group_size=32, nu=0.95)],
                         ids=["int4 flat", "int3 row", "int8 symmetric",
                              "nu 0.95"])
def test_rtn_matches_jax(ref, kw):
    """Codes ±1 at ties; rtn's values within one step (its scale) where a
    code differs and 1e-6 elsewhere."""
    jq = importlib.import_module("repro.core.qdq")
    W = _rng_w(0)
    cfgj = jq.QuantConfig(**kw)
    wj, sj, _ = jq.quantize(W, cfgj)
    wt, st, _ = quantize(torch.from_numpy(W), QuantConfig(**kw))
    _codes_close(wj, wt)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    got = rtn(torch.from_numpy(W), **kw).numpy()
    want = np.asarray(jq.rtn(W, **kw))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=float(np.asarray(sj).max()) + 1e-6)
    same = np.asarray(wj).reshape(W.shape) == wt.numpy().reshape(W.shape)
    np.testing.assert_allclose(got[same], want[same], rtol=1e-6, atol=1e-6)


def test_pack_int4_round_trip_and_matches_jax(ref):
    jq = importlib.import_module("repro.core.qdq")
    codes = np.random.default_rng(2).integers(0, 16, (6, 64)).astype(np.int32)
    packed = pack_int4(torch.from_numpy(codes))
    assert packed.shape == (6, 8) and packed.dtype == torch.int32
    assert np.array_equal(packed.numpy(), np.asarray(jq.pack_int4(codes)))
    assert torch.equal(unpack_int4(packed, 64), torch.from_numpy(codes))
    with pytest.raises(ValueError):
        pack_int4(torch.zeros((2, 12), dtype=torch.int32))


def test_activation_statistics_match_jax(ref):
    """Σ|x|^p, the token count, D and the AWQ loss: f32 sums of two
    libraries, rtol 1e-5."""
    ja = importlib.import_module("repro.core.awq")
    X = _rng_w(3, (2, 24, 64))
    W, What = _rng_w(4, (16, 64)), _rng_w(5, (16, 64))
    for p in (2.0, 1.0, 3.0):
        sj, nj = ja.accumulate_stats(X, p)
        st, nt = accumulate_stats(torch.from_numpy(X), p)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
        assert float(nt) == float(nj) == 48.0
    for cfg in (AWQConfig(), AWQConfig(form="raw", lam=0.1)):
        jcfg = ja.AWQConfig(**{k: getattr(cfg, k)
                               for k in ("p", "alpha", "lam", "form")})
        np.testing.assert_allclose(
            activation_diag(torch.from_numpy(X), cfg).numpy(),
            np.asarray(ja.activation_diag(X, jcfg)), rtol=1e-5)
    c = np.abs(_rng_w(6, (64,)))
    np.testing.assert_allclose(
        float(awq_loss(torch.from_numpy(W), torch.from_numpy(What),
                       torch.from_numpy(c))),
        float(ja.awq_loss(W, What, c)), rtol=1e-5)


# ------------------------------------------------------------------ GPTQ

@pytest.mark.parametrize("bits,g", [(4, 32), (3, 16)])
def test_gptq_qdq_matches_jax(ref, bits, g):
    """The column-serial OBS algorithm, with the reference's
    cholesky(inv(H), upper=True): within f32 tolerance of the JAX result
    (rtol 1e-4, atol 1e-5: two libraries' inverse and Cholesky)."""
    jg = importlib.import_module("repro.core.gptq")
    jq = importlib.import_module("repro.core.qdq")
    W, X = _rng_w(7, (24, 64)), _rng_w(8, (96, 64))
    np.testing.assert_allclose(jg._hessian(X), _hess(X), rtol=1e-5)
    want = np.asarray(jg.gptq_qdq(W, X, jq.QuantConfig(bits=bits,
                                                       group_size=g)))
    got = gptq_qdq(torch.from_numpy(W), torch.from_numpy(X),
                   QuantConfig(bits=bits, group_size=g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the reason for the method: a lower activation-aware error than RTN
    err = lambda Q: float(((torch.from_numpy(X) @ (torch.from_numpy(W) - Q).T)
                           ** 2).sum())
    plain = rtn(torch.from_numpy(W), bits, g, layout="row")
    assert err(torch.from_numpy(got)) < err(plain)


def _hess(X):
    from repro_torch.core.gptq import _hessian
    return _hessian(torch.from_numpy(X)).numpy()


def test_gptq_registry_reference(ref):
    q = get_quantizer("gptq")
    W, X = _rng_w(9, (8, 32)), _rng_w(10, (40, 32))
    cfg = QuantConfig(bits=4, group_size=16)
    assert torch.equal(q.qdq_reference(torch.from_numpy(W),
                                       torch.from_numpy(X), cfg),
                       gptq_qdq(torch.from_numpy(W), torch.from_numpy(X),
                                cfg))


# ------------------------------------------------------------ the methods

def test_registry_lists_every_method():
    assert registered_methods() == ("awq", "gptq", "none", "rtn", "ttq")
    assert all(isinstance(get_quantizer(m), Quantizer)
               for m in registered_methods())
    assert not get_quantizer("rtn").requires_stats
    with pytest.raises(KeyError) as e:
        get_quantizer("spqr")
    assert "not yet ported" not in str(e.value)
    assert "registered" in str(e.value)


def _qts(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qts(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _qts(v, path + (i,))
    elif hasattr(tree, "scale") and hasattr(tree, "dinv"):
        yield ".".join(map(str, path)), tree


@pytest.mark.parametrize("method", ["rtn", "awq", "gptq"])
def test_method_trees_match_jax(ref, method):
    """``quantize_params`` with each method on the same weights and
    statistics: codes ±1 at ties (at most 2e-3 of them), D⁻¹ rtol 1e-6
    (exactly 1 for rtn), S and Z rtol 1e-5."""
    from repro.core import ttq_policy as jpol
    from repro.quant.api import quantize_params as jqp
    kw = dict(bits=4, group_size=32, rank=0)
    want = dict(_qts(jqp(ref["params"], ref["stats"],
                         jpol(**kw).with_(method=method),
                         count=ref["count"])))
    got = dict(_qts(quantize_params(ref["tparams"], ref["tstats"],
                                    ttq_policy(**kw).with_(method=method),
                                    count=ref["count"])))
    assert set(got) == set(want) and len(got) == 7
    for path, tq in got.items():
        jq = want[path]
        _codes_close(np.asarray(jq.wint), tq.wint.numpy())
        np.testing.assert_allclose(tq.dinv.numpy(), np.asarray(jq.dinv),
                                   rtol=1e-6)
        np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                                   rtol=1e-5)
        np.testing.assert_allclose(tq.zero.numpy(), np.asarray(jq.zero),
                                   rtol=1e-5, atol=1e-6)
        if method == "rtn":
            assert torch.equal(tq.dinv, torch.ones_like(tq.dinv))


def test_rtn_requantizes_without_statistics(ref):
    """RTN needs no statistics: a model requantizes before any calibration,
    fused and eager alike, with D = 1."""
    pol = ttq_policy(bits=4, group_size=32, rank=0).with_(method="rtn")
    for fused in (True, False):
        qm = QuantizedModel(ref["tparams"], pol, fused=fused)
        tree = qm.requantize()
        qts = dict(_qts(tree))
        assert len(qts) == 7 and all(torch.equal(q.dinv, torch.ones_like(
            q.dinv)) for q in qts.values())


# ------------------------------------------------- fused=False and fused

def test_eager_path_matches_the_fused_plan(ref):
    """``QuantizedModel(fused=False)`` (the per-leaf ``quantize_params``)
    against the fused plan on the same statistics: codes ±1 at ties, S and
    Z rtol 1e-6."""
    pol = ttq_policy(bits=4, group_size=32, rank=0)
    trees = []
    for fused in (False, True):
        qm = QuantizedModel(ref["tparams"], pol, fused=fused)
        qm.calibrate(ref["tstats"], ref["count"])
        trees.append(dict(_qts(qm.requantize())))
        assert qm.n_requants == 1 and qm.decode_params is not ref["tparams"]
    eager, fused = trees
    assert eager.keys() == fused.keys()
    for k in eager:
        _codes_close(eager[k].wint.numpy(), fused[k].wint.numpy())
        np.testing.assert_allclose(eager[k].scale.numpy(),
                                   fused[k].scale.numpy(), rtol=1e-6)
        np.testing.assert_allclose(eager[k].zero.numpy(),
                                   fused[k].zero.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_eager_path_refusals(ref):
    pol = ttq_policy(bits=4, group_size=32, rank=0)
    qm = QuantizedModel(ref["tparams"], pol, fused=False)
    qm.calibrate(ref["tstats"], ref["count"])
    with pytest.raises(ValueError, match="fused"):
        qm.requantize(threshold=0.1)
    with pytest.raises(ValueError, match="fused"):
        QuantizedModel(ref["tparams"], pol, fused=False,
                       draft_policy=pol.draft_variant())


# -------------------------------------------------- session and fork/join

def _stats(seed):
    g = torch.Generator().manual_seed(seed)
    return {"stack": [{"u0.mix.wq": torch.rand((2, 8), generator=g)}]}


def test_session_reset_snapshot_merge():
    a = CalibrationSession(halflife=2.0).update(_stats(0), 10)
    snap = a.snapshot()
    a.update(_stats(1), 6)                       # the snapshot is unchanged
    assert snap.count == 10 and snap.n_updates == 1
    assert torch.equal(snap.stats["stack"][0]["u0.mix.wq"],
                       _stats(0)["stack"][0]["u0.mix.wq"])
    b = CalibrationSession(halflife=2.0).update(_stats(2), 4)
    m = a.merge(b)
    assert m.count == a.count + 4 and m.n_updates == 3
    assert torch.equal(m.stats["stack"][0]["u0.mix.wq"],
                       a.stats["stack"][0]["u0.mix.wq"]
                       + b.stats["stack"][0]["u0.mix.wq"])
    assert CalibrationSession.fork is CalibrationSession.snapshot
    with pytest.raises(ValueError, match="halflives"):
        a.merge(CalibrationSession(halflife=0.0))
    # merging into an empty session copies, never aliases
    e = CalibrationSession(halflife=2.0).merge(b)
    assert e.stats["stack"][0]["u0.mix.wq"] is not \
        b.stats["stack"][0]["u0.mix.wq"]
    a.reset()
    assert not a.calibrated and a.count == 0 and a.n_updates == 0


def test_session_merge_matches_jax(ref):
    """Decayed sessions merged in both packages: the same statistics (one
    f32 rounding per operation, rtol 1e-6) and counts."""
    from repro.quant.session import CalibrationSession as JS
    jnp = ref["jax"].numpy
    js, jt = JS(halflife=3.0), JS(halflife=3.0)
    ts, tt = CalibrationSession(halflife=3.0), CalibrationSession(halflife=3.0)
    for i in range(3):
        s = _stats(i)
        (js if i < 2 else jt).update(
            {"stack": [{k: jnp.asarray(v.numpy()) for k, v in
                        s["stack"][0].items()}]}, 5 + i)
        (ts if i < 2 else tt).update(s, 5 + i)
    jm, tm = js.merge(jt), ts.merge(tt)
    assert (jm.count, jm.n_updates) == (tm.count, tm.n_updates)
    np.testing.assert_allclose(tm.stats["stack"][0]["u0.mix.wq"].numpy(),
                               np.asarray(jm.stats["stack"][0]["u0.mix.wq"]),
                               rtol=1e-6)


def test_fork_and_adopt(ref):
    """A fork shares params and factors with its own session; adopting its
    statistics gives the tree of one model calibrated on both streams."""
    pol = ttq_policy(bits=4, group_size=32, rank=4)
    parent = QuantizedModel(ref["tparams"], pol)
    child = parent.fork()
    assert child.params is parent.params
    assert child.lowrank_tree is parent.lowrank_tree
    assert child.session is not parent.session
    toks = np.random.default_rng(5).integers(0, 128, (1, 16))
    cfg = _tcfg()
    _, _, s2 = lm.prefill(cfg, ref["tparams"],
                          {"tokens": torch.from_numpy(toks)}, 20)
    parent.calibrate(ref["tstats"], ref["count"])
    child.calibrate(s2, 16.0)
    assert parent.session.count == ref["count"]     # streams independent
    parent.adopt(child.session)
    assert parent.session.count == ref["count"] + 16.0
    both = QuantizedModel(ref["tparams"], pol, lowrank=parent.lowrank_tree)
    both.calibrate(ref["tstats"], ref["count"]).calibrate(s2, 16.0)
    a, b = dict(_qts(parent.requantize())), dict(_qts(both.requantize()))
    for k in a:
        assert torch.equal(a[k].wint, b[k].wint)
        assert torch.equal(a[k].dinv, b[k].dinv)


def _tcfg():
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)


def test_quantized_tensor_fields(ref):
    qt = next(iter(dict(_qts(quantize_params(
        ref["tparams"], ref["tstats"], ttq_policy(bits=4, group_size=32,
                                                  rank=0, packed=True),
        count=ref["count"]))).values()))
    assert isinstance(qt, QuantizedTensor) and qt.packed is not None
    assert torch.equal(unpack_int4(qt.packed, qt.in_features),
                       unpack_int4(pack_int4(unpack_int4(
                           qt.packed, qt.in_features)), qt.in_features))
