"""The port's model against the JAX package's, weights carried across by
``params_from_jax``: prefill logits and the whole stats tree, and
``decode_step`` logits on a bridged quantized tree for each KV layout.

Tolerances: both sides keep bf16 activations and round them at slightly
different places (one bf16 ulp is 2^-8 ≈ 0.4% relative), so elementwise
checks use the bf16-residual precedent of tests/test_fused_path.py:103
(rtol 1e-1, atol 5e-2); the relative L2 error over a whole tensor is held
to 3e-2, three times the ~1e-2 measured on these configs."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import KernelConfig
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TCfg
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 3e-2


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get
    from repro.core import KVCacheConfig, quantize_params, ttq_policy
    from repro.models import ModelConfig, lm
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    return dict(jax=jax, jnp=jnp, lm=lm, KV=KVCacheConfig, qp=quantize_params,
                pol=ttq_policy, cfgs={"gqa": cfg,
                                      "gemma_smoke": get("gemma_7b", smoke=True)})


def _tcfg(jcfg):
    return TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TCfg)})


def _np_tree(jx, tree):
    return jx["jax"].tree.map(np.asarray, tree)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


@pytest.fixture(scope="module", params=["gqa", "gemma_smoke"])
def setup(jx, request):
    jcfg = jx["cfgs"][request.param]
    jp = jx["lm"].init_params(jcfg, jx["jax"].random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jx, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16)) \
        .astype(np.int32)
    pre = jx["lm"].prefill(jcfg, jp, {"tokens": jx["jnp"].asarray(toks)},
                           max_len=24)
    return jcfg, _tcfg(jcfg), jp, tp, toks, pre


def test_prefill_logits_and_stats_match_jax(jx, setup):
    jcfg, tcfg, jp, tp, toks, (lj, _, stj) = setup
    lt, _, stt = tlm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, 24)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1, atol=5e-2)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    sj, st = stj["stack"][0], stt["stack"][0]
    assert set(sj) == set(st) == {"u0.mix.wq", "u0.mix.wo", "u0.mlp.wg",
                                  "u0.mlp.wd"}
    for k in sj:
        a, b = np.asarray(sj[k]), st[k].numpy()
        assert a.shape == b.shape
        # Σx² over bf16 activations: elementwise within the bf16 precedent
        # relative to the leaf's scale, and REL_L2 over the whole leaf
        np.testing.assert_allclose(b, a, rtol=1e-1, atol=1e-2 * np.abs(a).max())
        assert _rel_l2(a, b) < REL_L2, k


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_decode_step_on_quantized_tree_matches_jax(jx, setup, kv_dtype):
    jcfg, tcfg, jp, tp, toks, (_, _, stats) = setup
    jnp = jx["jnp"]
    pol = jx["pol"](bits=4, group_size=32, rank=0, packed=True,
                    kvcache=jx["KV"](dtype=kv_dtype))
    qp = jx["qp"](jp, stats, pol, count=float(toks.size))
    _, jstate, _ = jx["lm"].prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                    max_len=24, kvcfg=pol.kvcache)
    tq = params_from_jax(_np_tree(jx, qp), device="cpu")
    tstate = params_from_jax(_np_tree(jx, jstate), device="cpu")
    tok = np.array([[7], [11]], np.int32)
    pos = np.array([16, 16], np.int32)
    lj, _ = jx["lm"].decode_step(jcfg, qp, jstate, jnp.asarray(tok),
                                 jnp.asarray(pos), kvcfg=pol.kvcache)
    lt, _ = tlm.decode_step(tcfg, tq, tstate, torch.from_numpy(tok),
                            torch.from_numpy(pos), kvcfg=TKV(dtype=kv_dtype),
                            kcfg=KernelConfig(use_pallas=True))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1, atol=5e-2)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
