"""The port's FusedRequantPlan against the JAX package's, for the packed
policy of tests/test_fused_path.py:114, on the CPU.  Both read the same
weights and the same prefill statistics (carried across as numpy)."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import KernelConfig, QuantizedTensor, unpack_bits
from repro_torch.core import ttq_policy as t_policy
from repro_torch.quant import FusedRequantPlan, QuantizedModel, quantize_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.core import QuantizedTensor as JQT
    from repro.core import ttq_policy
    from repro.models import ModelConfig, lm
    from repro.quant.api import FusedRequantPlan as JPlan
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab)
    _, _, stats = lm.prefill(cfg, params, {"tokens": toks}, max_len=20)
    count = float(toks.size)
    pol = ttq_policy(bits=4, group_size=32, rank=0, packed=True)
    fused = JPlan(params, stats, pol).run(params, stats, count)
    qts = {}

    def visit(path, leaf):
        if isinstance(leaf, JQT):
            qts[".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path)] = jax.tree.map(np.asarray, leaf)
    jax.tree_util.tree_map_with_path(
        visit, fused, is_leaf=lambda x: isinstance(x, JQT))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(params=params_from_jax(np_tree(params), device="cpu"),
                stats=params_from_jax(np_tree(stats), device="cpu"),
                count=count, qts=qts)


def _walk_qts(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_qts(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk_qts(v, path + (i,))
    elif isinstance(tree, QuantizedTensor):
        yield ".".join(map(str, path)), tree


def _check(jqt, tqt):
    assert tqt.wint is None and tqt.packed is not None
    assert (tqt.bits, tqt.group_size) == (int(jqt.bits), int(jqt.group_size))
    d = tqt.in_features
    cj = unpack_bits(torch.from_numpy(np.array(jqt.packed)), d, 4).numpy()
    ct = unpack_bits(tqt.packed, d, 4).numpy()
    # codes equal except ±1 at round-half ties, on at most 2e-3 of them
    assert np.abs(cj - ct).max() <= 1 and (cj != ct).mean() <= 2e-3
    # D from the same f32 statistics by two libraries: a few ulps
    np.testing.assert_allclose(tqt.dinv.numpy(), jqt.dinv, rtol=1e-6)
    np.testing.assert_allclose(tqt.scale.numpy(), jqt.scale, rtol=1e-5)
    np.testing.assert_allclose(tqt.zero.numpy(), jqt.zero, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_fused_plan_matches_jax(ref, use_kernel):
    pol = t_policy(bits=4, group_size=32, rank=0, packed=True,
                   kernel=KernelConfig(use_pallas=use_kernel))
    plan = FusedRequantPlan(ref["params"], ref["stats"], pol)
    # families: {wq,wk,wv}, {wo}, {wg,wu}, {wd} for this config
    assert plan.n_layers == 7 and len(plan.families) == 4
    tree = plan.run(ref["params"], ref["stats"], ref["count"])
    got = dict(_walk_qts(tree))
    assert set(got) == set(ref["qts"])
    for path, tqt in got.items():
        _check(ref["qts"][path], tqt)
    assert tree["embed"] is ref["params"]["embed"]   # fp leaves shared


def test_fused_plan_matches_eager_path(ref):
    pol = t_policy(bits=4, group_size=32, rank=0, packed=True)
    fused = dict(_walk_qts(FusedRequantPlan(ref["params"], ref["stats"], pol)
                           .run(ref["params"], ref["stats"], ref["count"])))
    eager = dict(_walk_qts(quantize_params(ref["params"], ref["stats"], pol,
                                           count=ref["count"])))
    assert set(fused) == set(eager)
    for k in fused:
        torch.testing.assert_close(fused[k].packed, eager[k].packed,
                                   rtol=0, atol=0)
        torch.testing.assert_close(fused[k].dinv, eager[k].dinv)


def test_quantized_model_lifecycle(ref):
    pol = t_policy(bits=8, group_size=32, rank=0, packed=True)
    qm = QuantizedModel(ref["params"], pol)
    assert qm.requantize() is None and qm.decode_params is ref["params"]
    qm.calibrate(ref["stats"], tokens=ref["count"])
    tree = qm.requantize()
    assert qm.n_requants == 1 and qm.decode_params is tree
    wq = tree["stack"][0]["u0"]["mix"]["wq"]
    assert wq.bits == 8 and wq.packed.shape == (2, 64, 16)
    # the delta gate: the same statistics again drift by 0, so every
    # family keeps its codes and the tree stays the one decode reads
    codes = wq.packed.clone()
    assert qm.requantize(threshold=0.1) is tree
    assert qm.last_requant_layers == 0 and qm.last_skipped_layers == 7
    assert torch.equal(wq.packed, codes) and qm.decode_params is tree


def test_plan_honours_per_layer_overrides(ref):
    """Mixed precision through ``override`` patterns: attention projections
    8-bit, the MLP at the 4-bit base — one family per (shape, settings)."""
    from repro_torch.core import override
    pol = t_policy(bits=4, group_size=32, rank=0, packed=True).with_overrides(
        override("*.mix.*", bits=8))
    assert pol.resolve("stack.0.u0.mix.wq").qcfg.bits == 8
    assert pol.resolve("stack.0.u0.mlp.wg").qcfg.bits == 4
    tree = FusedRequantPlan(ref["params"], ref["stats"], pol).run(
        ref["params"], ref["stats"], ref["count"])
    got = dict(_walk_qts(tree))
    assert {k: q.bits for k, q in got.items()} == {
        k: (8 if ".mix." in k else 4) for k in ref["qts"]}
    for q in got.values():                 # 32/bits codes per int32 word
        assert q.packed.shape[-1] == q.in_features * q.bits // 32
