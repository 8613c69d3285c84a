"""The delta gate and the double buffer in the port against the JAX package,
on the CPU, at the sizes of tests/test_fused_path.py (2 layers, d 64).

``FusedRequantPlan.drift`` is held to JAX's on the same statistics and the
same D snapshots (rtol 1e-5: f32 norms by two libraries); the gate's
decisions, the threshold's 0/∞ semantics, the domain-shift partial gate,
gated decode and the double buffer's swap are the reference's tests
(tests/test_fused_path.py:236-316) run on the port.  The double buffer's
own contract — two trees that share no written storage, a skipped family
carried into the written tree — is held against a single-buffered model
through the same sequence of requants.  On the CPU a written tree is ready
at once.  Inputs come from JAX's seeded generators, carried across as
numpy."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import QuantizedTensor
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.quant import FusedRequantPlan, QuantizedModel
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("wint", "packed", "scale", "zero", "dinv")


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ModelConfig, lm
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    toks_a = jax.random.randint(jax.random.PRNGKey(5), (2, 16), 0, cfg.vocab)
    toks_b = jnp.full((2, 16), 3, jnp.int32)    # a degenerate shifted domain
    stats = [lm.prefill(cfg, params, {"tokens": t}, max_len=20)[2]
             for t in (toks_a, toks_b)]
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(jax=jax, cfg=cfg, params=params, stats=stats,
                np_tree=np_tree,
                tparams=params_from_jax(np_tree(params), device="cpu"),
                tstats=[params_from_jax(np_tree(s), device="cpu")
                        for s in stats],
                tcfg=TCfg(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(TCfg)}))


def _qts(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif isinstance(t, QuantizedTensor):
            out[".".join(map(str, path))] = t
    walk(tree, ())
    return out


def _written(tree):
    return [getattr(q, f) for q in _qts(tree).values() for f in FIELDS
            if getattr(q, f) is not None]


def test_drift_matches_jax(ref):
    """Drift of the shifted stream's D from the first stream's snapshot:
    the port's plan on JAX's snapshots equals JAX's plan, and the port's own
    snapshots (1/dinv of its first requant) equal JAX's."""
    from repro.core import ttq_policy
    from repro.quant import QuantizedModel as JQM
    jqm = JQM(ref["params"], ttq_policy(bits=4, group_size=32, rank=0))
    jqm.calibrate(ref["stats"][0], 32.0)
    jqm.requantize()
    want = jqm._plan.drift(ref["stats"][1], 32.0, jqm._last_D)
    last_D = {k: torch.from_numpy(np.array(v)) for k, v in
              jqm._last_D.items()}
    pol = t_policy(bits=4, group_size=32, rank=0)
    plan = FusedRequantPlan(ref["tparams"], ref["tstats"][1], pol)
    got = plan.drift(ref["tstats"][1], 32.0, last_D)
    assert got.keys() == want.keys() and len(got) == 7
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=1e-5)
    assert min(got.values()) > 0.01           # a real shift, not noise
    tqm = QuantizedModel(ref["tparams"], pol)
    tqm.calibrate(ref["tstats"][0], 32.0)
    tqm.requantize()
    assert tqm._last_D.keys() == last_D.keys()
    for k, v in last_D.items():
        np.testing.assert_allclose(tqm._last_D[k].numpy(), v.numpy(),
                                   rtol=1e-5)
    assert plan.drift(ref["tstats"][1], 32.0, {}) == {}


def test_drift_gate_threshold_semantics(ref):
    """tests/test_fused_path.py:236: threshold 0 requantizes every layer,
    ∞ none (each path's QuantizedTensor kept, the tree still returned)."""
    qm = QuantizedModel(ref["tparams"], t_policy(bits=4, group_size=32,
                                                 rank=0))
    stats, count = ref["tstats"][0], 32.0
    qm.calibrate(stats, count)
    assert qm.requantize() is not None
    n_all = qm.last_requant_layers
    assert n_all == 7 and qm.last_skipped_layers == 0
    qm.calibrate(stats, count)
    qm.requantize(threshold=0.0)
    assert qm.last_requant_layers == n_all and qm.last_skipped_layers == 0
    before = dict(qm._qt_by_path)
    held = [t.clone() for t in _written(qm.qparams)]
    qm.calibrate(ref["tstats"][1], count)
    out = qm.requantize(threshold=float("inf"))
    assert qm.last_requant_layers == 0 and qm.last_skipped_layers == n_all
    assert all(qt is before[ps] for ps, qt in qm._qt_by_path.items())
    assert out is qm.qparams
    assert all(torch.equal(a, b) for a, b in zip(_written(out), held))
    assert (qm.total_requant_layers, qm.total_skipped_layers) == (14, 7)


def test_drift_gate_partial_on_domain_shift(ref):
    """tests/test_fused_path.py:259: a stable stream skips, a shifted one
    wakes the drifted families; each requant's counts equal JAX's."""
    from repro.core import ttq_policy
    from repro.quant import QuantizedModel as JQM
    jqm = JQM(ref["params"], ttq_policy(bits=4, group_size=32, rank=0),
              halflife=1.0)
    tqm = QuantizedModel(ref["tparams"], t_policy(bits=4, group_size=32,
                                                  rank=0), halflife=1.0)
    counts = []
    for i, thr in ((0, None), (0, 0.05), (1, 0.05)):
        for qm, st in ((jqm, ref["stats"]), (tqm, ref["tstats"])):
            qm.calibrate(st[i], 32.0)
            qm.requantize(threshold=thr)
        counts.append((tqm.last_requant_layers, tqm.last_skipped_layers))
        assert counts[-1] == (jqm.last_requant_layers,
                              jqm.last_skipped_layers)
    (_, _), (stable, _), (shifted, skipped) = counts
    assert shifted > stable and skipped < tqm._plan.n_layers


def test_gated_decode_matches_full(ref):
    """tests/test_fused_path.py:278: a gate-skipped tree still decodes the
    full requant's greedy tokens (the statistics do not move)."""
    outs = {}
    for thr in (-1.0, float("inf")):
        eng = TEngine(ref["tcfg"], ref["tparams"],
                      t_policy(bits=8, group_size=32, rank=0),
                      TEngineConfig(max_slots=1, max_len=48, guards=False,
                                    requant_threshold=thr), device="cpu")
        for p in ([5, 9, 17, 3], [8, 8, 1]):
            eng.submit(p, max_new=4)
        o = eng.run_all()
        outs[thr] = [o[r] for r in sorted(o)]
        if thr == float("inf"):
            assert eng.layers_skipped > 0
            assert eng.layers_requantized + eng.layers_skipped == \
                7 * eng.n_requants
    assert outs[-1.0] == outs[float("inf")]


def test_double_buffer_swap_semantics(ref):
    """tests/test_fused_path.py:296: without the double buffer the requant
    swaps at the call; with it the first tree serves at once, a later one
    is parked until ready (at once on the CPU), then swapped in."""
    pol = t_policy(bits=4, group_size=32, rank=0)
    stats, count = ref["tstats"][0], 32.0
    qm = QuantizedModel(ref["tparams"], pol)
    qm.calibrate(stats, count)
    qm.requantize()
    t2 = qm.requantize()
    assert qm.decode_params is t2 and qm._pending is None
    db = QuantizedModel(ref["tparams"], pol, double_buffer=True)
    db.calibrate(stats, count)
    b1 = db.requantize()
    assert db.decode_params is b1
    b2 = db.requantize()
    assert db._pending is b2 and db.qparams is b1 and b2 is not b1
    assert db.decode_params is b2 and db._pending is None
    b3 = db.requantize()                      # the spare: b1's storage
    assert b3 is b1 and db.decode_params is b1


def test_double_buffer_trees_equal_single_buffer(ref):
    """Through a sequence of full and gated requants on shifting statistics,
    the double buffer's written tree holds, field for field, what the
    single-buffered model's tree holds (a skipped family's newest codes are
    carried into the tree being written), while its two trees share no
    written storage and the tree decode reads never changes under a
    requant."""
    pol = t_policy(bits=4, group_size=32, rank=8, packed=True)
    one = QuantizedModel(ref["tparams"], pol)
    two = QuantizedModel(ref["tparams"], pol, lowrank=one.lowrank_tree,
                         double_buffer=True)
    seq = [(0, None), (1, None), (0, 0.05), (1, 0.3), (1, 0.05), (0, 1e9),
           (1, 0.0)]
    skipped = 0
    for i, thr in seq:
        for qm in (one, two):
            qm.calibrate(ref["tstats"][i], 32.0)
        serving = two.decode_params
        held = [t.clone() for t in _written(serving)] \
            if serving is not two.params else []
        one.requantize(threshold=thr)
        b = two.requantize(threshold=thr)
        assert (one.last_requant_layers, one.last_skipped_layers) == \
            (two.last_requant_layers, two.last_skipped_layers)
        skipped += one.last_skipped_layers
        assert all(torch.equal(x, y) for x, y in zip(_written(serving),
                                                     held))
        assert all(torch.equal(x, y) for x, y in zip(_written(b),
                                                     _written(one.qparams)))
        if serving is not two.params:
            assert b is not serving
            assert not {t.data_ptr() for t in _written(b)} & \
                {t.data_ptr() for t in _written(serving)}
    assert skipped > 0 and one.last_requant_layers == 7
    assert two.decode_params is b


def test_engine_double_buffer_equals_single_on_the_cpu(ref):
    """On the CPU the pending tree is ready at once and swaps in at the next
    block, where the single buffer decodes its new tree: the same tokens,
    with the gate on or off."""
    outs = []
    for db in (False, True):
        for thr in (-1.0, 0.05):
            eng = TEngine(ref["tcfg"], ref["tparams"],
                          t_policy(bits=4, group_size=32, rank=8,
                                   packed=True),
                          TEngineConfig(max_slots=1, max_len=48,
                                        decode_chunk=2, guards=False,
                                        double_buffer=db,
                                        requant_threshold=thr),
                          device="cpu")
            rids = [eng.submit(p, max_new=6) for p in
                    ([5, 9, 17, 3], [8, 8, 1], [3] * 9, [100, 50, 25, 12])]
            o = eng.run_all()
            outs.append([list(o[r]) for r in rids])
            assert eng.n_requants == 4
    assert all(o == outs[0] for o in outs[2:]) and outs[1] == outs[3]
