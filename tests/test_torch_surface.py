"""The port's public surface against the JAX package's, on the CPU:
``serving.sample``, the serving exports (``BlockAllocator``,
``DeviceRunner``), ``core.calibrate`` and ``core.qdq``; the engine's
facade properties, ``QuantPolicy.per_expert_stats`` and the KV helpers;
and every public name of every reference module, which must have a
counterpart in the port unless the allow-list names the documented
difference (ROADMAP §C, or README's "The analysis tools") that replaces
it.
Inputs come from numpy with a seed."""
import importlib
import inspect
import pathlib

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.core import AWQConfig as TAWQ
from repro_torch.core import QuantConfig as TQC
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore
    import repro.serving as jserving
    return dict(jax=jax, jnp=jnp, core=jcore, serving=jserving)


def test_serving_exports_cover_the_reference(jx):
    """Every name the reference's ``repro.serving`` exports, the port's
    exports too, and the classes are the port's own modules'."""
    assert set(jx["serving"].__all__) <= set(tserving.__all__)
    from repro_torch.serving.blocks import BlockAllocator
    from repro_torch.serving.runner import DeviceRunner
    assert tserving.BlockAllocator is BlockAllocator
    assert tserving.DeviceRunner is DeviceRunner


def test_block_allocator_export_matches_jax(jx):
    """The exported allocator: a seeded allocate / free_request sequence
    gives the reference's blocks or its MemoryError at every call
    (tests/test_torch_paged.py holds the whole state after each call)."""
    ta = tserving.BlockAllocator(12, 4)
    ja = jx["serving"].BlockAllocator(12, 4)
    rng = np.random.default_rng(0)
    live = []
    for _ in range(60):
        if rng.integers(0, 2) == 0 or not live:
            prompt = rng.integers(0, 50, int(rng.integers(1, 12))).tolist()
            res = []
            for a in (ta, ja):
                try:
                    res.append(a.allocate(prompt, 4, 32))
                except MemoryError:
                    res.append("MemoryError")
            assert res[0] == res[1]
            if res[0] != "MemoryError":
                live.append(res[0][0])
        else:
            blocks = live.pop(int(rng.integers(0, len(live))))
            ta.free_request(blocks)
            ja.free_request(blocks)
        assert sorted(ta.free) == sorted(ja.free)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_sample_matches_jax(jx, temperature):
    """Greedy: the reference's argmax exactly.  Temperature > 0: the two
    frameworks draw different random numbers, so the draw is held to its
    form — int32 tokens in the vocabulary, one per row, reproducible from
    the generator's seed — and to the greedy token as the temperature goes
    to 0."""
    logits = np.random.default_rng(1).standard_normal((5, 97)) \
        .astype(np.float32)
    if temperature == 0.0:
        want = np.asarray(jx["serving"].sample(jx["jnp"].asarray(logits)))
        got = tserving.sample(torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
        return
    draw = lambda s, t: tserving.sample(  # noqa: E731
        torch.from_numpy(logits), torch.Generator().manual_seed(s), t)
    a, b = draw(3, temperature), draw(3, temperature)
    assert a.dtype == torch.int32 and a.shape == (5,)
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 97)).all())
    np.testing.assert_array_equal(draw(4, 1e-6).numpy(),
                                  logits.argmax(axis=-1))


@pytest.mark.parametrize("form", ["blend", "raw"])
def test_calibrate_matches_jax(jx, form):
    """A stats tree (a run list of dicts of (L, d) Σx² leaves, with a None
    leaf) and its counts → the D tree, within f32 rounding."""
    rng = np.random.default_rng(2)
    stats = {"stack": [{"u0.mix.wq": rng.random((2, 16)).astype(np.float32)
                        * 50,
                        "u0.mlp.w1": rng.random((2, 24)).astype(np.float32)
                        * 50}],
             "enc": None}
    counts = {"stack": [{"u0.mix.wq": 32.0, "u0.mlp.w1": 32.0}], "enc": None}
    acfg_j = jx["core"].AWQConfig(form=form)
    dj = jx["core"].calibrate(
        jx["jax"].tree.map(jx["jnp"].asarray, stats), counts, acfg_j)
    tstats = {"stack": [{k: torch.from_numpy(v)
                         for k, v in stats["stack"][0].items()}], "enc": None}
    dt = tcore.calibrate(tstats, counts, TAWQ(form=form))
    assert dt["enc"] is None
    for k, v in dt["stack"][0].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(dj["stack"][0][k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("bits,g", [(4, 32), (8, 64), (3, 16)])
def test_qdq_matches_jax(jx, bits, g):
    """``core.qdq``: the reference's fake-quant, equal except one step at a
    round-half tie (an f32 reassociation flips it) on at most 2e-3 of the
    values."""
    W = np.random.default_rng(3).standard_normal((32, 128)).astype(np.float32)
    cfg_j = jx["core"].QuantConfig(bits=bits, group_size=g)
    wj = np.asarray(jx["core"].qdq(jx["jnp"].asarray(W), cfg_j))
    wt = tcore.qdq(torch.from_numpy(W), TQC(bits=bits, group_size=g)).numpy()
    diff = np.abs(wj - wt)
    step = (W.reshape(32, -1, g).max(-1) - W.reshape(32, -1, g).min(-1)) \
        / (2 ** bits - 1)
    assert (diff <= np.repeat(step, g, axis=1) * 1.001 + 1e-6).all()
    assert (diff > 1e-6).mean() <= 2e-3


# ------------------------------------------------- every reference module

_SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF_MODULES = sorted(
    ".".join(p.relative_to(_SRC).with_suffix("").parts[:-1]
             if p.name == "__init__.py"
             else p.relative_to(_SRC).with_suffix("").parts)
    for p in (_SRC / "repro").rglob("*.py"))

# what has no counterpart: the documented differences of ROADMAP §C and
# of README's "The analysis tools" (the reference's HLO walkers and its
# TPU pod's mesh); nothing else
_HLO = "README, The analysis tools: walks XLA HLO"
QUEUED_MODULES = {
    "repro.launch.analysis": _HLO, "repro.launch.dryrun": _HLO,
    "repro.launch.reanalyze": _HLO, "repro.launch.steps": _HLO,
    "repro.parallel.compat": "§C: shard_map has no PyTorch counterpart",
}
QUEUED_NAMES = {
    "repro.launch.mesh": {"make_production_mesh":
                          "README, The analysis tools: a TPU pod's mesh"},
    "repro.models.common": {"opt_level": "§C: one attention path"},
    "repro.parallel": {"shard_map": "§C: no PyTorch counterpart"},
    "repro.quant.guards": {"compiled_programs": "§C: eager guards"},
}


def _public(mod):
    """A module's public surface: its ``__all__``, else the functions and
    classes it defines."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [k for k, v in vars(mod).items() if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__]


@pytest.mark.parametrize("name", REF_MODULES)
def test_reference_module_has_a_counterpart(jx, name):
    """``repro.X`` → ``repro_torch.X`` with every public name, or the
    name (module) is on the allow-list; an allow-listed name that the port
    now has must leave the list."""
    ref = importlib.import_module(name)
    port_name = "repro_torch" + name[len("repro"):]
    if name in QUEUED_MODULES:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(port_name)
        return
    port = importlib.import_module(port_name)
    queued = QUEUED_NAMES.get(name, {})
    missing = [k for k in _public(ref) if not hasattr(port, k)]
    assert sorted(missing) == sorted(queued), (name, missing)


# ------------------------------------ the engine's facade (ROADMAP C5)

def test_engine_facade_matches_jax(jx):
    """Every ``ENGINE_ATTRS`` name (``tools/tracecheck/serving.py``) is on
    the port's engine; after one shared workload (three prompts, two
    slots, one admission round) the eight facade properties over the
    session, scheduler and runner hold the JAX engine's values: the
    statistics within 5% (the two frameworks' bf16 activations differ by
    an ulp here and there, ~4% at most measured on this workload), the
    rest exactly."""
    import sys
    sys.path.insert(0, str(_SRC.parent))
    from tools.tracecheck.serving import ENGINE_ATTRS
    from repro.core import NO_QUANT as JNQ
    from repro.models import ModelConfig, lm
    from repro.serving import EngineConfig, TTQEngine
    from repro_torch.bridge import params_from_jax
    from repro_torch.core import NO_QUANT
    from repro_torch.models.config import ModelConfig as TCfg
    jax = jx["jax"]
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    prompts = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12]]
    ecfg = dict(max_slots=2, max_len=32, decode_chunk=2)
    je = TTQEngine(cfg, params, JNQ, EngineConfig(**ecfg))
    te = tserving.TTQEngine(
        TCfg(**{f: getattr(cfg, f) for f in TCfg.__dataclass_fields__}),
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu"),
        NO_QUANT, tserving.EngineConfig(**ecfg), device="cpu")
    assert [a for a in ENGINE_ATTRS if not hasattr(te, a)] == []
    for e in (je, te):
        for p in prompts:
            e.submit(p, max_new=4)
        e.admit()
    assert te.stat_count == je.stat_count
    assert te.admits_since_cal == je.admits_since_cal
    assert [r.rid for r in te.queue] == [r.rid for r in je.queue]
    assert [None if r is None else r.rid for r in te.slot_req] == \
        [None if r is None else r.rid for r in je.slot_req]
    assert sorted(te.finished) == sorted(je.finished)
    np.testing.assert_array_equal(te.pos.numpy(), np.asarray(je.pos))
    np.testing.assert_array_equal(te.cur_tok.numpy(), np.asarray(je.cur_tok))
    for a, b in zip(jax.tree.leaves(je.agg_stats),
                    [t for _, t in _walk_stats(te.agg_stats)]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-2,
                                   atol=1e-3)


def _walk_stats(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_stats(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_stats(v, path + (i,))
    elif tree is not None:
        yield path, tree


# -------------------------------- policy and KV helpers (ROADMAP C6, C7)

def test_policy_per_expert_stats_is_accepted():
    """The reference's field (default True) and its override."""
    from repro_torch.core import QuantPolicy, override
    assert QuantPolicy().per_expert_stats is True
    pol = QuantPolicy(per_expert_stats=False)
    assert pol.per_expert_stats is False
    o = override("*", per_expert_stats=False)
    assert QuantPolicy(overrides=(o,)).resolve("stack.0.u0.mlp.wg") \
        .per_expert_stats is False


@pytest.mark.parametrize("dtype,g", [("bf16", 0), ("int8", 0), ("int8", 32),
                                     ("int4", 0), ("int4", 16)])
def test_kv_bytes_per_token_head_matches_jax(jx, dtype, g):
    from repro.core import KVCacheConfig as JKV
    from repro_torch.core import KVCacheConfig as TKV
    for hd in (64, 128, 256):
        assert TKV(dtype=dtype, group_size=g).bytes_per_token_head(hd) == \
            JKV(dtype=dtype, group_size=g).bytes_per_token_head(hd)


@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_decode_attention_q8_matches_jax(jx, soft_cap):
    """The seed's int8 read, from seeded numpy codes and scales."""
    from repro.core.kvquant import decode_attention_q8 as jread
    from repro_torch.core.kvquant import decode_attention_q8 as tread
    rng = np.random.default_rng(4)
    B, H, Hkv, S, Dh = 2, 4, 2, 24, 32
    q = rng.standard_normal((B, H, 1, Dh)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (B, Hkv, S, Dh)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.random((B, Hkv, S, 1)).astype(np.float32) * 0.02
              for _ in range(2))
    pos = np.asarray([7, 23], np.int32)
    jnp = jx["jnp"]
    want = np.asarray(jread(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                            jnp.asarray(vq), jnp.asarray(vs),
                            jnp.asarray(pos), soft_cap=soft_cap))
    got = tread(*(torch.from_numpy(a) for a in (q, kq, ks, vq, vs, pos)),
                soft_cap=soft_cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
