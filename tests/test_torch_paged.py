"""The port's paged KV serving against the JAX package's, on the CPU.

* paged decode attention: the port's plain version against the JAX
  ``ttq_paged_decode_attention`` (Pallas in interpret mode, as
  tests/test_paged.py runs it), and the gather against the contiguous cache;
* the block allocator: the cases of tests/test_paged.py on the port's
  ``serving/blocks.py``, and one seeded call sequence through both
  allocators with their state equal after every call;
* the port's engine alone (``NO_QUANT``, plain versions): the exact token
  equalities of tests/test_paged.py — paged ⇔ dense, preemption, prefix
  cache, cancel;
* the port's paged engine against the JAX paged engine on bridged weights
  (int4 TTQ weights, int8/int4 KV), and the paged scheduler's telemetry
  under pool pressure and prefix sharing against the JAX engine's.

Inputs come from numpy with a seed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import NO_QUANT as T_NO_QUANT
from repro_torch.core import KernelConfig
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.core.kvquant import quantize_kv as t_quantize_kv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm
from repro_torch.models import stack as tstack
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from repro_torch.serving.blocks import SINK, BlockAllocator, chain_hashes
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = TCfg(name="paged-t", family="dense", n_layers=3, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=96, vocab=128)
PROMPTS = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12, 6, 3], [7, 7, 7, 2]]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import KVCacheConfig, NO_QUANT, ttq_policy
    from repro.core.kvquant import quantize_kv
    from repro.kernels import kv_paged_decode_attention
    from repro.models import ModelConfig, lm
    from repro.serving import EngineConfig, TTQEngine
    from repro.serving import blocks
    return dict(jax=jax, jnp=jnp, KV=KVCacheConfig, NO_QUANT=NO_QUANT,
                pol=ttq_policy, quantize_kv=quantize_kv,
                paged_attn=kv_paged_decode_attention, MCfg=ModelConfig, lm=lm,
                ECfg=EngineConfig, Eng=TTQEngine, blocks=blocks)


# ---------------------------------------------------------- paged attention

def _pools(seed, NB, Hkv, bs, Dh, B, H):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((NB, Hkv, bs, Dh)).astype("float32")
    pv = rng.standard_normal((NB, Hkv, bs, Dh)).astype("float32")
    q = rng.standard_normal((B, H, 1, Dh)).astype("float32")
    return pk, pv, q, rng


@pytest.mark.parametrize("bits,group_size", [(8, 0), (8, 16), (4, 0), (4, 16)])
def test_paged_attention_plain_matches_jax(jx, bits, group_size):
    """The port's plain paged attention against the JAX Pallas kernel
    (interpret mode) over a scrambled block table whose unowned entries
    point at the sink."""
    B, Hkv, H, Dh, bs, NB = 2, 2, 4, 32, 16, 9
    pk, pv, q, rng = _pools(3, NB, Hkv, bs, Dh, B, H)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = np.asarray([[perm[0], perm[1], perm[2], SINK],
                     [perm[3], perm[4], perm[5], perm[6]]], np.int32)
    pos = np.asarray([41, 60], np.int32)
    jnp = jx["jnp"]
    kq, ks = jx["quantize_kv"](jnp.asarray(pk), bits=bits,
                               group_size=group_size)
    vq, vs = jx["quantize_kv"](jnp.asarray(pv), bits=bits,
                               group_size=group_size)
    o_j = jx["paged_attn"](jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(bt),
                           jnp.asarray(pos), bits=bits, group_size=group_size)
    t = lambda a: torch.from_numpy(np.array(a))
    tkq, tks = t_quantize_kv(torch.from_numpy(pk), bits=bits,
                             group_size=group_size)
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(kq))
    o_t = tops.kv_paged_decode_attention(
        torch.from_numpy(q), t(kq), t(ks), t(vq), t(vs), torch.from_numpy(bt),
        torch.from_numpy(pos), bits=bits, group_size=group_size)
    # f32 softmax over the same dequantized values: tests/test_paged.py's 1e-5
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)


def test_paged_gather_equals_contiguous():
    """A block table laid out 0..n gathers back the contiguous cache, and
    the paged plain version equals the contiguous one on it (1e-6, as
    tests/test_paged.py:78)."""
    B, Hkv, S, Dh, bs, H = 2, 2, 64, 16, 16, 4
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.standard_normal((B, Hkv, S, Dh)).astype("float32"))
    pool = k.reshape(B, Hkv, S // bs, bs, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(B * (S // bs), Hkv, bs, Dh)
    bt = torch.arange(B * (S // bs), dtype=torch.int32).reshape(B, S // bs)
    assert torch.equal(tref.gather_paged_kv(pool, bt), k)
    kq, ks = t_quantize_kv(k)
    vq, vs = t_quantize_kv(k * 0.5)
    pq, ps = t_quantize_kv(pool)
    pvq, pvs = t_quantize_kv(pool * 0.5)
    q = torch.from_numpy(rng.standard_normal((B, H, 1, Dh)).astype("float32"))
    pos = torch.tensor([40, 63], dtype=torch.int32)
    o_c = tref.kv_attn_ref(q, kq, ks, vq, vs, pos)
    o_p = tref.kv_paged_attn_ref(q, pq, ps, pvq, pvs, bt, pos)
    torch.testing.assert_close(o_p, o_c, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- allocator

def test_allocator_prefix_trie_walk_hand_computed():
    a = BlockAllocator(num_blocks=32, block_size=4)
    p1 = list(range(100, 113))          # 13 tokens → 3 shareable blocks
    b1, pfx1 = a.allocate(p1, max_new=4, max_len=64)
    assert pfx1 == 0 and len(b1) == 5   # ceil((13+4)/4)
    assert (a.prefix_hits, a.prefix_misses) == (0, 3)
    p2 = p1[:8] + [1, 2, 3, 4, 5]       # diverges in block 2
    b2, pfx2 = a.allocate(p2, max_new=4, max_len=64)
    assert pfx2 == 8 and b2[:2] == b1[:2] and b2[2] != b1[2]
    assert (a.prefix_hits, a.prefix_misses) == (2, 4)
    assert a.ref[b1[0]] == 2
    p3 = [0] + p1[:7]                   # same content, shifted: no hit
    b3, pfx3 = a.allocate(p3, max_new=1, max_len=64)
    assert pfx3 == 0
    assert (a.prefix_hits, a.prefix_misses) == (2, 5)
    for b in (b1, b2, b3):
        a.free_request(b)
    a.assert_quiescent()


def test_allocator_cached_blocks_survive_owner():
    a = BlockAllocator(num_blocks=16, block_size=4)
    p = list(range(1, 10))              # 9 tokens → 2 shareable blocks
    b1, _ = a.allocate(p, max_new=2, max_len=64)
    a.free_request(b1)
    assert not a.ref and len(a.cached) == 2
    b2, pfx = a.allocate(p, max_new=2, max_len=64)
    assert pfx == 8 and b2[:2] == b1[:2]
    a.free_request(b2)
    a.assert_quiescent()


def test_allocator_exhaustion_is_atomic():
    a = BlockAllocator(num_blocks=6, block_size=4)      # 5 allocatable
    p = list(range(1, 13))                              # 3 blocks, 2 shareable
    b1, _ = a.allocate(p, max_new=0, max_len=64)
    a.free_request(b1)                                  # 2 cached + 3 free
    b2, _ = a.allocate(p[:8], max_new=4, max_len=64)    # revives 1 + takes 2
    with pytest.raises(MemoryError):
        a.allocate(list(range(50, 62)), max_new=8, max_len=64)
    hits, misses = a.prefix_hits, a.prefix_misses
    with pytest.raises(MemoryError):
        a.allocate(list(range(50, 62)), max_new=8, max_len=64)
    assert (a.prefix_hits, a.prefix_misses) == (hits, misses)
    a.free_request(b2)
    a.assert_quiescent()


def test_allocator_reregistration_keeps_trie_consistent():
    a = BlockAllocator(num_blocks=10, block_size=4)     # 9 allocatable
    p = list(range(1, 10))                              # 2 shareable blocks
    b1, _ = a.allocate(p, max_new=0, max_len=64)
    a.free_request(b1)
    b2, _ = a.allocate([91, 92, 93, 94], max_new=28, max_len=64)
    assert b1[0] in b2 and b1[1] not in b2              # old h1 block cached
    a.free_request(b2)
    b3, pfx = a.allocate(p, max_new=0, max_len=64)
    assert pfx == 0
    b4, _ = a.allocate([81, 82, 83, 84], max_new=20, max_len=64)
    a.free_request(b3)
    a.free_request(b4)
    b5, _ = a.allocate([71, 72, 73, 74], max_new=32, max_len=64)
    a.free_request(b5)
    assert set(a.trie.values()) == set(a.block_hash)
    a.assert_quiescent()


def test_chain_hash_positional():
    h1 = chain_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4, 2)
    h2 = chain_hashes([1, 2, 3, 4, 9, 9, 9, 9], 4, 2)
    assert h1[0] == h2[0] and h1[1] != h2[1]


def _alloc_state(a):
    return (list(a.free), dict(a.ref), dict(a.trie), dict(a.block_hash),
            list(a.cached), a.prefix_hits, a.prefix_misses, a.peak_in_use)


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_allocator_matches_jax_on_a_seeded_sequence(jx, prefix_cache):
    """400 seeded allocate / free_request calls through
    the port's and the JAX allocator: the same result or the same
    MemoryError for each call, and equal free lists, refcounts, trie,
    cached LRU order and hit counts after each call."""
    rng = np.random.default_rng(11)
    heads = [rng.integers(0, 50, 12).tolist() for _ in range(3)]
    ta = BlockAllocator(24, 4, prefix_cache=prefix_cache)
    ja = jx["blocks"].BlockAllocator(24, 4, prefix_cache=prefix_cache)
    live = []
    raised = 0
    for _ in range(400):
        if rng.integers(0, 2) == 0 or not live:
            head = heads[rng.integers(0, 3)][:int(rng.integers(0, 13))]
            prompt = head + rng.integers(0, 50, int(rng.integers(1, 9))).tolist()
            max_new = int(rng.integers(0, 12))
            res = []
            for a in (ta, ja):
                try:
                    res.append(a.allocate(prompt, max_new, 64))
                except MemoryError:
                    res.append("MemoryError")
            assert res[0] == res[1]
            if res[0] == "MemoryError":
                raised += 1
            else:
                live.append((prompt, res[0][0]))
        else:
            prompt, blocks = live.pop(rng.integers(0, len(live)))
            ta.free_request(blocks)
            ja.free_request(blocks)
        assert _alloc_state(ta) == _alloc_state(ja)
    assert raised > 0
    assert (ta.prefix_hits > 0) == prefix_cache
    for _, blocks in live:
        ta.free_request(blocks)
    ta.assert_quiescent()


# ------------------------------------------------ the port's engine, alone

@pytest.fixture(scope="module")
def params():
    return tlm.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _engine(params, kv_dtype="bf16", paged=True, slots=2, **kw):
    pol = T_NO_QUANT.with_(kvcache=TKV(dtype=kv_dtype, paged=paged))
    return TEngine(CFG, params, pol,
                   TECfg(max_slots=slots, max_len=64, guards=False, **kw),
                   device="cpu")


def _run(eng, prompts=PROMPTS, max_new=8):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    outs = eng.run_all()
    return [outs[r] for r in rids]


_DENSE = {}


def _dense(params, kv_dtype):
    if kv_dtype not in _DENSE:
        _DENSE[kv_dtype] = _run(_engine(params, kv_dtype, paged=False))
    return _DENSE[kv_dtype]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_engine_paged_matches_dense(params, kv_dtype):
    assert _run(_engine(params, kv_dtype)) == _dense(params, kv_dtype)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_preemption_requeue_matches_unconstrained(params, kv_dtype):
    """A pool too small for the traffic preempts (evict + requeue) instead
    of failing, and the greedy outputs still equal the dense run's."""
    eng = _engine(params, kv_dtype, kv_block_size=4, kv_pool_blocks=7)
    assert _run(eng) == _dense(params, kv_dtype)
    assert eng.preemptions > 0
    assert eng.kv_pool_utilization == 1.0
    eng.allocator.assert_quiescent()


def test_paged_pool_and_block_table_layout(params):
    eng = _engine(params, "int4")
    _run(eng, prompts=[PROMPTS[0]], max_new=3)
    st = eng.state["stack"][0]["u0"]
    NB, bs = eng.num_blocks, eng.kvcfg.block_size
    assert NB == 2 * 64 // bs + 1
    assert st["k_q"].shape == (CFG.n_layers, NB, CFG.n_kv_heads, bs,
                               CFG.hd // 8)
    assert st["k_q"].dtype == torch.int32
    assert st["k_s"].shape == (CFG.n_layers, NB, CFG.n_kv_heads, bs, 1)
    bt = eng.state["block_table"]
    assert bt.shape == (2, 64 // bs) and bt.dtype == torch.int32
    assert (bt == SINK).all()               # finished slots point at the sink


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefix_cache_outputs_unchanged(params, kv_dtype):
    sysp = list(range(1, 21))               # 20 tokens → 1 shareable block
    ps = [sysp + [40, 41], sysp + [50, 51, 52]]
    cold_eng = _engine(params, kv_dtype, prefix_cache=False)
    cold = _run(cold_eng, prompts=ps, max_new=6)
    assert cold_eng.prefix_hit_rate == 0.0
    warm_eng = _engine(params, kv_dtype)
    warm = _run(warm_eng, prompts=ps, max_new=6)
    assert warm == cold
    assert warm_eng.prefix_hit_rate > 0
    assert warm_eng.prefill_tokens < cold_eng.prefill_tokens
    warm_eng.allocator.assert_quiescent()


def test_same_round_prefix_hit_reads_written_blocks(params):
    """In one admission round D (an old cached prefix) makes group (16, 32)
    first, A registers fresh blocks, and B's walk hits A's blocks and joins
    D's earlier group: groups must dispatch in ascending prefix_len, or B
    gathers A's still-empty blocks (tests/test_paged.py:268)."""
    sysD, sysA = list(range(1, 33)), list(range(60, 92))
    eng = _engine(params, "bf16", slots=3)
    eng.submit(sysD + [40, 41], max_new=4)
    eng.run_all()
    reqs = [sysD + [42, 43], sysA + [50, 51], sysA + [52, 53]]
    rids = [eng.submit(p, max_new=5) for p in reqs]
    outs = eng.run_all()
    cold = _engine(params, "bf16", slots=3, prefix_cache=False)
    cold.submit(sysD + [40, 41], max_new=4)
    cold.run_all()
    crids = [cold.submit(p, max_new=5) for p in reqs]
    couts = cold.run_all()
    assert [outs[r] for r in rids] == [couts[r] for r in crids]
    assert eng.allocator.prefix_hits == 4       # D: 2 old + B: 2 same-round
    eng.allocator.assert_quiescent()


def test_prefix_hits_across_request_lifetimes(params):
    sysp = list(range(1, 33))
    eng = _engine(params, "bf16", slots=1)
    r1 = eng.submit(sysp + [40], max_new=3)
    assert not eng.run_all()[r1].unfinished
    eng.submit(sysp + [50, 51], max_new=3)
    eng.run_all()
    assert eng.allocator.prefix_hits == 2   # the two sysp blocks, from cache
    eng.allocator.assert_quiescent()


def test_cancel_queued_and_running(params):
    eng = _engine(params, "bf16")
    r1 = eng.submit(PROMPTS[0], max_new=20)
    r2 = eng.submit(PROMPTS[1], max_new=20)
    r3 = eng.submit(PROMPTS[3], max_new=5)      # queued behind 2 slots
    for _ in range(2):
        eng.step()
    assert eng.cancel(r3)
    assert eng.cancel(r1)
    outs = eng.run_all()
    assert outs[r1].cancelled and outs[r1].unfinished
    assert outs[r3].cancelled and len(outs[r3]) == 0
    assert not outs[r2].cancelled and len(outs[r2]) == 20
    assert not eng.cancel(r1)
    assert not eng.cancel(9999)
    eng.allocator.assert_quiescent()


def test_cancel_dense_engine(params):
    eng = _engine(params, "bf16", paged=False)
    r1 = eng.submit(PROMPTS[0], max_new=20)
    eng.step()
    assert eng.cancel(r1)
    assert eng.run_all()[r1].cancelled


def test_paged_validation(params):
    with pytest.raises(ValueError, match="divide"):
        _engine(params, "bf16", kv_block_size=48)   # 64 % 48 != 0
    with pytest.raises(ValueError, match="plain attention"):
        tstack.layer_state(CFG, "ssd", 1, 64, TKV(paged=True), 5, "cpu")
    with pytest.raises(ValueError, match="block_size"):
        TKV(paged=True, block_size=0)
    with pytest.raises(ValueError, match="num_blocks"):
        tlm.init_decode_state(CFG, 1, 64, TKV(paged=True), "cpu", 1)
    eng = _engine(params, "bf16", kv_block_size=16, kv_pool_blocks=3)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(list(range(1, 50)), max_new=16)  # needs 4 > 2 allocatable


def test_tail_prefill_over_prefix_equals_full_prefill(params):
    """``prefill(prefix_kv=, pos0=)`` over the first P tokens' cached k/v
    gives the full prefill's rows for the tail exactly, and its logits
    within 1e-5 (the bf16 cache holds the very rows the full prefill
    attends to; only the attention's f32 sums may run in another order).
    A paged int8 prefill returns the rows a dense slab would hold."""
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, CFG.vocab, (2, 24)).astype(np.int32))
    kv = TKV(dtype="bf16", paged=True, block_size=8)
    lf, sf, _ = tlm.prefill(CFG, params, {"tokens": toks}, 64,
                            full_logits=True, kvcfg=kv)
    P = 16
    run = sf["stack"][0]["u0"]
    prefix = [(run["k"][:, :, :, :P], run["v"][:, :, :, :P])]
    lt, st, _ = tlm.prefill(CFG, params, {"tokens": toks[:, P:]}, 64,
                            full_logits=True, kvcfg=kv, prefix_kv=prefix,
                            pos0=P)
    torch.testing.assert_close(lt, lf[:, P:], rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        assert torch.equal(st["stack"][0]["u0"][name], run[name][:, :, :, P:])
    # paged int8 prefill: the rows the dense slab would hold
    _, slab, _ = tlm.prefill(CFG, params, {"tokens": toks}, 64,
                             kvcfg=TKV(dtype="int8"))
    _, rows, _ = tlm.prefill(CFG, params, {"tokens": toks}, 64,
                             kvcfg=TKV(dtype="int8", paged=True, block_size=8))
    for name, leaf in rows["stack"][0]["u0"].items():
        assert leaf.shape[3] == 24
        assert torch.equal(leaf, slab["stack"][0]["u0"][name][:, :, :, :24])


# --------------------------------------------- the port against the JAX one

MAX_NEW, MAX_LEN = 5, 48
REPLAY_LEN = 64                 # the replay's dense slab: every position fits
RTOL = 1e-1
# (atol, relative L2) per KV layout: tests/test_torch_engine.py's TOL
TOL = {"int8": (5e-2, 3e-2), "int4": (2e-1, 6e-2)}


@pytest.fixture(scope="module")
def bridged(jx):
    jcfg = jx["MCfg"](name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    jp = jx["lm"].init_params(jcfg, jx["jax"].random.PRNGKey(0))
    tp = params_from_jax(jx["jax"].tree.map(np.asarray, jp), device="cpu")
    tcfg = TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TCfg)})
    return jcfg, jp, tcfg, tp


def _padded(prompts, bucket):
    toks = np.zeros((len(prompts), bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks


def _replay(jx, bridged, jq, tq, kv_dtype, prompts, out, bucket):
    """Per-step logits (R, MAX_NEW, V) of both models, teacher-forced on the
    JAX engine's tokens: prefill, then dense ``decode_step``s.  The paged
    read equals the dense read exactly (the port's engine tests above hold
    that), so these are the logits each paged engine decoded from."""
    jax, jnp, jlm = jx["jax"], jx["jnp"], jx["lm"]
    jcfg, jp, tcfg, tp = bridged
    jkv, tkv = jx["KV"](dtype=kv_dtype), TKV(dtype=kv_dtype)
    toks = _padded(prompts, bucket)
    plen = np.asarray([len(p) for p in prompts])
    lj, sj, _ = jax.jit(lambda p, t: jlm.prefill(
        jcfg, p, {"tokens": t}, max_len=REPLAY_LEN, full_logits=True,
        kvcfg=jkv))(jp, jnp.asarray(toks))
    lt, st, _ = tlm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            REPLAY_LEN, full_logits=True, kvcfg=tkv)
    rows = np.arange(len(prompts))
    steps_j = [np.asarray(lj)[rows, plen - 1]]
    steps_t = [lt.numpy()[rows, plen - 1]]
    step = jax.jit(lambda q, s, tok, pos: jlm.decode_step(jcfg, q, s, tok, pos,
                                                          kvcfg=jkv))
    for t in range(MAX_NEW - 1):
        tok = np.asarray([[o[t]] for o in out], np.int32)
        pos = (plen + t).astype(np.int32)
        g, sj = step(jq, sj, jnp.asarray(tok), jnp.asarray(pos))
        steps_j.append(np.asarray(g))
        g, st = tlm.decode_step(tcfg, tq, st, torch.from_numpy(tok),
                                torch.from_numpy(pos), kvcfg=tkv,
                                kcfg=KernelConfig(use_pallas=True))
        steps_t.append(g.numpy())
    return np.stack(steps_j, axis=1), np.stack(steps_t, axis=1)


def _hold(lj, lt, out_j, out_t, kv_dtype):
    """tests/test_torch_engine.py's rule: logits within TOL; greedy tokens
    equal up to the first step where JAX's top-2 margin is within twice
    the atol (a flip needs both logits to move toward each other)."""
    atol, rel_l2 = TOL[kv_dtype]
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=atol)
    rel = np.linalg.norm(lt - lj) / np.linalg.norm(lj)
    assert rel < rel_l2, rel
    top2 = np.sort(lj, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for r in range(len(out_j)):
        for t in range(MAX_NEW):
            if out_t[r][t] != out_j[r][t]:
                assert margin[r, t] <= 2 * atol, (r, t, margin[r, t])
                break


def _pair(jx, bridged, jpol, tpol, prompts, **ekw):
    """The JAX and the port's paged engine on the same traffic."""
    jcfg, jp, tcfg, tp = bridged
    jeng = jx["Eng"](jcfg, jp, jpol, jx["ECfg"](guards=False, kv_paged=True,
                                                **ekw))
    teng = TEngine(tcfg, tp, tpol, TECfg(guards=False, kv_paged=True, **ekw),
                   device="cpu")
    outs = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
        res = eng.run_all()
        outs.append([list(res[r]) for r in rids])
    return jeng, teng, outs[0], outs[1]


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_paged_engine_matches_jax(jx, bridged, kv_dtype):
    """int4 g32 TTQ weights, one admission round and one requant in both
    engines, then paged decode through the block tables."""
    prompts = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12]]
    jpol = jx["pol"](bits=4, group_size=32, rank=0, packed=True,
                     kvcache=jx["KV"](dtype=kv_dtype))
    tpol = t_policy(bits=4, group_size=32, rank=0, packed=True,
                    kvcache=TKV(dtype=kv_dtype),
                    kernel=KernelConfig(use_pallas=True))
    jeng, teng, out_j, out_t = _pair(jx, bridged, jpol, tpol, prompts,
                                     max_slots=3, max_len=MAX_LEN,
                                     decode_chunk=2)
    assert jeng.n_requants == teng.n_requants == 1
    assert all(len(o) == MAX_NEW for o in out_t)
    assert teng.host_syncs == 1 + (MAX_NEW - 1 + 1) // 2
    assert teng.num_blocks == jeng.num_blocks == 3 * MAX_LEN // 16 + 1
    jq = jeng.qparams
    tq = teng.qparams
    lj, lt = _replay(jx, bridged, jq, tq, kv_dtype, prompts, out_j, 16)
    _hold(lj, lt, out_j, out_t, kv_dtype)
    teng.allocator.assert_quiescent()


def test_paged_scheduling_matches_jax(jx, bridged):
    """Pool pressure and a shared 16-token prefix (full-precision weights,
    int8 KV, block 8): the port's scheduler preempts, hits the prefix
    cache and pads prefill exactly as the JAX engine's does, and the tokens
    hold to the margin rule."""
    rng = np.random.default_rng(9)
    sysp = rng.integers(1, 128, 16).tolist()
    prompts = [sysp + rng.integers(1, 128, int(n)).tolist()
               for n in rng.integers(3, 9, 5)]
    jeng, teng, out_j, out_t = _pair(
        jx, bridged, jx["NO_QUANT"].with_(kvcache=jx["KV"](dtype="int8")),
        T_NO_QUANT.with_(kvcache=TKV(dtype="int8")), prompts, max_slots=3,
        max_len=64, decode_chunk=2, kv_block_size=8, kv_pool_blocks=6)
    assert teng.preemptions == jeng.preemptions > 0
    ta, ja = teng.allocator, jeng.allocator
    assert (ta.prefix_hits, ta.prefix_misses, ta.peak_in_use) == \
        (ja.prefix_hits, ja.prefix_misses, ja.peak_in_use)
    assert ta.prefix_hits > 0
    assert teng.prefill_tokens == jeng.prefill_tokens
    assert all(len(o) == MAX_NEW for o in out_t)
    lj, lt = _replay(jx, bridged, bridged[1], bridged[3], "int8", prompts,
                     out_j, 32)
    _hold(lj, lt, out_j, out_t, "int8")
    ta.assert_quiescent()


def test_smoke_prefix_traffic_preempts():
    """chip_smoke.py phase 3c's traffic and pool on a tiny model of the same
    geometry (4 slots × 256, block 16, int8 KV, K = 8): the host-only
    scheduler's preemptions and prefix hits, which do not depend on the
    model because every request runs to max_new.  The pool of POOL_3C
    blocks preempts; 20 blocks hold the traffic without preemption."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = TCfg(name="t", family="dense", n_layers=1, d_model=32, n_heads=2,
               n_kv_heads=1, d_ff=32, vocab=256000)
    p = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pol = T_NO_QUANT.with_(kvcache=TKV(dtype="int8"))
    seen = {}
    for blocks in (smoke.POOL_3C, 20):
        eng = TEngine(cfg, p, pol,
                      TECfg(max_slots=4, max_len=256, decode_chunk=0,
                            guards=False, kv_paged=True,
                            kv_block_size=smoke.BLOCK,
                            kv_pool_blocks=blocks), device="cpu")
        rids = [eng.submit(q, max_new=smoke.MAX_NEW)
                for q in smoke.prefix_prompts()]
        out = eng.run_all()
        assert all(len(out[r]) == smoke.MAX_NEW and not out[r].unfinished
                   for r in rids)
        eng.allocator.assert_quiescent()
        a = eng.allocator
        seen[blocks] = (eng.preemptions, a.prefix_hits, a.prefix_misses)
    assert seen == {smoke.POOL_3C: (24, 72, 61), 20: (0, 14, 12)}
