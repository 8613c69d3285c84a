"""Self-speculative decoding in the port, on the CPU.

Every case of tests/test_speculative.py, in the port: greedy tokens with
``speculate_k`` = W bit for bit the non-speculative engine's of the same
configuration (the verify tree decides every token, and on the CPU a
verify window reproduces sequential decode exactly); the draft tree's
requant; the chunk rule; cancel and preemption mid-window.  Then the parts
against the JAX package on the same weights: the suffix reads, a verify
window's logits and the speculative engine's tokens; and the window write
at the slab's capacity boundary."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import (KernelConfig, KVCacheConfig, NO_QUANT,
                              QuantizedTensor, ttq_policy)
from repro_torch.kernels import ref
from repro_torch.models import common, layers, lm
from repro_torch.models.config import ModelConfig, SSMCfg
from repro_torch.quant import QuantizedModel
from repro_torch.serving import EngineConfig, TTQEngine, pick_decode_chunk

CFG = ModelConfig(name="spec-t", family="dense", n_layers=3, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
PROMPTS = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12, 6, 3], [7, 7, 7, 2]]
INT8_PAGED = NO_QUANT.with_(kvcache=KVCacheConfig(dtype="int8", paged=True))


@pytest.fixture(scope="module")
def params():
    return lm.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _engine(params, policy=NO_QUANT, speculate_k=0, slots=3, cfg=CFG,
            draft_policy=None, **kw):
    return TTQEngine(cfg, params, policy,
                     EngineConfig(max_slots=slots, max_len=64, guards=False,
                                  speculate_k=speculate_k, **kw),
                     device="cpu", draft_policy=draft_policy)


def _run(eng, prompts=PROMPTS, max_new=8):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    outs = eng.run_all()
    return [list(outs[r]) for r in rids]


def _spec_equal(params, policy, W, slots=3, **kw):
    """Tokens of the speculative engine and of the same engine with
    speculation off; returns the speculative engine."""
    base = _run(_engine(params, policy, slots=slots, **kw))
    eng = _engine(params, policy, W, slots=slots, **kw)
    assert _run(eng) == base
    return eng


# ------------------------------------------------------- greedy equivalence

@pytest.mark.parametrize("W", [2, 4])
def test_spec_matches_nonspec_dense_fp(params, W):
    eng = _spec_equal(params, NO_QUANT, W)
    assert eng.spec_windows > 0
    assert 0.0 <= eng.spec_acceptance_rate <= 1.0
    assert eng.runner.spec_drafted == W * eng.spec_windows


@pytest.mark.parametrize("policy", [
    ttq_policy(bits=8, group_size=32, rank=0),
    ttq_policy(bits=4, group_size=32, rank=8, packed=True,
               kernel=KernelConfig(use_pallas=True),
               kvcache=KVCacheConfig(dtype="int8"))],
    ids=["int8 fake-quant", "int4 packed rank 8, int8 KV"])
def test_spec_matches_nonspec_quantized(params, policy):
    """A quantized verify tree with the default int4 draft companion."""
    eng = _spec_equal(params, policy, 3)
    assert eng.draft_params is not eng.params
    assert eng.draft_params is not eng.decode_params


@pytest.mark.parametrize("kv_dtype", ["int8", "int4", "bf16"])
def test_spec_matches_nonspec_paged(params, kv_dtype):
    pol = NO_QUANT.with_(kvcache=KVCacheConfig(dtype=kv_dtype, paged=True))
    _spec_equal(params, pol, 2, slots=2)


def test_spec_uneven_lengths_and_eos(params):
    """Budgets and an EOS that end mid-window: the emitted counts stay
    exact per lane."""
    def run(eng, budgets):
        rids = [eng.submit(p, max_new=n) for p, n in zip(PROMPTS, budgets)]
        out = eng.run_all()
        return [list(out[r]) for r in rids]
    budgets = (1, 5, 9, 3)
    base = run(_engine(params), budgets)
    outs = run(_engine(params, speculate_k=3), budgets)
    assert outs == base and [len(o) for o in outs] == list(budgets)
    # an EOS that one request first emits mid-budget, past its first token
    base = run(_engine(params), (16,) * 4)
    r, t = next((r, t) for r, o in enumerate(base) for t in range(2, len(o))
                if o[t] not in o[:t])
    eos = base[r][t]
    base = run(_engine(params, eos_token=eos), (16,) * 4)
    assert run(_engine(params, speculate_k=3, eos_token=eos), (16,) * 4) \
        == base
    assert len(base[r]) == t + 1 and base[r][-1] == eos


# ------------------------------------------------------------ engine gates

def test_spec_auto_off_when_sampling(params):
    eng = _engine(params, speculate_k=4, temperature=0.7)
    assert eng.ecfg.speculate_k == 0 and eng.draft_params is None


def test_spec_rejects_non_attention_families():
    cfg = ModelConfig(name="ssm-t", family="ssm", n_layers=2, d_model=64,
                      n_heads=1, n_kv_heads=1, d_ff=0, vocab=128,
                      ssm=SSMCfg(d_state=16, head_dim=16, chunk=16))
    with pytest.raises(ValueError, match="attention"):
        TTQEngine(cfg, {}, NO_QUANT,
                  EngineConfig(max_slots=1, max_len=64, guards=False,
                               speculate_k=2), device="cpu")


def test_pick_decode_chunk_speculation_aware():
    """The table of tests/test_speculative.py:96-106."""
    assert pick_decode_chunk(1) == 1
    assert pick_decode_chunk(4) == 8
    assert pick_decode_chunk(1, 4) == 1
    assert pick_decode_chunk(4, 1) == 4
    assert pick_decode_chunk(4, 3) == 2
    assert pick_decode_chunk(4, 7) == 1
    assert pick_decode_chunk(8, 0) == pick_decode_chunk(8)


def test_auto_chunk_counts_windows(params):
    eng = _engine(params, speculate_k=3, slots=4, decode_chunk=0)
    assert eng.ecfg.decode_chunk == 2
    toks, valid, done, fault = eng.runner.decode_block(eng.decode_params,
                                                       eng.draft_params)
    assert toks.shape == valid.shape == (4, 2 * 4) and done.shape == (4,)
    assert fault is None                    # guards off: no fault column


# ------------------------------------------------------ dual-tree requant

def _qts(tree):
    if isinstance(tree, dict):
        return [q for v in tree.values() for q in _qts(v)]
    if isinstance(tree, (list, tuple)):
        return [q for v in tree for q in _qts(v)]
    return [tree] if isinstance(tree, QuantizedTensor) else []


def test_draft_tree_program_budget(params):
    """Draft and verify plans together hold at most twice the single
    tree's families (the port's counterpart of the reference's requant
    programs, one per family), and the draft is a second tree."""
    pol = ttq_policy(bits=8, group_size=32, rank=0)
    single = _engine(params, pol)
    _run(single, prompts=PROMPTS[:1], max_new=2)
    spec = _engine(params, pol, speculate_k=2)
    _run(spec, prompts=PROMPTS[:1], max_new=2)
    assert single.qmodel.requant_families > 0
    assert spec.qmodel.requant_families <= 2 * single.qmodel.requant_families
    dq, vq = _qts(spec.qmodel.draft_params), _qts(spec.qmodel.decode_params)
    assert dq and all(q.bits == 4 for q in dq) and all(q.bits == 8
                                                       for q in vq)
    assert not {id(q.scale) for q in dq} & {id(q.scale) for q in vq}


def _calibrated(qm, params):
    toks = torch.tensor([PROMPTS[0]])
    _, _, stats = lm.prefill(CFG, params, {"tokens": toks}, 16)
    qm.calibrate(stats, float(toks.numel()))
    return qm


def test_draft_params_fp_fallback(params):
    qm = QuantizedModel(params, ttq_policy(bits=8, group_size=32),
                        draft_policy=NO_QUANT)
    assert qm.draft_params is params
    _calibrated(qm, params).requantize()
    assert qm.decode_params is not params and qm.draft_params is params


def test_draft_only_quantization(params):
    """A disabled verify policy with an enabled draft: the verify tree
    stays fp, the draft tree quantizes, and the engine's greedy tokens are
    the plain fp engine's."""
    qm = QuantizedModel(params, NO_QUANT,
                        draft_policy=ttq_policy(bits=8, group_size=32,
                                                rank=0))
    tree = _calibrated(qm, params).requantize()
    assert tree is not None and tree is qm.draft_qparams
    assert qm.qparams is None and qm.decode_params is params
    assert _qts(qm.draft_qparams) and qm.requant_families > 0
    base = _run(_engine(params))
    spec = _run(_engine(params, speculate_k=3))
    eng = _engine(params, speculate_k=3,
                  draft_policy=ttq_policy(bits=8, group_size=32, rank=0))
    assert _run(eng) == base == spec
    assert eng.qmodel.qparams is None and eng.n_requants > 0


def test_draft_policy_requires_fused_plan(params):
    with pytest.raises(ValueError, match="fused"):
        QuantizedModel(params, ttq_policy(bits=8, group_size=32),
                       fused=False,
                       draft_policy=ttq_policy(bits=4, group_size=32))


def test_draft_variant_policy():
    pol = ttq_policy(bits=8, group_size=32, rank=8)
    d = pol.draft_variant()
    assert d.qcfg.bits == 4 and d.rank == 0 and not d.overrides
    assert d.qcfg.group_size == pol.qcfg.group_size
    assert d.kvcache == pol.kvcache and d.kernel == pol.kernel
    assert NO_QUANT.draft_variant() is NO_QUANT


# ---------------------------------------- scheduler: cancel / preemption

def test_cancel_mid_speculation_window(params):
    base = _run(_engine(params), prompts=[PROMPTS[1]], max_new=20)
    eng = _engine(params, speculate_k=3, slots=2)
    r1 = eng.submit(PROMPTS[0], max_new=20)
    r2 = eng.submit(PROMPTS[1], max_new=20)
    eng.step()                                  # admission + first block
    assert eng.cancel(r1)
    outs = eng.run_all()
    assert outs[r1].cancelled and outs[r1].unfinished
    assert len(outs[r1]) < 20
    assert list(outs[r2]) == base[0]


def test_preemption_mid_speculation_window(params):
    kw = dict(slots=2, kv_block_size=4, kv_pool_blocks=7)
    eng = _spec_equal(params, INT8_PAGED, 2, **kw)
    assert eng.preemptions > 0
    eng.allocator.assert_quiescent()


def test_spec_prefix_cache_not_polluted(params):
    """Draft rows (later overwritten) never reach the prefix trie: a request
    hitting the cached prefix decodes as the cold engine does."""
    sysp = list(range(1, 21))
    ps = [sysp + [40, 41], sysp + [50, 51, 52]]
    pol = NO_QUANT.with_(kvcache=KVCacheConfig(dtype="bf16", paged=True))
    cold = _run(_engine(params, pol, prefix_cache=False, slots=2),
                prompts=ps, max_new=6)
    eng = _engine(params, pol, speculate_k=2, slots=2)
    assert _run(eng, prompts=ps, max_new=6) == cold
    assert eng.prefix_hit_rate > 0
    eng.allocator.assert_quiescent()


# ----------------------------------------- the window write at capacity

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
def test_window_write_drops_rows_past_capacity(dtype):
    """Rows at or past Smax are dropped, like the reference's
    ``mode="drop"``; every other row lands, and row Smax-1 keeps the
    window's own row where the window covers it."""
    g = torch.Generator().manual_seed(3)
    B, Hkv, Smax, D, S = 5, 2, 8, 4, 4
    cache = (torch.randn((B, Hkv, Smax, D), generator=g) * 50).to(dtype)
    new = (torch.randn((B, Hkv, S, D), generator=g) * 50).to(dtype)
    pos = torch.tensor([0, 3, 5, 7, 8], dtype=torch.int32)  # 5: ends at 8
    want = cache.clone()
    for b in range(B):
        for s in range(S):
            if pos[b] + s < Smax:
                want[b, :, pos[b] + s] = new[b, :, s]
    got = layers._kv_write_rows(cache.clone(), new, pos)
    assert torch.equal(got, want)


def test_paged_window_rows_sink_past_capacity():
    bt = torch.tensor([[3, 4], [5, 0]], dtype=torch.int32)   # bs 4: cap 8
    pos = torch.tensor([6, 2], dtype=torch.int32)
    rows = layers.paged_window_rows(pos, bt, 1, 4, 4).reshape(2, 4)
    # slot 0: rows 6, 7 in block 4, rows 8, 9 past capacity → sink block 0
    assert rows[0].tolist() == [4 * 4 + 2, 4 * 4 + 3, 0, 1]
    # slot 1: rows 2, 3 in block 5; rows 4, 5 in its unallocated block 0
    assert rows[1].tolist() == [5 * 4 + 2, 5 * 4 + 3, 0, 1]


def test_verify_window_at_the_capacity_boundary(params):
    """A window that runs past the slab: its in-capacity rows give
    sequential decode's logits bit for bit and row Smax-1 holds the
    verify tree's own row."""
    kv = KVCacheConfig(dtype="int8")
    ML, B = 16, 2
    st = lm.init_decode_state(CFG, B, ML, kvcfg=kv, device="cpu")
    g = torch.Generator().manual_seed(4)
    pos = torch.tensor([10, 14], dtype=torch.int32)
    for t in range(4):
        lm.decode_step(CFG, params, st, torch.randint(0, 128, (B, 1),
                                                      generator=g),
                       pos - 4 + t, kvcfg=kv)
    win = torch.randint(0, 128, (B, 4), generator=g)
    st_v = {"stack": [{u: {k: x.clone() for k, x in r[u].items()} for u in r}
                      for r in st["stack"]]}
    lg_v, _ = lm.verify_window(CFG, params, st_v, win, pos, kvcfg=kv)
    seq = [lm.decode_step(CFG, params, st, win[:, s:s + 1],
                          torch.clamp(pos + s, max=ML - 1), kvcfg=kv)[0]
           for s in range(2)]
    assert torch.equal(lg_v[0, :2], torch.stack(seq, 1)[0])
    assert torch.equal(lg_v[1, :2], torch.stack(seq, 1)[1])   # rows 14, 15
    for a, b in zip(st_v["stack"][0]["u0"].values(),
                    st["stack"][0]["u0"].values()):
        assert torch.equal(a[:, 1, :, ML - 1], b[:, 1, :, ML - 1])


# ------------------------------------------------ against the JAX package

@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from repro.models import ModelConfig as JCfg
    from repro.models import lm as jlm
    jcfg = JCfg(name="spec-t", family="dense", n_layers=3, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jax=jax, jlm=jlm, cfg=jcfg, params=jp,
                tparams=params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu"))


def _suffix_inputs(bits, paged):
    rng = np.random.default_rng(bits + 10 * paged)
    B, H, Hkv, S, Dh, Smax, bs = 3, 4, 2, 4, 32, 32, 8
    q = rng.standard_normal((B, H, S, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Smax, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Smax, Dh)).astype(np.float32)
    pos = np.array([3, 17, 28], np.int32)
    return q, k, v, pos, bs


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_suffix_attn_ref_matches_jax(jref, bits):
    """The suffix read over an int8/int4 cache against the reference's
    (f32 math on both sides: 1e-5); the paged read bit for bit the dense
    read of the gathered pool."""
    from repro.core.kvquant import quantize_kv as jquant
    from repro.kernels import ref as jr
    jnp = jref["jax"].numpy
    q, k, v, pos, bs = _suffix_inputs(bits, False)
    kq, ks = jquant(jnp.asarray(k), bits=bits, group_size=0)
    vq, vs = jquant(jnp.asarray(v), bits=bits, group_size=0)
    want = jr.kv_suffix_attn_ref(jnp.asarray(q), kq, ks, vq, vs,
                                 jnp.asarray(pos), bits=bits)
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    got = ref.kv_suffix_attn_ref(torch.from_numpy(q), *t,
                                 torch.from_numpy(pos), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    B, Hkv, Smax = 3, 2, 32
    nblk = Smax // bs
    perm = torch.randperm(B * nblk, generator=torch.Generator().manual_seed(0))
    bt = (perm + 1).reshape(B, nblk).int()
    pools = []
    for x in t:
        pool = torch.zeros((B * nblk + 1, Hkv, bs, x.shape[-1]), dtype=x.dtype)
        pool[bt.long().reshape(-1)] = x.reshape(B, Hkv, nblk, bs, -1).permute(
            0, 2, 1, 3, 4).reshape(B * nblk, Hkv, bs, -1)
        pools.append(pool)
    paged = ref.kv_paged_suffix_attn_ref(torch.from_numpy(q), *pools, bt,
                                         torch.from_numpy(pos), bits=bits)
    assert torch.equal(paged, got)


def test_suffix_attention_matches_jax(jref):
    """The bf16 suffix read against the reference's (bf16 cache, f32
    products: one bf16 rounding of the output, 2^-7)."""
    from repro.models import common as jc
    jnp = jref["jax"].numpy
    q, k, v, pos, _ = _suffix_inputs(16, False)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = common.suffix_attention(qb, kb, vb, torch.from_numpy(pos))
    f = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = jc.suffix_attention(f(qb), f(kb), f(vb), jnp.asarray(pos))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_verify_window_matches_jax(jref, kv_dtype):
    """One verify window after a prefill, on bridged weights: logits within
    the bf16-residual tolerance of tests/test_torch_engine.py (atol 5e-2,
    rtol 1e-1) and relative L2 ≤ 3e-2."""
    from repro.core import KVCacheConfig as JKV
    jax, jlm = jref["jax"], jref["jlm"]
    jnp = jax.numpy
    toks = np.array([[5, 9, 17, 3, 11, 2, 0, 0], [8, 8, 1, 4, 6, 90, 3, 1]],
                    np.int32)
    win = np.array([[40, 41, 42, 43], [1, 2, 3, 4]], np.int32)
    pos = np.array([8, 8], np.int32)
    ML = 32
    jkv = JKV(dtype=kv_dtype)
    _, jst, _ = jlm.prefill(jref["cfg"], jref["params"],
                            {"tokens": jnp.asarray(toks)}, max_len=ML,
                            kvcfg=jkv)
    want, _ = jlm.verify_window(jref["cfg"], jref["params"], jst,
                                jnp.asarray(win), jnp.asarray(pos), kvcfg=jkv)
    tkv = KVCacheConfig(dtype=kv_dtype)
    _, tst, _ = lm.prefill(CFG, jref["tparams"],
                           {"tokens": torch.from_numpy(toks)}, ML, kvcfg=tkv)
    got, _ = lm.verify_window(CFG, jref["tparams"], tst,
                              torch.from_numpy(win), torch.from_numpy(pos),
                              kvcfg=tkv)
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-1, atol=5e-2)
    assert np.linalg.norm(got.numpy() - w) / np.linalg.norm(w) <= 3e-2


def _jax_margins(jref, jeng, prompt, out):
    """JAX's top-2 logit margin before each of ``out``'s tokens, teacher-
    forced through the JAX engine's verify tree (prefill, then decode)."""
    jax, jlm = jref["jax"], jref["jlm"]
    jnp = jax.numpy
    lg, st, _ = jlm.prefill(jref["cfg"], jref["params"],
                            {"tokens": jnp.asarray([prompt], jnp.int32)},
                            max_len=64, kvcfg=jeng.kvcfg)
    steps = [np.asarray(lg)[0]]
    for t, tok in enumerate(out[:-1]):
        lg, st = jlm.decode_step(jref["cfg"], jeng.decode_params, st,
                                 jnp.asarray([[tok]], jnp.int32),
                                 jnp.asarray([len(prompt) + t], jnp.int32),
                                 kvcfg=jeng.kvcfg)
        steps.append(np.asarray(lg)[0])
    top2 = np.sort(np.stack(steps), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8 tree"])
def test_spec_tokens_match_jax(jref, quantized):
    """The port's speculative engine and the JAX package's on the same
    weights: tokens equal up to the first position where JAX's top-2 margin
    is within 1e-1 (twice the logits' atol), where a flip is allowed and the
    request's comparison ends."""
    from repro.core import NO_QUANT as JNQ
    from repro.core import ttq_policy as jpol
    from repro.serving import EngineConfig as JE
    from repro.serving import TTQEngine as JEng
    kw = dict(bits=8, group_size=32, rank=0)
    jp, tp = (jpol(**kw), ttq_policy(**kw)) if quantized else (JNQ, NO_QUANT)
    jeng = JEng(jref["cfg"], jref["params"], jp,
                JE(max_slots=3, max_len=64, speculate_k=3, guards=False))
    teng = _engine(jref["tparams"], tp, 3)
    want, got = _run(jeng), _run(teng)
    assert teng.spec_windows > 0
    compared = 0
    for p, w, g in zip(PROMPTS, want, got):
        margins = _jax_margins(jref, jeng, p, w)
        for t, (a, b) in enumerate(zip(w, g)):
            if a != b:
                assert margins[t] <= 1e-1, (p, t, margins[t])
                break
            compared += 1
    assert compared >= len(PROMPTS) * 4
