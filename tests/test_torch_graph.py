"""The compiled decode block: ``DeviceRunner`` replays ``lm.decode_many``'s
K steps as one captured CUDA graph on the card (the reference's
``jax.jit(lm.decode_many)``), and runs them as the eager loop on the CPU.

On the CPU (``device="cpu"``, 2 layers, narrow widths) each precondition of
a replay that the CPU can check:

* the runner's decode inputs and every state leaf keep their storage
  through admission, decode, release and slot reuse;
* a requant lands in the previous tree's storage and holds exactly what a
  fresh ``FusedRequantPlan.run`` returns;
* the paged row index, now computed once per step, equals the per-layer
  formula it replaces;
* a block leaves the runner's state where ``lm.decode_many`` leaves it;
* ``compiled_programs`` is 0 where nothing is captured.

On the card (``gpu`` marker) the graph's tokens are held bitwise to the
eager ``lm.decode_many``'s on clones of the same state, block by block, and
each prefill replay's first tokens, statistics and written cache rows to
the eager prefill's; the double buffer's two trees are held apart.
Inputs come from numpy or torch generators with a seed."""
import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import KernelConfig, KVCacheConfig, ttq_policy
from repro_torch.core.ttq import QuantizedTensor
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ttq_quantize import _outputs
from repro_torch.kernels.ttq_quantize import ttq_quantize as quantize_kernel
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.config import MLACfg, ModelConfig, MoECfg
from repro_torch.quant import FusedRequantPlan, QuantizedModel
from repro_torch.serving import EngineConfig, TTQEngine
from repro_torch.serving.blocks import SINK
from repro_torch.serving.runner import _collector_paused, _layout
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU_CFG = ModelConfig(name="graph-t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
# on the card: shapes the kernels take (G = 2, head 64, d and d_ff whole
# int4 g32 code vectors)
GPU_CFG = ModelConfig(name="graph-gpu", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                      vocab=512)
FIELDS = ("wint", "packed", "scale", "zero", "dinv")


def _prompts(seed, n, vocab, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(k)).tolist()
            for k in rng.integers(lo, hi, size=n)]


def _policy(bits=4, kv="int8", use_kernels=True, rank=0, **kv_kw):
    return ttq_policy(bits=bits, group_size=32, rank=rank, packed=True,
                      kvcache=KVCacheConfig(dtype=kv, **kv_kw),
                      kernel=KernelConfig(use_pallas=use_kernels))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, QuantizedTensor):
        yield from (getattr(tree, f) for f in FIELDS
                    if getattr(tree, f) is not None)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _ptrs(runner):
    return ([t.data_ptr() for t in (runner.cur_tok, runner.pos, runner.done,
                                    runner.remaining)]
            + [t.data_ptr() for t in _leaves(runner.state)])


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
            out[path] = t
    walk(tree, ())
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _copy_into(dst, src):
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _snapshot(r):
    """Clones of everything a block reads from the runner (and the
    generator's state)."""
    gen = None
    if r.generator is not None:
        gen = torch.Generator(device=r.device)
        gen.set_state(r.generator.get_state())
    return (_clone(r.state), r.cur_tok.clone(), r.pos.clone(),
            r.done.clone(), r.remaining.clone(), gen)


def _eager(eng, params, snap, carry=False, draft=None, K=None,
           poison=None):
    """One eager ``lm.decode_many`` block of K (default the runner's) steps
    from ``snap`` (its state and generator are consumed), or with ``draft``
    one ``lm.speculate_many`` block: the host array the runner's block
    returns ((B, 2C+1); with guards (B, 2C+2), the fault flags last, under
    the ``poison`` mask) [, and the carry (token, pos, done, remaining)]."""
    r, e = eng.runner, eng.ecfg
    st, tok, pos, done, rem, gen = snap
    kw = dict(K=K or r.K, max_len=e.max_len, eos_token=e.eos_token,
              kvcfg=eng.kvcfg, kcfg=eng.kncfg, detect_faults=r.detect_faults)
    if draft is None:
        ys, (_, *rest, _) = tlm.decode_many(
            eng.cfg, params, st, tok, pos, done, rem, gen, poison,
            temperature=e.temperature, **kw)
    else:
        ys, (_, *rest, _) = tlm.speculate_many(
            eng.cfg, draft, params, st, tok, pos, done, rem, gen, poison,
            W=r.W, **kw)
    cols = [ys[0], ys[1].to(torch.int32), rest[2].to(torch.int32)[:, None]]
    if r.detect_faults:
        cols.append(ys[2].to(torch.int32)[:, None])
    out = torch.cat(cols, dim=1).cpu().numpy()
    return (out, rest) if carry else out


def _engine(cfg, params, policy, device, generator=None, **kw):
    base = dict(max_slots=2, max_len=64, decode_chunk=4, guards=False,
                prompt_buckets=(16, 32, 64))
    return TTQEngine(cfg, params, policy, EngineConfig(**{**base, **kw}),
                     device=device, generator=generator)


# ---------------------------------------------------------------- on the CPU

@pytest.fixture(scope="module")
def cpu_params():
    return tlm.init_params(CPU_CFG, torch.Generator().manual_seed(0),
                           device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_runner_inputs_keep_their_storage(cpu_params, paged):
    """admit → decode_block → release_slots → admit into a reused slot: the
    decode inputs and every state leaf stay where they were allocated."""
    kw = dict(kv_paged=True, kv_block_size=8) if paged else {}
    eng = _engine(CPU_CFG, cpu_params, _policy(), "cpu", **kw)
    r = eng.runner
    before = _ptrs(r)
    rids = [eng.submit(p, max_new=6) for p in _prompts(1, 5, CPU_CFG.vocab)]
    steps = 0
    while eng.scheduler.has_work() and eng.step():
        assert _ptrs(r) == before
        steps += 1
    out = eng.scheduler.results()
    assert all(len(out[i]) == 6 and not out[i].unfinished for i in rids)
    assert steps >= 3                         # 5 requests through 2 slots
    assert eng.n_requants >= 3
    assert r.compiled_programs == eng.compiled_programs == 0


def _requant_in_place(cfg, params, pol, device):
    """Two requants on different statistics: the second writes into the
    first's storage and holds exactly what a fresh plan returns."""
    qm = QuantizedModel(params, pol)
    stats = []
    for seed in (2, 3):
        toks = torch.from_numpy(np.asarray(_prompts(seed, 2, cfg.vocab, 8, 9),
                                           np.int64)).to(device)
        stats.append(tlm.prefill(cfg, params, {"tokens": toks}, 16)[2])
    first = qm.calibrate(stats[0], 16.0).requantize()
    ptrs = [t.data_ptr() for t in _leaves(first)]
    lay = _layout(first)
    old = {k: q.dinv.clone() for k, q in _qts(first).items()}
    second = qm.calibrate(stats[1], 16.0).requantize()
    assert second is first and qm.decode_params is first
    assert [t.data_ptr() for t in _leaves(second)] == ptrs
    assert _layout(second) == lay
    s, count = qm.session.as_calib()
    fresh = _qts(FusedRequantPlan(params, s, pol).run(params, s, count))
    got = _qts(second)
    assert got.keys() == fresh.keys() and len(got) == 7
    for k, q in got.items():
        for f in FIELDS:
            a, b = getattr(q, f), getattr(fresh[k], f)
            assert (a is None) == (b is None), (k, f)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (k, f)
    assert any(not torch.equal(old[k], q.dinv) for k, q in got.items())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_requant_lands_in_the_previous_tree(cpu_params, use_kernels):
    _requant_in_place(CPU_CFG, cpu_params, _policy(use_kernels=use_kernels),
                      "cpu")


def test_quantize_out_is_written_and_checked():
    """The quantize wrapper's ``out``: written in place and returned; on the
    card a mismatched ``out`` raises rather than being copied."""
    g = torch.Generator().manual_seed(4)
    W = torch.randn((2, 16, 64), generator=g).to(torch.bfloat16)
    D = torch.rand((2, 64), generator=g) + 0.5
    want = quantize_kernel(W, D, bits=4, group_size=32)
    out = tuple(torch.full_like(t, 7) for t in want)
    got = quantize_kernel(W, D, bits=4, group_size=32, out=out)
    assert all(a is b for a, b in zip(got, out))
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    cpu = torch.device("cpu")
    assert all(a is b for a, b in
               zip(_outputs(out, 2, 16, 64, 8, 32, cpu), out))
    with pytest.raises(ValueError):
        _outputs(out, 2, 16, 64, 8, 16, cpu)        # S of another group
    with pytest.raises(ValueError):
        _outputs((out[0].transpose(1, 2), *out[1:]), 2, 16, 64, 8, 32, cpu)


@pytest.mark.parametrize("bs", [1, 16])
def test_paged_rows_equal_the_per_layer_formula(bs):
    """``layers.paged_rows`` (once per step) against the per-layer formula
    it replaces, with two done lanes pointed at the sink block 0 at their
    clamped position max_len − 1."""
    rng = np.random.default_rng(bs)
    B, Hkv, ML = 6, 2, 32
    nblk, NB = ML // bs, 6 * (ML // bs) + 1
    bt = rng.permutation(np.arange(1, NB))[:B * nblk].reshape(B, nblk)
    pos = rng.integers(0, ML, size=B)
    bt[4:], pos[4:] = SINK, ML - 1
    bt, pos = torch.from_numpy(bt.astype(np.int32)), torch.from_numpy(
        pos.astype(np.int32))
    blk = torch.clamp(pos // bs, 0, bt.shape[1] - 1)        # layers.py, PR 16
    phys = bt.gather(1, blk.long()[:, None])
    h = torch.arange(Hkv)
    want = ((phys * Hkv + h) * bs + (pos % bs).long()[:, None]).reshape(-1)
    got = tlayers.paged_rows(pos, bt, Hkv, bs)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert bool((got[4 * Hkv:] < Hkv * bs).all())          # the sink block
    assert len(set(got[:4 * Hkv].tolist())) == 4 * Hkv


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("paged", [False, True])
def test_block_leaves_the_state_where_decode_many_does(cpu_params, paged,
                                                       temperature):
    """A runner block (the eager loop on the CPU) against ``decode_many`` on
    clones of the same state and generator: the same tokens, and the carry
    copied back into the runner's own tensors."""
    kw = dict(kv_paged=True, kv_block_size=8) if paged else {}
    eng = _engine(CPU_CFG, cpu_params, _policy(), "cpu",
                  temperature=temperature,
                  generator=torch.Generator().manual_seed(5), **kw)
    for p in _prompts(6, 2, CPU_CFG.vocab):
        eng.submit(p, max_new=12)
    eng.admit()
    r = eng.runner
    for _ in range(2):
        snap = _snapshot(r)
        want, carry = _eager(eng, eng.decode_params, snap, carry=True)
        got = r.block(eng.decode_params).numpy()
        assert np.array_equal(got, want)
        st, gen = snap[0], snap[-1]
        for a, b in zip((r.cur_tok, r.pos, r.done, r.remaining), carry):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(r.state),
                                                     _leaves(st)))
        assert torch.equal(r.generator.get_state(), gen.get_state())
    assert r.compiled_programs == 0


def test_session_keeps_its_own_copy(cpu_params):
    """CalibrationSession.update never keeps the caller's tensors (on the
    card they are a prefill graph's outputs, which its next replay
    overwrites): writing into them after an update changes nothing."""
    from repro_torch.quant import CalibrationSession
    toks = torch.from_numpy(np.asarray(_prompts(3, 2, CPU_CFG.vocab, 8, 9),
                                       np.int64))
    mine = tlm.prefill(CPU_CFG, cpu_params, {"tokens": toks}, 16)[2]
    want = [t.clone() for t in _leaves(mine)]
    s = CalibrationSession()
    s.update(mine, 16.0)
    for t in _leaves(mine):
        t.fill_(-1.0)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(s.stats), want))
    s.update(mine, 16.0)
    assert all(torch.equal(a, b - 1.0) for a, b in zip(_leaves(s.stats),
                                                       want))


# -------------------------------------------------------------- on a card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured only there")
    kbuild.lib()
    return torch.device("cuda")


@pytest.fixture
def gpu_params(cuda):
    return tlm.init_params(GPU_CFG, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)


@contextlib.contextmanager
def _shadowed(eng):
    """Hold every ``decode_block`` of ``eng`` to an eager ``decode_many`` (a
    speculative block: ``speculate_many``) on clones of the state it started
    from: the same tokens, valid and done flags, bit for bit.  Yields the
    count of blocks held."""
    r = eng.runner
    real = r.decode_block
    seen = {"blocks": 0}

    def run(params, draft=None, small_chunk=False):
        snap = _snapshot(r)
        poison = None if r._poison is None else r._poison.clone()
        toks, valid, done, fault = real(params, draft, small_chunk)
        want = _eager(eng, params, snap,
                      draft=draft if r.W > 0 and not small_chunk else None,
                      K=1 if small_chunk else None, poison=poison)
        C = toks.shape[1]
        assert np.array_equal(toks, want[:, :C])
        assert np.array_equal(valid, want[:, C:2 * C].astype(bool))
        assert np.array_equal(done, want[:, 2 * C].astype(bool))
        if fault is not None:
            assert np.array_equal(fault, want[:, 2 * C + 1].astype(bool))
        seen["blocks"] += 1
        return toks, valid, done, fault
    r.decode_block = run
    try:
        yield seen
    finally:
        del r.decode_block


CASES = {
    "int8 KV": dict(policy=dict(kv="int8")),
    "int4 KV": dict(policy=dict(kv="int4")),
    "paged pool": dict(policy=dict(kv="int8"),
                       engine=dict(kv_paged=True, kv_block_size=16)),
    "temperature 0.7": dict(policy=dict(kv="int8"),
                            engine=dict(temperature=0.7), generator=7),
    "preemption": dict(policy=dict(kv="int8"),
                       engine=dict(kv_paged=True, kv_block_size=16,
                                   kv_pool_blocks=7)),
    "low rank, gate, double buffer": dict(
        policy=dict(kv="int8", rank=16),
        engine=dict(requant_threshold=0.05, double_buffer=True)),
}


@pytest.mark.gpu
def test_requant_lands_in_the_previous_tree_on_the_card(gpu_params, cuda):
    """The same through the ``ttq_quantize`` kernel, writing its codes, S and
    Z into the earlier tree's storage."""
    kbuild.reset_launches()
    _requant_in_place(GPU_CFG, gpu_params, _policy(), cuda)
    assert kbuild.LAUNCHES["ttq_quantize"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_graph_tokens_equal_eager(gpu_params, cuda, case):
    c = CASES[case]
    kw = dict(c.get("engine", {}))
    if "generator" in c:
        kw["generator"] = torch.Generator(device=cuda).manual_seed(
            c["generator"])
    eng = _engine(GPU_CFG, gpu_params, _policy(**c["policy"]), cuda,
                  max_slots=3, **kw)
    rids = [eng.submit(p, max_new=20)
            for p in _prompts(8, 6, GPU_CFG.vocab, 5, 30)]
    with _shadowed(eng) as seen:
        out = eng.run_all()
    assert all(len(out[i]) == 20 and not out[i].unfinished for i in rids)
    assert seen["blocks"] >= 8 and eng.n_requants >= 2
    r = eng.runner
    assert eng.compiled_programs == len(r._graphs) + len(r._prefills)
    if eng.ecfg.double_buffer:                # one decode graph per tree
        assert 1 <= len(r._graphs) <= 2
    else:                                     # every requant landed in place
        assert len(r._graphs) == 1
    if case == "preemption":
        assert eng.preemptions > 0
        eng.allocator.assert_quiescent()


@pytest.mark.gpu
def test_graph_through_the_first_requant(gpu_params, cuda):
    """Blocks on the full-precision tree before the first requant, then on
    the quantized one: one graph each, tokens equal to eager in both."""
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, recalibrate_every=2)
    prompts = _prompts(9, 4, GPU_CFG.vocab, 5, 30)
    eng.submit(prompts[0], max_new=24)
    with _shadowed(eng) as seen:
        for _ in range(3):
            assert eng.step()
        assert eng.n_requants == 0 and len(eng.runner._graphs) == 1
        for p in prompts[1:]:
            eng.submit(p, max_new=12)
        eng.run_all()
    assert eng.n_requants >= 1 and len(eng.runner._graphs) == 2
    assert seen["blocks"] >= 6


@pytest.mark.gpu
def test_requant_between_blocks_and_the_stale_graph(gpu_params, cuda):
    """A requant between two blocks lands in the captured tree, so the next
    replay reads the new weights.  The trap it avoids: a tree at new
    storage replayed through the old graph decodes the OLD weights; the
    runner instead captures anew for the new layout."""
    pol = _policy()
    eng = _engine(GPU_CFG, gpu_params, pol, cuda)
    for p in _prompts(10, 2, GPU_CFG.vocab, 5, 30):
        eng.submit(p, max_new=40)
    eng.admit()
    r = eng.runner
    with _shadowed(eng):
        assert eng.step() and eng.step()                # capture, replay
        toks = torch.from_numpy(np.asarray(_prompts(11, 2, GPU_CFG.vocab,
                                                    16, 17), np.int64))
        stats = tlm.prefill(GPU_CFG, gpu_params, {"tokens": toks.to(cuda)},
                            64)[2]
        eng.qmodel.calibrate(stats, 1e4)
        eng._requantize()                               # in place
        assert eng.step()
    assert len(r._graphs) == 1
    # the trap: other weights at new storage, through the captured graph
    other = tlm.init_params(GPU_CFG, torch.Generator(device=cuda)
                            .manual_seed(1), device=cuda)
    s, count = eng.qmodel.session.as_calib()
    new_tree = FusedRequantPlan(other, s, pol).run(other, s, count)
    snap = _snapshot(r)
    want_old = _eager(eng, eng.decode_params, _snapshot(r))
    want_new = _eager(eng, new_tree, _snapshot(r))
    assert not np.array_equal(want_old, want_new)
    (stale,) = r._graphs.values()
    stale.graph.replay()
    assert np.array_equal(stale.out.cpu().numpy(), want_old)
    for dst, src in zip((r.state, r.cur_tok, r.pos, r.done, r.remaining),
                        snap):
        _copy_into(dst, src)
    got = r.block(new_tree).cpu().numpy()               # a new layout
    assert np.array_equal(got, want_new) and len(r._graphs) == 2


@pytest.mark.gpu
def test_compiled_programs_flat_with_requants(gpu_params, cuda):
    """The port of tests/test_runtime_guards.py:124-129: no decode graph is
    added from the first decode block to the end of a run that requantizes
    after every admission, one prefill graph is held per admission shape,
    and a rerun of the same traffic adds no program at all."""
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda)
    prompts = _prompts(12, 6, GPU_CFG.vocab, 5, 30)
    for p in prompts:
        eng.submit(p, max_new=10)
    assert eng.step()
    req = eng.n_requants
    eng.run_all()
    r = eng.runner
    assert len(r._graphs) == 1 and eng.n_requants >= req + 2
    assert len(r._prefills) == len(r.prefill_capture_s) >= 1
    cold = eng.compiled_programs
    assert cold == 1 + len(r._prefills)
    for p in prompts:
        eng.submit(p, max_new=10)
    eng.run_all()
    assert eng.compiled_programs == cold


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_replays_count_launches_and_sync_nothing(gpu_params, cuda, paged):
    """N replays add N times an eager block's kernel launches to
    ``build.LAUNCHES``, and a replay syncs nothing with the host."""
    kw = dict(kv_paged=True, kv_block_size=16) if paged else {}
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, **kw)
    for p in _prompts(13, 2, GPU_CFG.vocab, 5, 30):
        eng.submit(p, max_new=60)
    eng.admit()
    r = eng.runner
    r.decode_block(eng.decode_params)                   # warm + capture
    kbuild.reset_launches()
    _eager(eng, eng.decode_params, _snapshot(r))
    per_block = dict(kbuild.LAUNCHES)
    attn = "ttq_paged_decode_attention" if paged else "ttq_decode_attention"
    assert per_block["ttq_gemm"] == r.K * GPU_CFG.n_layers * 7
    assert per_block[attn] == r.K * GPU_CFG.n_layers
    kbuild.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            r.block(eng.decode_params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kbuild.LAUNCHES == {k: 3 * n for k, n in per_block.items()}
    assert len(r._graphs) == 1


# ------------------------------------------------------- the prefill graph

def _tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _kv_equal(eng, a, b):
    """Decode states equal, but a paged pool's sink block 0 (pad rows and
    done lanes write there in an unspecified order; never read unmasked)."""
    if not eng.runner.paged:
        return _tree_equal(a, b)
    return torch.equal(a["block_table"], b["block_table"]) and all(
        torch.equal(x[:, 1:], y[:, 1:])
        for x, y in zip(_leaves(a["stack"]), _leaves(b["stack"])))


@contextlib.contextmanager
def _prefill_shadowed(eng):
    """Hold every admission of ``eng`` to the eager prefill body on clones
    of the state and generator it started from: first tokens, statistics
    and every state leaf after the writes (a paged pool's but its sink
    block), bit for bit.  Yields counts of admissions that captured and
    that replayed."""
    r = eng.runner
    real = r.admit_group
    seen = {"captured": 0, "replayed": 0}

    def run(params, group):
        snap = _snapshot(r)
        n = len(r._prefills)
        first, fin, stats = real(params, group)
        st, gen = snap[0], snap[-1]
        inp = {k: torch.from_numpy(v).to(r.device)
               for k, v in r._prefill_inputs(group).items()}
        want, want_stats = r._prefill(params, st, inp, group.prefix_len, gen)
        assert np.array_equal(first, want.cpu().numpy())
        assert _tree_equal(stats, want_stats)
        assert _kv_equal(eng, r.state, st)
        seen["captured" if len(r._prefills) > n else "replayed"] += 1
        return first, fin, stats
    r.admit_group = run
    try:
        yield seen
    finally:
        del r.admit_group


def _prefix_prompts(seed, n, vocab, prefix=16):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, size=prefix).tolist()
    return [head + t for t in _prompts(seed + 1, n, vocab, 5, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged prefix"])
def test_prefill_graph_equals_eager(gpu_params, cuda, paged, temperature):
    """Every admission's prefill graph (captured, then replayed at the same
    key) against the eager prefill; paged traffic shares a one-block
    prefix, so tail prefills over a gathered prefix are among them."""
    kw = dict(kv_paged=True, kv_block_size=16) if paged else {}
    gen = torch.Generator(device=cuda).manual_seed(17)
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, max_slots=2,
                  temperature=temperature, generator=gen, **kw)
    prompts = (_prefix_prompts(18, 8, GPU_CFG.vocab) if paged
               else _prompts(18, 8, GPU_CFG.vocab, 5, 30))
    for p in prompts:
        eng.submit(p, max_new=6)
    with _prefill_shadowed(eng) as seen:
        eng.run_all()
    assert seen["captured"] >= 1 and seen["replayed"] >= 1
    if paged:
        assert eng.allocator.prefix_hits > 0
        eng.allocator.assert_quiescent()


@pytest.mark.gpu
def test_second_admission_at_a_key_replays(gpu_params, cuda):
    """Two admissions of the same shape: the first captures, the second
    writes its inputs into the graph's buffers and replays."""
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, max_slots=2)
    r = eng.runner
    replays = []
    real = r._replay
    r._replay = lambda g: replays.append(g) or real(g)
    a, b = _prompts(19, 2, GPU_CFG.vocab, 9, 10)
    eng.submit(a, max_new=3)
    eng.run_all()
    assert len(r._prefills) == 1 and not any(
        g in r._prefills.values() for g in replays)
    captured = dict(r.prefill_capture_s)
    eng.submit(b, max_new=3)
    eng.run_all()
    (g,) = r._prefills.values()
    assert replays.count(g) == 1 and r.prefill_capture_s == captured


@pytest.mark.gpu
def test_session_stats_survive_the_next_prefill_replay(gpu_params, cuda):
    """The statistics a replay returns are its graph's outputs, which the
    next replay at the key overwrites: a session whose first update came
    from a replay must hold its own copy."""
    from repro_torch.quant import CalibrationSession
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, max_slots=2,
                  recalibrate_every=100)
    r = eng.runner
    prompts = _prompts(20, 3, GPU_CFG.vocab, 9, 10)    # one admission key
    eng.submit(prompts[0], max_new=2)
    eng.run_all()                                      # captures
    eng.qmodel.session = CalibrationSession()
    eng.submit(prompts[1], max_new=2)
    eng.run_all()                                      # a replay: update 1
    (g,) = r._prefills.values()
    held = _clone(eng.qmodel.session.stats)
    assert _tree_equal(held, g.out[1])
    eng.submit(prompts[2], max_new=2)
    eng.run_all()                                      # overwrites g.out
    want = {"stack": [{k: held["stack"][0][k] + v for k, v in
                       g.out[1]["stack"][0].items()}]}
    assert not _tree_equal(held, g.out[1])
    assert _tree_equal(eng.qmodel.session.stats, want)


def _written(tree):
    return {t.data_ptr() for q in _qts(tree).values() for t in
            (getattr(q, f) for f in FIELDS) if t is not None}


@pytest.mark.gpu
def test_double_buffer_requant_never_writes_the_tree_decode_reads(
        gpu_params, cuda):
    """Under the double buffer, a requant writes the tree decode is not
    reading: the serving tree's codes, S, Z and 1/D are unchanged and its
    captured graph still decodes what eager decode does on it; the two
    trees share no written storage, and each gets its own decode graph."""
    eng = _engine(GPU_CFG, gpu_params, _policy(rank=16), cuda,
                  double_buffer=True, requant_threshold=0.0)
    prompts = _prompts(21, 6, GPU_CFG.vocab, 5, 30)
    for p in prompts[:2]:
        eng.submit(p, max_new=40)
    assert eng.step() and eng.step()                # tree A serves
    qm, r = eng.qmodel, eng.runner
    a = eng.decode_params
    held = _clone([getattr(q, f) for q in _qts(a).values() for f in FIELDS
                   if getattr(q, f) is not None])
    toks = torch.from_numpy(np.asarray(_prompts(22, 2, GPU_CFG.vocab, 16, 17),
                                       np.int64))
    stats = tlm.prefill(GPU_CFG, gpu_params, {"tokens": toks.to(cuda)}, 64)[2]
    qm.calibrate(stats, 1e4)
    b = qm.requantize(threshold=0.0)                # into B, side stream
    assert b is not a and qm._pending is b
    lanes = _snapshot(r)[:-1]
    with _shadowed(eng):
        assert r.decode_block(a)                    # a replay reading A
    torch.cuda.synchronize()
    for dst, src in zip((r.state, r.cur_tok, r.pos, r.done, r.remaining),
                        lanes):                     # as the scheduler left it
        _copy_into(dst, src)
    now = [getattr(q, f) for q in _qts(a).values() for f in FIELDS
           if getattr(q, f) is not None]
    assert all(torch.equal(x, y) for x, y in zip(now, held))
    assert not _written(a) & _written(b)
    assert eng.decode_params is b                   # ready → swapped
    with _shadowed(eng):
        for p in prompts[2:]:
            eng.submit(p, max_new=10)
        eng.run_all()
    assert eng.n_requants >= 4 and len(r._graphs) == 2
    trees = {id(t) for t in (qm.qparams, qm._spare, qm._pending)
             if t is not None}
    assert trees == {id(a), id(b)}


# ------------------------------------------------- speculation on the card

SPEC_CASES = {
    "int8 KV": dict(policy=dict(kv="int8")),
    "int4 KV": dict(policy=dict(kv="int4")),
    "paged pool": dict(policy=dict(kv="int8"),
                       engine=dict(kv_paged=True, kv_block_size=16)),
    "draft only": dict(policy=None, engine=dict(kv_dtype="int8")),
    "low rank, gate, double buffer": dict(
        policy=dict(kv="int8", rank=16),
        engine=dict(requant_threshold=0.05, double_buffer=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_graph_tokens_equal_eager(gpu_params, cuda, case):
    """Every speculative block is one replay of a graph keyed by both
    trees' layouts (two under the double buffer: the trees swap together),
    with tokens, valid and done flags bit for bit those of an eager
    ``speculate_many`` on clones of its starting state; rerunning the
    traffic adds no speculative graph."""
    from repro_torch.core import NO_QUANT
    c = SPEC_CASES[case]
    if c["policy"] is None:                  # bf16 weights, int4 draft
        pol = NO_QUANT.with_(kernel=KernelConfig(use_pallas=True))
        draft = _policy()
    else:
        pol, draft = _policy(**c["policy"]), None
    eng = TTQEngine(GPU_CFG, gpu_params, pol, EngineConfig(
        max_slots=3, max_len=64, decode_chunk=2, guards=False,
        prompt_buckets=(16, 32, 64), speculate_k=3, **c.get("engine", {})),
        device=cuda, draft_policy=draft)
    prompts = _prompts(18, 6, GPU_CFG.vocab, 5, 30)
    kbuild.reset_launches()
    with _shadowed(eng) as seen:
        rids = [eng.submit(p, max_new=20) for p in prompts]
        out = eng.run_all()
    assert all(len(out[i]) == 20 and not out[i].unfinished for i in rids)
    assert seen["blocks"] >= 4 and eng.spec_windows > 0
    assert kbuild.LAUNCHES["ttq_gemm"] > 0
    r = eng.runner
    n_graphs = len(r._graphs)
    assert 1 <= n_graphs <= (2 if eng.ecfg.double_buffer else 1)
    # a rerun may add prefill graphs only for tails past a prefix the first
    # run left in the paged pool's cache; a second rerun adds nothing
    shapes = {k[0] for k in r._prefills}
    for _ in range(2):
        programs = eng.compiled_programs
        rids = [eng.submit(p, max_new=20) for p in prompts]
        eng.run_all()
    assert eng.compiled_programs == programs and len(r._graphs) == n_graphs
    assert all(pfx > 0 for *_, pfx in {k[0] for k in r._prefills} - shapes)


@pytest.mark.gpu
def test_ttq_gemm_at_the_verify_width(cuda):
    """``ttq_gemm`` at T = 16 (4 slots × a window of 4) against its plain
    version: within one bf16 rounding (rtol 2^-7) and the f32 sums' order
    (atol 2e-4·√(d/256))."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=cuda).manual_seed(5)
    for dp, d in ((512, 256), (256, 512)):
        W = torch.randn((dp, d), generator=g, device=cuda)
        D = torch.rand((d,), generator=g, device=cuda) + 0.5
        pk, S, Z = ops.ttq_quantize(W, D, bits=4, group_size=32)
        x = torch.randn((4, 4, d), generator=g, device=cuda).to(torch.bfloat16)
        y = ops.ttq_gemm(x, pk, S, Z, 1.0 / D, bits=4, group_size=32)
        want = ref.ttq_gemm_ref(x.reshape(16, d), pk, S, Z, bits=4,
                                group_size=32, dinv=1.0 / D)
        torch.testing.assert_close(y.reshape(16, dp).float(),
                                   want.to(torch.bfloat16).float(),
                                   rtol=2 ** -7,
                                   atol=2e-4 * (d / 256) ** 0.5)


@pytest.mark.gpu
def test_gptq_on_the_card_matches_the_cpu(cuda):
    """The column-serial GPTQ at d = 512 on the card against the CPU: the
    same f32 algorithm on two devices, whose inverse and Cholesky differ in
    the last bits.  At least 99% of the weights within rtol 1e-3 / atol
    1e-4 (a value near a rounding tie may take the other code, and its row
    then carries another error forward), and the activation-aware error
    ‖X(W − Ŵ)ᵀ‖² within 1% of the CPU's."""
    from repro_torch.core import QuantConfig, gptq_qdq
    rng = np.random.default_rng(11)
    W = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((1024, 512)).astype(np.float32))
    cfg = QuantConfig(bits=4, group_size=32)
    want = gptq_qdq(W, X, cfg)
    got = gptq_qdq(W.to(cuda), X.to(cuda), cfg).cpu()
    close = torch.isclose(got, want, rtol=1e-3, atol=1e-4)
    assert close.float().mean() >= 0.99
    err = lambda Q: float(((X @ (W - Q).T) ** 2).sum())
    assert abs(err(got) - err(want)) <= 1e-2 * err(want)


# ------------------------------------------- guards, K = 1, chunks, server

@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_guarded_graph_block_equals_eager(gpu_params, cuda, paged):
    """Guards on (the default): every block, a replay of the guarded
    graph, bit for bit the eager guarded block (tokens, valid, done and
    fault flags), one host transfer per block."""
    kw = dict(kv_paged=True, kv_block_size=16) if paged else {}
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, max_slots=3,
                  guards=True, **kw)
    rids = [eng.submit(p, max_new=12)
            for p in _prompts(30, 5, GPU_CFG.vocab, 5, 30)]
    with _shadowed(eng) as seen:
        out = eng.run_all()
    assert all(len(out[i]) == 12 and not out[i].error for i in rids)
    assert seen["blocks"] >= 4 and eng.runner.detect_faults


@pytest.mark.gpu
def test_poison_between_replays_fails_one_lane(gpu_params, cuda):
    """``set_poison`` writes the static mask in place: the next replay of
    the captured graph sees it and faults only that lane, whose output is
    dropped; the other lane's tokens equal the eager unpoisoned block's."""
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, guards=True,
                  recalibrate_every=100)
    for p in _prompts(31, 2, GPU_CFG.vocab, 9, 10):
        eng.submit(p, max_new=30)
    eng.admit()
    r = eng.runner
    params = eng.decode_params
    r.decode_block(params)                          # warm + capture
    (g,) = r._graphs.values()
    snap = _snapshot(r)
    want = _eager(eng, params, snap)                # unpoisoned
    r.set_poison([1])
    toks, valid, done, fault = r.decode_block(params)
    assert len(r._graphs) == 1 and list(fault) == [False, True]
    C = toks.shape[1]
    assert np.array_equal(toks[0], want[0, :C]) and not valid[1].any()
    assert bool(done[1])
    r.set_poison([])
    assert not r._poison.any()


@pytest.mark.gpu
def test_k1_graph_is_captured_once(gpu_params, cuda):
    """Rung 2's K = 1 block is its own graph, keyed apart from the K-step
    one, captured at the first climb and replayed at every later one."""
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, guards=True,
                  recalibrate_every=100)
    for p in _prompts(32, 2, GPU_CFG.vocab, 9, 10):
        eng.submit(p, max_new=40)
    eng.admit()
    r = eng.runner
    params = eng.decode_params
    with _shadowed(eng) as seen:
        for small in (False, True, False, True, True, False, True):
            r.decode_block(params, small_chunk=small)
    keys = sorted(k[0] for k in r._graphs)
    assert keys == [1, r.K] and seen["blocks"] == 7
    assert eng.compiled_programs == 2 + len(r._prefills)


def _chunk_shadowed(eng):
    """Hold every chunk replay to the eager chunk body on a clone of the
    state it started from: last-row logits, statistics and every state
    leaf after the writes, bit for bit."""
    r = eng.runner
    real = r._replay
    seen = {"replayed": 0}

    def replay(g):
        if g not in r._chunks.values():
            return real(g)
        snap = _clone(r.state)
        last, stats = real(g)
        start = next(k[1] for k, v in r._chunks.items() if v is g)
        inp = {k: v.clone() for k, v in g.inputs.items()}
        want_last, want_stats = r._chunk(eng.params, snap, inp, start)
        assert torch.equal(last, want_last)
        assert _tree_equal(stats, want_stats)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(r.state),
                                                     _leaves(snap)))
        seen["replayed"] += 1
        return last, stats
    r._replay = replay
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunk_replay_equals_eager(gpu_params, cuda, paged):
    """Chunked prefill on the card: each chunk a replay of the graph of
    (C, start, tree layout), bit for bit the eager chunk; tokens equal the
    unchunked engine's; compiled programs flat over a warm rerun."""
    kw = dict(kv_paged=True, kv_block_size=16) if paged else {}
    prompts = _prompts(33, 4, GPU_CFG.vocab, 20, 60)
    outs = []
    for chunk in (0, 16):
        eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, guards=True,
                      max_len=128, prefill_chunk=chunk,
                      recalibrate_tokens=10**9, **kw)
        seen = _chunk_shadowed(eng)
        got = []
        for _ in range(2):                           # cold, then warm
            rids = [eng.submit(p, max_new=8) for p in prompts]
            res = eng.run_all()
            got.append([list(res[i]) for i in rids])
            programs = eng.compiled_programs
        assert got[0] == got[1] and eng.compiled_programs == programs
        outs.append(got[0])
        if chunk:
            assert eng.prefill_chunks > 4 and seen["replayed"] > 0
            assert len(eng.runner._chunks) >= 3
    assert outs[0] == outs[1]


def test_collector_paused_restores_its_state():
    """The capture window's pause of the cycle collector leaves it as it
    found it, on an exception too."""
    was = gc.isenabled()
    try:
        gc.enable()
        with pytest.raises(KeyError):
            with _collector_paused():
                assert not gc.isenabled()
                raise KeyError
        assert gc.isenabled()
        gc.disable()
        with _collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.gpu
def test_capture_survives_collecting_an_earlier_graph(gpu_params, cuda):
    """Graphs of an earlier engine that become cyclic garbage while a
    runner captures (an engine dropped by an earlier test holds such
    graphs): freeing a graph calls CUDA, which the capturing stream
    forbids, so the cycle collector must not run inside the capture
    window.  Here an engine serves two requests (its decode and prefill
    graphs captured and replayed), its graphs become garbage in a cycle
    inside a later capture, and allocations that stay alive make the
    collector run there at once (a threshold of 1).  The capture must
    succeed, its replay compute what the eager call does, and the graphs
    be freed after the capture, not inside it."""
    old = _engine(GPU_CFG, gpu_params, _policy(), cuda)
    for p in _prompts(35, 2, GPU_CFG.vocab, 5, 20):
        old.submit(p, max_new=9)
    old.run_all()
    gs = [*old.runner._graphs.values(), *old.runner._prefills.values()]
    freed = []
    for g in gs:
        weakref.finalize(g.graph, lambda: freed.append(
            torch.cuda.is_current_stream_capturing()))
    held = [gs]
    del gs, g
    old.runner._graphs.clear()
    old.runner._prefills.clear()
    x = torch.arange(8, dtype=torch.float32, device=cuda)
    r = _engine(GPU_CFG, gpu_params, _policy(), cuda).runner

    def body():
        if torch.cuda.is_current_stream_capturing() and held:
            box = [held.pop()]
            box.append(box)             # the graphs' last reference, a cycle
            del box
            junk = [[] for _ in range(4096)]    # kept alive: the collector
            del junk                            # runs on their count
        return x + 1
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        graphs = {}
        warm, _ = r._capture(body, graphs, "key")
    finally:
        gc.set_threshold(*threshold)
    assert not held and gc.isenabled()
    gc.collect()
    assert len(freed) >= 2 and not any(freed)
    x.add_(1)
    out = r._replay(graphs["key"])
    torch.cuda.synchronize()
    assert torch.equal(warm, torch.arange(1, 9, dtype=torch.float32,
                                          device=cuda))
    assert torch.equal(out, x + 1)


@pytest.mark.gpu
def test_server_captures_and_replays_on_its_worker(gpu_params, cuda):
    """``TTQServer`` drives the engine from its worker thread: every graph
    capture and replay happens there, and the streams equal the batch
    engine's tokens."""
    import asyncio
    import threading

    from repro_torch.serving import TTQServer
    prompts = _prompts(34, 4, GPU_CFG.vocab, 5, 40)
    kw = dict(guards=True, prefill_chunk=16, recalibrate_tokens=10**9,
              kv_paged=True, kv_block_size=16)
    batch = _engine(GPU_CFG, gpu_params, _policy(), cuda, **kw)
    rids = [batch.submit(p, max_new=6) for p in prompts]
    res = batch.run_all()
    want = [list(res[i]) for i in rids]
    eng = _engine(GPU_CFG, gpu_params, _policy(), cuda, **kw)
    r = eng.runner
    threads = set()
    real_capture, real_replay = r._capture, r._replay

    def capture(*a, **k):
        threads.add(threading.get_ident())
        return real_capture(*a, **k)

    def replay(g):
        threads.add(threading.get_ident())
        return real_replay(g)
    r._capture, r._replay = capture, replay

    async def main():
        async with TTQServer(eng) as server:
            async def stream(p):
                return [t async for t in server.generate(p, max_new=6)]
            got = await asyncio.gather(*[stream(p) for p in prompts])
            return got, server._thread.ident

    got, worker = asyncio.run(main())
    assert got == want
    assert threads == {worker} and worker != threading.get_ident()
    assert eng.compiled_programs > 0
    eng.allocator.assert_quiescent()


# the MoE family on the card: experts at widths the kernels take (llama4's
# kind: GQA attention, top-1 of 4 and a shared expert; deepseek's: MLA with
# a 128-wide latent, top-2 of 4 and two shared experts)
MOE_GPU = {
    "moe": ModelConfig(name="graph-moe", family="moe", n_layers=2,
                       d_model=256, n_heads=4, n_kv_heads=2, d_ff=256,
                       vocab=512, moe=MoECfg(n_experts=4, top_k=1,
                                             d_ff_expert=256, n_shared=1)),
    "mla": ModelConfig(name="graph-mla", family="moe", n_layers=2,
                       d_model=256, n_heads=4, n_kv_heads=4, d_ff=256,
                       vocab=512,
                       mla=MLACfg(kv_lora_rank=128, qk_nope_dim=32,
                                  qk_rope_dim=32, v_head_dim=32),
                       moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=256,
                                  n_shared=2)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MOE_GPU))
def test_moe_graph_tokens_equal_eager(cuda, name):
    """A MoE (and an MLA) engine's decode blocks are graph replays, each
    bit for bit the eager ``decode_many`` on clones of its state; the
    expert weights go through the batched ``ttq_gemm`` (3 launches per
    layer and step), the routing and its scatter stay on the device."""
    cfg = MOE_GPU[name]
    params = tlm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    eng = _engine(cfg, params, _policy(), cuda, max_slots=3)
    rids = [eng.submit(p, max_new=12)
            for p in _prompts(9, 5, cfg.vocab, 5, 30)]
    kbuild.reset_launches()
    with _shadowed(eng) as seen:
        out = eng.run_all()
    assert all(len(out[i]) == 12 and not out[i].unfinished for i in rids)
    assert seen["blocks"] >= 4 and len(eng.runner._graphs) == 1
    assert kbuild.LAUNCHES["ttq_gemm_experts"] > 0
    assert kbuild.LAUNCHES["ttq_gemm_experts"] % (3 * cfg.n_layers) == 0
    assert kbuild.LAUNCHES["ttq_gemm"] > 0
