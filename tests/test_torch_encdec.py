"""The encoder-decoder family (whisper-medium: an encoder over the stub
front end's frames, a decoder with cross-attention, learned positions) in
the port, against the JAX package, on the CPU.

Config: the reference's whisper smoke config (2 encoder and 2 decoder
layers, d 64, 4 heads of 16, gelu plain MLP 128, LayerNorm, learned
positions, 12 frames).  Weights come from the JAX package's
``lm.init_params`` carried across by ``params_from_jax``, every norm's
gamma and beta moved off its init value from a numpy seed.  Frames and
tokens are seeded.

Held: the config and the specs (``xdec`` decoder, ``enc`` encoder); the
init layout (``pos_embed``, ``enc_stack``, ``enc_norm``, ``xattn``);
``sinusoidal_pos``; ``attn_apply(x_cross=)`` and ``attn_decode(cross_kv=)``
in f32; an ``enc`` and an ``xdec`` layer bit for bit JAX's op by op;
``lm.forward`` logits and both stacks' statistics; prefill + decode
against ``forward`` on the appended tokens; the codes of both stacks (the
cross-attention's wk/wv on wq's statistics, as the reference joins them);
``TTQEngine`` greedy tokens against the JAX engine's by the near-tie rule;
each admission's own frames; the refusals; ``TTQServer`` and the CLI with
frames.  On the card (``gpu``): two admissions replaying one prefill graph
with different frames each give the eager results of their own frames,
and every decode block over the cross k/v is bit for bit eager.

Tolerances: f32 layer functions to rtol 1e-5.  bf16 model outputs against
the jitted JAX forward elementwise to rtol 1e-1 and atol ATOL = 0.12, and
to a relative L2 of 3e-2: on this config the jitted forward differs from
JAX's own op-by-op run by up to 0.055 in a logit, while the port equals the
op-by-op run bit for bit.  The near-tie bound is twice ATOL's measured gap:
a flip needs both logits to move."""
import asyncio
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get as t_get
from repro_torch.core import KernelConfig, unpack_bits
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import stack as TS
from repro_torch.models.common import sinusoidal_pos
from repro_torch.models.config import EncDecCfg as TEncDec
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.quant import FusedRequantPlan
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 3e-2
ATOL = 0.12
NEAR_TIE = 0.2
MAX_LEN = 48
MAX_NEW = 8


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get
    from repro.core import KVCacheConfig, ttq_policy
    from repro.models import common as C
    from repro.models import layers as L
    from repro.models import lm
    from repro.models import stack as JS
    from repro.quant.api import FusedRequantPlan as JPlan
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get=get, KV=KVCacheConfig, pol=ttq_policy, C=C,
        L=L, lm=lm, S=JS, Plan=JPlan, ECfg=EngineConfig, Eng=TTQEngine)


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TCfg)}
    kw["encdec"] = TEncDec(**dataclasses.asdict(jcfg.encdec))
    return TCfg(**kw)


def _perturb_norms(jx, params, seed):
    """Every norm's gamma and beta moved off its init value by N(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: (jx.jnp.asarray(np.asarray(v) + 0.2 * rng.standard_normal(
                np.shape(v)).astype(np.float32))
                if k in ("gamma", "beta") else go(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return t
    return go(params)


@pytest.fixture(scope="module")
def model(jx):
    jcfg = jx.get("whisper_medium", smoke=True)
    jp = _perturb_norms(jx, jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0)),
                        seed=19)
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, tcfg=_tcfg(jcfg), jp=jp, tp=tp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)


def _layer(tree, i=0):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_specs_equal_the_reference(jx, smoke):
    """whisper-medium field for field; the decoder one run of ``xdec``
    layers, the encoder one of ``enc`` layers, both with the plain MLP."""
    tc, jc = t_get("whisper_medium", smoke), jx.get("whisper_medium", smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    norm = lambda spec: [(tuple(k), n) for k, n in spec]  # noqa: E731
    assert TS.stack_spec(tc) == norm(jx.S.stack_spec(jc)) \
        == [(("xdec",), jc.n_layers)]
    assert TS.enc_spec(tc) == norm(jx.S.enc_spec(jc)) \
        == [(("enc",), jc.encdec.n_enc_layers)]
    for kind in ("enc", "xdec"):
        assert TS.mlp_kind(tc, kind) == jx.S.mlp_kind(jc, kind) == "plain"
    if not smoke:
        assert (tc.n_layers, tc.encdec.n_enc_layers, tc.d_model, tc.n_heads,
                tc.encdec.n_frames, tc.vocab) == (24, 24, 1024, 16, 1500,
                                                  51865)


def test_init_params_layout_matches_jax(jx, model):
    """The port's own init has the reference's tree (``pos_embed``,
    ``enc_stack``, ``enc_norm``, each decoder layer's ``lnx`` and
    ``xattn``), shapes and dtypes; learned positions N(0, 0.02²)."""
    jp = jx.jax.eval_shape(lambda k: jx.lm.init_params(model.jcfg, k),
                           jx.jax.random.PRNGKey(0))
    tp = tlm.init_params(model.tcfg, torch.Generator().manual_seed(0),
                         device="cpu")

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, path + (i,))
        else:
            yield path, t
    lj, lt = dict(leaves(jp)), dict(leaves(tp))
    assert lj.keys() == lt.keys()
    assert {"pos_embed", "enc_stack", "enc_norm"} <= set(tp)
    for k, a in lj.items():
        b = lt[k]
        assert tuple(a.shape) == tuple(b.shape), k
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), k
    assert abs(float(tp["pos_embed"].float().std()) - 0.02) < 2e-3


@pytest.mark.parametrize("n,d", [(12, 64), (1500, 1024)],
                         ids=["smoke", "whisper-medium"])
def test_sinusoidal_pos_matches_jax(jx, n, d):
    """The encoder's positions, bf16: bit for bit at the smoke config's
    (12, 64); at whisper-medium's (1500, 1024) within one bf16 step (atol
    2^-8) in at most 1e-4 of the entries: the two libraries' f32 sin and
    cos of angles up to 1,500 rad differ in their last bits, which moves
    a bf16 rounding now and then (36 of 1,536,000 entries)."""
    a = sinusoidal_pos(n, d).float().numpy()
    b = np.asarray(jx.C.sinusoidal_pos(n, d).astype(jx.jnp.float32))
    if n == 12:
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, b, rtol=0, atol=2 ** -8)
    assert (a != b).mean() <= 1e-4


# ------------------------------------------------------- cross-attention

def _xattn(jx, model):
    return (_layer(jx.jax.tree.map(np.asarray,
                                   model.jp["stack"][0]["u0"]["xattn"])),
            _layer(model.tp["stack"][0]["u0"]["xattn"]))


def test_cross_attn_apply_matches_jax_f32(jx, model):
    """``attn_apply(x_cross=)`` on f32 activations: every query over all
    12 encoder rows, no causal mask, no RoPE; the output, its stats taps
    (wq on the decoder input, wo) and the returned cross k/v."""
    jp, tp = _xattn(jx, model)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 12, 64)).astype(np.float32)
    sj, st = {}, {}
    yj, (kj, vj) = jx.L.attn_apply(model.jcfg, jp, jx.jnp.asarray(x), sj,
                                   "x.", x_cross=jx.jnp.asarray(enc),
                                   return_kv=True)
    yt, (kt, vt) = TL.attn_apply(model.tcfg, tp, torch.from_numpy(x), st,
                                 "x.", x_cross=torch.from_numpy(enc),
                                 return_kv=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    assert kt.shape == (2, 4, 12, 16)
    for a, b in ((kt, kj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert set(st) == set(sj) == {"x.wq", "x.wo"}
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   rtol=1e-5)


def test_cross_attn_decode_matches_jax_f32(jx, model):
    """``attn_decode(cross_kv=)``: one query per slot over the cached cross
    k/v through plain attention; the state comes back untouched."""
    jp, tp = _xattn(jx, model)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 4, 12, 16)).astype(np.float32)
            for _ in range(2))
    pos = np.asarray([3, 9], np.int32)
    yj, _ = jx.L.attn_decode(model.jcfg, jp, jx.jnp.asarray(x), None,
                             jx.jnp.asarray(pos),
                             cross_kv=(jx.jnp.asarray(k), jx.jnp.asarray(v)))
    state = {"k": torch.zeros(1)}
    yt, st = TL.attn_decode(model.tcfg, tp, torch.from_numpy(x), state,
                            torch.from_numpy(pos),
                            cross_kv=(torch.from_numpy(k),
                                      torch.from_numpy(v)))
    assert st is state
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("kind", ["enc", "xdec"])
def test_layer_equals_jax_op_by_op(jx, model, kind):
    """One layer on bf16 activations (an encoder layer over the 12 frames;
    a decoder layer at S = 9 attending over them, with its state): bit for
    bit the reference's ``apply_layer_seq`` run op by op, output and every
    state leaf (the self cache and the bf16 cross k/v)."""
    rng = np.random.default_rng(3)
    tree = "enc_stack" if kind == "enc" else "stack"
    S = 12 if kind == "enc" else 9
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 12, 64)).astype(np.float32)
    bf = lambda a: jx.jnp.asarray(a).astype(jx.jnp.bfloat16)  # noqa: E731
    pj = jx.jax.tree.map(lambda a: a[0], model.jp[tree][0]["u0"])
    want = kind == "xdec"
    yj, sj = jx.S.apply_layer_seq(model.jcfg, kind, pj, bf(x), None, "",
                                  enc_out=bf(enc), want_state=want,
                                  max_len=16)
    yt, st = TS.apply_layer_seq(model.tcfg, kind, _layer(model.tp[tree][0]
                                                         ["u0"]),
                                torch.from_numpy(x).to(torch.bfloat16), None,
                                "", enc_out=torch.from_numpy(enc).to(
                                    torch.bfloat16), want_state=want,
                                max_len=16)
    f32 = lambda a: np.asarray(a.astype(jx.jnp.float32))  # noqa: E731
    np.testing.assert_array_equal(yt.float().numpy(), f32(yj))
    if want:
        assert set(st) == set(sj) == {"k", "v", "xk", "xv"}
        for k in sj:
            np.testing.assert_array_equal(st[k].float().numpy(), f32(sj[k]))
    else:
        assert st is None and sj is None


def test_forward_matches_jax(jx, model):
    """``lm.forward`` logits (B, S, V) on frames and 11 tokens, and the
    stats of both stacks: against the jitted JAX forward within the stated
    tolerances."""
    toks, fr = _tokens(model.tcfg, 2, 11, seed=1), _frames(model.tcfg, 2, 2)
    lj, sj, _ = jx.lm.forward(model.jcfg, model.jp,
                              {"tokens": jx.jnp.asarray(toks),
                               "frames": jx.jnp.asarray(fr)},
                              collect_stats=True)
    lt, st, _ = tlm.forward(model.tcfg, model.tp,
                            {"tokens": torch.from_numpy(toks),
                             "frames": torch.from_numpy(fr)},
                            collect_stats=True)
    assert lt.shape == (2, 11, model.tcfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=ATOL)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    assert set(st) == set(sj) == {"stack", "enc_stack"}
    assert set(st["stack"][0]) == {"u0.mix.wq", "u0.mix.wo", "u0.xattn.wq",
                                   "u0.xattn.wo", "u0.mlp.w1", "u0.mlp.w2"}
    for tree in ("stack", "enc_stack"):
        a_run, b_run = sj[tree][0], st[tree][0]
        assert set(a_run) == set(b_run)
        for k in a_run:
            a, b = np.asarray(a_run[k]), b_run[k].numpy()
            assert a.shape == b.shape and _rel_l2(a, b) < REL_L2, (tree, k)


def test_prefill_decode_matches_forward(model):
    """prefill (the encoder, the decoder's self cache and cross k/v, the
    learned positions from 0), then 6 decode steps (learned positions per
    slot, cross-attention over the cached k/v) against ``forward`` on the
    appended tokens (the reference's tests/test_models_smoke.py:77
    tolerance); the state keeps ``enc_out``."""
    S, n = 10, 6
    toks = torch.from_numpy(_tokens(model.tcfg, 2, S, seed=3))
    fr = torch.from_numpy(_frames(model.tcfg, 2, 4))
    last, state, _ = tlm.prefill(model.tcfg, model.tp,
                                 {"tokens": toks, "frames": fr},
                                 max_len=S + n)
    assert state["enc_out"].shape == (2, 12, 64)
    assert state["stack"][0]["u0"]["xk"].shape == (2, 2, 4, 12, 16)
    new = torch.from_numpy(_tokens(model.tcfg, 2, n, seed=5))
    got = []
    for t in range(n):
        lg, _ = tlm.decode_step(model.tcfg, model.tp, state, new[:, t:t + 1],
                                torch.full((2,), S + t, dtype=torch.int32))
        got.append(lg)
    full, _, _ = tlm.forward(model.tcfg, model.tp,
                             {"tokens": torch.cat([toks, new], dim=1),
                              "frames": fr})
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                               rtol=8e-2, atol=8e-2)
    for t in range(n):
        np.testing.assert_allclose(got[t].numpy(), full[:, S + t].numpy(),
                                   rtol=8e-2, atol=8e-2)


# -------------------------------------------------------------------- codes

def test_both_stacks_codes_match_jax(jx, model):
    """The fused requant plan (TTQ int4 g32 packed) takes the encoder's
    linears as the reference does: the members and families equal the
    reference's across ``stack`` and ``enc_stack`` (xattn.wk and xattn.wv
    join xattn.wq's statistics, though their input is the encoder output:
    the reference's join, kept), and every member's codes equal except ±1
    at round-half ties, S, Z and 1/D within f32."""
    toks = jx.jnp.asarray(_tokens(model.jcfg, 2, 11, seed=4))
    fr = jx.jnp.asarray(_frames(model.jcfg, 2, 6))
    _, _, js = jx.lm.prefill(model.jcfg, model.jp,
                             {"tokens": toks, "frames": fr}, max_len=16)
    ts = params_from_jax(jx.jax.tree.map(np.asarray, js), device="cpu")
    count = float(toks.size)
    pol = dict(bits=4, group_size=32, rank=0, packed=True)
    jplan = jx.Plan(model.jp, js, jx.pol(**pol))
    plan = FusedRequantPlan(model.tp, ts, t_policy(
        **pol, kernel=KernelConfig(use_pallas=True)))
    fam = lambda p: sorted(sorted(m.path_str for m in ms)  # noqa: E731
                           for ms in p.families.values())
    assert fam(plan) == fam(jplan) and not jplan.eager
    members = {m.path_str for ms in plan.families.values() for m in ms}
    assert {"enc_stack.0.u0.mix.wq", "enc_stack.0.u0.mlp.w2",
            "stack.0.u0.xattn.wk"} <= members and len(members) == 16
    jq = jplan.run(model.jp, js, count)
    tq = plan.run(model.tp, ts, count)
    for ps in sorted(members):
        a, b = jq, tq
        for k in ps.split("."):
            a, b = (a[int(k)], b[int(k)]) if k.isdigit() else (a[k], b[k])
        a = jx.jax.tree.map(np.asarray, a)
        d = b.in_features
        ca = unpack_bits(torch.from_numpy(np.array(a.packed)), d, 4).numpy()
        cb = unpack_bits(b.packed, d, 4).numpy()
        diff = np.abs(ca.astype(np.int64) - cb.astype(np.int64))
        assert diff.max() <= 1 and (diff > 0).mean() <= 2e-3, ps
        np.testing.assert_allclose(b.dinv.numpy(), a.dinv, rtol=1e-6)
        np.testing.assert_allclose(b.scale.numpy(), a.scale, rtol=1e-5)
        np.testing.assert_allclose(b.zero.numpy(), a.zero, rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------------------- engine

PROMPTS = [[((7 * i + 3 * j) % 500) + 1 for i in range(n)]
           for j, n in enumerate((9, 14, 5))]


def _pol_kw():
    return dict(bits=4, group_size=32, rank=0, packed=True)


def _jax_logits_at(jx, model, jeng, prompt, frames, out, t):
    kv = jx.KV(dtype="int8")
    lg, state, _ = jx.lm.prefill(
        model.jcfg, model.jp, {"tokens": jx.jnp.asarray([list(prompt)],
                                                        jx.jnp.int32),
                               "frames": jx.jnp.asarray(frames[None])},
        max_len=MAX_LEN, kvcfg=kv)
    for i in range(t):
        lg, state = jx.lm.decode_step(
            model.jcfg, jeng.qparams, state,
            jx.jnp.asarray([[out[i]]], jx.jnp.int32),
            jx.jnp.asarray([len(prompt) + i], jx.jnp.int32), kvcfg=kv)
    return np.asarray(lg)[0]


def test_engine_matches_jax(jx, model):
    """Greedy tokens of both engines (int4 g32 packed weights, int8 KV on
    the self-attention, 2 slots, guards off) on 3 prompts, each with its
    own frames: equal, or equal up to a near-tie from the first
    disagreement on; requants equal."""
    frames = _frames(model.tcfg, 3, 8)
    ekw = dict(max_slots=2, max_len=MAX_LEN, decode_chunk=2, guards=False,
               prompt_buckets=(16, 32))
    jeng = jx.Eng(model.jcfg, model.jp,
                  jx.pol(**_pol_kw(), kvcache=jx.KV(dtype="int8")),
                  jx.ECfg(**ekw))
    jr = [jeng.submit(p, max_new=MAX_NEW, frames=f)
          for p, f in zip(PROMPTS, frames)]
    ja = jeng.run_all()
    teng = TEngine(model.tcfg, model.tp,
                   t_policy(**_pol_kw(), kvcache=TKV(dtype="int8"),
                            kernel=KernelConfig(use_pallas=True)),
                   TECfg(**ekw), device="cpu")
    tr = [teng.submit(p, max_new=MAX_NEW, frames=f)
          for p, f in zip(PROMPTS, frames)]
    tb = teng.run_all()
    assert jeng.n_requants == teng.n_requants
    for i, (p, f) in enumerate(zip(PROMPTS, frames)):
        a, b = list(ja[jr[i]]), list(tb[tr[i]])
        assert len(a) == len(b) == MAX_NEW
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is not None:
            lg = _jax_logits_at(jx, model, jeng, p, f, a, t)
            assert abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE, \
                (i, t, a[t], b[t])


def test_admissions_read_their_own_frames(model):
    """Two admissions of one prompt through the same prefill shape, with
    different frames: each request's tokens are those of a lone engine on
    its own frames (the runner stages each group's frames), and
    ``enc_out`` of each slot is its own encoder output."""
    fr = _frames(model.tcfg, 2, 9)
    kw = dict(max_slots=1, max_len=MAX_LEN, guards=False,
              prompt_buckets=(16,))
    pol = t_policy(**_pol_kw())
    eng = TEngine(model.tcfg, model.tp, pol, TECfg(**kw), device="cpu")
    outs = []
    for f in fr:
        r = eng.submit(PROMPTS[0], max_new=4, frames=f)
        outs.append(list(eng.run_all()[r]))
        enc, _ = tlm._encode(model.tcfg, model.tp, torch.from_numpy(f[None]))
        assert torch.equal(eng.state["enc_out"][0], enc[0])
    for f, got in zip(fr, outs):
        alone = TEngine(model.tcfg, model.tp, pol, TECfg(**kw), device="cpu")
        r = alone.submit(PROMPTS[0], max_new=4, frames=f[None])
        assert list(alone.run_all()[r]) == got
    assert outs[0] != outs[1]


def test_frames_are_required_and_checked(model):
    """An encoder-decoder request needs frames of (n_frames, d_model); a
    request of another family refuses them."""
    eng = TEngine(model.tcfg, model.tp, t_policy(rank=0),
                  TECfg(guards=False), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.submit(PROMPTS[0])
    with pytest.raises(ValueError, match="frames of shape"):
        eng.submit(PROMPTS[0], frames=np.zeros((11, 64), np.float32))
    cfg = t_get("gemma_7b", smoke=True)
    dense = TEngine(cfg, tlm.init_params(cfg, torch.Generator().manual_seed(0),
                                         device="cpu"),
                    t_policy(rank=0), TECfg(guards=False), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        dense.submit(PROMPTS[0], frames=np.zeros((12, 64), np.float32))


@pytest.mark.parametrize("kw,match", [
    (dict(kv_paged=True), "paged KV cache supports plain attention"),
    (dict(speculate_k=2), "speculate_k needs a plain-attention family"),
    (dict(prefill_chunk=16), "prefill_chunk needs a plain-attention family"),
], ids=["kv_paged", "speculate_k", "prefill_chunk"])
def test_encdec_misuse_raises(jx, model, kw, match):
    """The paged pool, speculation and chunked prefill on the
    encoder-decoder family fail with the reference's ValueError, on both
    engines."""
    with pytest.raises(ValueError, match=match):
        jx.Eng(model.jcfg, model.jp, jx.pol(rank=0), jx.ECfg(**kw))
    with pytest.raises(ValueError, match=match):
        TEngine(model.tcfg, model.tp, t_policy(rank=0), TECfg(**kw),
                device="cpu")


def test_server_streams_with_frames(model):
    """``TTQServer.generate(..., frames=)``: the streams equal the batch
    engine's tokens on the same frames."""
    from repro_torch.serving import TTQServer
    fr = _frames(model.tcfg, 3, 10)
    kw = dict(max_slots=2, max_len=MAX_LEN, guards=False)
    batch = TEngine(model.tcfg, model.tp, t_policy(**_pol_kw()), TECfg(**kw),
                    device="cpu")
    rids = [batch.submit(p, max_new=5, frames=f)
            for p, f in zip(PROMPTS, fr)]
    res = batch.run_all()
    want = [list(res[r]) for r in rids]
    eng = TEngine(model.tcfg, model.tp, t_policy(**_pol_kw()), TECfg(**kw),
                  device="cpu")

    async def main():
        async with TTQServer(eng) as server:
            async def stream(p, f):
                return [t async for t in server.generate(p, max_new=5,
                                                         frames=f)]
            return await asyncio.gather(*[stream(p, f)
                                          for p, f in zip(PROMPTS, fr)])
    assert asyncio.run(main()) == want


def test_cli_serves_the_encdec_family(capsys):
    """``python -m repro_torch.launch.serve --arch whisper_medium --smoke
    --device cpu`` serves its requests with frames from the seed;
    ``--kv-paged`` fails with the reference's message."""
    from repro_torch.launch import serve
    base = ["--arch", "whisper_medium", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--max-len", "48"]
    eng, outs = serve.main(base)
    assert len(outs) == 3 and all(len(v) == 4 for v in outs.values())
    assert "arch=whisper-smoke requests=3 tokens=12" in capsys.readouterr().out
    with pytest.raises(ValueError, match="paged KV cache supports plain"):
        serve.main(base + ["--kv-paged"])


# ------------------------------------------------------------- on the card

GPU_CFG = TCfg(name="encdec-gpu", family="encdec", n_layers=2, d_model=256,
               n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512, vocab=512,
               act="gelu", mlp="plain", norm="layer", pos="learned",
               max_seq=128, encdec=TEncDec(n_enc_layers=2, n_frames=48))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels and graphs run only there")
    from repro_torch.kernels import build
    build.lib()
    return torch.device("cuda")


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_clone(v) for v in t]
    return t.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.gpu
def test_frames_in_the_prefill_graph(cuda):
    """On the card (int4 g32 packed weights, int8 self-attention KV, guards
    on): one prompt admitted twice at one prefill shape with different
    frames — the second admission replays the graph the first captured,
    and its first token, statistics and every state leaf (cross k/v and
    ``enc_out`` included) equal the eager prefill's on its own frames, bit
    for bit; every decode block over the cross k/v equals the eager loop's
    tokens; the two admissions leave different cross k/v."""
    params = tlm.init_params(GPU_CFG, torch.Generator(device=cuda)
                             .manual_seed(0), device=cuda)
    pol = t_policy(**_pol_kw(), kvcache=TKV(dtype="int8"),
                   kernel=KernelConfig(use_pallas=True))
    eng = TEngine(GPU_CFG, params, pol,
                  TECfg(max_slots=1, max_len=64, decode_chunk=4,
                        prompt_buckets=(16,), recalibrate_tokens=10 ** 9),
                  device=cuda)
    r = eng.runner
    real_block, real_admit = r.decode_block, r.admit_group
    seen = {"blocks": 0, "replays": 0}

    def block(p, draft=None, small_chunk=False):
        snap = (_clone(r.state), r.cur_tok.clone(), r.pos.clone(),
                r.done.clone(), r.remaining.clone())
        toks, valid, done, fault = real_block(p, draft, small_chunk)
        ys, _ = tlm.decode_many(GPU_CFG, p, *snap, None, K=r.K, max_len=64,
                                kvcfg=eng.kvcfg, kcfg=eng.kncfg,
                                detect_faults=True)
        assert np.array_equal(toks, ys[0].cpu().numpy())
        seen["blocks"] += 1
        return toks, valid, done, fault

    def admit(p, group):
        snap, n = _clone(r.state), len(r._prefills)
        first, fin, stats = real_admit(p, group)
        if len(r._prefills) == n:
            inp = {k: torch.from_numpy(v).to(cuda)
                   for k, v in r._prefill_inputs(group).items()}
            want, want_stats = r._prefill(p, snap, inp, 0, None)
            assert np.array_equal(first, want.cpu().numpy())
            assert all(torch.equal(a, b) for a, b in zip(
                _leaves(stats), _leaves(want_stats)))
            assert all(torch.equal(a, b) for a, b in zip(
                _leaves(r.state), _leaves(snap)))
            seen["replays"] += 1
        return first, fin, stats
    r.decode_block, r.admit_group = block, admit
    fr = np.random.default_rng(11).standard_normal(
        (2, 48, 256)).astype(np.float32)
    xk = []
    for f in fr:
        rid = eng.submit(PROMPTS[1], max_new=8, frames=f)
        assert len(eng.run_all()[rid]) == 8
        xk.append(r.state["stack"][0]["u0"]["xk"][:, 0].clone())
    assert seen["replays"] == 1 and len(r._prefills) == 1
    assert seen["blocks"] >= 2 and not torch.equal(*xk)
