"""The MoE family (llama4-scout-17b-a16e: 16 experts top-1 plus a shared
expert over GQA attention) in the port, against the JAX package, on the
CPU; and the expert-batched ``ttq_gemm``'s plain version against the JAX
kernel vmapped over experts (Pallas in interpret mode).

Config: the reference's llama4 smoke config (2 layers, d 64, 4 heads over
2 kv heads, 4 experts top-1, expert hidden 64, one shared expert) and, for
top-k > 1 and the requant members, deepseek's smoke experts (8 experts
top-2, hidden 32).  Weights come from the JAX package's ``lm.init_params``
carried across by ``params_from_jax``.  Inputs are seeded.

Tolerances: bf16 model outputs to a relative L2 of 3e-2 and elementwise to
rtol 1e-1, atol 0.12, as tests/test_torch_hybrid.py (XLA keeps f32 across
fused bf16 ops); stats leaves to a relative L2 of 3e-2.  The plain batched
GEMM in f32 to rtol 1e-5 of the JAX kernel (another summation order), and
bit for bit a 2-D call per expert.  Codes equal except ±1 at round-half
ties.  Greedy tokens by the near-tie rule: a request's first disagreement
is allowed where the JAX engine's own logits of the two tokens are within
NEAR_TIE (twice ATOL: both logits move), or where it follows a routing
choice at a near-tie of router probabilities (within ROUTER_TIE) that the
two packages' quantized trees resolve differently (``_routing_near_tie``):
top-k is discontinuous, and a flipped choice moves a token's MLP output
by a whole expert's share."""
import dataclasses
import hashlib
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as t_get
from repro_torch.core import KernelConfig, unpack_bits
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.core.ttq import QuantizedTensor, dequant, qt_index
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ttq_gemm import gemm_splits
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import stack as TS
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.models.config import MoECfg as TMoE
from repro_torch.quant import FusedRequantPlan, lowrank_tree, quantize_params
from repro_torch.quant.api import _stat_for
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 3e-2
ATOL = 0.12
NEAR_TIE = 0.24
ROUTER_TIE = 0.02
MAX_LEN = 48
MAX_NEW = 8
PROMPTS = [[((7 * i + 3 * j) % 500) + 1 for i in range(9 + 5 * j)]
           for j in range(3)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get
    from repro.core import KVCacheConfig, ttq_policy
    from repro.core.qdq import unpack_bits as junpack
    from repro.core.ttq import dequant as jdequant
    from repro.kernels import ops
    from repro.models import layers as L
    from repro.models import lm
    from repro.quant.api import FusedRequantPlan as JPlan
    from repro.quant.api import lowrank_tree as jlowrank
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get=get, KV=KVCacheConfig, pol=ttq_policy, L=L,
        lm=lm, ops=ops, Plan=JPlan, lowrank=jlowrank, dequant=jdequant,
        unpack=junpack,
        ECfg=EngineConfig, Eng=TTQEngine)


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TCfg)}
    kw["moe"] = TMoE(**dataclasses.asdict(jcfg.moe))
    return TCfg(**kw)


def _bridge(jx, tree):
    return params_from_jax(jx.jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def model(jx):
    jcfg = jx.get("llama4_scout_17b_a16e", smoke=True)
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0))
    return types.SimpleNamespace(jcfg=jcfg, tcfg=_tcfg(jcfg), jp=jp,
                                 tp=_bridge(jx, jp))


@pytest.fixture(scope="module")
def top2(jx):
    """deepseek's smoke MoE (8 experts top-2, 2 shared) on plain attention:
    the expert path at top-k > 1 without MLA."""
    jcfg = dataclasses.replace(jx.get("deepseek_v2_lite_16b", smoke=True),
                               mla=None)
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(1))
    toks = _tokens(jcfg, 2, 12, seed=5)
    _, _, stats = jx.lm.prefill(jcfg, jp, {"tokens": jx.jnp.asarray(toks)},
                                max_len=16)
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=_tcfg(jcfg), jp=jp, tp=_bridge(jx, jp), jstats=stats,
        tstats=_bridge(jx, stats), count=float(toks.size))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _leaves(t, path=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _leaves(v, path + (i,))
    else:
        yield path, t


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_the_reference(jx, smoke):
    """llama4-scout field for field, one run of ``attn`` layers, every
    layer's MLP the MoE."""
    assert "llama4_scout_17b_a16e" in ARCH_IDS
    tc = t_get("llama4_scout_17b_a16e", smoke)
    jc = jx.get("llama4_scout_17b_a16e", smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert TS.stack_spec(tc) == [(("attn",), tc.n_layers)]
    assert TS.mlp_kind(tc, "attn") == "moe"
    if not smoke:
        assert (tc.moe.n_experts, tc.moe.top_k, tc.moe.n_shared,
                tc.n_heads // tc.n_kv_heads) == (16, 1, 1, 5)


def test_init_params_layout_matches_jax(jx, model):
    """The port's own init has the reference's tree: expert stacks (n, E,
    F, D) and (n, E, D, F) in bf16, the router (n, E, D) in f32, the shared
    expert's GLU at hidden F·n_shared."""
    jp = jx.jax.eval_shape(lambda k: jx.lm.init_params(model.jcfg, k),
                           jx.jax.random.PRNGKey(0))
    tp = tlm.init_params(model.tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    lj, lt = dict(_leaves(jp)), dict(_leaves(tp))
    assert lj.keys() == lt.keys()
    for k, a in lj.items():
        assert tuple(a.shape) == tuple(lt[k].shape), k
        assert str(a.dtype) == str(lt[k].dtype).removeprefix("torch."), k
    mlp = tp["stack"][0]["u0"]["mlp"]
    n, E, F, D = 2, 4, 64, 64
    assert mlp["experts"]["wg"].shape == (n, E, F, D)
    assert mlp["experts"]["wd"].shape == (n, E, D, F)
    assert mlp["router"].dtype == torch.float32
    assert mlp["router"].shape == (n, E, D)
    assert mlp["shared"]["wg"].shape == (n, F, D)


# ------------------------------------------------------------------ forward

def _routed_forward(jx, m, toks, monkeypatch):
    """Both packages' ``lm.forward`` with the stats tap, each recording its
    router's top-k indices per layer.  The JAX package runs op by op
    (``jax.disable_jit``): its jitted forward keeps f32 across fused bf16
    ops, which moves the router's input by a bf16 rounding, enough to flip
    a near-tie routing choice of the random weights (a whole expert's
    share of a token's output; the top-2 config flips one token)."""
    rec_j, rec_t = [], []
    real_j, real_t = jx.L._router, TL._router

    def spy_j(*a):
        out = real_j(*a)
        rec_j.append(np.asarray(out[1]))
        return out

    def spy_t(*a):
        out = real_t(*a)
        rec_t.append(out[1].numpy())
        return out
    monkeypatch.setattr(jx.L, "_router", spy_j)
    monkeypatch.setattr(TL, "_router", spy_t)
    with jx.jax.disable_jit():
        lj, sj, _ = jx.lm.forward(m.jcfg, m.jp,
                                  {"tokens": jx.jnp.asarray(toks)},
                                  collect_stats=True)
    lt, st, _ = tlm.forward(m.tcfg, m.tp, {"tokens": torch.from_numpy(toks)},
                            collect_stats=True)
    return lj, sj, rec_j, lt, st, rec_t


@pytest.mark.parametrize("which", ["llama4", "top2"])
def test_forward_matches_jax(jx, model, top2, which, monkeypatch):
    """``lm.forward`` logits and every stats leaf, among them the routing-
    mass-weighted ``u0.mlp.experts.wg`` (n, E, D) and ``experts.wd`` (n, E,
    F), the f32 router's and the shared expert's taps; every (token, layer,
    k) routing choice equal (see :func:`_routed_forward`)."""
    m = model if which == "llama4" else top2
    toks = _tokens(m.tcfg, 2, 12, seed=1)
    lj, sj, rj, lt, st, rt = _routed_forward(jx, m, toks, monkeypatch)
    assert len(rj) == len(rt) == m.tcfg.n_layers
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=ATOL)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    sj, st = sj["stack"][0], st["stack"][0]
    assert set(sj) == set(st)
    E = m.tcfg.moe.n_experts
    assert st["u0.mlp.experts.wg"].shape == (2, E, m.tcfg.d_model)
    assert st["u0.mlp.experts.wd"].shape == (2, E, m.tcfg.moe.d_ff_expert)
    assert {"u0.mlp.router", "u0.mlp.shared.wg", "u0.mlp.shared.wd"} <= set(st)
    for k in sj:
        assert _rel_l2(np.asarray(sj[k]), st[k].numpy()) < REL_L2, k


def test_forward_matches_jitted_jax(jx, model):
    """llama4-scout (top-1, no routing flip at these inputs) against the
    JAX package's jitted ``lm.forward``, at the same tolerances."""
    toks = _tokens(model.tcfg, 2, 12, seed=1)
    lj, _, _ = jx.lm.forward(model.jcfg, model.jp,
                             {"tokens": jx.jnp.asarray(toks)})
    lt, _, _ = tlm.forward(model.tcfg, model.tp,
                           {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=ATOL)
    assert _rel_l2(lj, lt.numpy()) < REL_L2


@pytest.mark.parametrize("which", ["llama4", "top2"])
def test_router_indices_equal(jx, model, top2, which):
    """The f32 router on the same bf16 tokens: top-k indices equal, the
    renormalised weights within f32, and each token's gate row sums to 1."""
    m = model if which == "llama4" else top2
    x = np.random.default_rng(2).standard_normal(
        (37, m.tcfg.d_model)).astype(np.float32)
    xb = jx.jnp.asarray(x).astype(jx.jnp.bfloat16)
    pj = jx.jax.tree.map(lambda a: a[0], m.jp["stack"][0]["u0"]["mlp"])
    pt = {"router": m.tp["stack"][0]["u0"]["mlp"]["router"][0]}
    jp_, ji = jx.L._router(m.jcfg, pj, xb, None, "")
    tp_, ti = TL._router(m.tcfg, pt, torch.from_numpy(x).bfloat16(), None,
                         "")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp_.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_moe_decode_uses_a_broadcast_not_a_copy(model, monkeypatch):
    """On the decode path the experts get the (T, D) tokens once: every
    ``_expert_mm`` input for wg/wu is 2-D, none (E, T, D)."""
    seen = []
    real = TL._expert_mm

    def spy(h, w, kcfg=None):
        seen.append(h.dim())
        return real(h, w, kcfg)
    monkeypatch.setattr(TL, "_expert_mm", spy)
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in model.tp["stack"][0]["u0"]["mlp"].items()}
    x = torch.randn((3, 1, model.tcfg.d_model)).bfloat16()
    TL.moe_apply_dense(model.tcfg, p, x, None, "")
    assert seen == [2, 2, 3]


def test_prefill_decode_matches_forward(model):
    """prefill on 12 tokens, then 8 decode steps, against ``forward`` on
    the appended tokens (tests/test_models_smoke.py's tolerance); the
    prefill's last-row logits are forward's."""
    S, n = 12, 8
    toks = torch.from_numpy(_tokens(model.tcfg, 2, S, seed=3))
    last, state, _ = tlm.prefill(model.tcfg, model.tp, {"tokens": toks},
                                 max_len=S + n)
    new = torch.from_numpy(_tokens(model.tcfg, 2, n, seed=4))
    got = []
    for t in range(n):
        lg, _ = tlm.decode_step(model.tcfg, model.tp, state, new[:, t:t + 1],
                                torch.full((2,), S + t, dtype=torch.int32))
        got.append(lg)
    full, _, _ = tlm.forward(model.tcfg, model.tp,
                             {"tokens": torch.cat([toks, new], dim=1)})
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                               rtol=8e-2, atol=8e-2)
    for t in range(n):
        np.testing.assert_allclose(got[t].numpy(), full[:, S + t].numpy(),
                                   rtol=8e-2, atol=8e-2)


# ------------------------------------------------- the batched GEMM (plain)

def _expert_case(seed, E, T, dp, d, bits, g, shared):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((E, dp, d)).astype(np.float32)
    D = np.exp(0.3 * rng.standard_normal((E, d))).astype(np.float32)
    x = rng.standard_normal((T, d) if shared else (E, T, d)).astype(
        np.float32)
    pk, S, Z = tref.ttq_quantize_ref(torch.from_numpy(W), torch.from_numpy(D),
                                     bits=bits, group_size=g)
    return torch.from_numpy(x), pk, S, Z, torch.from_numpy(1.0 / D)


@pytest.mark.parametrize("shared", [True, False], ids=["shared-x", "per-x"])
@pytest.mark.parametrize("E,T,bits,g", [(4, 3, 4, 32), (3, 1, 8, 64),
                                        (2, 5, 2, 32)])
def test_experts_gemm_plain_matches_jax_vmapped(jx, E, T, bits, g, shared):
    """``ttq_gemm_experts``'s plain version (x (T, d) shared, or (E, T, d))
    against the JAX ``ttq_gemm`` vmapped over the experts (one pallas_call
    with a leading batch axis, interpret mode) to rtol 1e-5; expert e's
    rows bit for bit a 2-D ``ttq_gemm_ref`` on expert e."""
    dp, d = 96, 256
    x, pk, S, Z, dinv = _expert_case(E * 10 + T, E, T, dp, d, bits, g, shared)
    y = tops.ttq_gemm_experts(x, pk, S, Z, dinv, bits=bits, group_size=g)
    assert y.shape == (E, T, dp) and y.dtype == torch.float32
    jnp = jx.jnp
    xin = jnp.broadcast_to(jnp.asarray(x.numpy()), (E, T, d)) if shared \
        else jnp.asarray(x.numpy())
    yj = jx.jax.vmap(lambda xx, p, s, z, dv: jx.ops.ttq_gemm(
        xx, p, s, z, dv, bits=bits, group_size=g))(
        xin, *(jnp.asarray(t.numpy()) for t in (pk, S, Z, dinv)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-4)
    for e in range(E):
        y2 = tref.ttq_gemm_ref(x if shared else x[e], pk[e], S[e], Z[e],
                               bits=bits, group_size=g, dinv=dinv[e])
        assert torch.equal(y[e], y2)


def test_experts_ttq_matmul_low_rank_per_expert():
    """``ttq_matmul`` on an (E, ...) QuantizedTensor with factors: each
    expert's rows equal the 2-D ``ttq_matmul`` on that expert (the batched
    B(Ax) on the unscaled x against the per-expert product, f32 close)."""
    from repro_torch.core.ttq import ttq_matmul
    E, T, dp, d, r = 3, 4, 64, 128, 8
    x, pk, S, Z, dinv = _expert_case(9, E, T, dp, d, 4, 32, shared=True)
    g = torch.Generator().manual_seed(0)
    B = torch.randn((E, dp, r), generator=g).bfloat16()
    A = torch.randn((E, r, d), generator=g).bfloat16()
    qt = QuantizedTensor(None, pk, S, Z, dinv, B, A, bits=4, group_size=32,
                         out_features=dp, in_features=d)
    xb = x.bfloat16()
    y = ttq_matmul(xb, qt)
    for e in range(E):
        want = ttq_matmul(xb, qt_index(qt, e))
        torch.testing.assert_close(y[e].float(), want.float(), rtol=1e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("E", [1, 16, 64])
def test_gemm_splits_count_the_experts(E):
    """The split rule counts E × row tiles × token tiles: at both configs'
    expert shapes every split is 1; a 2-D call at deepseek's d = 1408 takes
    2 (a 704-wide slice, whole groups and uint4 words)."""
    for dp, d in ((1408, 2048), (2048, 1408), (8192, 5120), (5120, 8192)):
        s = gemm_splits(dp, d, 4, 4, 32, 132, 64 if E > 1 else 1)
        assert s == (1 if E > 1 else s)
        assert d % s == 0 and (d // s) % 32 == 0
    assert gemm_splits(2048, 1408, 4, 4, 32, 132) == 2
    assert gemm_splits(1408, 2048, 4, 4, 32, 132, 64) == 1


# ------------------------------------ the mma tile's arithmetic (plain model)

def _mma_tile_model(x, pk, S, Z, dinv, *, g):
    """The arithmetic of ``csrc/ttq_gemm_experts.cu`` in plain torch, f32
    out: x̃ = x∘D⁻¹ as the bf16 pair hi = bf16(x̃), lo = bf16(x̃ − hi); the
    int4 codes as exact integers; per group the f32 sums Σ c·hi and Σ c·lo
    (the mma steps, hi and lo in their own columns) and Σ (hi + lo) (the
    unit sums, on the hi column only), s and z applied to them after: y =
    Σ_groups s·Σ c·hi + z·Σ(hi + lo), plus Σ_groups s·Σ c·lo, hi + lo.
    (The card takes each group's sums in its own fixed order; the model's
    is torch's.)"""
    E, dp = pk.shape[:2]
    d = x.shape[-1]
    xt = x.float() * dinv[:, None, :] if x.dim() == 3 \
        else x.float()[None] * dinv[:, None, :]
    hi = xt.bfloat16().float()
    lo = (xt - hi).bfloat16().float()
    codes = torch.stack([unpack_bits(pk[e], d, 4) for e in range(E)]).float()
    cg = codes.reshape(E, dp, d // g, g)

    def products(part):                                # Σ_{k∈g} c·x̃, then s
        pg = part.reshape(E, part.shape[1], d // g, g)
        return (S[:, None] * torch.einsum("epgk,etgk->etpg", cg, pg)).sum(-1)
    xsum = (hi + lo).reshape(E, hi.shape[1], d // g, g).sum(-1)
    y_hi = products(hi) + (Z[:, None] * xsum[:, :, None, :]).sum(-1)
    return y_hi + products(lo)


@pytest.mark.parametrize("shared", [True, False], ids=["shared-x", "per-x"])
@pytest.mark.parametrize("T", [1, 4, 5, 12])
@pytest.mark.parametrize("g", [32, 128])
def test_mma_tile_model_matches_jax_vmapped(jx, T, g, shared):
    """The mma tile's arithmetic (:func:`_mma_tile_model`, bf16 x as the
    port serves it) against the JAX ``ttq_gemm`` vmapped over the experts
    (interpret mode) and against ``ttq_gemm_experts_ref``, both on the same
    bf16 x.  The card tests' tolerances: bf16 outputs (the model's output
    rounded once to bf16) within rtol 2^-7, atol 2e-4·sqrt(d/256) of
    either.  And before that rounding, within the f32 GEMM tolerance (rtol
    2e-5, atol 2e-4): the hi/lo pair keeps x̃ to ~16 bits, so the tile adds
    no error of bf16 size beside the output's own rounding."""
    E, dp, d = 3, 40, 256
    x, pk, S, Z, dinv = _expert_case(7 * T + g, E, T, dp, d, 4, g, shared)
    xb = x.bfloat16()
    y = _mma_tile_model(xb, pk, S, Z, dinv, g=g)
    y_r = tref.ttq_gemm_experts_ref(xb, pk, S, Z, bits=4, group_size=g,
                                    dinv=dinv)
    jnp = jx.jnp
    xin = jnp.asarray(xb.float().numpy())
    xin = jnp.broadcast_to(xin, (E, T, d)) if shared else xin
    y_j = np.asarray(jx.jax.vmap(lambda xx, p, s, z, dv: jx.ops.ttq_gemm(
        xx, p, s, z, dv, bits=4, group_size=g))(
        xin, *(jnp.asarray(t.numpy()) for t in (pk, S, Z, dinv))))
    atol = 2e-4 * (d / 256) ** 0.5
    for want in (y_r.numpy(), y_j):
        np.testing.assert_allclose(y.numpy(), want, rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(y.bfloat16().float().numpy(), want,
                                   rtol=2 ** -7, atol=atol)


# the served expert shapes: (config, name) → (E, d', d) at int4 g32
SERVED_EXPERTS = {("deepseek-v2-lite", "wg/wu"): (64, 1408, 2048),
                  ("deepseek-v2-lite", "wd"): (64, 2048, 1408),
                  ("llama4-scout", "wg/wu"): (16, 8192, 5120),
                  ("llama4-scout", "wd"): (16, 5120, 8192)}


@pytest.mark.parametrize("key", SERVED_EXPERTS, ids=lambda k: " ".join(k))
def test_served_expert_shapes_take_the_mma_tile(key):
    """Both MoE configs' expert projections (bf16 x, int4 g32) take the
    tensor-core tile, and the configs agree with the shapes."""
    from repro_torch.kernels.ttq_gemm import experts_tile
    E, dp, d = SERVED_EXPERTS[key]
    cfg = t_get({"deepseek-v2-lite": "deepseek_v2_lite_16b",
                 "llama4-scout": "llama4_scout_17b_a16e"}[key[0]])
    F = cfg.moe.d_ff_expert
    assert (E, dp, d) == ((cfg.moe.n_experts, F, cfg.d_model)
                          if key[1] == "wg/wu"
                          else (cfg.moe.n_experts, cfg.d_model, F))
    assert experts_tile(d, 32, 4, torch.bfloat16) == "mma"
    assert experts_tile(d, 32, 4, torch.float32) == "batched"


@pytest.mark.parametrize("d,g,bits,dtype,want", [
    (2048, 32, 4, torch.bfloat16, "mma"), (1408, 64, 4, torch.bfloat16, "mma"),
    (256, 128, 4, torch.bfloat16, "mma"), (512, 256, 4, torch.bfloat16, "mma"),
    (160, 32, 4, torch.bfloat16, "mma"),
    (2048, 32, 4, torch.float32, "batched"),
    (2048, 32, 8, torch.bfloat16, "batched"),
    (2048, 32, 2, torch.bfloat16, "batched"),
    (2048, 16, 4, torch.bfloat16, "batched"),
    (192, 48, 4, torch.bfloat16, "batched"),
    (256, 8, 4, torch.bfloat16, "batched")])
def test_experts_tile_by_shape(d, g, bits, dtype, want):
    """The rule: bf16 x, int4, g a power of two >= 32 → the mma tile; bits 2
    and 8, g below 32 or not a power of two, f32 x → the batched tile."""
    from repro_torch.kernels.ttq_gemm import experts_tile
    assert experts_tile(d, g, bits, dtype) == want


# ---------------------------------------------------------- requantization

def _qts(tree):
    return {p: v for p, v in _leaves(tree) if hasattr(v, "bits")}


def test_expert_members_and_stats_join(top2):
    """The plan's members are the reference's: the (n, E, ·, ·) expert
    stacks are members of n·E rows, wg and wu join ``experts.wg``'s
    statistics and wd ``experts.wd``'s (the reference's expert lookup);
    the router and norms stay in full precision."""
    pol = t_policy(bits=4, group_size=16, rank=0, packed=True)
    plan = FusedRequantPlan(top2.tp, top2.tstats, pol)
    members = {m.path_str: m for ms in plan.families.values() for m in ms}
    E = top2.tcfg.moe.n_experts
    for w in ("wg", "wu", "wd"):
        m = members[f"stack.0.u0.mlp.experts.{w}"]
        assert m.lead == (2, E)
        want = "u0.mlp.experts." + ("wd" if w == "wd" else "wg")
        assert m.stat_key == (0, want)
        assert _stat_for(top2.tstats, m.path_str.split(".")) is \
            top2.tstats["stack"][0][want]
    assert not any("router" in p or "norm" in p for p in members)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_expert_codes_match_jax(jx, top2, use_kernel):
    """The fused plan on the MoE tree: every member's codes equal the JAX
    plan's except ±1 at round-half ties, per expert, and the port's own
    eager per-leaf tree's (``quantize_params``) likewise; S, Z and 1/D
    within f32; D differs between experts (each expert row its own
    diagonal)."""
    pol = dict(bits=4, group_size=16, rank=0, packed=True)
    jq = jx.Plan(top2.jp, top2.jstats, jx.pol(**pol)).run(
        top2.jp, top2.jstats, top2.count)
    plan = FusedRequantPlan(top2.tp, top2.tstats, t_policy(
        **pol, kernel=KernelConfig(use_pallas=use_kernel)))
    tq = plan.run(top2.tp, top2.tstats, top2.count)
    jqs, tqs = _qts(jq), _qts(tq)
    assert jqs.keys() == tqs.keys()
    for p, a in jqs.items():
        b = tqs[p]
        d = b.in_features
        ca = np.asarray(jx.unpack(a.packed, d, 4)).astype(np.int64)
        cb = unpack_bits(b.packed, d, 4).numpy().astype(np.int64)
        assert ca.shape == cb.shape, p
        assert np.abs(ca - cb).max() <= 1 and (ca != cb).mean() < 2e-3, p
        np.testing.assert_allclose(b.scale.numpy(), np.asarray(a.scale),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(b.dinv.numpy(), np.asarray(a.dinv),
                                   rtol=1e-4)
    eqs = _qts(quantize_params(top2.tp, top2.tstats, t_policy(**pol),
                               count=top2.count))
    assert eqs.keys() == tqs.keys()
    for p, a in eqs.items():
        d = a.in_features
        ca, cb = (unpack_bits(q.packed, d, 4).numpy().astype(np.int64)
                  for q in (a, tqs[p]))
        assert np.abs(ca - cb).max() <= 1 and (ca != cb).mean() < 2e-3, p
        np.testing.assert_allclose(tqs[p].dinv.numpy(), a.dinv.numpy(),
                                   rtol=1e-5)
    wg = tqs[("stack", 0, "u0", "mlp", "experts", "wg")]
    assert wg.packed.shape[:2] == (2, top2.tcfg.moe.n_experts)
    assert not torch.allclose(wg.dinv[0, 0], wg.dinv[0, 1])


def test_rank8_without_factors_quantizes_experts_inline(jx, top2):
    """Rank 8: ``lowrank_tree`` gives the 4-D expert stacks no factors (as
    the reference's), and the plan no longer raises: each expert stack is
    an eager family that runs the SVD inline.  Effective weights Ŵ =
    deq(codes)∘D⁻¹ + B·A match the JAX plan's (whose eager fallback does
    the same) per expert, and B·A too — not the factors, whose signs are
    ambiguous."""
    pol = dict(bits=4, group_size=16, rank=8, packed=True)
    jlr = jx.lowrank(top2.jp, jx.pol(**pol))
    jplan = jx.Plan(top2.jp, top2.jstats, jx.pol(**pol), lowrank_tree=jlr)
    jq = jplan.run(top2.jp, top2.jstats, top2.count, jlr)
    tlr = lowrank_tree(top2.tp, t_policy(**pol))
    assert tlr["stack"][0]["u0"]["mlp"]["experts"]["wg"] is None
    assert tlr["stack"][0]["u0"]["mix"]["wq"] is not None
    plan = FusedRequantPlan(top2.tp, top2.tstats, t_policy(**pol),
                            lowrank_tree=tlr)
    eager = sorted(k[1] for k in plan.families if k[0] == "eager")
    assert eager == sorted(m.path_str for m in jplan.eager)
    assert "stack.0.u0.mlp.experts.wd" in eager
    tq = plan.run(top2.tp, top2.tstats, top2.count, tlr)
    jqs, tqs = _qts(jq), _qts(tq)
    E = top2.tcfg.moe.n_experts
    for w in ("wg", "wu", "wd"):
        path = ("stack", 0, "u0", "mlp", "experts", w)
        a, b = jqs[path], tqs[path]
        assert b.B.shape == (2, E, b.out_features, 8)
        for i in range(2):
            for e in range(E):
                ja = jx.jax.tree.map(lambda t: t[i, e], a)
                tb = qt_index(qt_index(b, i), e)
                wa = np.asarray(jx.dequant(ja))
                wb = dequant(tb).numpy()
                assert _rel_l2(wa, wb) < 2e-2, (w, i, e)
                ba = np.asarray(ja.B, np.float32) @ np.asarray(ja.A,
                                                               np.float32)
                bb = (tb.B.float() @ tb.A.float()).numpy()
                assert _rel_l2(ba, bb) < 1e-2, (w, i, e)
    # a requant into the same tree writes in place and gives the same codes
    again = plan.run(top2.tp, top2.tstats, top2.count, tlr, into=tq)
    assert again is tq


def test_quantize_params_rank8_experts(top2):
    """The eager path ``quantize_params`` at rank 8 quantizes the expert
    stacks with inline SVDs too; its codes equal the plan's eager
    families' (same weights, same SVD)."""
    pol = t_policy(bits=4, group_size=16, rank=8, packed=True)
    tlr = lowrank_tree(top2.tp, pol)
    a = quantize_params(top2.tp, top2.tstats, pol, count=top2.count,
                        lowrank_tree=tlr)
    b = FusedRequantPlan(top2.tp, top2.tstats, pol, lowrank_tree=tlr).run(
        top2.tp, top2.tstats, top2.count, tlr)
    qa = a["stack"][0]["u0"]["mlp"]["experts"]["wd"]
    qb = b["stack"][0]["u0"]["mlp"]["experts"]["wd"]
    assert torch.equal(qa.packed, qb.packed)
    assert torch.equal(qa.B, qb.B)


# ------------------------------------------------------------------- engine

def _tree_digest(jx, tree) -> str:
    return hashlib.sha1(b"".join(np.asarray(x).tobytes()
                                 for x in jx.jax.tree.leaves(tree))).hexdigest()


def _jax_logits_at(jx, m, jeng, prompt, out, t, kv):
    """The JAX engine's teacher-forced logits of step t (op by op).  A
    replay is kept per model for the module: the engine cases of one model
    quantize the same tree and meet the same first disagreements."""
    key = (tuple(prompt), tuple(out[:t]), repr(kv),
           _tree_digest(jx, jeng.qparams))
    memo = vars(m).setdefault("replays", {})
    if key not in memo:
        memo[key] = _jax_replay(jx, m, jeng, prompt, out, t, kv)
    return memo[key]


def _jax_replay(jx, m, jeng, prompt, out, t, kv):
    seq = jx.jnp.asarray([list(prompt)], jx.jnp.int32)
    lg, state, _ = jx.lm.prefill(m.jcfg, m.jp, {"tokens": seq},
                                 max_len=MAX_LEN, kvcfg=kv)
    for i in range(t):
        lg, state = jx.lm.decode_step(
            m.jcfg, jeng.qparams, state,
            jx.jnp.asarray([[out[i]]], jx.jnp.int32),
            jx.jnp.asarray([len(prompt) + i], jx.jnp.int32), kvcfg=kv)
    return np.asarray(lg)[0]


def _port_replay(m, tree, prompt, out, t, monkeypatch):
    """The port's prefill of ``prompt`` (full precision), then decode steps
    teacher-forced on out[0..t-1] with the quantized ``tree``: the logits
    of token t and, per decode step, each layer's (top-k set, sorted router
    probabilities) of the one token."""
    steps = []
    real = TL._router

    def spy(cfg, p, x2, stats, prefix):
        top_p, top_i = real(cfg, p, x2, stats, prefix)
        probs = torch.softmax(x2.float() @ p["router"].T, dim=-1)[0]
        steps[-1].append((set(top_i[0].tolist()),
                          torch.sort(probs, descending=True).values))
        return top_p, top_i
    kv = TKV(dtype="int8")
    lg, state, _ = tlm.prefill(m.tcfg, m.tp, {"tokens": torch.tensor([prompt])},
                               MAX_LEN, kvcfg=kv)
    lg = lg[0]
    with monkeypatch.context() as mp:
        mp.setattr(TL, "_router", spy)
        for i in range(t):
            steps.append([])
            lg, state = tlm.decode_step(
                m.tcfg, tree, state, torch.tensor([[out[i]]]),
                torch.tensor([len(prompt) + i], dtype=torch.int32), kvcfg=kv)
            lg = lg[0]
    return lg, steps


def _routing_near_tie(jx, m, jeng, teng, prompt, a, t, monkeypatch):
    """Whether a first disagreement at step t comes from a routing near-tie:
    the port replaying the JAX engine's quantized tree gives the JAX token
    (up to a logit near-tie), and the first (step, layer) whose top-k set
    differs between that replay and the replay of the port's own tree sits
    at a near-tie of router probabilities: its k-th and (k+1)-th within
    ROUTER_TIE in either replay.  (The trees differ by codes at round-half
    ties and D's f32 rounding; a routing choice is discontinuous in them.)"""
    k = m.tcfg.moe.top_k
    lj, rj = _port_replay(m, _bridge(jx, jeng.qparams), prompt, a, t,
                          monkeypatch)
    _, rt = _port_replay(m, teng.qmodel.decode_params, prompt, a, t,
                         monkeypatch)
    if float(lj[a[t]]) < float(lj.max()) - NEAR_TIE:
        return False
    for sj, st in zip(rj, rt):
        for (ej, pj), (et, pt) in zip(sj, st):
            if ej != et:
                gap = min(float(pj[k - 1] - pj[k]), float(pt[k - 1] - pt[k]))
                return gap <= ROUTER_TIE
    return False


def engines_agree(jx, m, jeng, teng, prompts, max_new, monkeypatch):
    """Both engines serve ``prompts``; each request's tokens equal, or its
    first disagreement is a near-tie of the JAX engine's own logits, or of
    a routing choice (:func:`_routing_near_tie`).  Returns the number of
    disagreements by kind."""
    jr = [jeng.submit(p, max_new=max_new) for p in prompts]
    jo = jeng.run_all()
    tr = [teng.submit(p, max_new=max_new) for p in prompts]
    to = teng.run_all()
    assert jeng.n_requants >= 1 and teng.n_requants >= 1
    kv = jx.KV(dtype="int8")
    kinds = {"logit": 0, "routing": 0}
    for p, rj, rt in zip(prompts, jr, tr):
        a, b = list(jo[rj]), list(to[rt])
        assert len(a) == len(b) == max_new
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        lg = _jax_logits_at(jx, m, jeng, p, a, t, kv)
        if abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE:
            kinds["logit"] += 1
            continue
        assert _routing_near_tie(jx, m, jeng, teng, p, a, t, monkeypatch), \
            (t, a[t], b[t], float(lg[a[t]]), float(lg[b[t]]))
        kinds["routing"] += 1
    return kinds


ENGINE_CASES = {
    "dense": dict(),
    "paged": dict(kv_paged=True, kv_block_size=8),
    "speculate": dict(speculate_k=2),
    "chunked": dict(prefill_chunk=8),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax(jx, model, case, monkeypatch):
    """Greedy tokens of the port's engine on llama4-scout's smoke config
    (int4 g32 packed weights, int8 KV, guards off) on the dense slab, the
    paged pool, with self-speculation (speculate_k 2, its int4 draft) and
    with chunked prefill (the 19-token prompt alone in chunks of 8: three
    chunks, one admission, so one requant and the teacher-forced replays
    of the rule follow the engines' path; the last chunk's pad rows enter
    the statistics as in the reference, so a chunked tree is not the
    unchunked one), each against the JAX engine in the same configuration
    by the near-tie rule."""
    base = dict(max_slots=4, max_len=MAX_LEN, decode_chunk=2, guards=False,
                **ENGINE_CASES[case])
    jeng = jx.Eng(model.jcfg, model.jp,
                  jx.pol(bits=4, group_size=32, rank=0, packed=True,
                         kvcache=jx.KV(dtype="int8")), jx.ECfg(**base))
    teng = TEngine(model.tcfg, model.tp,
                   t_policy(bits=4, group_size=32, rank=0, packed=True,
                            kvcache=TKV(dtype="int8"),
                            kernel=KernelConfig(use_pallas=True)),
                   TECfg(**base), device="cpu")
    prompts = PROMPTS[2:] if case == "chunked" else PROMPTS
    engines_agree(jx, model, jeng, teng, prompts, MAX_NEW, monkeypatch)
    assert jeng.n_requants == teng.n_requants == 1
    if case == "paged":
        teng.allocator.assert_quiescent()
    if case == "speculate":
        assert teng.spec_windows > 0
    if case == "chunked":
        assert teng.prefill_chunks == 3


def test_speculation_equals_plain_decode(model):
    """On the port alone, speculation is exact: the speculative engine's
    tokens equal the non-speculative engine's bit for bit on the CPU."""
    pol = t_policy(bits=4, group_size=32, rank=0, packed=True,
                   kvcache=TKV(dtype="int8"),
                   kernel=KernelConfig(use_pallas=True))
    kw = dict(max_slots=3, max_len=MAX_LEN, guards=False)
    outs = []
    for k in (0, 3):
        eng = TEngine(model.tcfg, model.tp, pol, TECfg(speculate_k=k, **kw),
                      device="cpu")
        rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
        res = eng.run_all()
        outs.append([list(res[r]) for r in rids])
    assert outs[0] == outs[1]


def test_cli_serves_llama4(capsys):
    """``python -m repro_torch.launch.serve --arch llama4_scout_17b_a16e
    --smoke --device cpu`` answers, and with the paged pool too."""
    from repro_torch.launch import serve
    base = ["--arch", "llama4_scout_17b_a16e", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--max-len", "48"]
    for extra in ([], ["--kv-paged", "--kv-dtype", "int8"]):
        eng, outs = serve.main(base + extra)
        assert len(outs) == 3 and all(len(v) == 4 for v in outs.values())
        assert "arch=llama4-smoke requests=3 tokens=12" in \
            capsys.readouterr().out
