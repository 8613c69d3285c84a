"""The dense families beside gemma-7b in the port — minitron-4b,
starcoder2-15b, granite-34b — against the JAX package, on the CPU.

Configs: the three reference smoke configs and one small MQA config at
granite's group G = 48 (2 layers, 48 heads of 16 over 1 kv head, d 96,
LayerNorm, gelu plain MLP), since granite's smoke config is rms/glu/silu at
G = 6 and so exercises neither LayerNorm nor G = 48.  Weights come from the
JAX package's ``lm.init_params`` carried across by ``params_from_jax``, with
every norm's gamma and beta moved off their init values from a numpy seed
(a bug in beta would otherwise multiply or add zero).  Inputs are seeded.

Held: the configs field for field; ``lm.forward`` logits and stats against
the JAX package's; prefill + decode against ``forward`` on the appended
token (``tests/test_models_smoke.py:58``); ``TTQEngine`` greedy tokens
(int4 g32 packed weights, int8 KV) against the JAX engine's, dense and
paged, by a near-tie rule; quantized codes of the w1/w2 families; and the
port's own speculation, chunked prefill and default policy on the plain
MLP, bit for bit where the port holds them so on the CPU.

Tolerances: both sides keep bf16 activations and round them at slightly
different places, so logits are held elementwise to rtol 1e-1 and the atol
8e-2 of the reference's tests/test_models_smoke.py:58 (the 5e-2 of
tests/test_fused_path.py:103 is passed by all but 1 of 16384 logits of
granite's 4-layer smoke config, off by 0.057), and to a relative L2 of
3e-2 over the tensor, as tests/test_torch_models.py."""
import dataclasses
import hashlib
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as t_get
from repro_torch.core import KernelConfig, NO_QUANT, unpack_bits
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.quant import FusedRequantPlan
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 3e-2
# greedy tokens: equal, or equal up to a first disagreement whose two
# tokens' teacher-forced JAX logits lie within twice the logits' atol (a
# flip needs both logits to move toward each other; tests/test_torch_engine)
NEAR_TIE = 0.1
PROMPTS = [[5, 9, 17, 3, 40], [8, 8, 1], [100, 50, 25, 12, 6, 3, 77],
           [7, 7, 7, 2]]
MAX_NEW, MAX_LEN = 6, 48
MQA48 = dict(name="mqa48-t", family="dense", n_layers=2, d_model=96,
             n_heads=48, n_kv_heads=1, head_dim=16, d_ff=192, vocab=512,
             act="gelu", mlp="plain", norm="layer", pos="rope")
CASES = ["minitron_4b", "starcoder2_15b", "granite_34b", "mqa48"]
PLAIN_MLP = ["minitron_4b", "starcoder2_15b", "mqa48"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get
    from repro.core import KVCacheConfig, QuantizedTensor, ttq_policy
    from repro.models import ModelConfig, lm
    from repro.quant.api import FusedRequantPlan as JPlan
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get=get, KV=KVCacheConfig, QT=QuantizedTensor,
        pol=ttq_policy, MCfg=ModelConfig, lm=lm, Plan=JPlan,
        ECfg=EngineConfig, Eng=TTQEngine)


def _tcfg(jcfg):
    return TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(TCfg)})


def _perturb_norms(jx, params, seed):
    """Every norm's gamma and beta moved off its init value, from a numpy
    seed: gamma by N(0, 0.2), beta by N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if k in ("gamma", "beta") and not isinstance(v, dict):
                    a = np.asarray(v)
                    sd = 0.2 if k == "gamma" else 0.1
                    out[k] = jx.jnp.asarray(
                        a + sd * rng.standard_normal(a.shape).astype(a.dtype))
                else:
                    out[k] = go(v)
            return out
        if isinstance(t, list):
            return [go(v) for v in t]
        return t
    return go(params)


@pytest.fixture(scope="module", params=CASES)
def model(jx, request):
    name = request.param
    jcfg = jx.MCfg(**MQA48) if name == "mqa48" else jx.get(name, smoke=True)
    jp = _perturb_norms(jx, jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0)),
                        seed=11)
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(name=name, jcfg=jcfg, tcfg=_tcfg(jcfg),
                                 jp=jp, tp=tp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ["gemma_7b", "minitron_4b", "starcoder2_15b",
                                  "granite_34b"])
def test_configs_equal_the_reference(jx, arch):
    assert arch in ARCH_IDS
    for smoke in (False, True):
        assert dataclasses.asdict(t_get(arch, smoke=smoke)) == \
            dataclasses.asdict(jx.get(arch, smoke=smoke))


def test_init_params_layout_matches_jax(jx, model):
    """The port's own init has the reference's tree: paths, shapes, dtypes;
    LayerNorm gamma ones and beta zeros, RMSNorm gamma zeros."""
    jp = jx.jax.tree.map(np.asarray, jx.lm.init_params(
        model.jcfg, jx.jax.random.PRNGKey(0)))
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
    for k, a in lj.items():
        b = lt[k]
        assert tuple(a.shape) == tuple(b.shape), k
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), k
        if k[-1] in ("gamma", "beta"):
            np.testing.assert_array_equal(b.numpy(), a)
    layer = model.tcfg.norm == "layer"
    assert ("beta" in tp["final_norm"]) == layer
    assert set(tp["stack"][0]["u0"]["mlp"]) == (
        {"w1", "w2"} if model.tcfg.mlp == "plain" else {"wg", "wu", "wd"})


# ------------------------------------------------------------------ forward

def test_forward_matches_jax(jx, model):
    """``lm.forward`` logits (B, S, V) and the whole stats tree."""
    toks = _tokens(model.tcfg, 2, 16, seed=1)
    lj, sj, _ = jx.lm.forward(model.jcfg, model.jp,
                              {"tokens": jx.jnp.asarray(toks)},
                              collect_stats=True)
    lt, st, _ = tlm.forward(model.tcfg, model.tp,
                            {"tokens": torch.from_numpy(toks)},
                            collect_stats=True)
    assert lt.shape == (2, 16, model.tcfg.vocab) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=8e-2)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    mlp = ("w1", "w2") if model.tcfg.mlp == "plain" else ("wg", "wd")
    sj, st = sj["stack"][0], st["stack"][0]
    assert set(sj) == set(st) == {"u0.mix.wq", "u0.mix.wo",
                                  *(f"u0.mlp.{w}" for w in mlp)}
    for k in sj:
        a, b = np.asarray(sj[k]), st[k].numpy()
        assert a.shape == b.shape == (model.tcfg.n_layers, b.shape[-1])
        np.testing.assert_allclose(b, a, rtol=1e-1,
                                   atol=1e-2 * np.abs(a).max())
        assert _rel_l2(a, b) < REL_L2, k


def test_forward_without_stats(model):
    toks = torch.from_numpy(_tokens(model.tcfg, 1, 5, seed=2))
    lg, stats, states = tlm.forward(model.tcfg, model.tp, {"tokens": toks})
    assert stats is None and lg.shape == (1, 5, model.tcfg.vocab)
    assert bool(torch.isfinite(lg).all())


def test_prefill_decode_matches_forward(model):
    """prefill + decode_step == forward on the appended token (the
    reference's tests/test_models_smoke.py:58, its tolerance), and the
    prefill's last-row logits are forward's."""
    S = 12
    toks = torch.from_numpy(_tokens(model.tcfg, 2, S, seed=3))
    last, state, _ = tlm.prefill(model.tcfg, model.tp, {"tokens": toks},
                                 max_len=S + 4)
    nt = torch.full((2, 1), 7, dtype=torch.int32)
    lg, _ = tlm.decode_step(model.tcfg, model.tp, state, nt,
                            torch.full((2,), S, dtype=torch.int32))
    full, _, _ = tlm.forward(model.tcfg, model.tp,
                             {"tokens": torch.cat([toks, nt], dim=1)})
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), rtol=8e-2,
                               atol=8e-2)
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                               rtol=8e-2, atol=8e-2)


# ------------------------------------------------------------------- engine

def _jax_logits_at(jx, model, jeng, prompt, out, t):
    """The JAX engine's teacher-forced logits of step t of one request: the
    full-precision prefill of the prompt (step 0), then decode steps on its
    quantized tree fed the JAX tokens.  A replay is kept per model for the
    module: its dense and paged engines quantize the same tree and meet the
    same first disagreements."""
    key = (tuple(prompt), tuple(out[:t]), hashlib.sha1(b"".join(
        np.asarray(x).tobytes() for x in jx.jax.tree.leaves(jeng.qparams)))
        .hexdigest())
    memo = vars(model).setdefault("replays", {})
    if key not in memo:
        memo[key] = _jax_replay(jx, model, jeng, prompt, out, t)
    return memo[key]


def _jax_replay(jx, model, jeng, prompt, out, t):
    kv = jx.KV(dtype="int8")
    seq = jx.jnp.asarray([list(prompt)], jx.jnp.int32)
    lg, state, _ = jx.lm.prefill(model.jcfg, model.jp, {"tokens": seq},
                                 max_len=MAX_LEN, kvcfg=kv)
    for i in range(t):
        lg, state = jx.lm.decode_step(
            model.jcfg, jeng.qparams, state,
            jx.jnp.asarray([[out[i]]], jx.jnp.int32),
            jx.jnp.asarray([len(prompt) + i], jx.jnp.int32), kvcfg=kv)
    return np.asarray(lg)[0]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_jax(jx, model, paged):
    """Greedy tokens of both engines (int4 g32 packed weights, int8 KV, one
    admission round, one requant) under the near-tie rule."""
    ekw = dict(max_slots=4, max_len=MAX_LEN, decode_chunk=2, guards=False,
               kv_paged=paged, kv_block_size=8 if paged else 0)
    jpol = jx.pol(bits=4, group_size=32, rank=0, packed=True,
                  kvcache=jx.KV(dtype="int8"))
    jeng = jx.Eng(model.jcfg, model.jp, jpol, jx.ECfg(**ekw))
    jr = [jeng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    jo = jeng.run_all()
    tpol = t_policy(bits=4, group_size=32, rank=0, packed=True,
                    kvcache=TKV(dtype="int8"),
                    kernel=KernelConfig(use_pallas=True))
    teng = TEngine(model.tcfg, model.tp, tpol, TECfg(**ekw), device="cpu")
    tr = [teng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    to = teng.run_all()
    assert jeng.n_requants == teng.n_requants == 1
    if paged:
        teng.allocator.assert_quiescent()
    for p, rj, rt in zip(PROMPTS, jr, tr):
        a, b = list(jo[rj]), list(to[rt])
        assert len(a) == len(b) == MAX_NEW
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        lg = _jax_logits_at(jx, model, jeng, p, a, t)
        assert abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE, \
            (p, t, a[t], b[t], float(lg[a[t]]), float(lg[b[t]]))


# -------------------------------------------------------------------- codes

@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", PLAIN_MLP)
def test_plain_mlp_codes_match_jax(jx, name, use_kernel):
    """The fused requant plan of a w1/w2 family on the same weights and
    prefill statistics: codes equal except ±1 at round-half ties (on at
    most 2e-3 of them), scales, zeros and 1/D within f32 rounding."""
    jcfg = jx.MCfg(**MQA48) if name == "mqa48" else jx.get(name, smoke=True)
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0))
    toks = jx.jnp.asarray(_tokens(jcfg, 2, 16, seed=4))
    _, _, stats = jx.lm.prefill(jcfg, jp, {"tokens": toks}, max_len=20)
    count = float(toks.size)
    jq = jx.Plan(jp, stats, jx.pol(bits=4, group_size=32, rank=0,
                                   packed=True)).run(jp, stats, count)
    np_tree = lambda t: jx.jax.tree.map(np.asarray, t)  # noqa: E731
    tparams = params_from_jax(np_tree(jp), device="cpu")
    tstats = params_from_jax(np_tree(stats), device="cpu")
    plan = FusedRequantPlan(tparams, tstats, t_policy(
        bits=4, group_size=32, rank=0, packed=True,
        kernel=KernelConfig(use_pallas=use_kernel)))
    members = {m.path_str for ms in plan.families.values() for m in ms}
    assert {"stack.0.u0.mlp.w1", "stack.0.u0.mlp.w2"} <= members
    tq = plan.run(tparams, tstats, count)
    for w in ("w1", "w2", "wq", "wk", "wv", "wo"):
        grp = "mlp" if w in ("w1", "w2") else "mix"
        a = jx.jax.tree.map(np.asarray, jq["stack"][0]["u0"][grp][w])
        b = tq["stack"][0]["u0"][grp][w]
        d = b.in_features
        ca = unpack_bits(torch.from_numpy(np.array(a.packed)), d, 4).numpy()
        cb = unpack_bits(b.packed, d, 4).numpy()
        assert np.abs(ca - cb).max() <= 1 and (ca != cb).mean() <= 2e-3, w
        np.testing.assert_allclose(b.dinv.numpy(), a.dinv, rtol=1e-6)
        np.testing.assert_allclose(b.scale.numpy(), a.scale, rtol=1e-5)
        np.testing.assert_allclose(b.zero.numpy(), a.zero, rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------- the serving tier on the plain MLP

LONG = [((7 * i + 3) % 500) + 1 for i in range(40)]
SPEC_POLICY = t_policy(bits=4, group_size=32, rank=8, packed=True,
                       kernel=KernelConfig(use_pallas=True),
                       kvcache=TKV(dtype="int8"))


def _serve(eng, prompts, max_new=MAX_NEW):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    outs = eng.run_all()
    if eng.allocator is not None:
        eng.allocator.assert_quiescent()
    return [list(outs[r]) for r in rids]


def _plain_model(name):
    cfg = TCfg(**MQA48) if name == "mqa48" else t_get(name, smoke=True)
    return cfg, tlm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


@pytest.mark.parametrize("name", PLAIN_MLP)
def test_speculation_on_plain_mlp(name):
    """Rank-8 int4 verify tree with its int4 draft, W = 3: tokens bit for
    bit the non-speculative engine's (as tests/test_torch_spec.py)."""
    cfg, params = _plain_model(name)
    kw = dict(max_slots=3, max_len=64, guards=False)
    base = _serve(TEngine(cfg, params, SPEC_POLICY, TECfg(**kw),
                          device="cpu"), PROMPTS[:3])
    eng = TEngine(cfg, params, SPEC_POLICY, TECfg(speculate_k=3, **kw),
                  device="cpu")
    assert _serve(eng, PROMPTS[:3]) == base
    assert eng.spec_windows > 0 and eng.draft_params is not eng.params


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", PLAIN_MLP)
def test_chunked_prefill_on_plain_mlp(name, paged):
    """A 40-token prompt in chunks of 16 beside a short one: tokens bit for
    bit the unchunked run's (as tests/test_torch_chunked.py)."""
    cfg, params = _plain_model(name)
    kw = dict(max_slots=2, max_len=96, decode_chunk=1,
              recalibrate_tokens=10 ** 9, prompt_buckets=(16, 32, 64),
              kv_paged=paged, kv_block_size=16 if paged else 0)
    pol = NO_QUANT.with_(kvcache=TKV(dtype="int8"))
    want = _serve(TEngine(cfg, params, pol, TECfg(**kw), device="cpu"),
                  [LONG, PROMPTS[1]])
    eng = TEngine(cfg, params, pol, TECfg(prefill_chunk=16, **kw),
                  device="cpu")
    assert _serve(eng, [LONG, PROMPTS[1]]) == want
    assert eng.prefill_chunks == 3


@pytest.mark.parametrize("name", PLAIN_MLP)
def test_default_policy_on_plain_mlp(name):
    """The reference's default policy (rank 16, delta gate, double buffer,
    guards on) on a w1/w2 family: factors at w1 and w2, both requantized,
    every request served."""
    cfg, params = _plain_model(name)
    eng = TEngine(cfg, params, t_policy(),
                  TECfg(max_slots=2, max_len=64, requant_threshold=0.05,
                        double_buffer=True, recalibrate_tokens=8),
                  device="cpu")
    outs = _serve(eng, PROMPTS)
    assert all(len(o) == MAX_NEW and all(0 <= t < cfg.vocab for t in o)
               for o in outs)
    mlp = eng.lowrank_tree["stack"][0]["u0"]["mlp"]
    for w in ("w1", "w2"):
        B, A = mlp[w]["B"], mlp[w]["A"]
        assert B.shape[-1] == A.shape[-2] == 16
        assert B.shape[0] == A.shape[0] == cfg.n_layers
    assert eng.n_requants >= 1 and eng.layers_requantized > 0
    assert eng.requant_rejections == 0
