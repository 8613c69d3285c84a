"""DeepSeek-V2-Lite (MLA — multi-head latent attention — and 64 experts
top-6 with 2 shared) in the port, against the JAX package, on the CPU.

Config: the reference's deepseek smoke config (2 layers, d 64, 4 heads,
kv_lora 32, nope 16, rope 8, v 16; 8 experts top-2, hidden 32, 2 shared).
Weights come from the JAX package's ``lm.init_params`` carried across by
``params_from_jax``.  Inputs are seeded.

Held: the config and its stack spec; prefill attention and decode
attention with the reference's ``scale=`` and values narrower than keys
(192 and 128 at full width) in f32; one MLA layer op by op; the decode's
in-place cache writes; ``lm.forward`` (logits, stats, routing); prefill +
decode against forward; ``TTQEngine`` greedy tokens against the JAX
engine's by the near-tie rule of tests/test_torch_moe.py; the refusals of
the paged pool, speculation and chunked prefill; the CLI.

Tolerances: f32 attention to rtol 1e-5 (another summation order); bf16
model outputs as tests/test_torch_moe.py (rel-L2 3e-2, elementwise rtol
1e-1 and atol 0.12)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as t_get
from repro_torch.core import KernelConfig
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models import common as TC
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import stack as TS
from repro_torch.models.config import MLACfg as TMLA
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.models.config import MoECfg as TMoE
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine

from test_torch_moe import (ATOL, MAX_LEN, MAX_NEW, PROMPTS, REL_L2,
                            _bridge, _leaves, _rel_l2, _routed_forward,
                            _tokens, engines_agree)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "deepseek_v2_lite_16b"


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
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get=get, KV=KVCacheConfig, pol=ttq_policy, C=C,
        L=L, lm=lm, JS=JS, ECfg=EngineConfig, Eng=TTQEngine)


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TCfg)}
    kw["moe"] = TMoE(**dataclasses.asdict(jcfg.moe))
    kw["mla"] = TMLA(**dataclasses.asdict(jcfg.mla))
    return TCfg(**kw)


@pytest.fixture(scope="module")
def model(jx):
    jcfg = jx.get(ARCH, smoke=True)
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0))
    return types.SimpleNamespace(jcfg=jcfg, tcfg=_tcfg(jcfg), jp=jp,
                                 tp=_bridge(jx, jp))


def _layer(tree, i=0):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_the_reference(jx, smoke):
    """deepseek-v2-lite field for field; one run of ``mla`` layers, each
    with the MoE MLP."""
    assert ARCH in ARCH_IDS
    tc, jc = t_get(ARCH, smoke), jx.get(ARCH, smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    spec = TS.stack_spec(tc)
    assert spec == [tuple((tuple(k), n)) for k, n in jx.JS.stack_spec(jc)]
    assert spec == [(("mla",), tc.n_layers)]
    assert TS.mixer_kinds(tc) == {"mla"}
    if not smoke:
        assert (tc.mla.kv_lora_rank, tc.mla.qk_rope_dim, tc.moe.n_experts,
                tc.moe.top_k, tc.moe.n_shared) == (512, 64, 64, 6, 2)


def test_init_params_layout_matches_jax(jx, model):
    """The port's own init has the reference's tree, shapes and dtypes:
    wq, wkv_a, kv_norm, wkv_b, wo, the experts and the f32 router."""
    jp = jx.jax.eval_shape(lambda k: jx.lm.init_params(model.jcfg, k),
                           jx.jax.random.PRNGKey(0))
    tp = tlm.init_params(model.tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    lj, lt = dict(_leaves(jp)), dict(_leaves(tp))
    assert lj.keys() == lt.keys()
    for k, a in lj.items():
        assert tuple(a.shape) == tuple(lt[k].shape), k
        assert str(a.dtype) == str(lt[k].dtype).removeprefix("torch."), k
    mix = tp["stack"][0]["u0"]["mix"]
    assert mix["wkv_b"].shape == (2, 4 * (16 + 16), 32)
    assert mix["wkv_a"].shape == (2, 32 + 8, 64)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("causal", [True, False])
def test_attention_scale_and_value_width_match_jax(jx, causal):
    """``attention(..., scale=)`` with keys of 24 and values of 16 per head
    (MLA's nope+rope against v), f32, against the reference's; and the
    chunked path at a small threshold."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 20, 24)).astype(np.float32)
    k = rng.standard_normal((2, 4, 20, 24)).astype(np.float32)
    v = rng.standard_normal((2, 4, 20, 16)).astype(np.float32)
    sc = 0.3
    want = np.asarray(jx.C.attention(*(jx.jnp.asarray(t) for t in (q, k, v)),
                                     causal=causal, scale=sc))
    got = TC.attention(*(torch.from_numpy(t) for t in (q, k, v)),
                       causal=causal, scale=sc)
    assert got.shape == (2, 4, 20, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if causal:
        chunked = TC.chunked_attention(
            *(torch.from_numpy(t) for t in (q, k, v)), kv_chunk=5, scale=sc)
        np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_decode_attention_scale_and_value_width_match_jax(jx):
    """``decode_attention(..., scale=)`` over keys of 24 and values of 16
    per head, rows past each slot's position masked."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 4, 1, 24)).astype(np.float32)
    k = rng.standard_normal((3, 4, 30, 24)).astype(np.float32)
    v = rng.standard_normal((3, 4, 30, 16)).astype(np.float32)
    pos = np.asarray([0, 17, 29], np.int32)
    want = np.asarray(jx.C.decode_attention(
        *(jx.jnp.asarray(t) for t in (q, k, v, pos)), scale=0.2))
    got = TC.decode_attention(*(torch.from_numpy(t) for t in (q, k, v, pos)),
                              scale=0.2)
    assert got.shape == (3, 4, 1, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_seq_update_batched_in_place():
    """cache (B, Smax, D) ← new (B, 1, D) at each slot's row, in place."""
    cache = torch.zeros((3, 5, 4))
    ptr = cache.data_ptr()
    new = torch.arange(12, dtype=torch.float32).reshape(3, 1, 4)
    out = TC.seq_update_batched(cache, new, torch.tensor([0, 4, 2]))
    assert out is cache and cache.data_ptr() == ptr
    for b, p in enumerate((0, 4, 2)):
        assert torch.equal(cache[b, p], new[b, 0])
    assert float(cache.abs().sum()) == float(new.sum())


# -------------------------------------------------------------------- layer

def test_mla_layer_equals_jax_op_by_op(jx, model):
    """One MLA layer with its MoE MLP in sequence mode on bf16 activations
    (S = 12, max_len 16): output and the latent / rope-key caches against
    the reference's ``apply_layer_seq`` run op by op, within one bf16
    rounding (the port equals it bit for bit on the CPU here)."""
    x = np.random.default_rng(3).standard_normal((2, 12, 64)).astype(
        np.float32)
    pj = jx.jax.tree.map(lambda a: a[0], model.jp["stack"][0]["u0"])
    with jx.jax.disable_jit():
        yj, sj = jx.JS.apply_layer_seq(
            model.jcfg, "mla", pj, jx.jnp.asarray(x).astype(jx.jnp.bfloat16),
            None, "", want_state=True, max_len=16)
    yt, st = TS.apply_layer_seq(model.tcfg, "mla",
                                _layer(model.tp["stack"][0]["u0"]),
                                torch.from_numpy(x).to(torch.bfloat16), None,
                                "", want_state=True, max_len=16)
    f32 = lambda a: np.asarray(a.astype(jx.jnp.float32))  # noqa: E731
    np.testing.assert_allclose(yt.float().numpy(), f32(yj), rtol=1e-2,
                               atol=1e-2)
    assert set(st) == set(sj) == {"latent", "k_rope"}
    for k in sj:
        assert tuple(st[k].shape) == tuple(sj[k].shape)
        np.testing.assert_allclose(st[k].float().numpy(), f32(sj[k]),
                                   rtol=1e-2, atol=1e-2)


def test_mla_decode_in_place_matches_jax(jx, model):
    """Two decode steps on one state object: the latent and rope-key caches
    change in place (same storage) and match the reference's functional
    steps; outputs within one bf16 rounding."""
    pj = jx.jax.tree.map(lambda a: a[0], model.jp["stack"][0]["u0"]["mix"])
    pt = _layer(model.tp["stack"][0]["u0"]["mix"])
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 10, 32)).astype(np.float32)
    rope = rng.standard_normal((2, 10, 8)).astype(np.float32)
    bf = lambda a: jx.jnp.asarray(a).astype(jx.jnp.bfloat16)  # noqa: E731
    js = {"latent": bf(lat), "k_rope": bf(rope)}
    ts = {"latent": torch.from_numpy(lat).bfloat16(),
          "k_rope": torch.from_numpy(rope).bfloat16()}
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    f32 = lambda a: np.asarray(a.astype(jx.jnp.float32))  # noqa: E731
    for t in range(2):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        pos = np.asarray([3 + t, 7 + t], np.int32)
        with jx.jax.disable_jit():
            yj, js = jx.L.mla_decode(model.jcfg, pj, bf(x), js,
                                     jx.jnp.asarray(pos))
        yt, out = TL.mla_decode(model.tcfg, pt, torch.from_numpy(x).bfloat16(),
                                ts, torch.from_numpy(pos))
        assert out is ts and {k: v.data_ptr() for k, v in ts.items()} == ptrs
        np.testing.assert_allclose(yt.float().numpy(), f32(yj), rtol=1e-2,
                                   atol=1e-2)
        for k in ts:
            np.testing.assert_allclose(ts[k].float().numpy(), f32(js[k]),
                                       rtol=1e-2, atol=1e-2)
    assert not np.allclose(ts["latent"].float().numpy()[0, 3], lat[0, 3])


# ------------------------------------------------------------------ forward

def test_forward_matches_jax(jx, model, monkeypatch):
    """``lm.forward`` logits, every stats leaf (``u0.mix.wkv_b`` (n, r)
    from the latent, the experts' (n, E, ·), router, shared) and every
    routing choice (top-2 here), against the reference run op by op
    (tests/test_torch_moe.py:_routed_forward)."""
    toks = _tokens(model.tcfg, 2, 12, seed=1)
    lj, sj, rj, lt, st, rt = _routed_forward(jx, model, toks, monkeypatch)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=ATOL)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    sj, st = sj["stack"][0], st["stack"][0]
    assert set(sj) == set(st)
    assert st["u0.mix.wkv_b"].shape == (2, model.tcfg.mla.kv_lora_rank)
    for k in sj:
        assert _rel_l2(np.asarray(sj[k]), st[k].numpy()) < REL_L2, k


def test_prefill_decode_matches_forward(model):
    """prefill on 12 tokens (the caches (n, B, max_len, r) and (n, B,
    max_len, rope), no head axis), then 8 decode steps, each expanding the
    whole latent cache, against ``forward`` on the appended tokens."""
    S, n = 12, 8
    toks = torch.from_numpy(_tokens(model.tcfg, 2, S, seed=3))
    last, state, _ = tlm.prefill(model.tcfg, model.tp, {"tokens": toks},
                                 max_len=S + n)
    st = state["stack"][0]["u0"]
    assert st["latent"].shape == (2, 2, S + n, 32)
    assert st["k_rope"].shape == (2, 2, S + n, 8)
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


# ------------------------------------------------------------------- engine

def test_engine_matches_jax(jx, model, monkeypatch):
    """Greedy tokens of both engines (int4 g32 packed weights, int8 KV —
    MLA's caches stay bf16 as in the reference —, guards off) by the
    near-tie rule of tests/test_torch_moe.py; one requant each."""
    ekw = dict(max_slots=4, max_len=MAX_LEN, decode_chunk=2, guards=False)
    jeng = jx.Eng(model.jcfg, model.jp,
                  jx.pol(bits=4, group_size=32, rank=0, packed=True,
                         kvcache=jx.KV(dtype="int8")), jx.ECfg(**ekw))
    teng = TEngine(model.tcfg, model.tp,
                   t_policy(bits=4, group_size=32, rank=0, packed=True,
                            kvcache=TKV(dtype="int8"),
                            kernel=KernelConfig(use_pallas=True)),
                   TECfg(**ekw), device="cpu")
    engines_agree(jx, model, jeng, teng, PROMPTS, MAX_NEW, monkeypatch)
    assert jeng.n_requants == teng.n_requants == 1
    st = teng.runner.state["stack"][0]["u0"]
    assert set(st) == {"latent", "k_rope"}
    assert st["latent"].shape == (2, 4, MAX_LEN, 32)


@pytest.mark.parametrize("kw,match", [
    (dict(kv_paged=True), "paged KV cache supports plain attention"),
    (dict(speculate_k=2), "speculate_k needs a plain-attention family"),
    (dict(prefill_chunk=16), "prefill_chunk needs a plain-attention family"),
], ids=["kv_paged", "speculate_k", "prefill_chunk"])
def test_mla_misuse_raises(jx, model, kw, match):
    """The paged pool, speculation and chunked prefill on deepseek fail
    with the reference's ValueError, on both engines."""
    with pytest.raises(ValueError, match=match):
        jx.Eng(model.jcfg, model.jp, jx.pol(rank=0), jx.ECfg(**kw))
    with pytest.raises(ValueError, match=match):
        TEngine(model.tcfg, model.tp, t_policy(rank=0), TECfg(**kw),
                device="cpu")


def test_cli_serves_deepseek(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek_v2_lite_16b
    --smoke --device cpu`` answers; ``--kv-paged`` fails with the
    reference's message."""
    from repro_torch.launch import serve
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--max-len", "48"]
    eng, outs = serve.main(base)
    assert len(outs) == 3 and all(len(v) == 4 for v in outs.values())
    assert "arch=deepseek-smoke requests=3 tokens=12" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="paged KV cache supports plain"):
        serve.main(base + ["--kv-paged"])
