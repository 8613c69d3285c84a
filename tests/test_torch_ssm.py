"""The SSM family (mamba2-1.3b: Mamba2's chunked SSD) in the port, against
the JAX package, on the CPU.

Config: the reference's mamba2 smoke config (3 layers, d 64, d_inner 128, 8
heads of 16, d_state 16, chunk 8, conv width 4).  Weights come from the JAX
package's ``lm.init_params`` carried across by ``params_from_jax``, every
norm's gamma moved off its init value from a numpy seed.  Inputs are
seeded.

Held: the config, the stack spec and ``ARCH_IDS`` (the reference's ten, in
its order); the init layout; ``ssd_scan`` against JAX's and against the
sequential recurrence, ``ssd_apply`` (the dt = 0 padding, the carried-in
state) and ``ssd_decode`` (in place) against JAX's in f32 at S = 7, 8 and 19
(below, at and across the chunk of 8); one layer bit for bit JAX's op by op;
``lm.forward`` logits and stats; prefill + decode against ``forward`` on
the appended tokens; the codes of the SSD leaves (a method with statistics
and a stats-free one); ``TTQEngine`` greedy tokens against the JAX engine's
by the near-tie rule; exact-length prefill; the refusals; the CLI.  On the
card (``gpu``): ``ttq_gemm`` at mamba2-1.3b's small output widths, and a
decode graph and a prefill graph over the SSD state bit for bit eager.

Tolerances: f32 layer functions to rtol 1e-5 (the chunk recurrence
associates its products in another order than JAX's ``associative_scan``).
bf16 model outputs against the jitted JAX forward elementwise to rtol 1e-1
and atol ATOL = 0.12, and to a relative L2 of 3e-2: on this config the
jitted forward differs from JAX's own op-by-op run by up to 0.059 in a logit
(XLA keeps f32 across fused bf16 ops), while the port equals the op-by-op
run bit for bit.  The near-tie bound is twice ATOL's measured gap: a flip
needs both logits to move."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as t_get
from repro_torch.core import KernelConfig, NO_QUANT, unpack_bits
from repro_torch.core import ttq_policy as t_policy
from repro_torch.kernels.ttq_gemm import gemm_splits
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import stack as TS
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.models.config import SSMCfg as TSSM
from repro_torch.quant import FusedRequantPlan, quantize_params
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 3e-2
ATOL = 0.12
NEAR_TIE = 0.2
MAX_LEN = 48
PROMPT = [((13 * i + 7) % 500) + 1 for i in range(19)]   # 19: three chunks
MAX_NEW = 10


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import get
    from repro.core import KVCacheConfig, ttq_policy
    from repro.models import layers as L
    from repro.models import lm
    from repro.models import stack as JS
    from repro.quant.api import FusedRequantPlan as JPlan
    from repro.quant.api import quantize_params as jquant
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get=get, arch_ids=J_ARCH_IDS, KV=KVCacheConfig,
        pol=ttq_policy, L=L, lm=lm, S=JS, Plan=JPlan, quant=jquant,
        ECfg=EngineConfig, Eng=TTQEngine)


def _tcfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TCfg)}
    kw["ssm"] = TSSM(**dataclasses.asdict(jcfg.ssm))
    return TCfg(**kw)


def _perturb_norms(jx, params, seed):
    """Every norm's gamma moved off its init value by N(0, 0.2)."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: (jx.jnp.asarray(np.asarray(v) + 0.2 * rng.standard_normal(
                np.shape(v)).astype(np.float32))
                if k == "gamma" else go(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return t
    return go(params)


@pytest.fixture(scope="module")
def model(jx):
    jcfg = jx.get("mamba2_1p3b", smoke=True)
    jp = _perturb_norms(jx, jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0)),
                        seed=17)
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, tcfg=_tcfg(jcfg), jp=jp, tp=tp)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(a)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _layer(tree, i=0):
    """Layer i of a stacked tree (numpy or torch leaves)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _dims(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, di // s.head_dim, s.head_dim, s.n_groups, s.d_state


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_spec_equal_the_reference(jx, smoke):
    """mamba2-1.3b field for field; one run of ``ssd`` layers, no MLP; the
    port's ``ARCH_IDS`` is the reference's list of ten."""
    assert ARCH_IDS == list(jx.arch_ids)
    tc, jc = t_get("mamba2_1p3b", smoke), jx.get("mamba2_1p3b", smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert TS.stack_spec(tc) == [((("ssd",)), jc.n_layers)] \
        == [(tuple(k), n) for k, n in jx.S.stack_spec(jc)]
    assert TS.mlp_kind(tc, "ssd") == jx.S.mlp_kind(jc, "ssd") == "none"
    if not smoke:
        assert (tc.n_layers, tc.d_model, tc.ssm.d_state, tc.ssm.chunk,
                tc.vocab) == (48, 2048, 128, 256, 50280)


def test_init_params_layout_matches_jax(jx, model):
    """The port's own init has the reference's tree (the five split
    projections, three convs, A_log, Dskip, dt_bias, the gated norm and
    w_out; no ln2 or MLP), shapes and dtypes; A = exp(A_log) in [1, 16]
    and softplus(dt_bias) in [1e-3, 0.1]."""
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
    assert "ln2" not in tp["stack"][0]["u0"]
    for k, a in lj.items():
        b = lt[k]
        assert tuple(a.shape) == tuple(b.shape), k
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), k
    mix = tp["stack"][0]["u0"]["mix"]
    A = torch.exp(mix["A_log"])
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert bool(((A >= 1 - 1e-5) & (A <= 16 + 1e-4)).all())
    assert bool(((dt >= 1e-3 - 1e-7) & (dt <= 0.1 + 1e-6)).all())
    assert bool((mix["Dskip"] == 1).all())


# ------------------------------------------------------------ the SSD scan

def _scan_inputs(cfg, S, seed, h0):
    """f32 (xh, dt, A, Bm, Cm, h0 or None) at length S, padded with dt = 0
    steps to a whole number of chunks as ``ssd_apply`` pads them."""
    _, nh, P, G, N = _dims(cfg)
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    xh, Bm, Cm = f(2, S, nh, P), f(2, S, G, N), f(2, S, G, N)
    dt = rng.uniform(1e-3, 0.2, (2, S, nh)).astype(np.float32)
    A = rng.uniform(1.0, 16.0, (nh,)).astype(np.float32)
    padn = (-S) % min(cfg.ssm.chunk, S)
    pad = lambda a: np.pad(a, [(0, 0), (0, padn)]  # noqa: E731
                           + [(0, 0)] * (a.ndim - 2))
    hh = f(2, nh, P, N) if h0 else None
    return (pad(xh), pad(dt), A, pad(Bm), pad(Cm), hh), padn


@pytest.mark.parametrize("h0", [False, True], ids=["zero state", "h0"])
@pytest.mark.parametrize("S", [7, 8, 19])
def test_ssd_scan_matches_jax_f32(jx, model, S, h0):
    """The chunked scan (chunk 8) against the reference's at S below, at
    and across the chunk (19: three chunks after its dt = 0 padding), from a
    zero state and from a carried-in h0: y and the last state."""
    args, _ = _scan_inputs(model.tcfg, S, seed=S, h0=h0)
    ch = model.tcfg.ssm.chunk
    yj, hj = jx.L.ssd_scan(*(None if a is None else jx.jnp.asarray(a)
                             for a in args[:5]), ch,
                           None if args[5] is None else jx.jnp.asarray(args[5]))
    yt, ht = TL.ssd_scan(*(torch.from_numpy(a) for a in args[:5]), ch,
                         None if args[5] is None else torch.from_numpy(args[5]))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-5)


def test_ssd_scan_is_the_sequential_recurrence(model):
    """``ssd_scan`` (f32 inside, as the reference's) against h_t =
    e^(−A·dt_t)·h_{t−1} + dt_t·B_t⊗x_t, y_t = C_t·h_t stepped one t at a
    time in f64, over 4 chunks from a carried-in h0 (the dual forms are the
    same function): to rtol 1e-4 and atol 1e-5, f32's rounding over 32
    steps."""
    cfg = model.tcfg
    (xh, dt, A, Bm, Cm, h0), _ = _scan_inputs(cfg, 32, seed=5, h0=True)
    xh, dt, A, Bm, Cm, h0 = (torch.from_numpy(a)
                             for a in (xh, dt, A, Bm, Cm, h0))
    y, hl = TL.ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm.chunk, h0)
    xh, dt, A, Bm, Cm, h0 = (t.double() for t in (xh, dt, A, Bm, Cm, h0))
    h, want = h0.clone(), []
    rep = xh.shape[2] // Bm.shape[2]
    Bh, Ch = (t.repeat_interleave(rep, dim=2) for t in (Bm, Cm))
    for t in range(xh.shape[1]):
        decay = torch.exp(-A[None] * dt[:, t])                   # (B,H)
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], xh[:, t], Bh[:, t])
        want.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    torch.testing.assert_close(y.double(), torch.stack(want, 1), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(hl.double(), h, rtol=1e-4, atol=1e-5)


def _mix(jx, model):
    return (_layer(jx.jax.tree.map(np.asarray,
                                   model.jp["stack"][0]["u0"]["mix"])),
            _layer(model.tp["stack"][0]["u0"]["mix"]))


def _ssd_state(cfg, seed):
    di, nh, P, G, N = _dims(cfg)
    rng = np.random.default_rng(seed)
    w = cfg.ssm.conv_width - 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"h": f(2, nh, P, N), "conv_x": f(2, w, di),
            "conv_B": f(2, w, G * N), "conv_C": f(2, w, G * N)}


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("S", [7, 8, 19])
def test_ssd_apply_matches_jax_f32(jx, model, S, carried):
    """The sequence-mode block on f32 activations (every product f32): the
    output and the returned state (h, three conv histories) against the
    reference's ``ssd_apply``, from zeros or from a carried-in state (h and
    conv histories: a prompt continued past a chunk boundary)."""
    jp, tp = _mix(jx, model)
    x = np.random.default_rng(S).standard_normal(
        (2, S, model.tcfg.d_model)).astype(np.float32)
    st = _ssd_state(model.tcfg, seed=S + 1) if carried else None
    yj, sj = jx.L.ssd_apply(
        model.jcfg, jp, jx.jnp.asarray(x), None, "", return_state=True,
        state=None if st is None else {k: jx.jnp.asarray(v)
                                       for k, v in st.items()})
    yt, sd = TL.ssd_apply(
        model.tcfg, tp, torch.from_numpy(x), None, "", return_state=True,
        state=None if st is None else {k: torch.from_numpy(v)
                                       for k, v in st.items()})
    assert yt.dtype == torch.float32 and set(sd) == set(sj)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    for k in sj:
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(sj[k]),
                                   rtol=1e-5, atol=1e-5)


def test_ssd_decode_in_place_matches_jax(jx, model):
    """Three decode steps on one state object: h and the conv histories
    change in place (same storage) and match the reference's functional
    steps; outputs too (f32)."""
    jp, tp = _mix(jx, model)
    st = _ssd_state(model.tcfg, seed=9)
    x = np.random.default_rng(10).standard_normal(
        (2, 3, model.tcfg.d_model)).astype(np.float32)
    js = {k: jx.jnp.asarray(v) for k, v in st.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    for t in range(3):
        yj, js = jx.L.ssd_decode(model.jcfg, jp, jx.jnp.asarray(x[:, t:t + 1]),
                                 js, jx.jnp.asarray(np.full((2,), t, np.int32)))
        yt, out = TL.ssd_decode(model.tcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                ts)
        assert out is ts and {k: v.data_ptr() for k, v in ts.items()} == ptrs
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        for k in st:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-5, atol=1e-5)
    assert not np.allclose(ts["h"].numpy(), st["h"])


def test_gemm_splits_at_the_small_output_widths():
    """``ttq_gemm``'s split rule at mamba2-1.3b's decode shapes (d 2048,
    T = 4, int4 g32, 132 SMs): w_dt (64 rows) and w_B/w_C (128 rows) take
    a split whose K slices are whole groups and code words and at least
    512 long; the wide projections too."""
    cfg = t_get("mamba2_1p3b")
    di, nh, _, G, N = _dims(cfg)
    D = cfg.d_model
    for dp, d in ((nh, D), (G * N, D), (di, D), (D, di)):
        s = gemm_splits(dp, d, 4, 4, 32, 132)
        assert s in (1, 2, 4, 8) and d % s == 0 and (d // s) % 32 == 0
        assert s == 1 or d // s >= 512
    assert gemm_splits(nh, D, 4, 4, 32, 132) == 4


# ------------------------------------------------------------------ forward

def test_layer_equals_jax_op_by_op(jx, model):
    """One ``ssd`` layer in sequence mode on bf16 activations at S = 19
    (three chunks; norm, mixer, no MLP) against the reference's
    ``apply_layer_seq`` run op by op: the bf16 output equal but for single
    bf16 roundings (rtol 2^-7) in at most 1% of its elements, where the f32
    chunk products, contracted in another order than XLA's, round across a
    bf16 boundary (1 of 2,432 here); the conv histories bit for bit, the
    f32 h to rtol 1e-5."""
    x = np.random.default_rng(3).standard_normal((2, 19, 64)).astype(
        np.float32)
    pj = jx.jax.tree.map(lambda a: a[0], model.jp["stack"][0]["u0"])
    yj, sj = jx.S.apply_layer_seq(model.jcfg, "ssd", pj,
                                  jx.jnp.asarray(x).astype(jx.jnp.bfloat16),
                                  None, "", want_state=True, max_len=24)
    yt, st = TS.apply_layer_seq(model.tcfg, "ssd",
                                _layer(model.tp["stack"][0]["u0"]),
                                torch.from_numpy(x).to(torch.bfloat16), None,
                                "", want_state=True, max_len=24)
    f32 = lambda a: np.asarray(a.astype(jx.jnp.float32))  # noqa: E731
    yt, yj = yt.float().numpy(), f32(yj)
    np.testing.assert_allclose(yt, yj, rtol=2 ** -7, atol=0)
    assert (yt != yj).mean() <= 1e-2
    assert set(st) == set(sj) == {"h", "conv_x", "conv_B", "conv_C"}
    for k in sj:
        tol = 1e-5 if st[k].dtype == torch.float32 else 0.0
        np.testing.assert_allclose(st[k].float().numpy(), f32(sj[k]),
                                   rtol=tol, atol=tol)


def test_forward_matches_jax(jx, model):
    """``lm.forward`` logits (B, S, V) and the stats tree at S = 19 (three
    chunks): against the jitted JAX forward within the stated tolerances;
    the stats are tapped on w_x and w_out only."""
    toks = _tokens(model.tcfg, 2, 19, seed=1)
    lj, sj, _ = jx.lm.forward(model.jcfg, model.jp,
                              {"tokens": jx.jnp.asarray(toks)},
                              collect_stats=True)
    lt, st, _ = tlm.forward(model.tcfg, model.tp,
                            {"tokens": torch.from_numpy(toks)},
                            collect_stats=True)
    assert lt.shape == (2, 19, model.tcfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=ATOL)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    assert set(st) == set(sj) == {"stack"}
    sj, st = sj["stack"][0], st["stack"][0]
    assert set(sj) == set(st) == {"u0.mix.w_x", "u0.mix.w_out"}
    for k in sj:
        a, b = np.asarray(sj[k]), st[k].numpy()
        assert a.shape == b.shape and _rel_l2(a, b) < REL_L2, k


@pytest.mark.parametrize("S", [8, 19])
def test_prefill_decode_matches_forward(model, S):
    """prefill at S (one whole chunk; three chunks, padded), then 10 decode
    steps (h and the conv histories carried) against ``forward`` on the
    appended tokens (the reference's tests/test_models_smoke.py:77
    tolerance); the prefill's last-row logits are forward's."""
    n = 10
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


# ------------------------------------------------------------------- engine

def _jax_logits_at(jx, model, jeng, prompt, out, t):
    seq = jx.jnp.asarray([list(prompt)], jx.jnp.int32)
    lg, state, _ = jx.lm.prefill(model.jcfg, model.jp, {"tokens": seq},
                                 max_len=MAX_LEN)
    for i in range(t):
        lg, state = jx.lm.decode_step(
            model.jcfg, jeng.qparams, state,
            jx.jnp.asarray([[out[i]]], jx.jnp.int32),
            jx.jnp.asarray([len(prompt) + i], jx.jnp.int32))
    return np.asarray(lg)[0]


def test_engine_matches_jax(jx, model):
    """Greedy tokens of both engines (int4 g32 packed weights, 4 slots,
    guards off) on a 19-token prompt (three chunks) and 10 new tokens:
    equal, or equal up to a near-tie (tests/test_torch_families.py); one
    requant each, prefilled at the exact length."""
    ekw = dict(max_slots=4, max_len=MAX_LEN, decode_chunk=2, guards=False)
    jeng = jx.Eng(model.jcfg, model.jp,
                  jx.pol(bits=4, group_size=32, rank=0, packed=True),
                  jx.ECfg(**ekw))
    jr = jeng.submit(PROMPT, max_new=MAX_NEW)
    a = list(jeng.run_all()[jr])
    teng = TEngine(model.tcfg, model.tp,
                   t_policy(bits=4, group_size=32, rank=0, packed=True,
                            kernel=KernelConfig(use_pallas=True)),
                   TECfg(**ekw), device="cpu")
    tr = teng.submit(PROMPT, max_new=MAX_NEW)
    b = list(teng.run_all()[tr])
    assert jeng.n_requants == teng.n_requants == 1
    assert teng.prefill_tokens == len(PROMPT)
    assert len(a) == len(b) == MAX_NEW
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if t is not None:
        lg = _jax_logits_at(jx, model, jeng, PROMPT, a, t)
        assert abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE, \
            (t, a[t], b[t], float(lg[a[t]]), float(lg[b[t]]))


def test_exact_length_prefill(model):
    """The SSM engine prefills at each prompt's own length (pad tokens
    would run through the recurrence): two prompts of one length share a
    group, a prompt past the largest bucket is admitted, and the tokens
    of a prompt served beside others equal its tokens served alone."""
    pol = NO_QUANT
    kw = dict(max_slots=3, max_len=64, prompt_buckets=(16,), guards=False)
    eng = TEngine(model.tcfg, model.tp, pol, TECfg(**kw), device="cpu")
    assert eng.scheduler.exact_buckets and eng.scheduler.bucket(19) == 19
    prompts = [PROMPT[:7], PROMPT[1:8], PROMPT + PROMPT[:11]]
    rids = [eng.submit(p, max_new=3) for p in prompts]
    outs = eng.run_all()
    assert eng.prefill_tokens == 7 + 7 + 30
    alone = TEngine(model.tcfg, model.tp, pol, TECfg(**kw), device="cpu")
    r = alone.submit(prompts[2], max_new=3)
    assert list(alone.run_all()[r]) == list(outs[rids[2]])


# -------------------------------------------------------------------- codes

@pytest.fixture(scope="module")
def stats(jx, model):
    toks = jx.jnp.asarray(_tokens(model.jcfg, 2, 19, seed=4))
    _, _, st = jx.lm.prefill(model.jcfg, model.jp, {"tokens": toks},
                             max_len=24)
    return types.SimpleNamespace(
        j=st, t=params_from_jax(jx.jax.tree.map(np.asarray, st),
                                device="cpu"), count=float(toks.size))


def _codes_equal(jx, a, b, where):
    a = jx.jax.tree.map(np.asarray, a)
    d = b.in_features
    if b.packed is not None:
        ca = unpack_bits(torch.from_numpy(np.array(a.packed)), d, 4).numpy()
        cb = unpack_bits(b.packed, d, 4).numpy()
    else:
        ca, cb = np.asarray(a.wint), b.wint.numpy()
    ca, cb = ca.astype(np.int64), cb.astype(np.int64)
    assert np.abs(ca - cb).max() <= 1 and (ca != cb).mean() <= 2e-3, where
    np.testing.assert_allclose(b.dinv.numpy(), a.dinv, rtol=1e-6)
    np.testing.assert_allclose(b.scale.numpy(), a.scale, rtol=1e-5)
    np.testing.assert_allclose(b.zero.numpy(), a.zero, rtol=1e-5, atol=1e-6)


def _at(tree, ps):
    for k in ps.split("."):
        tree = tree[int(k) if k.isdigit() else k]
    return tree


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_ssd_codes_match_jax(jx, model, stats, use_kernel):
    """The fused requant plan with statistics (TTQ int4 g32 packed): the
    members are the reference's (the five projections, sharing w_x's
    statistics, and w_out; convs, A_log, Dskip, dt_bias and the norm stay
    in full precision) and so are the families; every member's codes equal
    except ±1 at round-half ties, S, Z and 1/D within f32."""
    pol = dict(bits=4, group_size=32, rank=0, packed=True)
    jplan = jx.Plan(model.jp, stats.j, jx.pol(**pol))
    plan = FusedRequantPlan(model.tp, stats.t, t_policy(
        **pol, kernel=KernelConfig(use_pallas=use_kernel)))
    fam = lambda p: sorted(sorted(m.path_str for m in ms)  # noqa: E731
                           for ms in p.families.values())
    assert fam(plan) == fam(jplan) and not jplan.eager
    members = {m.path_str for ms in plan.families.values() for m in ms}
    assert members == {f"stack.0.u0.mix.{w}" for w in
                       ("w_z", "w_x", "w_B", "w_C", "w_dt", "w_out")}
    jq = jplan.run(model.jp, stats.j, stats.count)
    tq = plan.run(model.tp, stats.t, stats.count)
    for ps in sorted(members):
        _codes_equal(jx, _at(jq, ps), _at(tq, ps), ps)


@pytest.mark.parametrize("skip_convs", [True, False],
                         ids=["default skip", "convs too"])
def test_stats_free_codes_match_jax(jx, model, skip_convs):
    """A stats-free method (rtn) takes every stacked leaf of 3 or more
    dimensions its policy does not skip (int4 g16: w_B's and the convs'
    widths are 16), as the reference does: the
    default skip list keeps the convs (``conv*``) in full precision; with
    ``conv*`` taken off it, the stacked (n, 4, ·) convs are quantized too.
    The 2-D stacked vectors (A_log, Dskip, dt_bias) never are.  Codes
    equal the reference's except ±1 at ties."""
    jpol, tpol = (pol(rank=0, group_size=16).with_(method="rtn")
                  for pol in (jx.pol, t_policy))
    if not skip_convs:
        skip = tuple(s for s in jpol.skip if s != "conv*")
        jpol, tpol = jpol.with_(skip=skip), tpol.with_(skip=skip)
    jq = jx.quant(model.jp, None, jpol)
    tq = quantize_params(model.tp, None, tpol)

    def quantized(t, path=""):
        if isinstance(t, dict):
            return set().union(*(quantized(v, f"{path}.{k}")
                                 for k, v in t.items()))
        if isinstance(t, list):
            return set().union(*(quantized(v, f"{path}.{i}")
                                 for i, v in enumerate(t)))
        return {path[1:]} if hasattr(t, "bits") else set()
    got = quantized(tq)
    assert got == quantized(jq)
    assert ("stack.0.u0.mix.conv_x" in got) is not skip_convs
    assert "stack.0.u0.mix.w_dt" in got
    assert not any(w in p for p in got for w in ("A_log", "Dskip", "dt_bias"))
    for ps in sorted(got):
        _codes_equal(jx, _at(jq, ps), _at(tq, ps), ps)


# ----------------------------------------------------------------- refusals

@pytest.mark.parametrize("kw,match", [
    (dict(kv_paged=True), "paged KV cache supports plain attention"),
    (dict(speculate_k=2), "speculate_k needs a plain-attention family"),
    (dict(prefill_chunk=16), "prefill_chunk needs a plain-attention family"),
], ids=["kv_paged", "speculate_k", "prefill_chunk"])
def test_ssm_misuse_raises(jx, model, kw, match):
    """The paged pool, speculation and chunked prefill on the SSM family
    fail with the reference's ValueError, on both engines."""
    with pytest.raises(ValueError, match=match):
        jx.Eng(model.jcfg, model.jp, jx.pol(rank=0), jx.ECfg(**kw))
    with pytest.raises(ValueError, match=match):
        TEngine(model.tcfg, model.tp, t_policy(rank=0), TECfg(**kw),
                device="cpu")


def test_cli_serves_the_ssm_family(capsys):
    """``python -m repro_torch.launch.serve --arch mamba2_1p3b --smoke
    --device cpu`` serves its requests at exact lengths; ``--kv-paged``
    fails with the reference's message."""
    from repro_torch.launch import serve
    base = ["--arch", "mamba2_1p3b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--max-len", "48"]
    eng, outs = serve.main(base)
    assert len(outs) == 3 and all(len(v) == 4 for v in outs.values())
    assert eng.scheduler.exact_buckets
    assert "arch=mamba2-smoke requests=3 tokens=12" in capsys.readouterr().out
    with pytest.raises(ValueError, match="paged KV cache supports plain"):
        serve.main(base + ["--kv-paged"])


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels and graphs run only there")
    from repro_torch.kernels import build
    build.lib()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [64, 128])
def test_gemm_at_the_small_output_widths(cuda, dp):
    """``ttq_gemm`` at w_dt's (64 × 2048) and w_B/w_C's (128 × 2048)
    decode shapes, T = 4, int4 g32, at the rule's split: within one bf16
    rounding of the plain version (rtol 2^-7, atol 2e-4·(d/256)^0.5, as
    ``chip_smoke.py`` holds every GEMM call)."""
    from repro_torch.core.qdq import pack_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_gemm import ttq_gemm
    d, g = 2048, 32
    gen = torch.Generator(device=cuda).manual_seed(dp)
    codes = torch.randint(0, 16, (dp, d), generator=gen, device=cuda)
    pk = pack_bits(codes.to(torch.int32), 4)
    S = torch.rand((dp, d // g), generator=gen, device=cuda) * 0.02
    Z = torch.randn((dp, d // g), generator=gen, device=cuda) * 0.1
    dinv = torch.rand((d,), generator=gen, device=cuda) + 0.5
    x = torch.randn((4, d), generator=gen, device=cuda).to(torch.bfloat16)
    y = ttq_gemm(x, pk, S, Z, dinv, bits=4, group_size=g)
    want = ref.ttq_gemm_ref(x, pk, S, Z, bits=4, group_size=g, dinv=dinv)
    torch.testing.assert_close(y.float(), want.float(), rtol=2 ** -7,
                               atol=2e-4 * (d / 256) ** 0.5)


GPU_CFG = TCfg(name="ssm-gpu", family="ssm", n_layers=2, d_model=256,
               n_heads=0, n_kv_heads=0, d_ff=0, vocab=512,
               ssm=TSSM(d_state=32, head_dim=32, expand=2, chunk=16,
                        conv_width=4, n_groups=1))


@pytest.mark.gpu
def test_ssd_graphs_equal_eager(cuda):
    """On the card, an SSM engine (int4 g32 packed weights through
    ``ttq_gemm``, guards on) serving prompts across chunk boundaries: every
    decode block a graph replay over the SSD state written in place, every
    prefill replay at an exact length, each bit for bit the eager code on
    clones of the state it started from; one prefill graph per distinct
    prompt length, and a rerun's tokens equal the first run's."""
    params = tlm.init_params(GPU_CFG, torch.Generator(device=cuda)
                             .manual_seed(0), device=cuda)
    pol = t_policy(bits=4, group_size=32, rank=0, packed=True,
                   kernel=KernelConfig(use_pallas=True))
    kw = dict(max_slots=2, max_len=96, decode_chunk=4,
              recalibrate_tokens=10 ** 9)
    prompts = [PROMPT[:9], PROMPT + PROMPT[:21], PROMPT[:9][::-1]]
    eng = TEngine(GPU_CFG, params, pol, TECfg(**kw), device=cuda)
    r = eng.runner
    real_block, real_admit = r.decode_block, r.admit_group
    seen = {"blocks": 0, "prefills": 0}

    def clone(t):
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, list):
            return [clone(v) for v in t]
        return t.clone()

    def block(params, draft=None, small_chunk=False):
        snap = (clone(r.state), r.cur_tok.clone(), r.pos.clone(),
                r.done.clone(), r.remaining.clone())
        toks, valid, done, fault = real_block(params, draft, small_chunk)
        ys, _ = tlm.decode_many(GPU_CFG, params, *snap, None, K=r.K,
                                max_len=96, kcfg=eng.kncfg,
                                detect_faults=True)
        assert np.array_equal(toks, ys[0].cpu().numpy())
        assert np.array_equal(valid, ys[1].cpu().numpy())
        seen["blocks"] += 1
        return toks, valid, done, fault

    def admit(params, group):
        snap, n = clone(r.state), len(r._prefills)
        first, fin, stats = real_admit(params, group)
        if len(r._prefills) == n:
            inp = {k: torch.from_numpy(v).to(cuda)
                   for k, v in r._prefill_inputs(group).items()}
            want, _ = r._prefill(params, snap, inp, 0, None)
            assert np.array_equal(first, want.cpu().numpy())
            assert all(torch.equal(a, b) for a, b in zip(
                _leaves(r.state), _leaves(snap)))
            seen["prefills"] += 1
        return first, fin, stats
    r.decode_block, r.admit_group = block, admit
    got = []
    for _ in range(2):                      # the second admissions replay
        rids = [eng.submit(p, max_new=8) for p in prompts]
        res = eng.run_all()
        got.append([list(res[i]) for i in rids])
    assert got[0] == got[1] and seen["blocks"] > 2 and seen["prefills"] >= 3
    assert len(r._prefills) == len({len(p) for p in prompts})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
