"""The port's training path against the JAX package's, on the CPU: the
schedules, AdamW, ``lm.loss_fn`` and its gradients for every mixer kind,
``make_train_step``, the Trainer's learn / crash-restart / straggler
loops, checkpoints (each package reads the other's), the data pipeline
and the train CLI.  (That no module of the port imports JAX, and that the
training entry points refuse a missing card, tests/test_torch_isolation.py
holds for every port file.)

Configs: the reference's training tests' dense model (2 layers, d 64,
vocab 64, ``tests/test_training.py``) and, for the gradients, the
reference's smoke config of each mixer kind.  Weights come from the JAX
package's ``lm.init_params`` carried across by ``params_from_jax``; both
sides get the same numpy batches.

Tolerances:

* the schedules, in f32 on both sides, to rtol 1e-6;
* AdamW over three steps to rtol 1e-5 (f32 arithmetic in another order:
  a few ulp);
* ``loss_fn`` with f32 parameters to rtol 1e-5;
* gradients per leaf by relative L2, GRAD_F32 = 1e-4 (measured ~2e-6),
  against a floor of 1e-4 of the whole gradient's norm: llama4's top-1
  router weight is p/p = 1, so its gradient is zero up to rounding on
  both sides.  whisper's encoder runs in bf16 whatever the parameters'
  dtype (the reference casts the frames to bf16), so its gradients carry
  bf16 rounding and are held to GRAD_BF16 = 3e-2, the relative L2 of the
  port's bf16 model outputs (tests/test_torch_models.py);
* three ``make_train_step`` steps: with f32 compute the losses to rtol
  1e-5 and each leaf's update (master − initial master) to a relative L2
  of 1e-3 (an AdamW step is ~lr·sign(g), so a component whose gradient is
  rounding noise moves by ±lr on either side); with bf16 compute the
  losses to rtol 1e-2 and the updates to a relative L2 of 0.1 (bf16
  rounding of the gradients, amplified as above).
"""
import ast
import os
import types

import numpy as np
import pytest
import torch

from repro_torch._tree import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager as TCkpt
from repro_torch.configs import get as t_get
from repro_torch.data import DataConfig as TDC
from repro_torch.data import make_domain as t_make_domain
from repro_torch.data import token_stream as t_stream
from repro_torch.launch import train as t_train_cli
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.optim import AdamWConfig as TAdamCfg
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.optim import adamw_update as t_adamw_update
from repro_torch.optim import clip_by_global_norm as t_clip
from repro_torch.optim import cosine_schedule as t_cosine
from repro_torch.optim import linear_warmup as t_warmup
from repro_torch.runtime import FailureInjector
from repro_torch.training import TrainConfig as TTC
from repro_torch.training import Trainer as TTrainer
from repro_torch.training import make_train_step as t_make_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG_KW = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=96, vocab=64)
DC_KW = dict(vocab=64, seq_len=32, batch=8, seed=1)
GRAD_F32, GRAD_BF16 = 1e-4, 3e-2
GRAD_ARCHS = {"gemma_7b": "dense GLU + RMSNorm",
              "starcoder2_15b": "plain MLP + LayerNorm",
              "chameleon_34b": "qk-norm",
              "recurrentgemma_9b": "hybrid RG-LRU",
              "llama4_scout_17b_a16e": "MoE",
              "deepseek_v2_lite_16b": "MLA",
              "mamba2_1p3b": "SSD",
              "whisper_medium": "enc-dec with frames"}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager
    from repro.configs import get
    from repro.data import pipeline as jpipe
    from repro.models import ModelConfig, lm
    from repro.optim import (AdamWConfig, adamw_init, adamw_update,
                             clip_by_global_norm, cosine_schedule,
                             linear_warmup)
    from repro.training import TrainConfig, make_train_step
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Ckpt=CheckpointManager, get=get, pipe=jpipe,
        MCfg=ModelConfig, lm=lm, AdamCfg=AdamWConfig, adamw_init=adamw_init,
        adamw_update=adamw_update, clip=clip_by_global_norm,
        cosine=cosine_schedule, warmup=linear_warmup, TC=TrainConfig,
        make_step=make_train_step)


def _np(jx, tree):
    return jx.jax.tree.map(lambda a: np.asarray(a, np.float32)
                           if a.dtype == jx.jnp.bfloat16 else np.asarray(a),
                           tree)


def _pairs(jtree, ttree):
    """(path, JAX leaf, port leaf) aligned by path (JAX orders dict keys,
    the port keeps insertion order)."""
    jd = dict(tree_leaves_with_path(jtree))
    return [(path, jd[path], b) for path, b in tree_leaves_with_path(ttree)]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


def _batch_np(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------

def test_schedules_match_jax(jx):
    warmup, total, peak = 10, 50, 3e-4
    for s in range(2 * total + 1):
        np.testing.assert_allclose(
            t_cosine(s, warmup, total, peak),
            float(jx.cosine(jx.jnp.asarray(s), warmup, total, peak)),
            rtol=1e-6)
        np.testing.assert_allclose(
            t_warmup(s, warmup, peak),
            float(jx.warmup(jx.jnp.asarray(s), warmup, peak)), rtol=1e-6)


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": [{"b": rng.standard_normal((7,)).astype(np.float32)}],
            "h": rng.standard_normal((3, 4)).astype(np.float32)}


def test_adamw_three_steps_match_jax(jx):
    """Three steps on a tree of f32 and bf16 leaves, gradients seeded,
    the lr varying: masters, moments, new params and metrics."""
    jnp = jx.jnp
    rng = np.random.default_rng(0)
    p0 = _opt_tree(rng)
    bf16 = {"w": False, "blk": [{"b": True}], "h": True}
    jp = jx.jax.tree.map(lambda a, b: jnp.asarray(a).astype(
        jnp.bfloat16 if b else jnp.float32), p0, bf16)
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    cfg = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               grad_clip=1.0)
    jst, tst = jx.adamw_init(jp), t_adamw_init(tp)
    for i in range(3):
        g = jx.jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.5)
                            .astype(np.float32), p0)
        jg = jx.jax.tree.map(lambda a, b: jnp.asarray(a).astype(
            jnp.bfloat16 if b else jnp.float32), g, bf16)
        tg = params_from_jax(jx.jax.tree.map(np.asarray, jg), device="cpu")
        lr = 1e-2 * (i + 1)
        jnew, jst, jm = jx.adamw_update(jg, jst, jx.AdamCfg(**cfg),
                                        params=jp, lr_t=lr)
        tnew, tst, tm = t_adamw_update(tg, tst, TAdamCfg(**cfg), params=tp,
                                       lr_t=lr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(tm["lr"]) == pytest.approx(lr)
        for k in ("master", "m", "v"):
            for path, a, b in _pairs(_np(jx, jst[k]), tst[k]):
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                           atol=1e-7, err_msg=f"{k} {path}")
        for _, a, b in _pairs(_np(jx, jnew), tnew):
            np.testing.assert_allclose(b.float().numpy(), a, rtol=1e-2)
        assert [b.dtype for b in tree_leaves(tnew)] == \
            [b.dtype for b in tree_leaves(tp)]
        assert int(tst["step"]) == int(jst["step"]) == i + 1


@pytest.mark.parametrize("max_norm", [0.5, 1e9], ids=["clipped", "not"])
def test_clip_by_global_norm_matches_jax(jx, max_norm):
    rng = np.random.default_rng(2)
    g = _opt_tree(rng)
    jc, jn = jx.clip(jx.jax.tree.map(jx.jnp.asarray, g), max_norm)
    tc, tn = t_clip(params_from_jax(g, device="cpu"), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for _, a, b in _pairs(_np(jx, jc), tc):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6)


def test_adamw_matches_reference_math():
    """One AdamW step vs the hand-computed update (the reference's
    tests/test_training.py case)."""
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.5]])}
    cfg = TAdamCfg(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                   grad_clip=1e9)
    newp, _, _ = t_adamw_update(g, t_adamw_init(p), cfg, params=p)
    m, v = 0.1 * 0.5, 0.01 * 0.25
    mh, vh = m / 0.1, v / 0.01
    expect = 1.0 - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(float(newp["w"][0, 0]), expect, rtol=1e-5)


# ---------------------------------------------------------------------------
# loss_fn and gradients per mixer kind
# ---------------------------------------------------------------------------

def _f32_model(jx, jcfg, seed=0):
    jp = jx.jax.tree.map(lambda a: a.astype(jx.jnp.float32),
                         jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("mask", [None, "full", "shifted"])
def test_loss_fn_matches_jax(jx, mask):
    jcfg = jx.MCfg(**CFG_KW)
    jp, tp = _f32_model(jx, jcfg)
    toks = _batch_np(64, 4, 16, seed=3)
    jb, tb = {"tokens": jx.jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if mask is not None:
        S = 16 if mask == "full" else 15
        mk = (np.random.default_rng(4).random((4, S)) > 0.3).astype(np.float32)
        jb["mask"], tb["mask"] = jx.jnp.asarray(mk), torch.from_numpy(mk)
    jl, jaux = jx.lm.loss_fn(jcfg, jp, jb)
    tl, taux = tlm.loss_fn(TCfg(**CFG_KW), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(taux["tokens"]) == float(jaux["tokens"])


@pytest.fixture(scope="module", params=list(GRAD_ARCHS))
def grads(jx, request):
    """One JAX gradient per mixer kind (jitted once), f32 parameters."""
    arch = request.param
    jcfg, tcfg = jx.get(arch, smoke=True), t_get(arch, smoke=True)
    jp, tp = _f32_model(jx, jcfg)
    rng = np.random.default_rng(3)
    toks = _batch_np(jcfg.vocab, 2, 16, seed=3)
    jb, tb = {"tokens": jx.jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if jcfg.family == "encdec":
        fr = rng.standard_normal((2, jcfg.encdec.n_frames, jcfg.d_model)) \
            .astype(np.float32)
        jb["frames"], tb["frames"] = jx.jnp.asarray(fr), torch.from_numpy(fr)
    vg = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jx.lm.loss_fn(jcfg, p, b)[0]))
    jl, jg = vg(jp, jb)
    return types.SimpleNamespace(arch=arch, tcfg=tcfg, tp=tp, tb=tb,
                                 loss=float(jl), g=_np(jx, jg))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_grads_match_jax_per_mixer_kind(grads, remat):
    leaves = tree_leaves(grads.tp)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, _ = tlm.loss_fn(grads.tcfg, grads.tp, grads.tb, remat=remat)
        tg = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    bf16_enc = grads.arch == "whisper_medium"
    np.testing.assert_allclose(float(loss.detach()), grads.loss,
                               rtol=1e-3 if bf16_enc else 1e-5)
    tol = GRAD_BF16 if bf16_enc else GRAD_F32
    jl = list(tree_leaves_with_path(grads.g))
    floor = 1e-4 * np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                               for _, a in jl))
    assert len(jl) == len(tg)
    jd = dict(jl)
    for (path, _), b in zip(tree_leaves_with_path(grads.tp), tg):
        a = jd[path]
        assert b.shape == a.shape, path
        err = np.linalg.norm(a.astype(np.float64) - b.double().numpy())
        assert err <= tol * max(np.linalg.norm(a), floor), \
            (GRAD_ARCHS[grads.arch], path, err, np.linalg.norm(a))


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

def _three_steps(jx, param_dtypes):
    jcfg, tcfg = jx.MCfg(**CFG_KW), TCfg(**CFG_KW)
    jp, tp = _f32_model(jx, jcfg, seed=1)
    kw = dict(n_microbatches=1, remat=False, total_steps=10, warmup=1)
    jdt = None if param_dtypes is None else jx.jax.tree.map(
        lambda _: jx.jnp.float32, jp)
    tdt = None if param_dtypes is None else jx.jax.tree.map(
        lambda _: torch.float32, jp)
    jstep = jx.jax.jit(jx.make_step(jcfg, jx.TC(**kw), param_dtypes=jdt))
    tstep = t_make_step(tcfg, TTC(**kw), param_dtypes=tdt)
    jst, tst = jx.adamw_init(jp), t_adamw_init(tp)
    m0 = _np(jx, jst["master"])
    losses = []
    for i in range(3):
        toks = _batch_np(64, 8, 32, seed=10 + i)
        jst, jm = jstep(jst, {"tokens": jx.jnp.asarray(toks)})
        tst, tm = tstep(tst, {"tokens": torch.from_numpy(toks)})
        losses.append((float(jm["loss"]), float(tm["loss"])))
    return m0, _np(jx, jst["master"]), tst["master"], losses


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_train_step_matches_jax(jx, f32):
    m0, jm, tm, losses = _three_steps(jx, torch.float32 if f32 else None)
    rtol, upd_tol = (1e-5, 1e-3) if f32 else (1e-2, 0.1)
    for a, b in losses:
        np.testing.assert_allclose(b, a, rtol=rtol)
    j0 = dict(tree_leaves_with_path(m0))
    for path, a, b in _pairs(jm, tm):
        a0 = j0[path]
        assert _rel_l2(a - a0, b.numpy() - a0) < upd_tol, path


def _port_step(nmb, remat, toks, tp):
    tc = TTC(n_microbatches=nmb, remat=remat, total_steps=10, warmup=1)
    st = t_adamw_init(tp)
    st, m = t_make_step(TCfg(**CFG_KW), tc)(st, {"tokens": toks})
    return st, m


@pytest.fixture(scope="module")
def port_model(jx):
    return _f32_model(jx, jx.MCfg(**CFG_KW), seed=1)[1]


def test_microbatch_equivalence(port_model):
    """nmb=1 vs nmb=4 give the same update (the reference's test, its
    tolerances)."""
    toks = torch.from_numpy(_batch_np(64, 8, 32, seed=0))
    (a, ma), (b, mb) = (_port_step(n, n > 1, toks, port_model)
                        for n in (1, 4))
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                               rtol=2e-2)
    for x, y in zip(tree_leaves(a["master"]), tree_leaves(b["master"])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-2, atol=2e-3)


def test_remat_gives_the_same_gradients(port_model):
    """remat recomputes the same ops on the CPU: the updates are equal bit
    for bit."""
    toks = torch.from_numpy(_batch_np(64, 8, 32, seed=0))
    (a, ma), (b, mb) = (_port_step(2, r, toks, port_model)
                        for r in (False, True))
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    for x, y in zip(tree_leaves(a["master"]), tree_leaves(b["master"])):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the Trainer (the reference's tests/test_training.py on the port)
# ---------------------------------------------------------------------------

def _trainer(tc, start_step=0):
    return TTrainer(TCfg(**CFG_KW), tc,
                    t_stream(TDC(**DC_KW), 0, start_step=start_step,
                             device="cpu"),
                    device="cpu")


def test_trainer_learns():
    tr = _trainer(TTC(n_microbatches=1, remat=False, total_steps=100,
                      warmup=2))
    log = tr.run(15)
    assert log[-1]["loss"] < log[0]["loss"]


def test_crash_restart_resumes(tmp_path):
    tc = TTC(n_microbatches=1, remat=False, checkpoint_every=4,
             checkpoint_dir=str(tmp_path), total_steps=50, warmup=2)
    tr = _trainer(tc)
    tr.failure_hook = FailureInjector({6})
    with pytest.raises(FailureInjector.Crash):
        tr.run(10)
    tr2 = _trainer(tc, start_step=4)
    assert tr2.restore_if_available()
    assert tr2.step == 4
    tr2.run(4)
    assert tr2.step == 8


def test_straggler_deadline_logged():
    tr = _trainer(TTC(n_microbatches=1, remat=False, total_steps=10,
                      warmup=1, step_deadline_s=1e-9))
    tr.run(3)
    assert len(tr.skipped_steps) == 3


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nest": {"b": torch.ones((2, 2), dtype=torch.bfloat16)},
            "lst": [torch.zeros((5,), dtype=torch.int32)]}


def test_checkpoint_roundtrip(tmp_path):
    mgr = TCkpt(str(tmp_path), keep=2)
    t = _ckpt_tree()
    mgr.save(10, t)
    out = mgr.restore(10, t)
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_keep_n_and_latest(tmp_path):
    mgr = TCkpt(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _ckpt_tree())
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = TCkpt(str(tmp_path), keep=3)
    mgr.save(5, _ckpt_tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000009"))
    assert mgr.latest_step() == 5


@pytest.fixture(scope="module")
def opt_pair(jx):
    """A JAX opt state (bf16 masters' source, after one AdamW step so m
    and v are nonzero) and the port's of the same nesting."""
    jcfg = jx.MCfg(**CFG_KW)
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(2))
    jst = jx.adamw_init(jp)
    g = jx.jax.tree.map(lambda p: jx.jnp.full(p.shape, 0.01, p.dtype), jp)
    _, jst, _ = jx.adamw_update(g, jst, jx.AdamCfg(), params=jp)
    tst = t_adamw_init(params_from_jax(jx.jax.tree.map(np.asarray, jp),
                                       device="cpu"))
    return jst, tst


def test_jax_checkpoint_restores_into_the_port(jx, opt_pair, tmp_path):
    jst, tst = opt_pair
    jx.Ckpt(str(tmp_path)).save(7, {"opt": jst})
    mgr = TCkpt(str(tmp_path))
    assert mgr.latest_step() == 7
    out = mgr.restore(7, {"opt": tst})["opt"]
    for path, a, b in _pairs(_np(jx, {"opt": jst}), {"opt": out}):
        assert b.dtype == (torch.int32 if path[-1] == "step"
                           else torch.float32)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))


def test_port_checkpoint_restores_through_jax(jx, opt_pair, tmp_path):
    jst, tst = opt_pair
    tst = {k: (v.clone() if k == "step" else
               tree_map(lambda t: t + 0.25, v)) for k, v in tst.items()}
    TCkpt(str(tmp_path)).save(3, {"opt": tst, "bf": torch.full(
        (3,), 1.5, dtype=torch.bfloat16)})
    like = {"opt": jst, "bf": jx.jnp.zeros((3,), jx.jnp.bfloat16)}
    out = jx.Ckpt(str(tmp_path)).restore(3, like)
    assert out["bf"].dtype == jx.jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["bf"], np.float32), 1.5)
    for path, b, a in _pairs(_np(jx, {"opt": out["opt"]}), {"opt": tst}):
        np.testing.assert_array_equal(b, a.numpy(), err_msg=str(path))


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domain", [0, 3])
def test_make_domain_is_jax_bit_for_bit(jx, domain):
    jd = jx.pipe.make_domain(jx.pipe.DataConfig(**DC_KW), domain)
    td = t_make_domain(TDC(**DC_KW), domain)
    for f in ("succ", "probs", "start"):
        a, b = np.asarray(getattr(jd, f)), getattr(td, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _take(it, n):
    return [next(it)["tokens"].clone() for _ in range(n)]


def test_token_stream_deterministic_resumes_and_slices():
    dc = TDC(**DC_KW)
    a = _take(t_stream(dc, 0, device="cpu"), 4)
    assert all(x.shape == (8, 32) and x.dtype == torch.int32 for x in a)
    assert all(torch.equal(x, y)
               for x, y in zip(a, _take(t_stream(dc, 0, device="cpu"), 4)))
    assert all(torch.equal(x, y) for x, y in
               zip(a[2:], _take(t_stream(dc, 0, start_step=2,
                                         device="cpu"), 2)))
    for h in range(4):
        rows = _take(t_stream(dc, 0, host_id=h, n_hosts=4, device="cpu"), 2)
        for x, full in zip(rows, a):
            assert torch.equal(x, full[2 * h:2 * h + 2])
    other = _take(t_stream(dc, 1, device="cpu"), 1)[0]
    assert not torch.equal(other, a[0])
    assert not torch.equal(a[0], a[1])


def test_every_bigram_allowed_and_frequencies_follow_probs():
    """Every transition lies in ``succ``; over 64 × 512 draws the
    empirical transition frequencies of each well-visited token (≥ 400
    visits) lie within 0.08 of ``probs`` (summed over repeated successors):
    ~4 standard deviations of a frequency at 400 draws."""
    dc = TDC(vocab=64, seq_len=512, batch=64, seed=5)
    spec = t_make_domain(dc, 0)
    toks = next(t_stream(dc, 0, device="cpu"))["tokens"].long()
    cur, nxt = toks[:, :-1].reshape(-1), toks[:, 1:].reshape(-1)
    succ = spec.succ.long()
    assert bool((succ[cur] == nxt[:, None]).any(1).all())
    counts = torch.zeros((64, 64), dtype=torch.float64)
    counts.index_put_((cur, nxt), torch.ones_like(cur, dtype=torch.float64),
                      accumulate=True)
    expect = torch.zeros((64, 64), dtype=torch.float64)
    expect.scatter_add_(1, succ, spec.probs.double())
    visits = counts.sum(1)
    well = visits >= 400
    assert int(well.sum()) >= 8
    freq = counts[well] / visits[well, None]
    assert float((freq - expect[well]).abs().max()) < 0.08


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_trains_saves_and_resumes(tmp_path, capsys):
    """``--steps 10`` checkpoints at step 10 (every max(10, steps/3)
    steps, the reference's rule); ``--resume`` restarts there."""
    base = ["--arch", "gemma_7b", "--smoke", "--device", "cpu", "--seq",
            "16", "--batch", "4", "--ckpt", str(tmp_path)]
    tr = t_train_cli.main(base + ["--steps", "10"])
    assert tr.step == 10 and TCkpt(str(tmp_path)).latest_step() == 10
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 6 and out[0].startswith("{'step': 0,")
    tr2 = t_train_cli.main(base + ["--steps", "3", "--resume"])
    assert tr2.step == 13
    assert [m["step"] for m in tr2.metrics_log] == [10, 11, 12]
    assert all(np.isfinite(m["loss"]) for m in tr2.metrics_log)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_1p3b",
                                  "deepseek_v2_lite_16b",
                                  "llama4_scout_17b_a16e", "whisper_medium"])
def test_train_cli_tensor_parallel(arch, capsys):
    """``--model-parallel 2`` trains every family (two spawned ranks; the
    encoder-decoder family's batches carry frames): rank 0 prints its
    steps' lines, with finite losses and grad norms.
    tests/test_torch_parallel_training_families.py holds the runs to
    world 1."""
    out = t_train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--model-parallel", "2", "--steps", "2",
                            "--seq", "16", "--batch", "4"])
    lines = [ast.literal_eval(x)
             for x in capsys.readouterr().out.strip().splitlines()]
    assert out.step == 2 and [m["step"] for m in lines] == [0, 1, 0, 1]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in lines)
