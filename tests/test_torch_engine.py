"""The port's TTQEngine against the JAX package's on the same weights, on
the CPU: the prompts of tests/test_fused_path.py:54, bits {4, 8} × KV
{int8, int4}, decode_chunk=2.

Both engines admit all three prompts in one round, calibrate once and
requantize once, then decode on that tree.  The per-step logits are
replayed teacher-forced from each engine's own quantized tree (prefill,
then decode steps fed the JAX engine's tokens) and compared within the
bf16-residual tolerance; the greedy tokens of the two engines must be equal
wherever JAX's top-2 logit margin exceeds twice that tolerance's atol (a
flip needs both logits to move toward each other)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import KernelConfig
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import TTQEngine as TEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPTS = [[5, 9, 17, 3], [8, 8, 1], [100, 50, 25, 12]]
MAX_NEW, MAX_LEN, BUCKET = 5, 48, 16
RTOL = 1e-1
# (atol, relative L2) per KV layout.  int8: the bf16-residual precedent of
# tests/test_fused_path.py:103 and 3x the ~1e-2 relative L2 measured.  int4:
# the two frameworks' bf16 k/v differ by an ulp now and then, and near a
# rounding boundary that flips an int4 code by one step (1/7 of the row's
# max), so the logits move up to ~0.14 (~3e-2 relative L2 measured); held
# to 2e-1 and 6e-2.
TOL = {"int8": (5e-2, 3e-2), "int4": (2e-1, 6e-2)}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import KVCacheConfig, ttq_policy
    from repro.models import ModelConfig, lm
    from repro.serving import EngineConfig, TTQEngine
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    return dict(jax=jax, jnp=jnp, lm=lm, cfg=cfg, params=params,
                KV=KVCacheConfig, pol=ttq_policy, Eng=TTQEngine,
                ECfg=EngineConfig,
                tparams=params_from_jax(jax.tree.map(np.asarray, params),
                                        device="cpu"),
                tcfg=TCfg(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(TCfg)}))


def _padded():
    toks = np.zeros((len(PROMPTS), BUCKET), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    return toks


def _replay_jax(ref, qparams, kvcfg, out):
    """Per-step logits (R, MAX_NEW, V) of the JAX model, teacher-forced."""
    jax, jnp, lm = ref["jax"], ref["jnp"], ref["lm"]
    logits, state, _ = jax.jit(lambda p, t: lm.prefill(
        ref["cfg"], p, {"tokens": t}, max_len=MAX_LEN, full_logits=True,
        kvcfg=kvcfg))(ref["params"], jnp.asarray(_padded()))
    step = jax.jit(lambda q, st, tok, pos: lm.decode_step(
        ref["cfg"], q, st, tok, pos, kvcfg=kvcfg))
    plen = np.asarray([len(p) for p in PROMPTS])
    steps = [np.asarray(logits)[np.arange(len(PROMPTS)), plen - 1]]
    for t in range(MAX_NEW - 1):
        tok = jnp.asarray([[o[t]] for o in out], jnp.int32)
        lg, state = step(qparams, state, tok,
                         jnp.asarray(plen + t, jnp.int32))
        steps.append(np.asarray(lg))
    return np.stack(steps, axis=1)


def _replay_torch(ref, qparams, kvcfg, out):
    logits, state, _ = tlm.prefill(ref["tcfg"], ref["tparams"],
                                   {"tokens": torch.from_numpy(_padded())},
                                   MAX_LEN, full_logits=True, kvcfg=kvcfg)
    plen = np.asarray([len(p) for p in PROMPTS])
    steps = [logits[torch.arange(len(PROMPTS)), torch.from_numpy(plen - 1)]
             .numpy()]
    for t in range(MAX_NEW - 1):
        tok = torch.tensor([[o[t]] for o in out], dtype=torch.int32)
        lg, state = tlm.decode_step(
            ref["tcfg"], qparams, state, tok,
            torch.from_numpy((plen + t).astype(np.int32)), kvcfg=kvcfg,
            kcfg=KernelConfig(use_pallas=True))
        steps.append(lg.numpy())
    return np.stack(steps, axis=1)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("bits", [4, 8])
def test_engine_matches_jax(ref, bits, kv_dtype):
    jpol = ref["pol"](bits=bits, group_size=32, rank=0, packed=True,
                      kvcache=ref["KV"](dtype=kv_dtype))
    jeng = ref["Eng"](ref["cfg"], ref["params"], jpol,
                      ref["ECfg"](max_slots=3, max_len=MAX_LEN,
                                  decode_chunk=2, guards=False))
    jr = [jeng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    jo = jeng.run_all()
    out_j = [list(jo[r]) for r in jr]

    kvcfg = TKV(dtype=kv_dtype)
    tpol = t_policy(bits=bits, group_size=32, rank=0, packed=True,
                    kvcache=kvcfg, kernel=KernelConfig(use_pallas=True))
    teng = TEngine(ref["tcfg"], ref["tparams"], tpol,
                   TEngineConfig(max_slots=3, max_len=MAX_LEN, decode_chunk=2,
                                 guards=False), device="cpu")
    tr = [teng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    to = teng.run_all()
    out_t = [list(to[r]) for r in tr]
    assert jeng.n_requants == teng.n_requants == 1
    assert all(len(o) == MAX_NEW for o in out_t)
    # one sync for the admission group + one per 2-token decode block
    assert teng.host_syncs == 1 + (MAX_NEW - 1 + 1) // 2

    lj = _replay_jax(ref, jeng.qparams, jpol.kvcache, out_j)
    lt = _replay_torch(ref, teng.qparams, kvcfg, out_j)
    rel = np.linalg.norm(lt - lj) / np.linalg.norm(lj)
    atol, rel_l2 = TOL[kv_dtype]
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=atol)
    assert rel < rel_l2, rel

    top2 = np.sort(lj, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for r in range(len(PROMPTS)):
        for t in range(MAX_NEW):
            if out_t[r][t] != out_j[r][t]:
                assert margin[r, t] <= 2 * atol, (r, t, margin[r, t])
                break
