"""The untied vocab head (``tie_embeddings=False``) in the port, on the CPU:
held to the JAX package without a mesh, and under tensor parallelism to
the port's own world 1 (the reference's mesh tier is red on jax 0.9.0).

Configs: the dense CFG of tests/test_fused_path.py:20 and chameleon-34b's
smoke config, each with ``tie_embeddings=False`` on both sides (no config
file has an untied head).  Weights come from the JAX package's
``lm.init_params``, which draws ``lm_head``, carried across by
``params_from_jax``; inputs are seeded.

Held:

* init: the port draws ``lm_head`` (V, D) bf16 at the embedding's scale,
  last, so every other leaf is the tied init's on the same generator;
  the bridge carries the JAX ``lm_head`` as it is;
* ``forward`` logits: with f32 parameters on both sides to rtol and atol
  1e-5 (the f32 tolerance of tests/test_torch_training.py's loss), with
  the bf16 parameters to tests/test_torch_models.py's bf16 tolerance
  (rtol 1e-1, atol 5e-2, relative L2 3e-2);
* ``TTQEngine`` greedy tokens against the JAX engine's, full precision
  and TTQ int4 g32, dense slab and paged pool, under the near-tie rule of
  tests/test_torch_vlm.py (at a first disagreement both tokens' JAX
  logits, teacher-forced on the JAX engine's tree, within NEAR_TIE =
  0.1); one speculative window (W = 3, an int4 draft for the fp model)
  the same way, and bit for bit the port's non-speculative tokens;
* step 1's f32 gradients of every leaf, ``lm_head`` and ``embed`` among
  them, against ``jax.grad``: relative L2 within GRAD_F32 = 1e-4 against
  a floor of 1e-4 of the whole gradient's norm
  (tests/test_torch_training.py);
* controls: ``lm_head := embed`` gives the tied engine's tokens, codes and
  teacher-forced logits bit for bit; an independent ``lm_head`` changes
  the tokens and the logits;
* the new leaf in the tree walks: no statistics tap, unquantized, vocab
  split like ``embed`` (placement, ZeRO-1's optimizer shards, not a
  partial gradient), a port checkpoint the reference restores;
* under tensor parallelism (one spawn of four processes,
  ``tests/_torch_untied_worker.py``, on tests/test_torch_parallel.py's
  serving model and tests/test_torch_parallel_training.py's training
  model, both untied): worlds 2 and 4 serve world 1's
  tokens, every rank's codes and ``lm_head`` bit for bit its slice of
  world 1's; at the (1,2) mesh step 1's f32 gradients within GRAD_F32 of
  world 1's (tests/test_torch_parallel_training.py)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import _torch_untied_worker as W
from repro_torch._tree import tree_leaves, tree_leaves_with_path
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager as TCkpt
from repro_torch.core import NO_QUANT, KernelConfig
from repro_torch.core import KVCacheConfig as TKV
from repro_torch.core import ttq_policy as t_policy
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.parallel import ParallelCtx
from repro_torch.parallel import rules as R
from repro_torch.parallel.ctx import Mesh
from repro_torch.serving import EngineConfig as TECfg
from repro_torch.serving import TTQEngine as TEngine
from repro_torch.training.trainer import opt_sharding
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEAR_TIE = 0.1
REL_L2 = 3e-2
GRAD_F32 = 1e-4
SUITE_TIMEOUT = 300
PROMPTS = [[5, 9, 17, 3, 40], [8, 8, 1], [100, 50, 25, 12, 6, 3, 77],
           [7, 7, 7, 2]]
MAX_NEW, MAX_LEN = 6, 48
ARCHS = ("dense", "chameleon")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager
    from repro.configs import get
    from repro.core import NO_QUANT as J_NO_QUANT
    from repro.core import KVCacheConfig, ttq_policy
    from repro.models import ModelConfig, lm
    from repro.optim import adamw_init
    from repro.serving import EngineConfig, TTQEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Ckpt=CheckpointManager, get=get, NOQ=J_NO_QUANT,
        KV=KVCacheConfig, pol=ttq_policy, MCfg=ModelConfig, lm=lm,
        adamw_init=adamw_init, ECfg=EngineConfig, Eng=TTQEngine,
        prefill=jax.jit(lm.prefill, static_argnums=(0,),
                        static_argnames=("max_len", "kvcfg")),
        step=jax.jit(lm.decode_step, static_argnums=(0,),
                     static_argnames=("kvcfg",)))


def _jcfg(jx, arch):
    if arch == "dense":
        return jx.MCfg(**dataclasses.asdict(W.CFG))
    return dataclasses.replace(jx.get("chameleon_34b", smoke=True),
                               tie_embeddings=False)


@pytest.fixture(scope="module")
def models(jx):
    """arch → its untied JAX tree and the bridged port tree (made once)."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = _jcfg(jx, arch)
            jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0))
            np_tree = jx.jax.tree.map(np.asarray, jp)
            made[arch] = types.SimpleNamespace(
                arch=arch, jcfg=jcfg, jp=jp, np_tree=np_tree,
                tcfg=TCfg(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(TCfg)}),
                tp=params_from_jax(np_tree, device="cpu"))
        return made[arch]
    return get


@pytest.fixture(params=ARCHS)
def model(models, request):
    return models(request.param)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


# ------------------------------------------------------------ init, bridge

def test_init_draws_lm_head_last(model):
    """The port's own init: ``lm_head`` (V, D) bf16 at std D^-1/2 (the
    reference's scale); every other leaf the tied config's on the same
    generator, bit for bit; the bridged tree holds JAX's ``lm_head``."""
    cfg = model.tcfg
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    pu = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pt = tlm.init_params(tied, torch.Generator().manual_seed(0),
                         device="cpu")
    assert "lm_head" in pu and "lm_head" not in pt
    head = pu.pop("lm_head")
    assert head.shape == (cfg.vocab, cfg.d_model)
    assert head.dtype == torch.bfloat16
    assert abs(float(head.float().std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert not torch.equal(head, pu["embed"])
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(pt),
                                tree_leaves_with_path(pu)):
        assert pa == pb and torch.equal(a, b), pa
    np.testing.assert_array_equal(model.tp["lm_head"].float().numpy(),
                                  model.np_tree["lm_head"].astype(np.float32))
    assert set(model.tp) == set(model.np_tree)


# ---------------------------------------------------------------- forward

def test_forward_f32_matches_jax(jx, model):
    """f32 parameters on both sides: logits to rtol and atol 1e-5."""
    jp32 = jx.jax.tree.map(lambda a: a.astype(jx.jnp.float32), model.jp)
    tp32 = params_from_jax(jx.jax.tree.map(np.asarray, jp32), device="cpu")
    toks = _tokens(model.tcfg.vocab, 2, 16, seed=1)
    lj, _, _ = jx.lm.forward(model.jcfg, jp32,
                             {"tokens": jx.jnp.asarray(toks)})
    lt, _, _ = tlm.forward(model.tcfg, tp32,
                           {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)


def test_forward_bf16_matches_jax(jx, model):
    toks = _tokens(model.tcfg.vocab, 2, 16, seed=2)
    lj, _, _ = jx.lm.forward(model.jcfg, model.jp,
                             {"tokens": jx.jnp.asarray(toks)})
    lt, st, _ = tlm.forward(model.tcfg, model.tp,
                            {"tokens": torch.from_numpy(toks)},
                            collect_stats=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-1,
                               atol=5e-2)
    assert _rel_l2(lj, lt.numpy()) < REL_L2
    assert not any("lm_head" in k or "embed" in k
                   for run in st["stack"] for k in run)


# ----------------------------------------------------------------- engine

def _policies(jx):
    return {"fp": (jx.NOQ, NO_QUANT),
            "int4": (jx.pol(bits=4, group_size=32, rank=0, packed=True,
                            kvcache=jx.KV(dtype="int8")),
                     t_policy(bits=4, group_size=32, rank=0, packed=True,
                              kvcache=TKV(dtype="int8"),
                              kernel=KernelConfig(use_pallas=True)))}


def _ekw(paged, **kw):
    return {**dict(max_slots=4, max_len=MAX_LEN, decode_chunk=2,
                   guards=False, kv_paged=paged,
                   kv_block_size=8 if paged else 0), **kw}


def _jax_logits_at(jx, model, jeng, prompt, out, t):
    """JAX's logits behind token ``t`` of ``out``, teacher-forced: the
    prompt's prefill, then decode steps on the JAX engine's tree."""
    kv = dataclasses.replace(jeng.kvcfg, paged=False)
    seq = jx.jnp.asarray([list(prompt)], jx.jnp.int32)
    lg, state, _ = jx.prefill(model.jcfg, model.jp, {"tokens": seq},
                              max_len=MAX_LEN, kvcfg=kv)
    for i in range(t):
        lg, state = jx.step(model.jcfg, jeng.decode_params, state,
                         jx.jnp.asarray([[out[i]]], jx.jnp.int32),
                         jx.jnp.asarray([len(prompt) + i], jx.jnp.int32),
                         kvcfg=kv)
    return np.asarray(lg)[0]


def _near_tie_equal(jx, model, jeng, jo, to):
    for p, a, b in zip(PROMPTS, jo, to):
        assert len(a) == len(b)
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        lg = _jax_logits_at(jx, model, jeng, p, a, t)
        assert abs(float(lg[a[t]]) - float(lg[b[t]])) <= NEAR_TIE, \
            (p, t, a[t], b[t], float(lg[a[t]]), float(lg[b[t]]))


def _serve(eng, prompts=PROMPTS, max_new=MAX_NEW):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    outs = eng.run_all()
    return [list(outs[r]) for r in rids]


# the dense config runs int4 on the slab and the pool and fp on the pool,
# chameleon its int4 slab (its qk-norm engine is tests/test_torch_vlm.py's;
# the head is the same read in every case)
ENGINE_CASES = [("dense", "fp", True), ("dense", "int4", False),
                ("dense", "int4", True), ("chameleon", "int4", False)]


@pytest.mark.parametrize("arch,pol,paged", ENGINE_CASES)
def test_engine_matches_jax(jx, models, arch, pol, paged):
    """Greedy tokens of both engines (one admission round, one requant)
    under the near-tie rule; ``lm_head`` stays in full precision."""
    model = models(arch)
    jpol, tpol = _policies(jx)[pol]
    jeng = jx.Eng(model.jcfg, model.jp, jpol, jx.ECfg(**_ekw(paged)))
    jo = _serve(jeng)
    teng = TEngine(model.tcfg, model.tp, tpol, TECfg(**_ekw(paged)),
                   device="cpu")
    to = _serve(teng)
    assert jeng.n_requants == teng.n_requants == (pol == "int4")
    tree = teng.decode_params
    assert isinstance(tree["lm_head"], torch.Tensor)
    assert tree["lm_head"] is model.tp["lm_head"]
    if paged:
        teng.allocator.assert_quiescent()
    _near_tie_equal(jx, model, jeng, jo, to)


def test_speculative_window_matches_jax(jx, models):
    """One window (W = 3, max_new 4) on the dense config: an int4 g32
    draft for the fp model on both sides; the port's tokens bit for bit
    its non-speculative run's and near-tie equal to the JAX engine's."""
    model = models("dense")
    kw = _ekw(False, speculate_k=3, decode_chunk=1)
    jdraft = jx.pol(bits=4, group_size=32, rank=0)
    tdraft = t_policy(bits=4, group_size=32, rank=0)
    jeng = jx.Eng(model.jcfg, model.jp, jx.NOQ, jx.ECfg(**kw),
                  draft_policy=jdraft)
    jo = _serve(jeng, max_new=4)
    teng = TEngine(model.tcfg, model.tp, NO_QUANT, TECfg(**kw),
                   device="cpu", draft_policy=tdraft)
    to = _serve(teng, max_new=4)
    assert teng.spec_windows > 0
    assert teng.draft_params["lm_head"] is model.tp["lm_head"]
    base = _serve(TEngine(model.tcfg, model.tp, NO_QUANT,
                          TECfg(**_ekw(False, decode_chunk=1)),
                          device="cpu"), max_new=4)
    assert to == base
    _near_tie_equal(jx, model, jeng, jo, to)


# -------------------------------------------------------------- gradients

def test_step1_grads_match_jax(jx, models):
    """f32 parameters, the dense config: every leaf's gradient, the
    head's and the embedding's among them, within GRAD_F32 of
    ``jax.grad``'s."""
    model = models("dense")
    jp32 = jx.jax.tree.map(lambda a: a.astype(jx.jnp.float32), model.jp)
    tp32 = params_from_jax(jx.jax.tree.map(np.asarray, jp32), device="cpu")
    toks = _tokens(model.tcfg.vocab, 2, 16, seed=3)
    jl, jg = jx.jax.value_and_grad(lambda p: jx.lm.loss_fn(
        model.jcfg, p, {"tokens": jx.jnp.asarray(toks)})[0])(jp32)
    leaves = tree_leaves(tp32)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tlm.loss_fn(model.tcfg, tp32, {"tokens": torch.from_numpy(toks)})
    tg = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jd = dict(tree_leaves_with_path(jx.jax.tree.map(np.asarray, jg)))
    floor = 1e-4 * np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                               for a in jd.values()))
    seen = set()
    for (path, _), b in zip(tree_leaves_with_path(tp32), tg):
        a = jd[path]
        err = np.linalg.norm(a.astype(np.float64) - b.double().numpy())
        assert err <= GRAD_F32 * max(np.linalg.norm(a), floor), \
            (path, err, np.linalg.norm(a))
        seen.add(path[0])
    assert {"lm_head", "embed"} <= seen and len(jd) == len(tg)


# --------------------------------------------------------------- controls

@pytest.fixture(scope="module")
def dense_pair(jx):
    """The dense config's bridged untied tree and its tied twin (the same
    leaves, no ``lm_head``)."""
    jcfg = _jcfg(jx, "dense")
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jx.lm.init_params(
        jcfg, jx.jax.random.PRNGKey(0))), device="cpu")
    tied = {k: v for k, v in tp.items() if k != "lm_head"}
    return W.CFG, dataclasses.replace(W.CFG, tie_embeddings=True), tp, tied


def _leaf_equal(a, b) -> bool:
    """Bit for bit: a tensor, or every field of a QuantizedTensor."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all((getattr(a, f) is None and getattr(b, f) is None)
               or torch.equal(getattr(a, f), getattr(b, f))
               for f in ("wint", "packed", "scale", "zero", "dinv", "B", "A"))


def _controlled(cfg, params, paged):
    pol = t_policy(bits=4, group_size=32, rank=0, packed=True,
                   kvcache=TKV(dtype="int8"),
                   kernel=KernelConfig(use_pallas=True))
    eng = TEngine(cfg, params, pol, TECfg(**_ekw(paged)), device="cpu")
    return _serve(eng), eng


def _teacher(cfg, params, tree, tokens, kvcfg, kcfg):
    """(R, 3, V) logits behind the first three tokens of each request."""
    out = []
    for p, toks in zip(PROMPTS, tokens):
        lg, st, _ = tlm.prefill(cfg, params, {"tokens": torch.tensor([p])},
                                MAX_LEN, collect_stats=False, kvcfg=kvcfg)
        row = [lg[0]]
        for i in range(2):
            lg, st = tlm.decode_step(cfg, tree, st, torch.tensor([[toks[i]]]),
                                     torch.tensor([len(p) + i]),
                                     kvcfg=kvcfg, kcfg=kcfg)
            row.append(lg[0])
        out.append(torch.stack(row))
    return torch.stack(out)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_head_equal_to_embed_is_the_tied_engine(dense_pair, paged):
    """``lm_head := embed``: tokens, every code and the teacher-forced
    logits bit for bit the tied engine's; an independent ``lm_head`` (the
    bridged one) changes the tokens and the logits."""
    ucfg, tcfg, pu, pt = dense_pair
    want, teng = _controlled(tcfg, pt, paged)
    got, ueng = _controlled(ucfg, dict(pt, lm_head=pt["embed"]), paged)
    assert got == want
    for (pa, a), (pb, b) in zip(
            tree_leaves_with_path(teng.qparams),
            tree_leaves_with_path({k: v for k, v in ueng.qparams.items()
                                   if k != "lm_head"})):
        assert pa == pb and _leaf_equal(a, b), pa
    kv, kc = teng.kvcfg, teng.kncfg
    lt = _teacher(tcfg, pt, teng.qparams, want, dataclasses.replace(
        kv, paged=False), kc)
    lu = _teacher(ucfg, dict(pt, lm_head=pt["embed"]), ueng.qparams, want,
                  dataclasses.replace(kv, paged=False), kc)
    assert torch.equal(lt, lu)
    other, oeng = _controlled(ucfg, pu, paged)
    assert other != want
    lo = _teacher(ucfg, pu, oeng.qparams, want, dataclasses.replace(
        kv, paged=False), kc)
    assert not torch.allclose(lo, lt, rtol=0.1, atol=0.1)


# --------------------------------------------------- the leaf in the walks

def test_lm_head_placement_zero1_and_grads(dense_pair):
    """Under a bound (2,2) layout ``lm_head`` splits over the model axis
    like ``embed`` (vocab rows, a 'row' split), its ZeRO-1 optimizer
    shards are ``embed``'s, and its gradient is no partial sum."""
    ucfg, _, pu, _ = dense_pair
    pctx = R.bind(ParallelCtx(mesh=Mesh(shape={"data": 2, "model": 2})),
                  ucfg)
    specs = R.param_sharding(pu, pctx)
    assert tuple(specs["lm_head"]) == tuple(specs["embed"]) == ("model", None)
    assert R.split_of("lm_head", pctx) == "row"
    assert not R.partial_grad("lm_head", specs["lm_head"], pctx)
    osh = opt_sharding(t_adamw_init(pu), specs, pctx, zero1=True)
    for k in ("master", "m", "v"):
        assert tuple(osh[k]["lm_head"].spec) == tuple(osh[k]["embed"].spec) \
            == ("model", "data")


def test_port_checkpoint_of_untied_state_restores_through_jax(
        jx, dense_pair, tmp_path):
    """The port's AdamW state of the untied tree, saved by the port, read
    back by the reference into its own untied state: every leaf equal."""
    ucfg, _, pu, _ = dense_pair
    tst = t_adamw_init(pu)
    TCkpt(str(tmp_path)).save(4, {"opt": tst})
    jst = jx.adamw_init(jx.lm.init_params(_jcfg(jx, "dense"),
                                          jx.jax.random.PRNGKey(5)))
    out = jx.Ckpt(str(tmp_path)).restore(4, {"opt": jst})["opt"]
    jd = dict(tree_leaves_with_path(jx.jax.tree.map(np.asarray, out)))
    n = 0
    for path, b in tree_leaves_with_path(tst):
        np.testing.assert_array_equal(
            np.asarray(jd[path], np.float32), b.float().numpy(),
            err_msg=str(path))
        n += "lm_head" in path
    assert n == 3                       # master, m and v


# ------------------------------------------------------ tensor parallelism

@pytest.fixture(scope="module")
def tp_runs(jx):
    jcfg = jx.MCfg(**dataclasses.asdict(W.TP_CFG))
    jp = jx.lm.init_params(jcfg, jx.jax.random.PRNGKey(0))
    _, _, stats = jx.lm.prefill(jcfg, jp, {"tokens": np.array([
        [100, 50, 25, 12, 6, 3, 7, 9, 2, 4]])}, 64)
    np_tree, np_stats = (jx.jax.tree.map(np.asarray, t) for t in (jp, stats))
    ranks = spawn(W.untied_suite, 4, np_tree, np_stats, device="cpu",
                  timeout=SUITE_TIMEOUT)
    return ranks, W.world1(params_from_jax(np_tree, device="cpu"),
                           params_from_jax(np_stats, device="cpu"))


def _case(res):
    assert "error" not in res, res.get("error")
    return res


def _rows(full, world, rank):
    k = full.shape[-2] // world
    return full[..., rank * k:(rank + 1) * k, :]


def _cols(full, world, rank):
    k = full.shape[-1] // world
    return full[..., rank * k:(rank + 1) * k]


@pytest.mark.parametrize("world", [2, 4])
def test_tp_serving_equals_world1(tp_runs, world):
    """Every rank at worlds 2 and 4: world 1's tokens (int8 slab, int4
    pool), its rows of ``lm_head`` and ``embed`` (the decode tree's head
    the placed one, unquantized), and, requantized from fixed statistics,
    every weight's codes, S, Z and D⁻¹ bit for bit its slice of world
    1's."""
    ranks, one = tp_runs
    pctx = R.bind(ParallelCtx(mesh=Mesh(shape={"data": 1, "model": world})),
                  W.TP_CFG, R.col_align(t_policy(**W.POLICY)))
    for rank in range(world):
        got = _case(ranks[rank][world]["serve"])
        for case, base in one["serve"].items():
            if case == "codes":
                continue
            g = got[case]
            assert g["tokens"] == base["tokens"], (world, rank, case)
            assert g["head_in_tree"]
            for k in ("lm_head", "embed"):
                np.testing.assert_array_equal(
                    g[k], _rows(base[k], world, rank))
        codes, base = got["codes"], one["serve"]["codes"]
        assert set(codes) == set(base) and "lm_head" not in codes
        for ps, fields in codes.items():
            sp = R.split_of(ps, pctx)
            for f, a in fields.items():
                full = base[ps][f]
                want = (_rows(full, world, rank) if sp == "row"
                        and f != "dinv" else _cols(full, world, rank)
                        if sp == "col" else full)
                np.testing.assert_array_equal(
                    a, want, err_msg=f"{ps}.{f} rank {rank}")


def test_tp_training_grads_equal_world1(tp_runs):
    """(1,2): step 1's f32 gradients, gathered whole, each leaf within
    GRAD_F32 of world 1's (floored at 1e-4 of the whole norm)."""
    ranks, one = tp_runs
    want = one["train"]["grads32"]
    paths = [path for path, _ in tree_leaves_with_path(tlm.init_params(
        W.TRAIN_CFG, torch.Generator().manual_seed(0), device="cpu"))]
    head = paths.index(("lm_head",))
    assert np.linalg.norm(want[head]) > 0
    floor = 1e-4 * np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                               for a in want))
    for rank in (0, 1):
        got = _case(ranks[rank][2]["train"])
        np.testing.assert_allclose(got["loss1"], one["train"]["loss1"],
                                   rtol=1e-5)
        assert len(got["grads32"]) == len(want)
        for i, (a, b) in enumerate(zip(want, got["grads32"])):
            err = np.linalg.norm(a.astype(np.float64) - b)
            assert err <= GRAD_F32 * max(np.linalg.norm(a), floor), (i, err)
