"""Tensor-parallel serving of the port over ``torch.distributed`` (gloo, on
the CPU), held to the reference and to the port's own world 1.

* (i) the placement rules (``repro_torch.parallel.rules``) against the
  reference's pure-Python spec functions on the same paths, shapes and
  axis sizes, compared as tuples, with the reference's seeded cases
  (``tests/test_sharding.py``);
* (ii) shard-local requant at worlds 2 and 4: every child bit for bit the
  slice of world 1's; world 1's held to the JAX ``quantize_params``
  (``tests/test_mesh_serving.py::test_requant_bit_equality_on_mesh``);
* (iii) greedy tokens of the reference's ``_SETUP`` workload at worlds 2
  and 4 equal to world 1's (``pctx=None``) for bf16 slab, int8 paged and
  int4 slab, every rank the same tokens, the layer-0 cache (row-parallel
  outputs) bit for bit world 1's slice; a world-1 context bit for bit the
  unwrapped engine;
* (iv) speculation (W = 2) at world 2 against world 1 without it;
* (v) the default policy (rank 16, gate 0.05, guards on) at world 2: the
  same layers requantized on both ranks and at world 1;
* (vi) ``launch.serve --mesh 2`` against ``--mesh 1``.

The other five families are held the same way in
``tests/test_torch_parallel_families.py``.

Worlds 2 and 4 run in one spawn of four processes for the whole module
(``tests/_torch_tp_worker.py:tp_suite``), under a timeout, so a
disagreement between ranks fails instead of hanging.  The kernels run as
their plain versions (CPU tensors); ``test_world1_nccl_graphs_on_card``
holds the card's path (gpu marker)."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from repro_torch import bridge
from repro_torch.configs import get as t_get
from repro_torch.core import ttq_policy
from repro_torch.launch.mesh import spawn
from repro_torch.parallel import ParallelCtx, rules as R
from repro_torch.parallel.ctx import Mesh
from repro_torch.quant.api import FusedRequantPlan
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SUITE_TIMEOUT = 420


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import repro.parallel.rules as JR
    from repro.models import ModelConfig, lm
    cfg = ModelConfig(**dataclasses.asdict(W.CFG))
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    from repro.core import ttq_policy as jpolicy
    from repro.quant.api import lowrank_tree
    _, _, stats = lm.prefill(cfg, params,
                             {"tokens": np.array([W.PROMPTS[2]])}, 64)
    lowrank = lowrank_tree(params, jpolicy(**W.POLICY))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(jax=jax, JR=JR, cfg=cfg, lm=lm, params=params,
                lowrank=lowrank, params_np=to_np(params),
                stats_np=to_np(stats), lowrank_np=to_np(lowrank))


@pytest.fixture(scope="module")
def suite(jx):
    """Every rank's {world: {case: result}} (one spawn per module)."""
    return spawn(W.tp_suite, 4, jx["params_np"], jx["stats_np"],
                 jx["lowrank_np"], ("requant", "tokens", "spec", "default"), device="cpu",
                 timeout=SUITE_TIMEOUT)


@pytest.fixture(scope="module")
def tparams(jx):
    return bridge.params_from_jax(jx["params_np"], device="cpu")


def _case(suite, rank, world, name):
    res = suite[rank][world][name]
    assert "error" not in res, res.get("error")
    return res


def _tree_get(tree, ps):
    for p in ps.split("."):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


# ------------------------------------------------------------ (i) specs

_PATHS = ["embed", "lm_head", "pos_embed", "stack.0.u0.mix.wq",
          "stack.0.u0.mix.wk", "stack.0.u0.mix.wo", "stack.0.u1.xattn.wv",
          "stack.0.u0.mix.wkv_b", "stack.0.u0.mix.w_in",
          "stack.0.u0.mix.w_out", "stack.0.u0.mix.w_gate_a",
          "stack.0.u0.mix.conv_w", "stack.0.u0.mix.A_log",
          "stack.0.u0.mlp.wg", "stack.0.u0.mlp.wd", "stack.0.u0.mlp.w1",
          "stack.0.u0.mlp.w2", "stack.0.u0.mlp.experts.wg",
          "stack.0.u0.mlp.experts.wd", "stack.0.u0.mlp.shared.wg",
          "stack.0.u0.mlp.shared.wd", "stack.0.u0.mlp.router",
          "stack.0.u0.ln1.gamma", "stack.0.u0.mix.qnorm.gamma",
          "final_norm.gamma"]


class _FakeMesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def test_spec_for_path_matches_reference(jx):
    """Every rule path at every rank 1-4, stacked and not."""
    for ps in _PATHS:
        for nd in (1, 2, 3, 4):
            for stacked in (True, False):
                want = jx["JR"].spec_for_path(ps, nd, "model", stacked)
                got = R.spec_for_path(ps, nd, "model", stacked)
                assert tuple(got) == tuple(want), (ps, nd, stacked)


def test_reference_spec_rules_hold_on_the_port():
    """``tests/test_sharding.py::test_spec_rules``, on the port's P."""
    P = R.P
    assert R.spec_for_path("stack.0.u0.mix.wq", 3) == P(None, "model", None)
    assert R.spec_for_path("stack.0.u0.mix.wo", 3) == P(None, None, "model")
    assert R.spec_for_path("embed", 2, stacked=False) == P("model", None)
    assert R.spec_for_path("stack.0.u0.mlp.experts.wg", 4) == \
        P(None, "model", None, None)
    assert R.spec_for_path("stack.0.u0.ln1.gamma", 2) == P(None, None)


def test_divisible_spec_matches_reference(jx):
    """The reference's seeded property (``test_sharding.py:141``): random
    paths, shapes and (data, model) sizes, as tuples."""
    rng = np.random.default_rng(0)
    for _ in range(400):
        ps = _PATHS[int(rng.integers(len(_PATHS)))]
        nd = int(rng.integers(1, 5))
        mesh = _FakeMesh(int(rng.integers(1, 5)),
                         int(rng.choice([1, 2, 3, 4, 8])))
        shape = tuple(int(rng.integers(1, 65)) for _ in range(nd))
        spec = R.spec_for_path(ps, nd, "model", stacked="stack" in ps)
        want = jx["JR"].divisible_spec(
            jx["JR"].spec_for_path(ps, nd, "model", "stack" in ps), shape,
            mesh)
        assert tuple(R.divisible_spec(spec, shape, mesh)) == tuple(want)


def test_qt_specs_matches_reference(jx):
    """The reference's seeded QuantizedTensor cases (``test_sharding.py:
    160``): low-rank and expert children, with and without a mesh."""
    rng = np.random.default_rng(1)
    for _ in range(300):
        ps = _PATHS[int(rng.integers(3, len(_PATHS)))]
        lead = (1,) if "stack" in ps else ()
        g = int(rng.choice([8, 16, 32]))
        d, dp = g * 8 * int(rng.integers(1, 5)), 8 * int(rng.integers(1, 9))
        ex = (int(rng.choice([2, 4, 8])),) if rng.integers(2) else ()
        r = int(rng.integers(1, 9))
        low = bool(rng.integers(2))
        shapes = {"wint": None, "packed": (*lead, *ex, dp, d // 8),
                  "scale": (*lead, *ex, dp, d // g),
                  "zero": (*lead, *ex, dp, d // g), "dinv": (*lead, *ex, d),
                  "B": (*lead, *ex, dp, r) if low else None,
                  "A": (*lead, *ex, r, d) if low else None}
        mesh = _FakeMesh(int(rng.integers(1, 5)),
                         int(rng.choice([1, 2, 4, 8])))
        for m in (None, mesh):
            want = jx["JR"].qt_specs(ps, shapes, "model", m)
            got = R.qt_specs(ps, shapes, "model", m)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (ps, shapes)


@pytest.mark.parametrize("paged", [False, True])
def test_state_sharding_matches_reference(jx, paged):
    """The decode state's specs on a gemma-like and an MQA cache: equal
    to the reference's where Hkv divides the model axis; a cache whose
    Hkv does not divide is replicated (the reference shards its
    sequence instead, a documented difference)."""
    jnp = pytest.importorskip("jax.numpy")
    for hkv, n in ((4, 2), (4, 4), (1, 2)):
        lead = (9, hkv, 16, 8) if paged else (4, hkv, 64, 8)
        shapes = {"k_q": (2, *lead), "k_s": (2, *lead[:-1], 1),
                  "v": (2, *lead)}
        st_t = {"stack": [{"u0": {k: torch.zeros(s) for k, s in
                                  shapes.items()}}],
                "block_table": torch.zeros((4, 4), dtype=torch.int32)}
        st_j = {"stack": [{"u0": {k: jnp.zeros(s) for k, s in
                                  shapes.items()}}],
                "block_table": jnp.zeros((4, 4), jnp.int32)}
        pctx = ParallelCtx(mesh=Mesh(shape={"data": 1, "model": n}))
        got = R.state_sharding(st_t, pctx, paged=paged)
        jctx = type("C", (), dict(mesh=_FakeMesh(1, n), model_axis="model",
                                  dp="data"))()
        want = _ref_state_specs(jx, st_j, jctx, paged)
        for k in shapes:
            g = tuple(got["stack"][0]["u0"][k])
            w = want[k]
            if hkv % n == 0 or paged:
                assert g == w, (k, hkv, n, g, w)
            else:
                assert "model" not in g and g[2] is None, (k, g)
        assert tuple(got["block_table"]) == (None, None)


def _ref_state_specs(jx, state, jctx, paged):
    """The reference's ``state_sharding`` specs (its NamedSharding wrap
    replaced by the bare spec: it needs a real mesh of that shape)."""
    JR = jx["JR"]
    orig = jx["jax"].sharding.NamedSharding
    try:
        jx["jax"].sharding.NamedSharding = lambda mesh, spec: spec
        tree = JR.state_sharding(state, jctx, paged=paged)
    finally:
        jx["jax"].sharding.NamedSharding = orig
    return {k: tuple(v) for k, v in tree["stack"][0]["u0"].items()}


# ------------------------------------------------------- (ii) requant

@pytest.fixture(scope="module")
def world1_tree(jx, tparams):
    stats = bridge.params_from_jax(jx["stats_np"], device="cpu")
    lowrank = bridge.lowrank_from_jax(jx["lowrank_np"], device="cpu")
    policy = ttq_policy(**W.POLICY)
    return W.qt_numpy(FusedRequantPlan(
        tparams, stats, policy, lowrank_tree=lowrank).run(
        tparams, stats, 10.0, lowrank))


def test_requant_world1_matches_jax_quantize_params(jx, world1_tree):
    """World 1's plan against the JAX ``quantize_params`` (rank 16, both
    on the JAX package's factors: SVD signs are ambiguous): codes equal
    but ±1 at round-half ties, S, Z and D⁻¹ within f32 rounding."""
    from repro.core import ttq_policy as jpolicy
    from repro.quant.api import quantize_params
    ref = quantize_params(jx["params"], jx["stats_np"], jpolicy(**W.POLICY),
                          count=10.0, lowrank_tree=jx["lowrank"])
    assert world1_tree
    for ps, got in world1_tree.items():
        want = _tree_get(ref, ps)
        from repro_torch.core import unpack_bits
        cg = unpack_bits(torch.from_numpy(got["packed"]), want.in_features,
                         4).numpy()
        cw = unpack_bits(torch.from_numpy(np.asarray(want.packed)),
                         want.in_features, 4).numpy()
        diff = np.abs(cg.astype(np.int64) - cw)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, ps
        for f, rtol in (("scale", 1e-5), ("zero", 1e-5), ("dinv", 1e-6)):
            np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                       rtol=rtol, atol=1e-6, err_msg=ps)


def _slice_of(full, spec, world, rank):
    out = full
    for i, ax in enumerate(spec):
        if ax == "model":
            k = full.shape[i] // world
            out = np.take(out, np.arange(rank * k, (rank + 1) * k), axis=i)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_requant_shards_bit_equal_world1_slices(suite, world1_tree, world):
    """Every rank's codes, S, Z and D⁻¹ of every weight: bit for bit the
    rank's slice of world 1's (row slices of wq/wk/wv/wg/wu, column
    slices of wo/wd, D⁻¹ with the columns)."""
    pctx = R.bind(ParallelCtx(mesh=Mesh(shape={"data": 1, "model": world})),
                  W.CFG, R.col_align(ttq_policy(**W.POLICY)))
    n_split = 0
    for rank in range(world):
        got = _case(suite, rank, world, "requant")
        assert set(got) == set(world1_tree)
        for ps, fields in got.items():
            sp = R.split_of(ps, pctx)
            n_split += sp is not None
            for f, a in fields.items():
                full = world1_tree[ps][f]
                spec = [None] * full.ndim
                if sp == "row" and f != "dinv":
                    spec[-2] = "model"
                elif sp == "col":
                    spec[-1] = "model"
                np.testing.assert_array_equal(
                    a, _slice_of(full, spec, world, rank),
                    err_msg=f"{ps}.{f} rank {rank}")
    assert n_split == 7 * world         # wq wk wv wo wg wu wd, all split


# ------------------------------------------------------- (iii) tokens

@pytest.fixture(scope="module")
def base_tokens(tparams):
    """World 1 (no context) for every KV case: tokens and layer-0 cache."""
    out = {}
    for kv, paged in W.KV_CASES:
        toks, eng = W.engine_run(tparams, None, kv=kv, paged=paged)
        out[f"{kv}-{paged}"] = dict(tokens=toks, cache=W.layer0_cache(eng))
    return out


@pytest.mark.parametrize("case", [f"{kv}-{p}" for kv, p in W.KV_CASES])
def test_tp_greedy_tokens_match_world1(suite, base_tokens, case):
    """Worlds 2 and 4: every rank emits world 1's greedy tokens, and its
    layer-0 cache is bit for bit its KV-head slice of world 1's."""
    base = base_tokens[case]
    for world in (2, 4):
        for rank in range(world):
            got = _case(suite, rank, world, "tokens")[case]
            assert got["tokens"] == base["tokens"], (world, rank)
            for k, full in base["cache"].items():
                hdim = 1
                np.testing.assert_array_equal(
                    got["cache"][k],
                    _slice_of(full, [None] * hdim + ["model"], world, rank),
                    err_msg=f"{case} {k} world {world} rank {rank}")


def test_world1_context_is_the_unwrapped_engine(suite, base_tokens):
    """A one-rank context (gloo): tokens and caches bit for bit the
    ``pctx=None`` engine's (a one-rank all-reduce is the identity, the
    one-rank vocab head the whole head)."""
    res = _case(suite, 0, 1, "tokens")
    for case, base in base_tokens.items():
        assert res[case]["tokens"] == base["tokens"], case
        for k, full in base["cache"].items():
            np.testing.assert_array_equal(res[case]["cache"][k], full)


# ------------------------------------------------- (iv) speculation

def test_tp_speculation_world2_matches_world1(suite, tparams):
    """W = 2 self-speculation at world 2 (draft scan, batched verify and
    both trees shard-local) emits world 1's non-speculative tokens."""
    base, _ = W.engine_run(tparams, None, policy=ttq_policy(bits=8,
                                                           group_size=16),
                           decode_chunk=1, use_kernels=None)
    for rank in (0, 1):
        got = _case(suite, rank, 2, "spec")
        assert got["windows"] > 0
        assert got["tokens"] == base, rank


# ----------------------------------------------- (v) default policy

def test_tp_default_policy_world2_same_layers(suite, tparams):
    """Rank 16 (factors of the whole weights, sliced), the delta gate at
    0.05 and the guards: both ranks requantize the same layers at every
    requant, the same as world 1, and emit world 1's tokens."""
    toks, eng = W.engine_run(tparams, None, policy=ttq_policy(),
                             requant_threshold=0.05, decode_chunk=2,
                             use_kernels=None)
    r0, r1 = (_case(suite, r, 2, "default") for r in (0, 1))
    assert r0["paths"] == r1["paths"] == eng.qmodel.requant_paths
    assert r0["skipped"] == eng.layers_skipped
    assert r0["tokens"] == r1["tokens"] == toks


# ------------------------------------------------------- (vi) the CLI

def test_serve_cli_mesh2_matches_mesh1(capfd):
    """``python -m repro_torch.launch.serve --mesh 2`` (two spawned ranks
    over gloo) prints ``--mesh 1``'s tokens, the mesh line and the
    backend it chose."""
    from repro_torch.launch import serve
    argv = ["--arch", "gemma_7b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--use-kernels",
            "--kv-dtype", "int8"]
    _, one = serve.main(argv)
    _, two = serve.main(argv + ["--mesh", "2"])
    out = capfd.readouterr().out
    assert {r: list(v) for r, v in two.items()} == \
        {r: list(v) for r, v in one.items()}
    assert "mesh: (1, 2) data×model over 2 rank(s), backend gloo" in out


# ------------------------------------------------------ on the card

@pytest.mark.gpu
def test_world1_nccl_graphs_on_card():
    """[3l] (a) at a small depth: a world-1 NCCL context with CUDA graphs
    serves tokens bit for bit the ``pctx=None`` engine's, its graph
    replays capturing the collectives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    from repro_torch.serving import EngineConfig, TTQEngine
    cfg = dataclasses.replace(t_get("gemma_7b"), n_layers=2)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    pol = ttq_policy(bits=4, group_size=32, rank=0, packed=True,
                     kv_dtype="int8",
                     kernel=dataclasses.replace(ttq_policy().kernel,
                                                use_pallas=True))
    ecfg = EngineConfig(max_slots=4, max_len=256, decode_chunk=8)
    prompts = [[(7 * i + j) % cfg.vocab + 1 for j in range(12 + i)]
               for i in range(4)]

    def run(pctx):
        eng = TTQEngine(cfg, params, pol, ecfg, device="cuda", pctx=pctx)
        rids = [eng.submit(p, max_new=24) for p in prompts]
        eng.run_all()
        return [list(eng.scheduler.results()[r]) for r in rids], eng
    base, _ = run(None)
    mesh = make_mesh(1, 1, device="cuda")
    assert mesh.backend == "nccl"
    before = comm.COUNTS["all_reduce"]
    got, eng = run(make_ctx(mesh))
    assert got == base
    assert eng.runner.graphs and eng.compiled_programs > 0
    assert comm.COUNTS["all_reduce"] > before
