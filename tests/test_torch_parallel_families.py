"""Tensor- and expert-parallel serving of the five families beyond plain
attention (RG-LRU, SSD, MLA, encoder-decoder, MoE) over
``torch.distributed`` (gloo, on the CPU), held to the port's own world 1
and, for the all-to-all MoE layer, to the reference's ``moe_a2a``.

* (i) the layout: every config of ``repro_torch.configs`` binds at worlds 2
  and 4 (no family refuses), each smoke config's block decisions, and the
  decode state's placement (which leaves split, which stay whole);
* (ii) shard-local requant at worlds 2 and 4 on fixed statistics: every
  child bit for bit the slice of world 1's (row, column and expert
  slices);
* (iii) greedy tokens at worlds 2 and 4 equal to world 1's on every rank,
  for recurrentgemma, mamba2, whisper, deepseek and llama4-scout (smoke)
  and both ``moe_impl``s (``"a2a"`` at capacity factor 8, held to the
  world-1 ``"a2a"`` context); a world-1 context bit for bit ``pctx=None``
  (tokens, tree and state) for the non-MoE families and MoE under
  ``"dense"``;
* (iv) the port's ``moe_apply_a2a`` at worlds 1, 2 and 4 against the
  reference's ``moe_a2a`` on (1, n) meshes at capacity factors 1.0 (it
  drops) and 8.0: outputs, dropped assignments and count statistics;
* (v) the SSD gated norm at world 2 (it needs its Σy² all-reduce);
* (vi) ``launch.serve --mesh 2`` for an SSD and an MLA + MoE arch.

Worlds 4, 2 and 1 run in one spawn of four processes for the whole module
(``tests/_torch_tp_families_worker.py:families_suite``), under a timeout;
the reference's a2a runs in one JAX subprocess on four host devices.  The
kernels run as their plain versions (CPU tensors);
``test_a2a_world1_nccl_graphs_on_card`` holds the card's path (gpu
marker)."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import _torch_tp_families_worker as W
from repro_torch.configs import ARCH_IDS, get
from repro_torch.core import ttq_policy
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm
from repro_torch.parallel import ParallelCtx, rules as R
from repro_torch.parallel.ctx import Mesh
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SUITE_TIMEOUT = 420
# the a2a layer against the reference: bf16 outputs of the same bf16
# weights through different matmuls (one bf16 rounding of the GLU's
# products apart), the count statistics of the expert inputs in f32 (the
# same bf16 values, summed in another order), those of the GLU's products
# at the outputs' tolerance
A2A_Y_TOL = 3e-2
A2A_STAT_WG_RTOL = 1e-5
A2A_STAT_WD_RTOL = 3e-2


def shape_ctx(world, cfg, policy=None):
    """A bound layout on a shape-only mesh (no process group)."""
    pctx = ParallelCtx(mesh=Mesh(shape={"data": 1, "model": world}))
    return R.bind(pctx, cfg, R.col_align(policy or ttq_policy(**W.POLICY)))


@pytest.fixture(scope="module")
def world1():
    """Per arch (pctx=None): the fixed statistics, the whole weights'
    low-rank factors, their requantized tree, and the engine's tokens, tree
    and final state."""
    from repro_torch.quant.api import FusedRequantPlan, lowrank_tree
    out = {}
    policy = ttq_policy(**W.POLICY)
    for arch in W.ARCHS:
        cfg = W.family_cfg(arch)
        params = W.family_params(cfg)
        stats = W.world1_stats(cfg, params)
        lr = lowrank_tree(params, policy)
        tree = W.qt_numpy(FusedRequantPlan(
            params, stats, policy, lowrank_tree=lr).run(params, stats, 10.0,
                                                        lr))
        toks, eng = W.engine_run(cfg, params, None)
        out[arch] = dict(fixed=dict(stats=W.to_np(stats),
                                    lowrank=W.to_np(lr)), tree=tree,
                         tokens=toks,
                         eng_tree=W.qt_numpy(eng.decode_params),
                         state=W.to_np(eng.state))
    return out


@pytest.fixture(scope="module")
def ref_a2a(subproc, tmp_path_factory):
    """The reference's ``moe_a2a`` on (1, n) Auto-axis meshes of four host
    devices, n = 1, 2, 4, at each capacity factor: its output and
    statistics, and its routing's dropped assignments per rank's chunk
    (its ``_router`` on the chunk, its slot rule, ``layers.py:921-931``)."""
    path = str(tmp_path_factory.mktemp("a2a") / "ref.pkl")
    c = W.REF_MOE
    subproc(f"""
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.models import ModelConfig, MoECfg
from repro.models import layers as L
from repro.parallel import ParallelCtx
cfg0 = ModelConfig(name='t', family='moe', n_layers={c.n_layers},
                   d_model={c.d_model}, n_heads={c.n_heads},
                   n_kv_heads={c.n_kv_heads}, d_ff=0, vocab={c.vocab},
                   moe=MoECfg(n_experts={c.moe.n_experts},
                              top_k={c.moe.top_k},
                              d_ff_expert={c.moe.d_ff_expert},
                              n_shared={c.moe.n_shared}))
p = L.init_moe(jax.random.PRNGKey(0), cfg0)
x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 8, {c.d_model})),
                jnp.bfloat16)
f32 = lambda t: np.asarray(t.astype(jnp.float32))
out = dict(params=dict(router=f32(p["router"]),
                       experts={{k: f32(v) for k, v in p["experts"].items()}}),
           x=f32(x))
E, k = cfg0.moe.n_experts, cfg0.moe.top_k
for n in (1, 2, 4):
    mesh = jax.make_mesh((1, n), ('data', 'model'),
                         axis_types=(AxisType.Auto,) * 2)
    pctx = ParallelCtx(mesh=mesh, data_axes=('data',), model_axis='model')
    for cf in {W.REF_CFS}:
        cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
            cfg0.moe, capacity_factor=cf))
        y, st = jax.jit(lambda p, x: L.moe_a2a(cfg, p, x, True, "", pctx))(
            p, x)
        x2 = x.reshape(-1, x.shape[-1])
        Tc = -(-x2.shape[0] // n)
        C = max(1, int(Tc * k / E * cf))
        valid = []
        for r in range(n):
            _, top_i = L._router(cfg, p, x2[r * Tc:(r + 1) * Tc], None, "")
            flat_e = top_i.reshape(-1)
            pos = jnp.cumsum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), 0) - 1
            slot = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
            valid.append(np.asarray(slot < C))
        out[(n, cf)] = dict(y=f32(y), valid=valid,
                            stats={{kk: np.asarray(v) for kk, v in st.items()}})
pickle.dump(out, open({path!r}, "wb"))
print("OK")
""", devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def suite(world1, ref_a2a):
    """Every rank's {world: {case: result}} (one spawn per module)."""
    fixed = {a: world1[a]["fixed"] for a in W.ARCHS}
    ref = dict(params=ref_a2a["params"], x=ref_a2a["x"])
    return spawn(W.families_suite, 4, fixed, ref, device="cpu",
                 timeout=SUITE_TIMEOUT)


def _case(suite, rank, world, name):
    res = suite[rank][world][name]
    assert "error" not in res, res.get("error")
    return res


# ------------------------------------------------------------ (i) layout

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("world", [2, 4])
def test_every_config_binds(arch, world):
    """No family refuses a world above 1: every full config binds a layout
    (int4 g32 columns) and lays out its decode state at the rank's size;
    the blocks that cannot split replicate (recurrentgemma-9b's attention,
    Hkv = 1; whisper-medium's vocab, 51,865 rows)."""
    cfg = get(arch)
    pctx = shape_ctx(world, cfg, ttq_policy(bits=4, group_size=32))
    lay = pctx.layout
    assert not hasattr(R, "check_family") and not hasattr(R, "TP_FAMILIES")
    if arch == "recurrentgemma_9b":
        assert lay.attn is False and lay.rec is True
    if arch == "whisper_medium":
        assert lay.vocab is False and lay.attn is True
    st = lm.init_decode_state(cfg, 2, 64, device="meta", pctx=pctx)
    whole = lm.init_decode_state(cfg, 2, 64, device="meta")
    assert all(a.dim() == b.dim() and a.numel() * world in (b.numel(),
               b.numel() * world) for a, b in zip(_leaves(st),
                                                  _leaves(whole)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [tree]


# the smoke configs' decisions at worlds 2 and 4 (int4 g16: a column slice
# keeps 16 features); None: the model has no such block
LAYOUTS = {
    "recurrentgemma_9b": {2: dict(attn=False, mlp=True, rec=True),
                          4: dict(attn=False, mlp=True, rec=True)},
    "mamba2_1p3b": {2: dict(attn=False, mlp=False, ssd=True),
                    4: dict(attn=False, mlp=False, ssd=True)},
    "whisper_medium": {2: dict(attn=True, mlp=True),
                       4: dict(attn=True, mlp=True)},
    "deepseek_v2_lite_16b": {2: dict(attn=False, mlp=True, mla=True,
                                     experts=True),
                             4: dict(attn=False, mlp=True, mla=True,
                                     experts=True)},
    "llama4_scout_17b_a16e": {2: dict(attn=True, mlp=True, experts=True),
                              4: dict(attn=False, mlp=True, experts=True)},
}


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_smoke_layout(arch, world):
    """Each block splits where its heads, channels or experts divide and
    its column slices keep whole groups; a block that fails replicates:
    recurrentgemma's windowed attention (Hkv = 1), mamba2's absent MLP,
    llama4-scout's attention at world 4 (Hkv = 2)."""
    lay = shape_ctx(world, get(arch, smoke=True)).layout
    want = dict(vocab=True, rec=None, ssd=None, mla=None, experts=None)
    want.update(LAYOUTS[arch][world])
    assert dataclasses.asdict(lay) == want


def test_world1_splits_every_block():
    for arch in W.ARCHS:
        lay = shape_ctx(1, get(arch, smoke=True)).layout
        assert all(v in (True, None) for v in
                   dataclasses.asdict(lay).values()), arch


# leaf → whether it splits over the model axis at world 2 (int8 KV)
PLACEMENT = {
    "recurrentgemma_9b": {"h": True, "conv": True, "k_q": False,
                          "v_s": False},
    "mamba2_1p3b": {"h": True, "conv_x": True, "conv_B": False,
                    "conv_C": False},
    "whisper_medium": {"k_q": True, "v_s": True, "xk": True, "xv": True,
                       "enc_out": False},
    "deepseek_v2_lite_16b": {"latent": False, "k_rope": False},
    "llama4_scout_17b_a16e": {"k_q": True, "k_s": True},
}


@pytest.mark.parametrize("arch", W.ARCHS)
def test_state_placement(arch):
    """The rank's decode state at world 2 (``lm.init_decode_state`` under
    a bound layout): RG-LRU ``h``/``conv`` on channels, SSD ``h`` on
    heads and ``conv_x`` on channels with ``conv_B``/``conv_C`` whole (they
    feed the whole B and C), the self and cross KV caches on heads;
    ``enc_out``, MLA's ``latent``/``k_rope`` and a replicated attention's
    cache whole."""
    cfg = get(arch, smoke=True)
    kvcfg = ttq_policy(kv_dtype="int8").kvcache
    pctx = shape_ctx(2, cfg)
    whole = lm.init_decode_state(cfg, 4, 32, kvcfg, device="meta")
    local = lm.init_decode_state(cfg, 4, 32, kvcfg, device="meta", pctx=pctx)
    seen = {}
    for (ps, a), b in zip(_paths(whole), _leaves(local)):
        name = ps.split(".")[-1]
        if name in PLACEMENT[arch]:
            seen[name] = b.numel() * 2 == a.numel()
            assert seen[name] or b.shape == a.shape, (ps, a.shape, b.shape)
    assert seen == PLACEMENT[arch]


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, path + (i,))]
    return [(".".join(map(str, path)), tree)]


# ------------------------------------------------------- (ii) requant

def _slice_of(full, axis, world, rank):
    if axis is None:
        return full
    k = full.shape[axis] // world
    return np.take(full, np.arange(rank * k, (rank + 1) * k), axis=axis)


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_requant_shards_bit_equal_world1_slices(suite, world1, arch, world):
    """Every rank's codes, S, Z and D⁻¹ of every weight, from the rank's
    slice of the fixed statistics: bit for bit the rank's slice of world
    1's (rows of w_branch/w_in/w_z/w_x/wq/wkv_b/xattn.wq/shared.wg, columns
    of w_out/wo/shared.wd with D⁻¹, whole experts with theirs)."""
    cfg = get(arch, smoke=True)
    pctx = shape_ctx(world, cfg)
    full = world1[arch]["tree"]
    kinds = set()
    for rank in range(world):
        got = _case(suite, rank, world, f"requant-{arch}")
        assert set(got) == set(full)
        for ps, fields in got.items():
            sp = R.split_of(ps, pctx)
            kinds.add(sp)
            for f, a in fields.items():
                ref = full[ps][f]
                axis = {"row": None if f == "dinv" else ref.ndim - 2,
                        "col": ref.ndim - 1, "expert": 1}.get(sp)
                np.testing.assert_array_equal(
                    a, _slice_of(ref, axis, world, rank),
                    err_msg=f"{ps}.{f} rank {rank}")
    assert {"row", "col"} <= kinds, kinds
    assert ("expert" in kinds) == (get(arch, smoke=True).moe is not None)


# ------------------------------------------------------- (iii) tokens

@pytest.mark.parametrize("arch,impl", W.ENGINES)
def test_tokens_match_world1(suite, world1, arch, impl):
    """Worlds 2 and 4: every rank emits world 1's greedy tokens (exactly:
    no near-tie arises in these runs).  World 1 is ``pctx=None``, but for
    ``a2a``, whose count statistics and capacity are its own: there the
    one-rank ``a2a`` context (capacity ample, nothing dropped)."""
    if impl == "a2a":
        base = _case(suite, 0, 1, f"tokens-{arch}-{impl}")["tokens"]
    else:
        base = world1[arch]["tokens"]
    for world in (2, 4):
        for rank in range(world):
            got = _case(suite, rank, world, f"tokens-{arch}-{impl}")
            assert got["tokens"] == base, (world, rank)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_world1_context_is_pctx_none(suite, world1, arch):
    """A one-rank context (gloo; MoE under ``"dense"``): tokens, the
    requantized tree and the final decode state bit for bit the
    ``pctx=None`` engine's (a one-rank collective is the identity; the
    gated norm takes its mean as :func:`rmsnorm` does)."""
    res = _case(suite, 0, 1, f"tokens-{arch}-dense")
    base = world1[arch]
    assert res["tokens"] == base["tokens"]
    assert set(res["tree"]) == set(base["eng_tree"])
    for ps, fields in res["tree"].items():
        for f, a in fields.items():
            np.testing.assert_array_equal(a, base["eng_tree"][ps][f],
                                          err_msg=f"{ps}.{f}")
    for (ps, a), b in zip(_paths(res["state"]), _leaves(base["state"])):
        np.testing.assert_array_equal(a, b, err_msg=ps)


# ------------------------------------------- (iv) a2a vs the reference

@pytest.mark.parametrize("cf", W.REF_CFS)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_a2a_layer_matches_reference(suite, ref_a2a, world, cf):
    """The port's ``moe_apply_a2a`` on the reference's MoE test layer at
    world n against the reference's ``moe_a2a`` on a (1, n) mesh: the same
    dropped (token, expert) assignments per rank's chunk, outputs within
    :data:`A2A_Y_TOL`, the count statistics (whole on every rank, as the
    reference's) within their tolerances; at capacity factor 1.0 something
    is dropped at some world, at 8.0 nothing."""
    ref = ref_a2a[(world, cf)]
    ranks = [_case(suite, r, world, "a2a")[cf] for r in range(world)]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["valid"], ref["valid"][r])
        np.testing.assert_allclose(got["y"], ref["y"], atol=A2A_Y_TOL,
                                   rtol=A2A_Y_TOL, err_msg=f"rank {r}")
        for key, rtol in (("experts.wg", A2A_STAT_WG_RTOL),
                          ("experts.wd", A2A_STAT_WD_RTOL)):
            want = ref["stats"][key]
            np.testing.assert_allclose(got["stats"][key], want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(),
                                       err_msg=f"{key} rank {r}")
    drops = {(w, c): sum((~np.asarray(v)).sum() for v in ref_a2a[(w, c)]
                         ["valid"]) for w in (1, 2, 4) for c in W.REF_CFS}
    assert sum(drops[(w, 1.0)] for w in (1, 2, 4)) > 0
    assert all(drops[(w, 8.0)] == 0 for w in (1, 2, 4))


# ---------------------------------------------- (v) the SSD gated norm

def test_ssd_gated_norm_world2(suite):
    """At world 2 the rank's gated norm equals its slice of world 1's at
    f32 tolerance; without the Σy² all-reduce (the norm over the rank's
    channels alone) it does not."""
    for rank in (0, 1):
        got = _case(suite, rank, 2, "ssd_gate")
        k = got["whole"].shape[-1] // 2
        want = got["whole"][..., rank * k:(rank + 1) * k]
        np.testing.assert_allclose(got["tp"], want, rtol=1e-5, atol=1e-6)
        assert np.abs(got["local_only"] - want).max() > 1e-2


# ------------------------------------------------------- (vi) the CLI

@pytest.mark.parametrize("arch", ["mamba2_1p3b", "deepseek_v2_lite_16b"])
def test_serve_cli_mesh2(capfd, arch):
    """``python -m repro_torch.launch.serve --mesh 2`` serves the arch
    over two spawned ranks that emit the same tokens (``main`` raises
    otherwise) and prints the mesh line.  mamba2's tokens are ``--mesh
    1``'s.  deepseek's are not held to ``--mesh 1``: under a mesh a MoE
    layer takes the reference's default ``moe_impl="a2a"``, whose decode
    step at 2 ranks has one slot per (rank, expert) at the smoke config's
    capacity factor 2.0 and drops assignments, and whose statistics count
    tokens where ``--mesh 1``'s weight them by gate mass (the reference's
    CLI behaves the same way)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--use-kernels", "--kv-dtype", "int8"]
    _, two = serve.main(argv + ["--mesh", "2"])
    out = capfd.readouterr().out
    assert "mesh: (1, 2) data×model over 2 rank(s), backend gloo" in out
    assert sorted(two) == [0, 1, 2] and all(len(v) == 4
                                            for v in two.values())
    if arch == "mamba2_1p3b":
        _, one = serve.main(argv)
        assert {r: list(v) for r, v in two.items()} == \
            {r: list(v) for r, v in one.items()}


# ------------------------------------------------------ on the card

@pytest.mark.gpu
def test_a2a_world1_nccl_graphs_on_card():
    """A world-1 NCCL engine of a two-layer deepseek-v2-lite under
    ``moe_impl="a2a"``: its decode graphs capture the all-to-alls, and its
    tokens and final state are bit for bit the same engine's run with
    every block eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.serving import EngineConfig, TTQEngine
    cfg = dataclasses.replace(get("deepseek_v2_lite_16b"), n_layers=2)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    pol = ttq_policy(bits=4, group_size=32, packed=True, kv_dtype="int8",
                     kernel=dataclasses.replace(ttq_policy().kernel,
                                                use_pallas=True))
    ecfg = EngineConfig(max_slots=4, max_len=128, decode_chunk=4)
    prompts = [[(7 * i + j) % cfg.vocab + 1 for j in range(12 + i)]
               for i in range(4)]
    pctx = make_ctx(make_mesh(1, 1, device="cuda"))
    assert pctx.mesh.backend == "nccl" and pctx.moe_impl == "a2a"

    def run(graphs):
        eng = TTQEngine(cfg, params, pol, ecfg, device="cuda", pctx=pctx)
        eng.runner.graphs = graphs
        rids = [eng.submit(p, max_new=16) for p in prompts]
        eng.run_all()
        return [list(eng.scheduler.results()[r]) for r in rids], eng
    eager, e0 = run(False)
    got, e1 = run(True)
    assert got == eager
    g = next(iter(e1.runner._graphs.values()))
    assert g.launches.get(("comm", "all_to_all"), 0) > 0
    for a, b in zip(_leaves(e0.state), _leaves(e1.state)):
        assert torch.equal(a, b)
