"""Data- and tensor-parallel training of the port over ``torch.distributed``
(gloo, on the CPU), held to the port's own world 1 (``pctx=None``) and,
where the reference runs, to the reference.

* the (data, model) mesh: global rank d·M + m;
* a (1,1) mesh trains bit for bit like ``pctx=None`` (losses, grad norms,
  masters; 3 steps);
* data parallelism with ZeRO-1 at (2,1) and (4,1): each rank's optimizer
  elements are :func:`opt_sharding`'s prediction, below 0.6× world 1's at
  D = 2;
* tensor and data × tensor parallelism at (1,2), (1,4), (2,2) for gemma
  (dense) and chameleon (vlm, qk-norm);
* the block entry's backward all-reduce (``comm.enter``) is what makes the
  gradients right: without it every norm gain's gradient is wrong;
* MoE (deepseek-v2-lite smoke) at (2,1) under ``moe_impl="dense"``
  against world 1, and under ``"a2a"`` at a capacity where nothing drops
  against the world-1 a2a context; every expert leaf gets a gradient;
* checkpoints across meshes: the reference's checkpoint restored by
  ``reshard_restore`` at (1,2), (2,1), (2,2); a (2,2) ZeRO-1 checkpoint
  read back by the reference's ``CheckpointManager.restore``;
* ``ElasticController.rescale`` from (2,1), crashed at step 6, onto (1,2)
  from step 4 to 8;
* ``compressed_psum`` at world 4 bit for bit the reference's under
  ``shard_map`` on 4 host devices; ``make_compressed_dp_step`` at world 4
  within the reference test's bound of the uncompressed step;
* ``launch.train --data-parallel 2 --model-parallel 2``.

Tolerances.  The DP rule is the reference's microbatch-equivalence
tolerance (``tests/test_training.py:57,62``): losses within rtol 2e-2,
masters within rtol 2e-2 and atol 2e-3 (measured: at most half of it).
Step 1's gradients under data parallelism are held in the trainer's bf16
compute, each leaf's relative L2 within GRAD_DP = 1e-2 of world 1's
(measured ≤ 3.2e-3: the same products summed over ranks in another
order).  Under tensor parallelism each rank's partial cotangents are
rounded to bf16 before their sum, where world 1 rounds once: in bf16
the split runs sit 1.1–1.3% from world 1, while world 1 itself sits
2.0–2.4% from the f32 gradient and the split runs 2.1–2.3%.  So the
split runs' step-1 gradients are held in f32 compute, where they are
world 1's up to reassociation: each leaf's relative L2 within GRAD_F32 =
1e-4 (floored at 1e-4 of the whole gradient's norm, as
``tests/test_torch_training.py`` holds the port's to ``jax.grad``;
measured 1.2e-6).  Step 1's bf16 grad norm is held within GN_RTOL = 1e-3
of world 1's.  The compressed step is held to rel-L2 0.05 of the
masters (``tests/test_training.py:118``; measured 4e-4).

Every mesh runs in one spawn of four processes
(``tests/_torch_train_worker.py:train_suite``) under a timeout; the
reference's ``compressed_psum`` runs in one JAX subprocess; the CLI
spawns its own four ranks."""
import ast
import pickle

import numpy as np
import pytest
import torch

import _torch_train_worker as W
from repro_torch._tree import tree_leaves_with_path
from repro_torch.launch import train as t_train_cli
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm
from repro_torch.parallel import ParallelCtx
from repro_torch.parallel.ctx import Mesh
from repro_torch.parallel.rules import P, bind, param_sharding
from repro_torch.training.trainer import opt_sharding
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SUITE_TIMEOUT = 300
LOSS_RTOL = MASTER_RTOL = 2e-2
MASTER_ATOL = 2e-3
GRAD_F32 = 1e-4
GRAD_DP = 1e-2
NO_ENTRY = 0.1
GN_RTOL = 1e-3
COMPRESSED_REL = 0.05
PSUM_SHAPES = {"w": (8, 16), "b": (5,), "s": ()}


def _key(path):
    return "/".join(str(p) for p in path)


def _rel(a, b, floor=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), floor, 1e-30)


def _paths(name):
    params = lm.init_params(W.model_cfg(name),
                            torch.Generator().manual_seed(0), "cpu")
    return [_key(p) for p, _ in tree_leaves_with_path(params)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager
    from repro.configs import get
    from repro.models import lm as jlm
    from repro.optim import AdamWConfig, adamw_init, adamw_update
    return dict(jax=jax, jnp=jnp, Ckpt=CheckpointManager, get=get, lm=jlm,
                adamw_init=adamw_init, adamw_update=adamw_update,
                AdamWConfig=AdamWConfig)


def _jnp_tree(jx, tree):
    """{path key: numpy} of a JAX tree (bf16 widened to f32)."""
    return {_key(p): np.asarray(v, np.float32) if v.dtype == jx["jnp"]
            .bfloat16 else np.asarray(v)
            for p, v in tree_leaves_with_path(tree)}


def _jax_opt(jx, seed, update):
    """The reference's opt state of gemma's smoke config (one AdamW step
    of 0.01 gradients with ``update``, so m and v are not zero)."""
    cfg = jx["get"]("gemma_7b", smoke=True)
    jp = jx["lm"].init_params(cfg, jx["jax"].random.PRNGKey(seed))
    st = jx["adamw_init"](jp)
    if update:
        g = jx["jax"].tree.map(lambda p: jx["jnp"].full(p.shape, 0.01,
                                                        p.dtype), jp)
        _, st, _ = jx["adamw_update"](g, st, jx["AdamWConfig"](), params=jp)
    return st


@pytest.fixture(scope="module")
def inputs(jx, tmp_path_factory):
    """The suite's inputs: checkpoint directories (the reference's at step
    5), the reference checkpoint's arrays, compressed_psum's per-rank f32
    gradients and error buffers, and the compressed step's batches."""
    root = tmp_path_factory.mktemp("ptrain")
    dirs = {k: str(root / k) for k in ("reference", "port", "elastic")}
    st = _jax_opt(jx, 2, True)
    jx["Ckpt"](dirs["reference"]).save(5, {"opt": st})
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal((4, *s)).astype(np.float32)
             for k, s in PSUM_SHAPES.items()}
    errs = {k: (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in grads.items()}
    batches = [rng.integers(0, 64, (W.BATCH, 16)).astype(np.int32)
               for _ in range(5)]
    return dict(dirs=dirs, ref=_jnp_tree(jx, {"opt": st}),
                psum=(grads, errs), batches=batches, root=root)


@pytest.fixture(scope="module")
def suite(inputs):
    """Every rank's {case: result} (one spawn per module)."""
    return spawn(W.train_suite, 4, inputs["dirs"], inputs["ref"],
                 inputs["psum"], inputs["batches"], device="cpu",
                 timeout=SUITE_TIMEOUT)


@pytest.fixture(scope="module")
def world1():
    """World 1 (pctx=None) of every case the suite holds to it."""
    out = {n: W.world1(n, grads=True) for n in ("dense", *W.TP_ARCHS)}
    out["moe"] = W.world1("deepseek_v2_lite_16b", grads=True)
    out["dense-8"] = W.world1("dense", steps=8)
    return out


def _case(suite, name, rank=0):
    res = suite[rank][name]
    assert "error" not in res, res["error"]
    return res


def _dp_rule(w1, res):
    np.testing.assert_allclose(res["loss"], w1["loss"], rtol=LOSS_RTOL)
    for a, b in zip(w1["master"], res["master"]):
        np.testing.assert_allclose(b, a, rtol=MASTER_RTOL, atol=MASTER_ATOL)


# ---------------------------------------------------------------- the mesh

def test_mesh_lays_ranks_out_as_jax_make_mesh(suite):
    """make_mesh(2, 2): global rank d·2 + m is model rank m of data row d
    (``jax.make_mesh((2, 2))``'s device order)."""
    for r, res in enumerate(suite):
        lay = res["layout"]
        assert (lay["dp_world"], lay["world"]) == (2, 2)
        assert lay["global_rank"] == r == lay["dp_rank"] * 2 + lay["rank"]


def test_one_rank_mesh_is_pctx_none_bit_for_bit(suite):
    res = _case(suite, "identity")
    assert res == dict(loss=True, grad_norm=True, master=True)


def test_opt_sharding_reads_global_shapes():
    """The reference's rule on a (2, 2) shape-only mesh: a layer-stacked
    leaf splits its layer axis over the data ranks, the vocab-parallel
    table its free width; a leaf no free dimension of which the data ranks
    divide stays as its parameter; ``zero1=False`` copies the parameter's
    spec."""
    pctx = bind(ParallelCtx(mesh=Mesh(shape={"data": 2, "model": 2})),
                W.CFG)
    params = lm.init_params(W.CFG, torch.Generator().manual_seed(0), "cpu")
    params["odd"] = torch.zeros((3, 5))
    tmpl = {k: params for k in ("master", "m", "v")}
    ps = param_sharding(params, pctx)
    sh = opt_sharding(tmpl, ps, pctx, True)
    u0 = sh["m"]["stack"][0]["u0"]
    assert sh["step"].spec == P()
    assert sh["master"]["embed"].spec == P("model", "data")
    assert u0["mix"]["wq"].spec == P("data", "model", None)
    assert u0["ln1"]["gamma"].spec == P("data", None)
    assert sh["v"]["odd"].spec == P(None, None)
    flat = opt_sharding(tmpl, ps, pctx, False)
    assert flat["master"]["embed"].spec == P("model", None)
    assert flat["master"]["stack"][0]["u0"]["mix"]["wq"].spec == \
        P(None, "model", None)


# ---------------------------------------------------------- data parallel

@pytest.mark.parametrize("d", [2, 4])
def test_data_parallel_zero1_holds_world1(suite, world1, d):
    """3 steps in 2 microbatches; step 1's bf16 gradients (reduce-scattered,
    gathered) within GRAD_DP of world 1's (measured 3.2e-3: the sum over
    ranks in another order) and its grad norm within GN_RTOL."""
    res, w1 = _case(suite, f"dp-dense-{d}1"), world1["dense"]
    _dp_rule(w1, res)
    np.testing.assert_allclose(res["grad_norm"][0], w1["grad_norm"][0],
                               rtol=GN_RTOL)
    for path, a, b in zip(_paths("dense"), w1["grads"], res["grads"]):
        assert _rel(a, b) < GRAD_DP, path


@pytest.mark.parametrize("d", [2, 4])
def test_zero1_state_per_rank_is_the_prediction(suite, world1, d):
    whole = sum(3 * m.size for m in world1["dense"]["master"])
    for r in range(d):
        res = _case(suite, f"dp-dense-{d}1", r)
        assert res["elements"] == res["predicted"]
        if d == 2:
            assert res["elements"] < 0.6 * whole


# -------------------------------------------------------- tensor parallel

TP_CASES = [(n, d, m) for n in W.TP_ARCHS for d, m in W.TP_MESHES]


@pytest.mark.parametrize("name,d,m", TP_CASES)
def test_tensor_parallel_holds_world1(suite, world1, name, d, m):
    res = _case(suite, f"tp-{name}-{d}{m}")
    _dp_rule(world1[name], res)
    np.testing.assert_allclose(res["grad_norm"][0],
                               world1[name]["grad_norm"][0], rtol=GN_RTOL)


@pytest.mark.parametrize("name,d,m", TP_CASES)
def test_step1_gradients_hold_world1(suite, world1, name, d, m):
    """Step 1's gradients in f32 compute, gathered whole: every leaf within
    GRAD_F32 of world 1's."""
    res, w1 = _case(suite, f"tp-{name}-{d}{m}"), world1[name]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in w1["grads32"]))
    for path, a, b in zip(_paths(name), w1["grads32"], res["grads32"]):
        assert _rel(a, b, GRAD_F32 * norm) < GRAD_F32, path


def test_block_entry_backward_is_what_makes_it_right(suite, world1):
    """With ``comm.enter``'s backward the identity (patched in the worker),
    each rank keeps its partial cotangent of the residual stream: at (1,2)
    every norm gain's f32 gradient is off by more than NO_ENTRY (10× the
    rel-L2 1e-2 step 1's gradients must meet; measured 0.57–0.96)."""
    res = _case(suite, "no-entry")
    gains = [(p, a, b) for p, a, b in zip(
        _paths("gemma_7b"), world1["gemma_7b"]["grads32"], res["grads"])
        if p.endswith("gamma")]
    assert len(gains) == 3                   # ln1, ln2 (layer-stacked), final
    for path, a, b in gains:
        assert _rel(a, b) > NO_ENTRY, path


# --------------------------------------------------------------------- MoE

@pytest.mark.parametrize("impl", ["dense", "a2a"])
def test_moe_under_data_parallel(suite, world1, impl):
    """(2,1): ``"dense"`` against world 1, ``"a2a"`` (capacity C = 2·Tc:
    nothing dropped) against the world-1 a2a context, by the DP rule;
    step 1's bf16 gradients within GRAD_DP (measured 2.7e-3)."""
    res = _case(suite, f"moe-{impl}")
    ref = world1["moe"] if impl == "dense" else _case(suite, "moe-a2a-world1")
    _dp_rule(ref, res)
    for path, a, b in zip(_paths("deepseek_v2_lite_16b"), ref["grads"],
                          res["grads"]):
        assert _rel(a, b) < GRAD_DP, path


@pytest.mark.parametrize("impl", ["dense", "a2a"])
def test_every_expert_leaf_gets_a_gradient(suite, impl):
    """The experts' gradients reach them through the differentiable
    collectives (an all-to-all's output cut from the graph gave none)."""
    res = _case(suite, f"moe-{impl}")
    experts = [g for p, g in zip(_paths("deepseek_v2_lite_16b"),
                                 res["grads"]) if "/experts/" in p]
    assert len(experts) == 3
    assert all(np.abs(g).max() > 0 for g in experts)


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("d,m", W.CKPT_MESHES)
def test_reference_checkpoint_restores_onto_meshes(suite, d, m):
    for r in range(d * m):
        res = _case(suite, f"ckpt-ref-{d}{m}", r)
        assert res["local"] and res["gathered"] and res["split"] > 0


@pytest.mark.parametrize("step", [0, 1])
def test_port_mesh_checkpoint_reads_through_the_reference(jx, suite, inputs,
                                                          step):
    """A (2,2) ZeRO-1 Trainer's checkpoint, read by the reference's
    ``CheckpointManager.restore``: at step 0 bit for bit world 1's initial
    state (the same seed), at step 1 bit for bit the ranks' state
    gathered whole."""
    like = {"opt": _jax_opt(jx, 0, False)}
    got = _jnp_tree(jx, jx["Ckpt"](inputs["dirs"]["port"]).restore(step,
                                                                   like))
    if step == 0:
        tr = W.trainer(W.model_cfg("gemma_7b"), None)
        want = {_key(("opt",) + p): W.npy(t)
                for p, t in tree_leaves_with_path(tr.opt_state)}
    else:
        tr = W.trainer(W.model_cfg("gemma_7b"), None)
        keys = [_key(("opt",) + p) for p, _ in
                tree_leaves_with_path(tr.opt_state)]
        want = dict(zip(keys, _case(suite, "ckpt-port")["state"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_elastic_rescale_resumes_on_another_mesh(suite, world1):
    """(2,1) crashes at step 6; step 4's checkpoint is restored onto (1,2)
    (every leaf bit for bit the saved slice), which runs steps 4–7 within
    the DP rule of an uninterrupted world-1 run."""
    res = _case(suite, "elastic")
    assert res["crashed"] and res["exact"] and res["steps"] == [4, 5, 6, 7]
    w1 = world1["dense-8"]
    np.testing.assert_allclose(res["loss"], w1["loss"][4:], rtol=LOSS_RTOL)
    for a, b in zip(w1["master"], res["master"]):
        np.testing.assert_allclose(b, a, rtol=MASTER_RTOL, atol=MASTER_ATOL)


# ----------------------------------------------------- compressed DP step

@pytest.fixture(scope="module")
def ref_psum(subproc, inputs):
    """The reference's ``compressed_psum`` under ``shard_map`` on 4 host
    devices, on the suite's per-rank inputs."""
    src, dst = inputs["root"] / "psum_in.pkl", inputs["root"] / "psum.pkl"
    with open(src, "wb") as f:
        pickle.dump(inputs["psum"], f)
    subproc(f"""
import pickle
import jax, numpy as np
from repro.optim.compress import compressed_psum
from repro.parallel import shard_map
P = jax.sharding.PartitionSpec
grads, errs = pickle.load(open({str(src)!r}, "rb"))
mesh = jax.make_mesh((4,), ('data',))
def fn(g, e):
    deq, err = compressed_psum({{k: v[0] for k, v in g.items()}}, ('data',),
                               {{k: v[0] for k, v in e.items()}})
    return deq, {{k: v[None] for k, v in err.items()}}
deq, err = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P('data'), P('data')),
                             out_specs=(P(), P('data')), check_vma=False))(
    grads, errs)
pickle.dump(({{k: np.asarray(v) for k, v in deq.items()}},
             {{k: np.asarray(v) for k, v in err.items()}}),
            open({str(dst)!r}, "wb"))
print("OK")
""", devices=4)
    with open(dst, "rb") as f:
        return pickle.load(f)


def test_compressed_psum_bit_for_bit_the_reference(suite, ref_psum):
    deq, err = ref_psum
    for r in range(4):
        res = _case(suite, "psum", r)
        for k in PSUM_SHAPES:
            assert np.array_equal(res["deq"][k], deq[k]), (r, k)
            assert np.array_equal(res["err"][k], err[k][r]), (r, k)


def test_compressed_step_world4_near_uncompressed(suite):
    res = _case(suite, "compressed")
    num = sum(float(np.sum((a - b) ** 2)) for a, b in
              zip(res["master"], res["uncompressed"]))
    den = sum(float(np.sum(b ** 2)) for b in res["uncompressed"])
    assert (num / den) ** 0.5 < COMPRESSED_REL
    assert all(np.isfinite(res["loss"]))


# --------------------------------------------------------------------- CLI

def _lines(capsys):
    return [ast.literal_eval(x) for x in
            capsys.readouterr().out.strip().splitlines()]


def test_train_cli_data_and_model_parallel(capsys):
    """``--data-parallel 2 --model-parallel 2`` prints world 1's lines
    within the DP rule (4 spawned ranks; the global batch split over the
    data rows)."""
    base = ["--arch", "gemma_7b", "--smoke", "--device", "cpu", "--steps",
            "3", "--seq", "16", "--batch", "4"]
    t_train_cli.main(base)
    one = _lines(capsys)
    out = t_train_cli.main(base + ["--data-parallel", "2",
                                   "--model-parallel", "2"])
    four = _lines(capsys)
    assert out.step == 3 and len(four) == len(one) == 6
    for a, b in zip(one, four):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=LOSS_RTOL)
