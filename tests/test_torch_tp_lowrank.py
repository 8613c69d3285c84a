"""Low-rank factors of whole weights under tensor parallelism, on the CPU
(gloo), held to the port's own world 1 (the reference's path is red on
jax 0.9.0: its ``svd`` refuses a ``PartitionSpec('model', None)`` input).

* A rank-16 draft tree at worlds 2 and 4: ``TTQEngine`` computes the
  draft policy's factors on the whole weights before it places the
  parameters and keeps the rank's slices (``rules.shard_lowrank``), as
  for the verify tree.  Every shard's draft codes, S, Z, D⁻¹, B and A
  are bit for bit its slice of world 1's, and the speculative tokens
  (W = 2) are world 1's.
* ``lowrank=None`` with a rank-16 policy at worlds 2 and 4: a row- or
  column-split weight without factors gathers its whole weight when the
  plan is built and keeps its slice of the whole weight's SVD.  Every
  shard's fields are bit for bit its slice of world 1's ``lowrank=None``
  tree (the reference's per-weight inline SVD), and equal to the
  default factors' tree at the same world; the tokens are world 1's.
* The negative control: factors taken from a slice's own SVD differ from
  the slice of the whole weight's factors (for a row split, the slice of
  B; for a column split, of A).

Every engine quantizes its trees once, from fixed statistics (the JAX
package's prefill of one prompt, sliced to each rank), before it serves.
Worlds 2 and 4 run in one spawn of four processes
(``tests/_torch_tp_lowrank_worker.py``) under a timeout; world 1 runs in
the test process."""
import dataclasses

import numpy as np
import pytest

import _torch_tp_lowrank_worker as W
from repro_torch.bridge import params_from_jax
from repro_torch.core import ttq_policy
from repro_torch.launch.mesh import spawn
from repro_torch.parallel import ParallelCtx
from repro_torch.parallel import rules as R
from repro_torch.parallel.ctx import Mesh
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SUITE_TIMEOUT = 300


@pytest.fixture(scope="module")
def runs():
    """(every rank's {world: {case: result}}, world 1's {case: result})."""
    jax = pytest.importorskip("jax")
    from repro.models import ModelConfig, lm
    jcfg = ModelConfig(**dataclasses.asdict(W.CFG))
    jp = lm.init_params(jcfg, jax.random.PRNGKey(0))
    _, _, stats = lm.prefill(jcfg, jp, {"tokens": np.array([W.TP.PROMPTS[2]])},
                             64)
    np_tree, np_stats = (jax.tree.map(np.asarray, t) for t in (jp, stats))
    ranks = spawn(W.lowrank_suite, 4, np_tree, np_stats, device="cpu",
                  timeout=SUITE_TIMEOUT)
    return ranks, W.world1(params_from_jax(np_tree, device="cpu"),
                           params_from_jax(np_stats, device="cpu"))


def _case(ranks, rank, world, name):
    res = ranks[rank][world][name]
    assert "error" not in res, res.get("error")
    return res


def _slice(full, dim, world, rank):
    k = full.shape[dim] // world
    idx = [slice(None)] * full.ndim
    idx[dim] = slice(rank * k, (rank + 1) * k)
    return full[tuple(idx)]


def _want(full, field, split, world, rank):
    """World 1's ``field`` of a weight split ``split``, sliced to
    ``rank``: codes, S, Z and B on rows for a row split; codes, S, Z, D⁻¹
    and A on columns for a column split."""
    if split == "row" and field not in ("dinv", "A"):
        return _slice(full, -2, world, rank)
    if split == "col" and field not in ("B",):
        return _slice(full, -1, world, rank)
    return full


def _held(tree, base, policies, world, rank, what):
    pctx = R.bind(ParallelCtx(mesh=Mesh(shape={"data": 1, "model": world})),
                  W.CFG, R.col_align(*policies))
    assert set(tree) == set(base), what
    n_split = 0
    for ps, fs in tree.items():
        sp = R.split_of(ps, pctx)
        n_split += sp in ("row", "col")
        assert set(fs) == set(base[ps]) and {"B", "A"} <= set(fs), (what, ps)
        for f, a in fs.items():
            np.testing.assert_array_equal(
                a, _want(base[ps][f], f, sp, world, rank),
                err_msg=f"{what} {ps}.{f} world {world} rank {rank}")
    assert n_split == 7, what           # wq wk wv wo wg wu wd, all split


@pytest.mark.parametrize("world", [2, 4])
def test_rank16_draft_tree_is_world1_sliced(runs, world):
    ranks, one = runs
    base = one["draft"]
    pols = (ttq_policy(**W.VERIFY), ttq_policy(**W.DRAFT))
    for rank in range(world):
        got = _case(ranks, rank, world, "draft")
        assert got["windows"] > 0
        assert got["tokens"] == base["tokens"], (world, rank)
        _held(got["draft"], base["draft"], pols, world, rank, "draft")


@pytest.mark.parametrize("world", [2, 4])
def test_no_factors_is_world1_sliced_and_the_default(runs, world):
    ranks, one = runs
    base = one["none"]
    pols = (ttq_policy(**W.RANKED),)
    for rank in range(world):
        got = _case(ranks, rank, world, "none")
        assert got["tokens"] == got["tokens_default"] == base["tokens"], \
            (world, rank)
        _held(got["none"], base["none"], pols, world, rank, "lowrank=None")
        for ps, fs in got["none"].items():
            for f, a in fs.items():
                np.testing.assert_array_equal(
                    a, got["default"][ps][f],
                    err_msg=f"lowrank=None vs default {ps}.{f}")


@pytest.mark.parametrize("world", [2, 4])
def test_a_slices_own_svd_is_not_the_slice_of_the_svd(runs, world):
    """Negative control: the SVD of a rank's slice of ``wq`` (rows) and
    ``wd`` (columns) gives other factors than the rank's slice of the
    whole weight's, which the plan keeps."""
    ranks, one = runs
    for rank in range(world):
        got = _case(ranks, rank, world, "none")
        for ps, split in zip(W.CONTROL, ("row", "col")):
            f = "B" if split == "row" else "A"
            kept = got["none"][ps][f][0]
            whole = _want(one["none"]["none"][ps][f][0], f, split, world,
                          rank)
            np.testing.assert_array_equal(kept, whole)
            own = got["own"][ps][f]
            assert own.shape == kept.shape
            assert not np.allclose(np.abs(own), np.abs(kept), atol=1e-2), \
                (ps, world, rank)
