"""The port's public surface against the JAX package's, on the CPU:
``serving.sample``, the serving exports (``BlockAllocator``,
``DeviceRunner``), ``core.calibrate`` and ``core.qdq``.  Inputs come from
numpy with a seed."""
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.core import AWQConfig as TAWQ
from repro_torch.core import QuantConfig as TQC
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as jcore
    import repro.serving as jserving
    return dict(jax=jax, jnp=jnp, core=jcore, serving=jserving)


def test_serving_exports_cover_the_reference(jx):
    """Every name the reference's ``repro.serving`` exports, the port's
    exports too, and the classes are the port's own modules'."""
    assert set(jx["serving"].__all__) <= set(tserving.__all__)
    from repro_torch.serving.blocks import BlockAllocator
    from repro_torch.serving.runner import DeviceRunner
    assert tserving.BlockAllocator is BlockAllocator
    assert tserving.DeviceRunner is DeviceRunner


def test_block_allocator_export_matches_jax(jx):
    """The exported allocator: a seeded allocate / free_request sequence
    gives the reference's blocks or its MemoryError at every call
    (tests/test_torch_paged.py holds the whole state after each call)."""
    ta = tserving.BlockAllocator(12, 4)
    ja = jx["serving"].BlockAllocator(12, 4)
    rng = np.random.default_rng(0)
    live = []
    for _ in range(60):
        if rng.integers(0, 2) == 0 or not live:
            prompt = rng.integers(0, 50, int(rng.integers(1, 12))).tolist()
            res = []
            for a in (ta, ja):
                try:
                    res.append(a.allocate(prompt, 4, 32))
                except MemoryError:
                    res.append("MemoryError")
            assert res[0] == res[1]
            if res[0] != "MemoryError":
                live.append(res[0][0])
        else:
            blocks = live.pop(int(rng.integers(0, len(live))))
            ta.free_request(blocks)
            ja.free_request(blocks)
        assert sorted(ta.free) == sorted(ja.free)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_sample_matches_jax(jx, temperature):
    """Greedy: the reference's argmax exactly.  Temperature > 0: the two
    frameworks draw different random numbers, so the draw is held to its
    form — int32 tokens in the vocabulary, one per row, reproducible from
    the generator's seed — and to the greedy token as the temperature goes
    to 0."""
    logits = np.random.default_rng(1).standard_normal((5, 97)) \
        .astype(np.float32)
    if temperature == 0.0:
        want = np.asarray(jx["serving"].sample(jx["jnp"].asarray(logits)))
        got = tserving.sample(torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
        return
    draw = lambda s, t: tserving.sample(  # noqa: E731
        torch.from_numpy(logits), torch.Generator().manual_seed(s), t)
    a, b = draw(3, temperature), draw(3, temperature)
    assert a.dtype == torch.int32 and a.shape == (5,)
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 97)).all())
    np.testing.assert_array_equal(draw(4, 1e-6).numpy(),
                                  logits.argmax(axis=-1))


@pytest.mark.parametrize("form", ["blend", "raw"])
def test_calibrate_matches_jax(jx, form):
    """A stats tree (a run list of dicts of (L, d) Σx² leaves, with a None
    leaf) and its counts → the D tree, within f32 rounding."""
    rng = np.random.default_rng(2)
    stats = {"stack": [{"u0.mix.wq": rng.random((2, 16)).astype(np.float32)
                        * 50,
                        "u0.mlp.w1": rng.random((2, 24)).astype(np.float32)
                        * 50}],
             "enc": None}
    counts = {"stack": [{"u0.mix.wq": 32.0, "u0.mlp.w1": 32.0}], "enc": None}
    acfg_j = jx["core"].AWQConfig(form=form)
    dj = jx["core"].calibrate(
        jx["jax"].tree.map(jx["jnp"].asarray, stats), counts, acfg_j)
    tstats = {"stack": [{k: torch.from_numpy(v)
                         for k, v in stats["stack"][0].items()}], "enc": None}
    dt = tcore.calibrate(tstats, counts, TAWQ(form=form))
    assert dt["enc"] is None
    for k, v in dt["stack"][0].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(dj["stack"][0][k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("bits,g", [(4, 32), (8, 64), (3, 16)])
def test_qdq_matches_jax(jx, bits, g):
    """``core.qdq``: the reference's fake-quant, equal except one step at a
    round-half tie (an f32 reassociation flips it) on at most 2e-3 of the
    values."""
    W = np.random.default_rng(3).standard_normal((32, 128)).astype(np.float32)
    cfg_j = jx["core"].QuantConfig(bits=bits, group_size=g)
    wj = np.asarray(jx["core"].qdq(jx["jnp"].asarray(W), cfg_j))
    wt = tcore.qdq(torch.from_numpy(W), TQC(bits=bits, group_size=g)).numpy()
    diff = np.abs(wj - wt)
    step = (W.reshape(32, -1, g).max(-1) - W.reshape(32, -1, g).min(-1)) \
        / (2 ** bits - 1)
    assert (diff <= np.repeat(step, g, axis=1) * 1.001 + 1e-6).all()
    assert (diff > 1e-6).mean() <= 2e-3
