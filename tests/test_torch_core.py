"""The port's core quantization math against the JAX package's, on the CPU.

Inputs come from numpy with a seed; both sides get the same arrays."""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import awq as t_awq
from repro_torch.core import kvquant as t_kv
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the module: the package exports the function ``qdq`` under that name, as
# the reference's does
t_qdq = importlib.import_module("repro_torch.core.qdq")

RNG_SEED = 7


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import importlib

    import jax.numpy as jnp
    mod = lambda n: importlib.import_module(f"repro.core.{n}")
    return dict(jnp=jnp, awq=mod("awq"), kv=mod("kvquant"), qdq=mod("qdq"))


def _close_codes(a, b, frac=2e-3):
    """Equal except ±1 at round-half ties (an f32 reassociation flips one),
    on at most ``frac`` of the codes."""
    a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() <= frac


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_roundtrip(bits):
    rng = np.random.default_rng(RNG_SEED)
    codes = rng.integers(0, 1 << bits, size=(5, 64)).astype(np.int32)
    if bits == 8:
        codes[:, 3::4] = 255          # top byte of every word: the sign wrap
    pk = t_qdq.pack_bits(torch.from_numpy(codes), bits)
    assert pk.dtype == torch.int32 and pk.shape == (5, 64 * bits // 32)
    if bits == 8:
        assert (pk < 0).all()         # 255 << 24 wrapped into the sign bit
    back = t_qdq.unpack_bits(pk, 64, bits)
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_bits_matches_jax(jx, bits):
    rng = np.random.default_rng(RNG_SEED + bits)
    codes = rng.integers(0, 1 << bits, size=(7, 128)).astype(np.int32)
    pk_j = jx["qdq"].pack_bits(jx["jnp"].asarray(codes), bits)
    pk_t = t_qdq.pack_bits(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(pk_t.numpy(), np.asarray(pk_j))


@pytest.mark.parametrize("layout", ["row", "flat"])
@pytest.mark.parametrize("bits,g,symmetric", [(4, 32, False), (8, 64, False),
                                              (3, 32, False), (4, 32, True)])
def test_quantize_matches_jax(jx, layout, bits, g, symmetric):
    rng = np.random.default_rng(RNG_SEED)
    W = rng.standard_normal((48, 256)).astype(np.float32)
    cfg_j = jx["qdq"].QuantConfig(bits=bits, group_size=g, layout=layout,
                                  symmetric=symmetric)
    cfg_t = t_qdq.QuantConfig(bits=bits, group_size=g, layout=layout,
                              symmetric=symmetric)
    wi_j, S_j, Z_j = jx["qdq"].quantize(jx["jnp"].asarray(W), cfg_j)
    wi_t, S_t, Z_t = t_qdq.quantize(torch.from_numpy(W), cfg_t)
    _close_codes(wi_t.numpy(), wi_j)
    # same f32 min/max/divide on the same inputs: ulp-level agreement
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-6)
    np.testing.assert_allclose(Z_t.numpy(), np.asarray(Z_j), rtol=1e-6)
    deq_t = t_qdq.dequantize(wi_t, S_t, Z_t, cfg_t)
    deq_j = jx["qdq"].dequantize(wi_j, S_j, Z_j, cfg_j)
    # a tie flip moves one element by one step S
    np.testing.assert_allclose(deq_t.numpy(), np.asarray(deq_j),
                               atol=float(np.asarray(S_j).max()) * 1.001)


@pytest.mark.parametrize("form", ["raw", "blend"])
def test_diag_from_stats_matches_jax(jx, form):
    rng = np.random.default_rng(RNG_SEED)
    stat = (rng.standard_normal(96) ** 2 * 50).astype(np.float32)
    cfg_j = jx["awq"].AWQConfig(form=form)
    cfg_t = t_awq.AWQConfig(form=form)
    D_j = jx["awq"].diag_from_stats(jx["jnp"].asarray(stat),
                                    jx["jnp"].asarray(32.0), cfg_j)
    D_t = t_awq.diag_from_stats(torch.from_numpy(stat), 32.0, cfg_t)
    # pow/mean in f32 by two libraries: a few ulps
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), rtol=2e-6)


def test_awq_quantize_matches_jax(jx):
    rng = np.random.default_rng(RNG_SEED)
    W = rng.standard_normal((64, 128)).astype(np.float32)
    D = np.exp(rng.standard_normal(128) * 0.3).astype(np.float32)
    q_j = jx["qdq"].QuantConfig(bits=4, group_size=32, layout="row")
    q_t = t_qdq.QuantConfig(bits=4, group_size=32, layout="row")
    wi_j, S_j, _ = jx["awq"].awq_quantize(jx["jnp"].asarray(W),
                                          jx["jnp"].asarray(D), q_j)
    wi_t, S_t, _ = t_awq.awq_quantize(torch.from_numpy(W),
                                      torch.from_numpy(D), q_t)
    _close_codes(wi_t.numpy(), wi_j)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [0, 8])
def test_kv_quant_matches_jax(jx, bits, group_size):
    rng = np.random.default_rng(RNG_SEED)
    kv = rng.standard_normal((2, 3, 11, 32)).astype(np.float32)
    q_j, s_j = jx["kv"].quantize_kv(jx["jnp"].asarray(kv), bits=bits,
                                    group_size=group_size)
    q_t, s_t = t_kv.quantize_kv(torch.from_numpy(kv), bits=bits,
                                group_size=group_size)
    codes = (lambda q: q) if bits == 8 else \
        (lambda q: t_qdq.unpack_bits(q, 32, 4))
    _close_codes(codes(q_t).numpy(),
                 codes(torch.from_numpy(np.array(q_j))).numpy())
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    d_j = jx["kv"].dequantize_kv(q_j, s_j, jx["jnp"].float32, bits=bits,
                                 group_size=group_size)
    d_t = t_kv.dequantize_kv(q_t, s_t, torch.float32, bits=bits,
                             group_size=group_size)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j),
                               atol=float(np.asarray(s_j).max()) * 1.001)


@pytest.mark.parametrize("packed", [True, False])
def test_ttq_matmul_bridged_lowrank_matches_jax(jx, packed):
    """A QuantizedTensor with low-rank B/A made by the JAX package (the port
    has no SVD init yet) runs in the port's ttq_matmul: y = deq(W)(x/D) + BAx."""
    import importlib
    from repro_torch.bridge import params_from_jax
    from repro_torch.core.ttq import ttq_matmul
    jnp = jx["jnp"]
    jttq = importlib.import_module("repro.core.ttq")
    jlr = importlib.import_module("repro.core.lowrank")
    jpol = importlib.import_module("repro.core.policy")
    rng = np.random.default_rng(RNG_SEED)
    W = rng.standard_normal((64, 128)).astype(np.float32)
    D = np.exp(rng.standard_normal(128) * 0.3).astype(np.float32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    B, A = jlr.svd_factors(jnp.asarray(W), 8)
    pol = jpol.ttq_policy(bits=4, group_size=32, rank=8, packed=packed)
    qt = jttq.quantize_weight(jnp.asarray(W), jnp.asarray(D), pol, B, A)
    y_j = jttq.ttq_matmul(jnp.asarray(x), qt)
    jax = importlib.import_module("jax")
    tqt = params_from_jax({"w": jax.tree.map(np.asarray, qt)},
                          device="cpu")["w"]
    assert tqt.B is not None and (tqt.packed is not None) == packed
    y_t = ttq_matmul(torch.from_numpy(x), tqt)
    # f32 products in another order: the JAX kernel test's tolerance
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5,
                               atol=2e-4)
    from repro_torch.core.ttq import dequant
    np.testing.assert_allclose(dequant(tqt).numpy(),
                               np.asarray(jttq.dequant(qt)), rtol=1e-5,
                               atol=1e-5)
