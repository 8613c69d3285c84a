"""The 2-D ``ttq_gemm``'s wide tile (``csrc/ttq_gemm_wide.cu``): which
shapes ``gemm_tile`` sends there, a plain model of its arithmetic against
the JAX kernel (Pallas in interpret mode) and the port's plain version on
the CPU, and (on a card) the kernel against the plain version.

Inputs come from numpy with a seed.  Tolerances are those of
``tests/test_torch_moe.py::test_mma_tile_model_matches_jax_vmapped`` (the
same arithmetic): before the bf16 output rounding the f32 GEMM tolerance,
rtol 2e-5 / atol 2e-4; after it rtol 2^-7 / atol 2e-4·sqrt(d/256), which is
also [2]'s tolerance in ``chip_smoke.py`` for the kernel on the card."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as t_get
from repro_torch.core.qdq import unpack_bits
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ttq_gemm import (WIDE_MAX_D, WIDE_MIN_T,
                                          WIDE_MIN_TILES, WIDE_ROWS,
                                          WIDE_TOKENS, _launch, gemm_tile)
from repro_torch.serving import EngineConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16
SPEC_W = 3          # the speculative window the card serves (chip_smoke.py)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops
    return dict(jax=jax, jnp=jnp, ops=ops)


def _case(seed, T, dp, d, g, bits=4):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((dp, d)).astype(np.float32)
    D = np.exp(0.3 * rng.standard_normal(d)).astype(np.float32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    pk, S, Z = tref.ttq_quantize_ref(torch.from_numpy(W), torch.from_numpy(D),
                                     bits=bits, group_size=g)
    return torch.from_numpy(x), pk, S, Z, torch.from_numpy(1.0 / D)


def _wkv_b(arch="deepseek_v2_lite_16b"):
    """(d', d) of an MLA config's ``wkv_b`` and its decode T = slots ×
    max_len at the default EngineConfig."""
    cfg = t_get(arch)
    m = cfg.mla
    ecfg = EngineConfig()
    return (cfg.n_heads * (m.qk_nope_dim + m.v_head_dim), m.kv_lora_rank,
            ecfg.max_slots * ecfg.max_len)


# ------------------------------------------------------------- the rule

@pytest.mark.parametrize("world", [1, 2, 4])
def test_wkv_b_and_its_row_shards_take_the_wide_tile(world):
    """deepseek-v2-lite's latent expansion (T = 4 × 256 = 1,024, d' =
    4,096, d = 512, int4 g32 bf16) takes the wide tile, and so does a
    row-split rank's shard at worlds 2 and 4 (the same T and d, d'/world
    rows)."""
    dp, d, T = _wkv_b()
    assert (dp, d, T) == (4096, 512, 1024)
    assert dp % world == 0 and (dp // world) % 8 == 0
    assert gemm_tile(T, dp // world, d, 32, 4, BF16) == "wide"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_served_decode_and_verify_linears_stay_split(arch):
    """Every config's decode linears (T = slots) and speculative verify
    linears (T = slots × (W + 1)) take the split tile at every input width
    the config has, whatever the group size: T stays below WIDE_MIN_T."""
    cfg = t_get(arch)
    slots = EngineConfig().max_slots
    widths = {cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim}
    if cfg.moe is not None:
        widths.add(cfg.moe.d_ff_expert)
    if cfg.mla is not None:
        widths |= {cfg.mla.kv_lora_rank, cfg.n_heads * cfg.mla.v_head_dim}
    for T in (slots, slots * (SPEC_W + 1)):
        assert T < WIDE_MIN_T
        for dp in widths:
            for d in widths:
                for g in (32, 64, 128):
                    if d % g == 0:
                        assert gemm_tile(T, dp, d, g, 4, BF16) == "split", (
                            T, dp, d, g)


@pytest.mark.parametrize("T,dp,d,g,bits,dtype,want", [
    (1024, 4096, 512, 32, 4, BF16, "wide"),
    (64, 4096, 512, 32, 4, BF16, "wide"),
    (63, 4096, 512, 32, 4, BF16, "split"),
    (16, 4096, 3072, 32, 4, BF16, "split"),
    (4, 4096, 3072, 32, 4, BF16, "split"),
    (1024, 4096, 512, 128, 4, BF16, "wide"),
    (1024, 4096, 1408, 64, 4, BF16, "split"),
    (1024, 4096, 160, 32, 4, BF16, "wide"),
    (64, 4096, 1024, 32, 4, BF16, "wide"),
    (64, 4096, 2048, 32, 4, BF16, "split"),
    (1024, 4096, 1024, 128, 4, BF16, "wide"),
    (1024, 4096, 2048, 64, 4, BF16, "split"),
    (1024, 4096, 3072, 32, 4, BF16, "split"),
    (64, 3072, 24576, 32, 4, BF16, "split"),
    (64, 2048, 512, 32, 4, BF16, "wide"),
    (64, 1792, 512, 32, 4, BF16, "split"),
    (64, 1024, 1024, 32, 4, BF16, "split"),
    (1024, 1024, 512, 32, 4, BF16, "wide"),
    (128, 1024, 512, 32, 4, BF16, "wide"),
    (1024, 4096, 512, 32, 4, torch.float32, "split"),
    (1024, 4096, 512, 32, 2, BF16, "split"),
    (1024, 4096, 512, 32, 8, BF16, "split"),
    (1024, 4096, 512, 16, 4, BF16, "split"),
    (1024, 4096, 192, 48, 4, BF16, "split"),
    (1024, 4096, 256, 8, 4, BF16, "split")])
def test_gemm_tile_by_shape(T, dp, d, g, bits, dtype, want):
    """bf16 x, int4, g a power of two >= 32 dividing d, T >= WIDE_MIN_T
    (64), d <= WIDE_MAX_D (1,024) and at least WIDE_MIN_TILES (8) tiles of
    WIDE_ROWS × WIDE_TOKENS (256 × 64) → the wide tile; f32 x (a
    column-split linear at world > 1), bits 2 and 8, g below 32 or not a
    power of two, T < 64, a wider input (gemma-7b's linears take d = 3,072
    and 24,576) or a smaller grid (d' = 1,024 or 1,792 at T = 64: 4 and 7
    tiles) → the split tile."""
    assert (WIDE_MIN_T, WIDE_MAX_D, WIDE_MIN_TILES) == (64, 1024, 8)
    assert (WIDE_ROWS, WIDE_TOKENS) == (256, 64)
    assert gemm_tile(T, dp, d, g, bits, dtype) == want


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """On CPU tensors ``ttq_gemm`` at a wide shape is ``ttq_gemm_ref`` bit
    for bit and counts no launch and no tile."""
    x, pk, S, Z, dinv = _case(0, 70, 48, 256, 32)
    before = (dict(kbuild.LAUNCHES), dict(kbuild.GEMM_TILES))
    y = tops.ttq_gemm(x.to(BF16), pk, S, Z, dinv, bits=4, group_size=32)
    y_r = tref.ttq_gemm_ref(x.to(BF16), pk, S, Z, bits=4, group_size=32,
                            dinv=dinv).to(BF16)
    assert torch.equal(y, y_r)
    assert (dict(kbuild.LAUNCHES), dict(kbuild.GEMM_TILES)) == before


def test_graph_replay_counts_each_gemm_tile():
    """A graph replay adds its captured counts again: the launches, each
    launch's GEMM tile (``build.GEMM_TILES``, ``build.EXPERTS_TILES``) and
    the collectives, each to its own counter."""
    from repro_torch.parallel import comm
    from repro_torch.serving import runner
    captured = {"ttq_gemm": 3, ("gemm_tile", "wide"): 1,
                ("gemm_tile", "split"): 2, ("tile", "mma"): 4,
                ("comm", "all_reduce"): 5}
    g = runner._Graph(types.SimpleNamespace(replay=lambda: None), "out",
                      captured, {})
    before = [dict(c) for c in (kbuild.LAUNCHES, kbuild.GEMM_TILES,
                                kbuild.EXPERTS_TILES, comm.COUNTS)]
    assert runner.DeviceRunner._replay(g) == "out"
    after = [dict(c) for c in (kbuild.LAUNCHES, kbuild.GEMM_TILES,
                               kbuild.EXPERTS_TILES, comm.COUNTS)]
    for c, b in zip((kbuild.LAUNCHES, kbuild.GEMM_TILES, kbuild.EXPERTS_TILES,
                     comm.COUNTS), before):
        c.update(b)
    assert after[0]["ttq_gemm"] - before[0]["ttq_gemm"] == 3
    assert {k: after[1][k] - before[1][k] for k in after[1]} == {
        "split": 2, "wide": 1}
    assert after[2]["mma"] - before[2]["mma"] == 4
    assert after[3]["all_reduce"] - before[3]["all_reduce"] == 5


# --------------------------------- the wide tile's arithmetic (plain model)

def _wide_tile_model(x, pk, S, Z, dinv, *, g):
    """The arithmetic of ``csrc/ttq_gemm_wide.cu`` in plain torch, f32 out:
    x̃ = x∘D⁻¹ as the bf16 pair hi = bf16(x̃), lo = bf16(x̃ − hi); the int4
    codes as exact integers; per group one f32 sum Σ c·hi + Σ c·lo (hi and
    lo extend K: one accumulator) and Σ (hi + lo); s and z applied to them
    after: y = Σ_groups s·(Σ c·hi + Σ c·lo) + z·Σ(hi + lo).  (The card
    takes each sum in its own fixed order; the model's is torch's.)"""
    T, d = x.shape
    dp = pk.shape[0]
    xt = x.float() * dinv
    hi = xt.bfloat16().float()
    lo = (xt - hi).bfloat16().float()
    cg = unpack_bits(pk, d, 4).float().reshape(dp, d // g, g)
    acc = (torch.einsum("pgk,tgk->tpg", cg, hi.reshape(T, d // g, g))
           + torch.einsum("pgk,tgk->tpg", cg, lo.reshape(T, d // g, g)))
    xsum = (hi + lo).reshape(T, d // g, g).sum(-1)
    return (S[None] * acc).sum(-1) + (Z[None] * xsum[:, None, :]).sum(-1)


@pytest.mark.parametrize("T", [64, 100, 300])
@pytest.mark.parametrize("g", [32, 128])
def test_wide_tile_model_matches_jax(jx, T, g):
    """The wide tile's arithmetic (:func:`_wide_tile_model`, bf16 x as the
    port serves it, a ragged d' = 200) against the JAX ``ttq_gemm``
    (interpret mode) and against ``ttq_gemm_ref``, both on the same bf16 x:
    within the f32 GEMM tolerance before the output's bf16 rounding, and
    within rtol 2^-7, atol 2e-4·sqrt(d/256) after it."""
    dp, d = 200, 256
    x, pk, S, Z, dinv = _case(3 * T + g, T, dp, d, g)
    xb = x.to(BF16)
    y = _wide_tile_model(xb, pk, S, Z, dinv, g=g)
    y_r = tref.ttq_gemm_ref(xb, pk, S, Z, bits=4, group_size=g, dinv=dinv)
    jnp = jx["jnp"]
    y_j = np.asarray(jx["ops"].ttq_gemm(
        jnp.asarray(xb.float().numpy()), *(jnp.asarray(t.numpy())
                                            for t in (pk, S, Z, dinv)),
        bits=4, group_size=g))
    atol = 2e-4 * (d / 256) ** 0.5
    for want in (y_r.numpy(), y_j):
        np.testing.assert_allclose(y.numpy(), want, rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(y.bfloat16().float().numpy(), want,
                                   rtol=2 ** -7, atol=atol)


# ---------------------------------------------------------------- on a card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    kbuild.lib()
    return torch.device("cuda")


def _cuda_case(dev, T, dp, d, g, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((dp, d), generator=gen, device=dev) * d ** -0.5
    D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=dev))
    x = torch.randn((T, d), generator=gen, device=dev).to(BF16)
    pk, S, Z = tref.ttq_quantize_ref(W, D, bits=4, group_size=g)
    return x, pk, S, Z, 1.0 / D


def _tol(d):
    return dict(rtol=2 ** -7, atol=2e-4 * (d / 256) ** 0.5)


def _wide(x, pk, S, Z, dinv, g):
    """One launch of the wide tile, forced (``_launch``) whatever
    ``gemm_tile`` would choose at the shape: the kernel itself."""
    return _launch(x, pk, S, Z, dinv, 4, g, "wide")


def _counted(x, pk, S, Z, dinv, g):
    """One forced wide launch: (y, launches counted, tiles counted)."""
    before = (kbuild.LAUNCHES["ttq_gemm"], dict(kbuild.GEMM_TILES))
    y = _wide(x, pk, S, Z, dinv, g)
    return (y, kbuild.LAUNCHES["ttq_gemm"] - before[0],
            {k: v - before[1][k] for k, v in kbuild.GEMM_TILES.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("dp", [40, 2048, 4096])
@pytest.mark.parametrize("T", [64, 100, 1024, 1031])
def test_wide_kernel_matches_plain(cuda, T, dp):
    """wkv_b's d = 512, int4 g32, bf16 x: one launch of the wide tile,
    counted once as "wide", within [2]'s tolerance of the plain version;
    two calls bitwise equal; ``ttq_gemm`` takes this launch where
    ``gemm_tile`` says "wide", the split tile's otherwise (d' = 40 at T =
    64 and 100: fewer than WIDE_MIN_TILES tiles)."""
    d = 512
    x, pk, S, Z, dinv = _cuda_case(cuda, T, dp, d, 32)
    y, n, tiles = _counted(x, pk, S, Z, dinv, 32)
    assert n == 1 and tiles == {"split": 0, "wide": 1}
    assert y.shape == (T, dp) and y.dtype == BF16
    y_r = tref.ttq_gemm_ref(x, pk, S, Z, bits=4, group_size=32, dinv=dinv)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_r, **_tol(d))
    assert torch.equal(y, _wide(x, pk, S, Z, dinv, 32))
    routed = tops.ttq_gemm(x, pk, S, Z, dinv, bits=4, group_size=32)
    if gemm_tile(T, dp, d, 32, 4, BF16) == "wide":
        assert torch.equal(y, routed)
    else:                       # d' = 40 at T = 64 and 100: 1 and 2 tiles
        assert dp == 40 and T <= 100
        torch.testing.assert_close(routed.float(), y_r, **_tol(d))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(100, 200, 512, 128, True),
                                  (300, 96, 1024, 64, True),
                                  (70, 300, 160, 32, True),
                                  (129, 264, 512, 32, False),
                                  (65, 37, 256, 256, False)],
                         ids=["g128", "g64", "d160", "no-dinv",
                              "odd-dp-g256"])
def test_wide_kernel_other_shapes(cuda, case):
    """Other group sizes (a group over several units and stages), d = 160
    (a half stage at the end), no D⁻¹ and an odd d' (rows stored one by
    one): within [2]'s tolerance of the plain version."""
    T, dp, d, g, with_dinv = case
    x, pk, S, Z, dinv = _cuda_case(cuda, T, dp, d, g)
    dinv = dinv if with_dinv else None
    y, n, tiles = _counted(x, pk, S, Z, dinv, g)
    assert n == 1 and tiles["wide"] == 1
    y_r = tref.ttq_gemm_ref(x, pk, S, Z, bits=4, group_size=g, dinv=dinv)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_r, **_tol(d))


@pytest.mark.gpu
@pytest.mark.parametrize("g", [32, 128])
def test_wide_kernel_rows_and_tokens_independent(cuda, g):
    """The rows of a d' slice (a row-split rank's shard, and a slice that
    starts off a tile's 256 rows) and the first T' tokens are bit for bit
    the whole launch's."""
    T, dp, d = 1031, 4096, 512
    x, pk, S, Z, dinv = _cuda_case(cuda, T, dp, d, g)
    y = _wide(x, pk, S, Z, dinv, g)
    for lo, hi in ((2048, 4096), (1024, 2048), (40, 1000)):
        ys = _wide(x, pk[lo:hi], S[lo:hi], Z[lo:hi], dinv, g)
        assert torch.equal(y[:, lo:hi], ys), (lo, hi)
    for n in (64, 515, 1000):
        assert torch.equal(y[:n], _wide(x[:n].clone(), pk, S, Z, dinv, g)), n


@pytest.mark.gpu
def test_either_tile_forced_at_one_shape(cuda):
    """``_launch`` forces a tile: the split tile at wkv_b's shape agrees
    with the plain version too; the wide tile refuses f32 x and int8 codes
    instead of computing them."""
    dp, d, T = _wkv_b()
    x, pk, S, Z, dinv = _cuda_case(cuda, T, dp, d, 32)
    y_s = _launch(x, pk, S, Z, dinv, 4, 32, "split")
    y_r = tref.ttq_gemm_ref(x, pk, S, Z, bits=4, group_size=32, dinv=dinv)
    torch.cuda.synchronize()
    torch.testing.assert_close(y_s.float(), y_r, **_tol(d))
    with pytest.raises(ValueError, match="wide tile"):
        _launch(x.float(), pk, S, Z, dinv, 4, 32, "wide")
    pk8, S8, Z8 = tref.ttq_quantize_ref(torch.randn((dp, d), device=cuda),
                                        torch.ones(d, device=cuda), bits=8,
                                        group_size=32)
    with pytest.raises(ValueError, match="wide tile"):
        _launch(x, pk8, S8, Z8, dinv, 8, 32, "wide")
