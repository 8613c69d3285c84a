"""The port's kernel plain versions against the JAX package's kernels, and
(on a card) each CUDA kernel against its plain version.

JAX side: ``repro.kernels.ops`` as the JAX tests run it on the CPU (Pallas
in interpret mode).  Port side: ``device="cpu"``, so every wrapper uses its
plain version.  Inputs come from numpy with a seed."""
import numpy as np
import pytest
import torch

from repro_torch.core.kvquant import quantize_kv as t_quantize_kv
from repro_torch.core.qdq import unpack_bits as t_unpack
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ttq_attn import (MIN_ROWS, SPLITS, _launch,
                                          attn_splits, head_tile,
                                          ttq_decode_attention,
                                          ttq_paged_decode_attention)
from repro_torch.kernels.ttq_gemm import (fast_shape, gemm_splits,
                                          ttq_gemm_experts)
from repro_torch.kernels.ttq_quantize import (
    BLOCKS_PER_SM as QUANT_BLOCKS_PER_SM, MIN_ROWS as QUANT_MIN_ROWS, VECS,
    WARPS, quant_blocks, strip_count)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the SWEEP of tests/test_kernels.py: (T, d, dp, bits, g)
SWEEP = [
    (16, 256, 128, 4, 32),
    (1, 512, 384, 4, 128),
    (9, 256, 256, 8, 32),
    (32, 512, 256, 2, 64),
    (200, 1024, 512, 4, 256),
    (4, 256, 64, 4, 256),
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops, ref
    from repro.core.qdq import unpack_bits
    from repro.core.kvquant import quantize_kv
    return dict(jax=jax, jnp=jnp, ops=ops, ref=ref, unpack=unpack_bits,
                quantize_kv=quantize_kv)


def _data(seed, T, d, dp):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((dp, d)).astype("float32")
    D = np.exp(rng.standard_normal(d) * 0.3).astype("float32")
    x = rng.standard_normal((T, d)).astype("float32")
    return W, D, x


def _codes_close(a, b, frac=2e-3):
    """Codes equal except ±1 at round-half ties (an f32 reassociation flips a
    tie), on at most ``frac`` of the codes."""
    a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() <= frac


@pytest.mark.parametrize("T,d,dp,bits,g", SWEEP)
def test_quantize_plain_matches_jax(jx, T, d, dp, bits, g):
    W, D, _ = _data(0, T, d, dp)
    pk_j, S_j, Z_j = jx["ops"].ttq_quantize(jx["jnp"].asarray(W),
                                            jx["jnp"].asarray(D), bits=bits,
                                            group_size=g)
    pk_t, S_t, Z_t = tops.ttq_quantize(torch.from_numpy(W),
                                       torch.from_numpy(D), bits=bits,
                                       group_size=g)
    _codes_close(jx["unpack"](pk_j, d, bits), t_unpack(pk_t, d, bits))
    # S and Z: same f32 min/max/divide; rtol 1e-5 is the JAX kernel test's
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-5)
    np.testing.assert_allclose(Z_t.numpy(), np.asarray(Z_j), rtol=1e-5,
                               atol=1e-6)


def _tie_data(seed, n, dp, d, bits, g, bf16=False):
    """W (n, dp, d) and D (n, d) f32 whose w = W∘D puts the quotient
    (w − z)/s of the plain version on half-integers in every group.

    D is a power of two per column, so w = W·D exactly.  Each group holds its
    min z and max z + R at random places, with s = R/qmax the same whether
    it is divided or multiplied by rn(1/qmax) (the plain version on the CPU
    and on the card), and its other elements sit where rn((w − z)/s) is
    k + 1/2 or one ulp beside it (``bf16=False``: s of a full mantissa,
    where rn((w − z)·rn(1/s)) can fall on the other side of the tie), or
    exactly on k + 1/2 or k (``bf16=True``: s a power of two and every W
    exact in bf16).  Inputs from numpy with a seed."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    qmax = (1 << bits) - 1
    shape = (n, dp, d // g)
    inv = f32(f32(1) / f32(qmax))
    if bf16:
        s = np.ldexp(f32(1), rng.integers(-6, 1, shape)).astype(f32)
        R = (s * f32(qmax)).astype(f32)
        j = rng.integers(1, qmax, shape) if bits < 8 else \
            rng.integers(127, 129, shape)
        z = (-j * s).astype(f32)
        t = rng.integers(0, 2 * qmax + 1, (*shape, g)) / 2
        w = (z[..., None] + t * s[..., None]).astype(f32)
    else:
        s0 = (2.0 ** rng.uniform(-6, 1, shape)).astype(f32)
        for _ in range(200):            # s on which both formulas agree
            R = (s0 * f32(qmax)).astype(f32)
            bad = (R / f32(qmax)).astype(f32) != (R * inv).astype(f32)
            if not bad.any():
                break
            s0[bad] = (2.0 ** rng.uniform(-6, 1, int(bad.sum()))).astype(f32)
        assert not bad.any()
        s = (R / f32(qmax)).astype(f32)
        ulp = np.spacing(R)
        z = (np.round(-R * rng.uniform(0.2, 0.8, shape) / ulp) * ulp
             ).astype(f32)
        t = (rng.integers(0, qmax, (*shape, g)) + 0.5).astype(f32)
        want = t + rng.integers(-1, 2, t.shape) * np.spacing(t)
        w0 = (z[..., None] + t * s[..., None]).astype(f32)
        cand = (w0.view(np.int32)[..., None] + np.arange(-8, 9, dtype=np.int32)
                ).view(f32)
        q = ((cand - z[..., None, None]).astype(f32)
             / s[..., None, None]).astype(f32)
        hit = q == want[..., None]
        w = np.where(hit.any(-1), np.take_along_axis(
            cand, hit.argmax(-1)[..., None], -1)[..., 0], w0).astype(f32)
    w[..., 0], w[..., 1] = z, (z + R).astype(f32)
    assert ((w[..., 1] - z).astype(f32) == R).all()
    perm = np.argsort(rng.random(w.shape), axis=-1)
    w = np.take_along_axis(w, perm, -1).reshape(n, dp, d)
    D = np.ldexp(f32(1), rng.integers(-1, 2, (n, d))).astype(f32)
    return (w / D[:, None, :]).astype(f32), D


def _exact_ties(W, D, bits, g):
    """Share of groups with an element whose f32 quotient (w − z)/s is
    exactly a half-integer, s = max((max − min)/qmax, 1e-12)."""
    f32 = np.float32
    wg = (W * D[:, None, :]).astype(f32).reshape(*W.shape[:-1], -1, g)
    z = wg.min(-1, keepdims=True)
    s = np.maximum(((wg.max(-1, keepdims=True) - z) / f32((1 << bits) - 1)
                    ).astype(f32), f32(1e-12))
    q = ((wg - z).astype(f32) / s).astype(f32)
    return (q - np.floor(q) == 0.5).any(-1).mean()


@pytest.mark.parametrize("bits,g", [(4, 32), (8, 32), (2, 16), (4, 128),
                                    (8, 4)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_quantize_plain_matches_jax_at_ties(jx, bits, g, bf16):
    """Ties built into the data: the plain version against the JAX kernel
    in interpret mode on groups whose quotient lands on half-integers."""
    d = max(256, 2 * g)
    W, D = _tie_data(5, 1, 16, d, bits, g, bf16=bf16)
    W, D = W[0], D[0]
    assert _exact_ties(W[None], D[None], bits, g) >= 0.5
    if bf16:
        assert np.array_equal(torch.from_numpy(W).bfloat16().float().numpy(),
                              W)
    pk_j, S_j, Z_j = jx["ops"].ttq_quantize(jx["jnp"].asarray(W),
                                            jx["jnp"].asarray(D), bits=bits,
                                            group_size=g)
    pk_t, S_t, Z_t = tops.ttq_quantize(torch.from_numpy(W),
                                       torch.from_numpy(D), bits=bits,
                                       group_size=g)
    _codes_close(jx["unpack"](pk_j, d, bits), t_unpack(pk_t, d, bits))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-5)
    np.testing.assert_allclose(Z_t.numpy(), np.asarray(Z_j), rtol=1e-5,
                               atol=1e-6)


# gemma-7b's requant families (n = 28 layers, bf16 W) and the grid each
# gets on 132 SMs: name → (d', d, blocks)
GEMMA_QUANT_BLOCKS = {"wq/wk/wv": (4096, 3072, 264), "wo": (3072, 4096, 264),
                      "wg/wu": (24576, 3072, 264), "wd": (3072, 24576, 264)}


@pytest.mark.parametrize("name", GEMMA_QUANT_BLOCKS)
def test_quant_blocks_pinned_for_gemma(name):
    dp, d, blocks = GEMMA_QUANT_BLOCKS[name]
    assert quant_blocks(28, dp, d, 2, n_sm=132) == blocks
    assert strip_count(d, 2) == d // 1024


@pytest.mark.parametrize("n,dp,d", [(1, 1, 8), (1, 37, 1028), (2, 96, 1024),
                                    (28, 4096, 3072), (3, 5, 24576),
                                    (28, 24576, 3072), (2, 3, 1088)])
@pytest.mark.parametrize("wbytes", [2, 4])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_quant_blocks_invariants(n, dp, d, wbytes, n_sm):
    """Every warp walks at least QUANT_MIN_ROWS rows unless the grid is one
    block; the grid never exceeds the blocks the card holds at once, and
    takes all of them where the rows allow; strips of 2 KB of W cover d with
    less than one strip to spare."""
    width = 32 * VECS * (16 // wbytes)
    strips = strip_count(d, wbytes)
    assert strips * width >= d > (strips - 1) * width
    b = quant_blocks(n, dp, d, wbytes, n_sm)
    rows = n * strips * dp
    assert 1 <= b <= QUANT_BLOCKS_PER_SM * n_sm
    assert b == 1 or rows // (b * WARPS) >= QUANT_MIN_ROWS
    if rows >= QUANT_BLOCKS_PER_SM * n_sm * WARPS * QUANT_MIN_ROWS:
        assert b == QUANT_BLOCKS_PER_SM * n_sm


@pytest.mark.parametrize("T,d,dp,bits,g", SWEEP)
def test_gemm_plain_matches_jax(jx, T, d, dp, bits, g):
    W, D, x = _data(1, T, d, dp)
    jnp = jx["jnp"]
    pk, S, Z = jx["ref"].ttq_quantize_ref(jnp.asarray(W), jnp.asarray(D),
                                          bits=bits, group_size=g)
    y_j = jx["ops"].ttq_gemm(jnp.asarray(x), pk, S, Z,
                             dinv=jnp.asarray(1.0 / D), bits=bits,
                             group_size=g)
    y_t = tops.ttq_gemm(torch.from_numpy(x),
                        torch.from_numpy(np.array(pk)),
                        torch.from_numpy(np.array(S)),
                        torch.from_numpy(np.array(Z)),
                        torch.from_numpy(1.0 / D), bits=bits, group_size=g)
    # f32 accumulation in another order: the JAX kernel test's tolerance
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5,
                               atol=2e-4)


# group sizes the reference's Pallas kernels take that are not a power of
# two, or below one code word, or at a d that is not whole uint4 words of
# codes (ROADMAP C2): (d, g, bits) with g and 32/bits dividing d <= 256, or
# g dividing 256 where 256 divides d
C2_CASES = [(d, g, bits) for d, g in ((96, 24), (192, 48), (200, 40),
                                      (256, 4), (512, 2))
            for bits in (2, 4, 8) if d % (32 // bits) == 0]


@pytest.mark.parametrize("d,g,bits", C2_CASES)
def test_other_group_sizes_plain_match_jax(jx, d, g, bits):
    """The plain quantize and GEMM at C2's (d, g, bits) against the JAX
    kernels (interpret mode), which take them: codes ±1 at ties, S and Z to
    rtol 1e-5, the GEMM to the f32 tolerance above; and the card's tile
    choice: none of these is the fast tile but (256, 4) and (512, 2) at
    bits 8 (g >= 32/bits, a power of two)."""
    T, dp = 3, 40
    W, D, x = _data(5, T, d, dp)
    jnp = jx["jnp"]
    pk_j, S_j, Z_j = jx["ops"].ttq_quantize(jnp.asarray(W), jnp.asarray(D),
                                            bits=bits, group_size=g)
    pk_t, S_t, Z_t = tops.ttq_quantize(torch.from_numpy(W),
                                       torch.from_numpy(D), bits=bits,
                                       group_size=g)
    _codes_close(jx["unpack"](pk_j, d, bits), t_unpack(pk_t, d, bits))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=1e-5)
    np.testing.assert_allclose(Z_t.numpy(), np.asarray(Z_j), rtol=1e-5,
                               atol=1e-6)
    y_j = jx["ops"].ttq_gemm(jnp.asarray(x), pk_j, S_j, Z_j,
                             dinv=jnp.asarray(1.0 / D), bits=bits,
                             group_size=g)
    y_t = tops.ttq_gemm(torch.from_numpy(x), torch.from_numpy(np.array(pk_j)),
                        torch.from_numpy(np.array(S_j)),
                        torch.from_numpy(np.array(Z_j)),
                        torch.from_numpy(1.0 / D), bits=bits, group_size=g)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5,
                               atol=2e-4)
    assert fast_shape(d, g, bits) == (bits == 8 and g >= 4 and d % 16 == 0
                                      and not g & (g - 1))
    assert gemm_splits(dp, d, T, bits, g, 132) == 1


# gemma-7b's decode GEMMs at int4 g32, T = 4, and the split each gets on
# 132 SMs: name → (d', d, S)
GEMMA_SPLITS = {"wq/wk/wv": (4096, 3072, 2), "wo": (3072, 4096, 2),
                "wg/wu": (24576, 3072, 1), "wd": (3072, 24576, 2)}
# test_gemm_kernel_matches_plain's shapes: (d', d, bits, g)
GEMM_KERNEL_SHAPES = [(128, 256, 4, 32), (384, 512, 8, 32), (256, 512, 2, 64),
                      (4096, 3072, 4, 32), (3072, 24576, 4, 32)]


@pytest.mark.parametrize("shape", [(dp, d, 4, 32) for dp, d, _ in
                                   GEMMA_SPLITS.values()] + GEMM_KERNEL_SHAPES)
@pytest.mark.parametrize("T", [1, 4, 37])
def test_gemm_splits_divide_k(shape, T):
    dp, d, bits, g = shape
    s = gemm_splits(dp, d, T, bits, g, n_sm=132)
    assert s in (1, 2, 4, 8)
    assert d % s == 0 and (d // s) % g == 0 and (d // s) % (4 * 32 // bits) == 0
    assert s == 1 or d // s >= 512


@pytest.mark.parametrize("name", GEMMA_SPLITS)
def test_gemm_splits_pinned_for_gemma(name):
    dp, d, s = GEMMA_SPLITS[name]
    assert gemm_splits(dp, d, 4, 4, 32, n_sm=132) == s


# gemma-7b's decode attention (4 slots, 16 kv heads) at its main-path
# capacity (256 rows) and its own context (8192), and the split C each gets
# on 132 SMs: capacity → C
GEMMA_ATTN_SPLITS = {256: 2, 8192: 8}


@pytest.mark.parametrize("capacity", GEMMA_ATTN_SPLITS)
def test_attn_splits_pinned_for_gemma(capacity):
    assert attn_splits(4, 16, capacity, n_sm=132) == GEMMA_ATTN_SPLITS[capacity]


@pytest.mark.parametrize("B,Hkv,capacity", [(1, 1, 16), (1, 2, 100),
                                            (2, 8, 256), (8, 32, 4096),
                                            (64, 16, 8192), (1, 1, 131072)])
def test_attn_splits_leave_each_rank_rows(B, Hkv, capacity):
    c = attn_splits(B, Hkv, capacity, n_sm=132)
    assert c in SPLITS
    assert c == 1 or capacity // c >= MIN_ROWS


# the GQA groups of the reference configs (and their smoke configs)
GROUPS = [1, 2, 3, 4, 5, 6, 8, 12, 16, 48]


@pytest.mark.parametrize("Dh", [16, 128, 256, 512])
@pytest.mark.parametrize("G", GROUPS)
def test_head_tile_covers_every_group(G, Dh):
    """Tiles of Gt in {1, 2, 4} heads with Gt·ceil(Dh/256) <= 4 cover the G
    heads with fewer than Gt heads masked; G in {1, 2, 4} is one tile
    where it fits (the walk of before)."""
    gt, tiles = head_tile(G, Dh)
    nch = -(-Dh // 256)
    assert gt in (1, 2, 4) and gt * nch <= 4
    assert tiles == -(-G // gt) and 0 <= gt * tiles - G < gt
    if G in (1, 2, 4) and G * nch <= 4:
        assert (gt, tiles) == (G, 1)
    if G == 3 and nch == 1:
        assert (gt, tiles) == (4, 1)


def _cache(seed, B, Hkv, S, Dh, H):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, Hkv, S, Dh)).astype("float32")
    v = rng.standard_normal((B, Hkv, S, Dh)).astype("float32")
    q = rng.standard_normal((B, H, 1, Dh)).astype("float32")
    return k, v, q


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [0, 16])
@pytest.mark.parametrize("cur", [[37, 99], [0, 5], [99, 99]],
                         ids=["mixed", "short", "full"])
def test_attention_plain_matches_jax(jx, bits, group_size, cur):
    B, Hkv, S, Dh, H = 2, 2, 100, 32, 4
    k, v, q = _cache(2, B, Hkv, S, Dh, H)
    jnp = jx["jnp"]
    pos = np.asarray(cur, np.int32)
    kq, ks = jx["quantize_kv"](jnp.asarray(k), bits=bits, group_size=group_size)
    vq, vs = jx["quantize_kv"](jnp.asarray(v), bits=bits, group_size=group_size)
    o_j = jx["ops"].kv_decode_attention(jnp.asarray(q), kq, ks, vq, vs,
                                        jnp.asarray(pos), bits=bits,
                                        group_size=group_size, bs=32)
    tq, tk = torch.from_numpy(q), lambda a: torch.from_numpy(np.array(a))
    tkq, tks = t_quantize_kv(torch.from_numpy(k), bits=bits,
                             group_size=group_size)
    tvq, tvs = t_quantize_kv(torch.from_numpy(v), bits=bits,
                             group_size=group_size)
    # the port's KV codes are the reference's codes
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(kq))
    np.testing.assert_allclose(tks.numpy(), np.asarray(ks), rtol=1e-6)
    o_t = tops.kv_decode_attention(tq, tk(kq), tk(ks), tk(vq), tk(vs),
                                   torch.from_numpy(pos), bits=bits,
                                   group_size=group_size)
    # f32 softmax over the same dequantized values: the JAX test's 1e-5
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("G", [3, 12, 48])
@pytest.mark.parametrize("bits", [8, 4])
def test_attention_plain_matches_jax_any_group(jx, bits, G):
    """The plain version at the new configs' groups (minitron 3, starcoder2
    12, granite 48) against the Pallas kernel in interpret mode: the JAX
    test's 1e-5, soft cap on."""
    B, Hkv, S, Dh = 2, 1, 40, 16
    k, v, q = _cache(7, B, Hkv, S, Dh, G * Hkv)
    jnp = jx["jnp"]
    pos = np.asarray([17, 39], np.int32)
    kq, ks = jx["quantize_kv"](jnp.asarray(k), bits=bits)
    vq, vs = jx["quantize_kv"](jnp.asarray(v), bits=bits)
    o_j = jx["ops"].kv_decode_attention(jnp.asarray(q), kq, ks, vq, vs,
                                        jnp.asarray(pos), bits=bits,
                                        soft_cap=30.0, bs=8)
    tk = lambda a: torch.from_numpy(np.array(a))
    o_t = tops.kv_decode_attention(torch.from_numpy(q), tk(kq), tk(ks),
                                   tk(vq), tk(vs), torch.from_numpy(pos),
                                   bits=bits, soft_cap=30.0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)


def test_attention_plain_soft_cap_matches_jax(jx):
    B, Hkv, S, Dh, H = 1, 2, 48, 16, 4
    k, v, q = _cache(3, B, Hkv, S, Dh, H)
    jnp = jx["jnp"]
    kq, ks = jx["quantize_kv"](jnp.asarray(k))
    vq, vs = jx["quantize_kv"](jnp.asarray(v))
    pos = np.asarray([20], np.int32)
    o_j = jx["ops"].kv_decode_attention(jnp.asarray(q), kq, ks, vq, vs,
                                        jnp.asarray(pos), soft_cap=30.0,
                                        bs=64)
    tk = lambda a: torch.from_numpy(np.array(a))
    o_t = tops.kv_decode_attention(torch.from_numpy(q), tk(kq), tk(ks),
                                   tk(vq), tk(vs), torch.from_numpy(pos),
                                   soft_cap=30.0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- on a card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    kbuild.lib()
    print(kbuild.build_log)
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (2, 128, 256, 4, 32), (3, 64, 512, 8, 32), (1, 96, 1024, 2, 64),
    (2, 128, 256, 4, 256), (1, 4096, 3072, 4, 32), (1, 3072, 24576, 4, 32),
    (1, 24576, 3072, 8, 32), (28, 4096, 3072, 4, 32)])
def test_quantize_kernel_matches_plain(cuda, case):
    n, dp, d, bits, g = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    W = torch.randn((n, dp, d), generator=gen, device=cuda).to(torch.bfloat16)
    D = torch.exp(0.3 * torch.randn((n, d), generator=gen, device=cuda))
    pk, S, Z = tops.ttq_quantize(W, D, bits=bits, group_size=g)
    pk_r, S_r, Z_r = tref.ttq_quantize_ref(W, D, bits=bits, group_size=g)
    torch.cuda.synchronize()
    _codes_close(t_unpack(pk, d, bits).cpu(), t_unpack(pk_r, d, bits).cpu())
    torch.testing.assert_close(S, S_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(Z, Z_r, rtol=1e-5, atol=1e-6)


# every (bits, g) the wrapper takes: g a power of two in [32/bits, 512]
QUANT_BITS_G = [(bits, g) for bits in (2, 4, 8)
                for g in (4, 8, 16, 32, 64, 128, 256, 512) if g >= 32 // bits]


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("bits,g", QUANT_BITS_G)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernel_bitwise_at_ties(cuda, bits, g, dtype):
    """Tie-built inputs (``_tie_data``), d' = 37 (a ragged batch of rows),
    d = 1024 + g (a ragged strip where g < 256; at bits 8 g 4 in bf16 a row
    of 8-byte multiples): packed, S and Z bit for bit the plain version's."""
    d = 1024 + g
    W, D = _tie_data(7, 2, 37, d, bits, g, bf16=dtype == torch.bfloat16)
    W = torch.from_numpy(W).to(cuda, dtype)
    D = torch.from_numpy(D).to(cuda)
    out = tops.ttq_quantize(W, D, bits=bits, group_size=g)
    ref = tref.ttq_quantize_ref(W, D, bits=bits, group_size=g)
    torch.cuda.synchronize()
    for x, y in zip(out, ref):
        assert _bitwise(x, y)


@pytest.mark.gpu
def test_quantize_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    W = torch.randn((4, 4096, 3072), generator=gen, device=cuda).bfloat16()
    D = torch.exp(0.3 * torch.randn((4, 3072), generator=gen, device=cuda))
    a = tops.ttq_quantize(W, D, bits=4, group_size=32)
    b = tops.ttq_quantize(W, D, bits=4, group_size=32)
    torch.cuda.synchronize()
    assert all(_bitwise(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 3, 4, 16, 37])
@pytest.mark.parametrize("shape", [(128, 256, 4, 32), (384, 512, 8, 32),
                                   (256, 512, 2, 64), (4096, 3072, 4, 32),
                                   (3072, 24576, 4, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_kernel_matches_plain(cuda, T, shape, dtype):
    dp, d, bits, g = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    W = torch.randn((dp, d), generator=gen, device=cuda)
    D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=cuda))
    x = torch.randn((T, d), generator=gen, device=cuda).to(dtype)
    pk, S, Z = tref.ttq_quantize_ref(W, D, bits=bits, group_size=g)
    y = tops.ttq_gemm(x, pk, S, Z, 1.0 / D, bits=bits, group_size=g)
    y_r = tref.ttq_gemm_ref(x, pk, S, Z, bits=bits, group_size=g,
                            dinv=1.0 / D).to(dtype)
    torch.cuda.synchronize()
    # f32 sums in another order; the JAX kernel test's tolerance, scaled by
    # sqrt(d/256) for the longer sums, plus one bf16 rounding of the output
    scale = (d / 256) ** 0.5
    tol = dict(rtol=2e-5 * scale, atol=2e-4 * scale)
    if dtype == torch.bfloat16:
        tol = dict(rtol=1e-2, atol=1e-2 * scale)
    torch.testing.assert_close(y.float(), y_r.float(), **tol)


def _gemm_case(dev, dp, d, bits, g, T, dtype, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((dp, d), generator=gen, device=dev)
    D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=dev))
    x = torch.randn((T, d), generator=gen, device=dev).to(dtype)
    pk, S, Z = tref.ttq_quantize_ref(W, D, bits=bits, group_size=g)
    return x, pk, S, Z, 1.0 / D


def _gemm_tol(d, dtype):
    """test_gemm_kernel_matches_plain's tolerance."""
    scale = (d / 256) ** 0.5
    if dtype == torch.bfloat16:
        return dict(rtol=1e-2, atol=1e-2 * scale)
    return dict(rtol=2e-5 * scale, atol=2e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3072, 24576), (4096, 3072)],
                         ids=["wd", "wq"])
def test_gemm_kernel_is_deterministic(cuda, shape):
    """The cluster's partial sums are added in rank order: two calls on the
    same inputs are bitwise equal."""
    dp, d = shape
    x, pk, S, Z, dinv = _gemm_case(cuda, dp, d, 4, 32, 4, torch.bfloat16)
    assert gemm_splits(dp, d, 4, 4, 32, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    y1 = tops.ttq_gemm(x, pk, S, Z, dinv, bits=4, group_size=32)
    y2 = tops.ttq_gemm(x, pk, S, Z, dinv, bits=4, group_size=32)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (4100, 3072, 4, 32, 1, True), (4100, 3072, 4, 32, 5, True),
    (4100, 3072, 4, 32, 37, True), (256, 4096, 8, 32, 4, True),
    (256, 4096, 2, 64, 4, True), (256, 4096, 2, 32, 5, True),
    (256, 4096, 4, 8, 4, True), (4100, 3072, 4, 32, 4, False),
    (256, 4096, 8, 32, 3, False)],
    ids=["ragged-T1", "ragged-T5", "ragged-T37", "bits8-split",
         "bits2-split", "bits2-g32-split", "g8-split", "no-dinv",
         "bits8-no-dinv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_kernel_split_cases(cuda, case, dtype):
    """Ragged row tiles (d' not a multiple of 32), odd T, bits 2 and 8 under
    a split, one to four groups per uint4 of codes, and no D⁻¹: the kernel
    against its plain version."""
    dp, d, bits, g, T, with_dinv = case
    x, pk, S, Z, dinv = _gemm_case(cuda, dp, d, bits, g, T, dtype)
    if not with_dinv:
        dinv = None
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert dp % 32 or gemm_splits(dp, d, T, bits, g, n_sm) > 1
    y = tops.ttq_gemm(x, pk, S, Z, dinv, bits=bits, group_size=g)
    y_r = tref.ttq_gemm_ref(x, pk, S, Z, bits=bits, group_size=g,
                            dinv=dinv).to(dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_r.float(), **_gemm_tol(d, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 2, 4, 8, 3, 16])
def test_gemm_kernel_every_split(cuda, split):
    """The C entry at each split the kernel takes, against the plain
    version; a split it does not take (3, 16, or a slice that is not whole
    groups) is refused with cudaErrorInvalidValue (1), never changed."""
    dp, d, T = 96, 4096, 4
    x, pk, S, Z, dinv = _gemm_case(cuda, dp, d, 4, 128, T, torch.float32)
    y = torch.empty((T, dp), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(s, g=128):
        return kbuild.lib().ttq_gemm_launch(
            x.data_ptr(), 0, pk.data_ptr(), S.data_ptr(), Z.data_ptr(),
            dinv.data_ptr(), y.data_ptr(), T, dp, d, 4, g, s, stream)
    if split not in (1, 2, 4, 8):
        assert launch(split) == 1
        return
    assert launch(split) == 0
    y_r = tref.ttq_gemm_ref(x, pk, S, Z, bits=4, group_size=128, dinv=dinv)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_r, **_gemm_tol(d, torch.float32))
    if split == 8:                  # 4096 / 8 = 512 is not whole groups of 1024
        assert launch(8, g=1024) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("geom", [(2, 2, 4, 100, 32, 16), (4, 16, 16, 256, 256, 0),
                                  (2, 2, 4, 64, 16, 0)])
def test_attention_kernel_matches_plain(cuda, bits, geom):
    B, Hkv, H, S, Dh, gsz = geom
    gen = torch.Generator(device=cuda).manual_seed(2)
    k = torch.randn((B, Hkv, S, Dh), generator=gen, device=cuda)
    v = torch.randn((B, Hkv, S, Dh), generator=gen, device=cuda)
    q = torch.randn((B, H, 1, Dh), generator=gen, device=cuda).to(torch.bfloat16)
    kq, ks = t_quantize_kv(k, bits=bits, group_size=gsz)
    vq, vs = t_quantize_kv(v, bits=bits, group_size=gsz)
    for cur in ([0] * B, [S - 1] * B, list(range(3, 3 + 7 * B, 7))):
        pos = torch.tensor(cur, dtype=torch.int32, device=cuda)
        o = tops.kv_decode_attention(q.float(), kq, ks, vq, vs, pos,
                                     bits=bits, group_size=gsz, soft_cap=0.0)
        o_r = tref.kv_attn_ref(q.float(), kq, ks, vq, vs, pos, bits=bits,
                               group_size=gsz)
        torch.cuda.synchronize()
        torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
    o = tops.kv_decode_attention(q, kq, ks, vq, vs, pos, bits=bits,
                                 group_size=gsz, soft_cap=30.0)
    o_r = tref.kv_attn_ref(q, kq, ks, vq, vs, pos, bits=bits, group_size=gsz,
                           soft_cap=30.0)
    torch.testing.assert_close(o.float(), o_r.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("geom", [(2, 1, 16, 2048, 256), (2, 8, 64, 256, 128)],
                         ids=["rolling-G16-Dh256", "G8-Dh128"])
def test_attention_kernel_on_rolling_slab(cuda, bits, geom):
    """The dense kernel at the hybrid and vlm families' decode shapes:
    recurrentgemma-9b's rolling 2,048-row window slab (one kv head, G = 16,
    Dh 256) read at cur_pos = W − 1 (wrapped: every row live) and below,
    and chameleon-34b's G = 8 at Dh 128; within 1e-5 of the plain version
    on f32 q, one bf16 rounding on bf16 q."""
    B, Hkv, H, S, Dh = geom
    gen = torch.Generator(device=cuda).manual_seed(6)
    k = torch.randn((B, Hkv, S, Dh), generator=gen, device=cuda)
    v = torch.randn((B, Hkv, S, Dh), generator=gen, device=cuda)
    q = torch.randn((B, H, 1, Dh), generator=gen, device=cuda)
    kq, ks = t_quantize_kv(k, bits=bits)
    vq, vs = t_quantize_kv(v, bits=bits)
    for cur in ([S - 1] * B, [S - 1, S // 2 + 5], [0, 17]):
        pos = torch.tensor(cur, dtype=torch.int32, device=cuda)
        o = tops.kv_decode_attention(q, kq, ks, vq, vs, pos, bits=bits)
        o_r = tref.kv_attn_ref(q, kq, ks, vq, vs, pos, bits=bits)
        qb = q.to(torch.bfloat16)
        ob = tops.kv_decode_attention(qb, kq, ks, vq, vs, pos, bits=bits)
        ob_r = tref.kv_attn_ref(qb, kq, ks, vq, vs, pos, bits=bits)
        torch.cuda.synchronize()
        torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ob.float(), ob_r.float(), rtol=2 ** -7,
                                   atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("geom", [(2, 2, 4, 16, 4, 9, 32, 16),
                                  (4, 16, 16, 16, 16, 65, 256, 0),
                                  (3, 2, 8, 8, 8, 30, 64, 0),
                                  (1, 2, 4, 16, 4, 9, 512, 0)])
def test_paged_attention_kernel_matches_plain(cuda, bits, geom):
    """The paged kernel over a scrambled block table: within 1e-5 of its
    plain version, and bit for bit the dense kernel on the gathered cache
    (both kernels walk the same rows in the same order)."""
    B, Hkv, H, bs, nblk, NB, Dh, gsz = geom
    gen = torch.Generator(device=cuda).manual_seed(3)
    pk = torch.randn((NB, Hkv, bs, Dh), generator=gen, device=cuda)
    pv = torch.randn((NB, Hkv, bs, Dh), generator=gen, device=cuda)
    q = torch.randn((B, H, 1, Dh), generator=gen, device=cuda)
    kq, ks = t_quantize_kv(pk, bits=bits, group_size=gsz)
    vq, vs = t_quantize_kv(pv, bits=bits, group_size=gsz)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(4))
    bt = (perm[:B * nblk] + 1).reshape(B, nblk).to(torch.int32).to(cuda)
    bt[0, nblk // 2:] = 0                      # the sink past slot 0's rows
    gathered = [tref.gather_paged_kv(t, bt) for t in (kq, ks, vq, vs)]
    S = nblk * bs
    for cur in ([0] * B, [S - 1] * B, list(range(3, 3 + 7 * B, 7))):
        cur[0] = min(cur[0], nblk // 2 * bs - 1)
        pos = torch.tensor(cur, dtype=torch.int32, device=cuda)
        for cap in (0.0, 30.0):
            o = tops.kv_paged_decode_attention(q, kq, ks, vq, vs, bt, pos,
                                               bits=bits, group_size=gsz,
                                               soft_cap=cap)
            o_r = tref.kv_paged_attn_ref(q, kq, ks, vq, vs, bt, pos,
                                         bits=bits, group_size=gsz,
                                         soft_cap=cap)
            o_d = tops.kv_decode_attention(q, *gathered, pos, bits=bits,
                                           group_size=gsz, soft_cap=cap)
            torch.cuda.synchronize()
            torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
            assert torch.equal(o, o_d)


def _paged_case(dev, bits, B=3, Hkv=2, H=4, bs=16, nblk=12, Dh=64, gsz=16,
                seed=5):
    """A scrambled pool, its block table and the gathered dense cache."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    NB = B * nblk + 1
    pk = torch.randn((NB, Hkv, bs, Dh), generator=gen, device=dev)
    pv = torch.randn((NB, Hkv, bs, Dh), generator=gen, device=dev)
    q = torch.randn((B, H, 1, Dh), generator=gen, device=dev)
    kq, ks = t_quantize_kv(pk, bits=bits, group_size=gsz)
    vq, vs = t_quantize_kv(pv, bits=bits, group_size=gsz)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(seed))
    bt = (perm + 1).reshape(B, nblk).to(torch.int32).to(dev)
    gathered = [tref.gather_paged_kv(t, bt) for t in (kq, ks, vq, vs)]
    return q, (kq, ks, vq, vs), bt, gathered


@pytest.mark.gpu
@pytest.mark.parametrize("gsz", [0, 16], ids=["row-scale", "group-16"])
@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["no-cap", "soft-cap"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("bits", [8, 4])
def test_attention_kernels_every_split(cuda, bits, splits, cap, gsz):
    """Both kernels at every split C, with one scale per row or per group
    of 16: within 1e-5 of the plain version, and the paged kernel bit for
    bit the dense one on the gathered cache; one slot whose slice
    boundaries fall inside pool blocks (70 rows in slices of 35, 18 or 9
    at C = 2, 4, 8), one shorter than C."""
    q, pool, bt, gathered = _paged_case(cuda, bits, gsz=gsz)
    bs, S = pool[0].shape[2], bt.shape[1] * pool[0].shape[2]
    cur = [69, 5, S - 1]
    assert splits == 1 or -(-(cur[0] + 1) // splits) % bs
    pos = torch.tensor(cur, dtype=torch.int32, device=cuda)
    kw = dict(bits=bits, group_size=gsz, soft_cap=cap)
    o_d = _launch(q, *gathered, None, pos, splits, **kw)
    o_p = _launch(q, *pool, bt, pos, splits, **kw)
    o_r = tref.kv_attn_ref(q, *gathered, pos, bits=bits, group_size=gsz,
                           soft_cap=cap)
    torch.cuda.synchronize()
    torch.testing.assert_close(o_d, o_r, rtol=1e-5, atol=1e-5)
    assert torch.equal(o_p, o_d)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [12, 6, 1])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_paged_attention_odd_block_sizes(cuda, bs, splits):
    """Block sizes 12, 6 and 1 (G = 1, batches of 8 rows): a batch spans
    pool blocks and slices end inside them (at 1, every row is a block of
    its own); still within 1e-5 of the plain version and bit for bit the
    dense kernel."""
    q, pool, bt, gathered = _paged_case(cuda, 8, H=2, bs=bs, nblk=16,
                                        gsz=0)
    S = 16 * bs
    pos = torch.tensor([S // 2 + 3, 1, S - 1], dtype=torch.int32,
                       device=cuda)
    o_d = _launch(q, *gathered, None, pos, splits)
    o_p = _launch(q, *pool, bt, pos, splits)
    o_r = tref.kv_attn_ref(q, *gathered, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(o_d, o_r, rtol=1e-5, atol=1e-5)
    assert torch.equal(o_p, o_d)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_attention_kernels_are_deterministic(cuda, bits):
    """gemma-7b's main-path geometry at the split the rule picks (C > 1):
    the ranks are merged in rank order, so two calls are bitwise equal."""
    q, pool, bt, gathered = _paged_case(cuda, bits, B=4, Hkv=16, H=16,
                                        nblk=16, Dh=256, gsz=0)
    assert attn_splits(4, 16, 256, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    pos = torch.tensor([73, 63, 57, 45], dtype=torch.int32, device=cuda)
    qb = q.to(torch.bfloat16)
    for run in (lambda: ttq_decode_attention(qb, *gathered, pos, bits=bits),
                lambda: ttq_paged_decode_attention(qb, *pool, bt, pos,
                                                   bits=bits)):
        o1, o2 = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)


@pytest.mark.gpu
@pytest.mark.parametrize("gsz", [0, 16], ids=["row-scale", "group-16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_attention_empty_ranks_add_nothing(cuda, bits, gsz):
    """cur_pos = 0 at C = 8: one row, seven ranks with none.  The empty
    ranks add exactly nothing: the result is bitwise the C = 1 one, and
    within 1e-5 of the plain version."""
    q, pool, bt, gathered = _paged_case(cuda, bits, gsz=gsz)
    pos = torch.zeros((3,), dtype=torch.int32, device=cuda)
    kw = dict(bits=bits, group_size=gsz)
    o8 = _launch(q, *gathered, None, pos, 8, **kw)
    o1 = _launch(q, *gathered, None, pos, 1, **kw)
    p8 = _launch(q, *pool, bt, pos, 8, **kw)
    o_r = tref.kv_attn_ref(q, *gathered, pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o8, o_r, rtol=1e-5, atol=1e-5)
    assert torch.equal(o8, o1)
    assert torch.equal(p8, o8)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_q_dtype_folds_scale_and_cast(cuda, dtype, paged):
    """q in bf16 or f32 is read as it is, scaled in f32 inside the kernel,
    and the output comes back in q's dtype: bitwise the f32 prescale, the
    kernel at scale 1 and a cast, and (f32) within 1e-5 or (bf16) one bf16
    rounding of the plain version."""
    q, pool, bt, gathered = _paged_case(cuda, 8)
    q = q.to(dtype)
    sc = q.shape[-1] ** -0.5
    pos = torch.tensor([100, 5, 191], dtype=torch.int32, device=cuda)
    cache, table = (pool, bt) if paged else (gathered, None)
    run = lambda x, **kw: _launch(  # noqa: E731
        x, *cache, table, pos, 4, bits=8, group_size=16, **kw)
    o = run(q)
    o_pre = run(q.float() * sc, scale=1.0).to(dtype)
    o_r = tref.kv_attn_ref(q, *gathered, pos, bits=8, group_size=16)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert torch.equal(o, o_pre)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(o.float(), o_r.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["no-cap", "soft-cap"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("Dh", [128, 256])
@pytest.mark.parametrize("G", GROUPS)
def test_attention_kernels_any_group(cuda, G, Dh, bits, cap):
    """Both kernels at every GQA group of the reference configs, over 2 kv
    heads, at the split the rule picks: within 1e-5 of the plain version
    on f32 q (bf16 q: one more rounding), the paged kernel bit for bit the
    dense one on the gathered cache, two calls bitwise equal; the slots end
    mid-block, at the first row and at the last."""
    q, pool, bt, gathered = _paged_case(cuda, bits, Hkv=2, H=2 * G, nblk=8,
                                        Dh=Dh, gsz=0, seed=G)
    pos = torch.tensor([70, 0, 127], dtype=torch.int32, device=cuda)
    kw = dict(bits=bits, soft_cap=cap)
    for x, tol in ((q, dict(rtol=1e-5, atol=1e-5)),
                   (q.to(torch.bfloat16), dict(rtol=2 ** -7, atol=1e-5))):
        o_d = ttq_decode_attention(x, *gathered, pos, **kw)
        o_p = ttq_paged_decode_attention(x, *pool, bt, pos, **kw)
        o_r = tref.kv_attn_ref(x, *gathered, pos, **kw)
        torch.cuda.synchronize()
        assert o_d.shape == x.shape and o_d.dtype == x.dtype
        torch.testing.assert_close(o_d.float(), o_r.float(), **tol)
        assert torch.equal(o_p, o_d)
        assert torch.equal(ttq_decode_attention(x, *gathered, pos, **kw), o_d)
        assert torch.equal(ttq_paged_decode_attention(x, *pool, bt, pos,
                                                      **kw), o_p)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [12, 6, 1])
@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("G", [3, 5, 12, 48])
def test_paged_attention_any_group_odd_blocks(cuda, G, splits, bs):
    """Head tiles with block sizes 12, 6 and 1 at C = 1 and 8: within 1e-5
    of the plain version and bit for bit the dense kernel."""
    q, pool, bt, gathered = _paged_case(cuda, 8, Hkv=2, H=2 * G, bs=bs,
                                        nblk=16, Dh=128, gsz=0)
    S = 16 * bs
    pos = torch.tensor([S // 2 + 3, 1, S - 1], dtype=torch.int32,
                       device=cuda)
    o_d = _launch(q, *gathered, None, pos, splits)
    o_p = _launch(q, *pool, bt, pos, splits)
    o_r = tref.kv_attn_ref(q, *gathered, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(o_d, o_r, rtol=1e-5, atol=1e-5)
    assert torch.equal(o_p, o_d)


@pytest.mark.gpu
@pytest.mark.parametrize("gsz", [0, 16], ids=["row-scale", "group-16"])
@pytest.mark.parametrize("G", [3, 5, 6])
def test_attention_any_group_two_chunks(cuda, G, gsz):
    """Dh 512 (two head-dim chunks per lane, tiles of 2 heads) at groups
    past 2, with one scale per row and per group of 16: within 1e-5 of the
    plain version, paged bit for bit dense."""
    q, pool, bt, gathered = _paged_case(cuda, 4, Hkv=2, H=2 * G, nblk=8,
                                        Dh=512, gsz=gsz)
    pos = torch.tensor([70, 9, 127], dtype=torch.int32, device=cuda)
    kw = dict(bits=4, group_size=gsz, soft_cap=30.0)
    o_d = ttq_decode_attention(q, *gathered, pos, **kw)
    o_p = ttq_paged_decode_attention(q, *pool, bt, pos, **kw)
    o_r = tref.kv_attn_ref(q, *gathered, pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o_d, o_r, rtol=1e-5, atol=1e-5)
    assert torch.equal(o_p, o_d)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [0, 3, 16])
def test_attention_unsupported_split_refused(cuda, splits):
    """A split the kernels do not take is refused by their C entry points
    (cudaErrorInvalidValue), never changed, and the launch raises."""
    q, pool, bt, gathered = _paged_case(cuda, 8)
    pos = torch.tensor([100, 5, 191], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        _launch(q, *gathered, None, pos, splits, group_size=16)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        _launch(q, *pool, bt, pos, splits, group_size=16)


# ------------------------------------------- expert-batched GEMM on a card

def _experts_case(dev, E, T, dp, d, bits, g, shared, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((E, dp, d), generator=gen, device=dev)
    D = torch.exp(0.3 * torch.randn((E, d), generator=gen, device=dev))
    x = torch.randn((T, d) if shared else (E, T, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    pk, S, Z = tref.ttq_quantize_ref(W, D, bits=bits, group_size=g)
    return x, pk, S, Z, 1.0 / D


def _launch_2d(x2, pk, S, Z, dinv, bits, g, split):
    """One 2-D ``ttq_gemm_launch`` at a given split (the wrapper would pick
    its own)."""
    T, d = x2.shape
    dp = pk.shape[0]
    y = torch.empty((T, dp), dtype=x2.dtype, device=x2.device)
    err = kbuild.lib().ttq_gemm_launch(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), pk.data_ptr(),
        S.data_ptr(), Z.data_ptr(), dinv.data_ptr(), y.data_ptr(), T, dp, d,
        bits, g, split, torch.cuda.current_stream(x2.device).cuda_stream)
    assert err == 0
    return y


def _experts_launch_counted(x, pk, S, Z, dinv, bits, g):
    """One ``ttq_gemm_experts`` call: (y, launches counted, tiles counted)."""
    before = kbuild.LAUNCHES["ttq_gemm_experts"]
    tiles = dict(kbuild.EXPERTS_TILES)
    y = ttq_gemm_experts(x, pk, S, Z, dinv, bits=bits, group_size=g)
    return (y, kbuild.LAUNCHES["ttq_gemm_experts"] - before,
            {k: v - tiles[k] for k, v in kbuild.EXPERTS_TILES.items()})


def _e_independent(x, pk, S, Z, dinv, bits, g, y, shared):
    """Expert e of an E-launch (``y``) equals, bit for bit, a launch over
    expert e alone and over the half of the experts that holds it."""
    E = pk.shape[0]
    half = max(E // 2, 1)
    for e in sorted({0, E // 2, E - 1}):
        for lo in (e, e // half * half):
            hi = lo + (1 if lo == e else half)
            xs = x if shared else x[lo:hi]
            ys = ttq_gemm_experts(xs, pk[lo:hi], S[lo:hi], Z[lo:hi],
                                  None if dinv is None else dinv[lo:hi],
                                  bits=bits, group_size=g)
            assert torch.equal(y[e], ys[e - lo]), (e, lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False], ids=["shared-x", "per-x"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("T", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("E", [1, 4, 16, 64])
def test_gemm_experts_is_e_launches(cuda, E, T, bits, shared):
    """One batched launch over E experts (x shared by every expert, or one
    per expert), bf16 x, counts one launch and one tile, and is within the
    GEMM's tolerance of the plain version.  On the batched tile (bits 2 and
    8) it is bit for bit E 2-D launches at the split the batched one takes;
    d' = 96 (three row tiles) and d = 2048 make the split vary with E and T
    (4 at E = 1, T <= 8 on 132 SMs; 1 at E = 64).  On the mma tile (int4)
    expert e is bit for bit the same whether the launch holds E experts,
    expert e alone or half of them, and two calls are bitwise equal."""
    dp, d, g = 96, 2048, 32
    x, pk, S, Z, dinv = _experts_case(cuda, E, T, dp, d, bits, g, shared)
    tile = "mma" if bits == 4 else "batched"
    y, n, tiles = _experts_launch_counted(x, pk, S, Z, dinv, bits, g)
    assert n == 1 and tiles == {"mma": int(tile == "mma"),
                                "batched": int(tile == "batched")}
    assert y.shape == (E, T, dp) and y.dtype == torch.bfloat16
    if tile == "batched":
        n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        split = gemm_splits(dp, d, T, bits, g, n_sm, E)
        for e in range(E):
            x2 = x if shared else x[e]
            assert torch.equal(y[e], _launch_2d(
                x2, pk[e], S[e], Z[e], dinv[e], bits, g, split)), e
    else:
        _e_independent(x, pk, S, Z, dinv, bits, g, y, shared)
        assert torch.equal(y, ttq_gemm_experts(x, pk, S, Z, dinv, bits=bits,
                                               group_size=g))
    y_r = tref.ttq_gemm_experts_ref(x, pk, S, Z, bits=bits, group_size=g,
                                    dinv=dinv).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_r.float(),
                               **_gemm_tol(d, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1408, 2048, 64, True),
                                   (2048, 1408, 64, False),
                                   (8192, 5120, 16, True),
                                   (5120, 8192, 16, False)],
                         ids=["deepseek-wg", "deepseek-wd", "llama4-wg",
                              "llama4-wd"])
def test_gemm_experts_at_the_configs_shapes(cuda, shape, dtype):
    """The expert shapes of both configs at T = 4 (deepseek's wd at d =
    1408, which the reference's Pallas tile does not take), x shared for
    wg/wu and one per expert for wd.  f32 x takes the batched tile at split
    1, within the f32 tolerance of the plain version; bf16 x (the served
    path) the mma tile, within the bf16 tolerance, with expert e bit for
    bit independent of its launch companions."""
    dp, d, E, shared = shape
    x, pk, S, Z, dinv = _experts_case(cuda, E, 4, dp, d, 4, 32, shared)
    x = x.to(dtype)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert gemm_splits(dp, d, 4, 4, 32, n_sm, E) == 1
    y, n, tiles = _experts_launch_counted(x, pk, S, Z, dinv, 4, 32)
    assert n == 1 and tiles["mma" if dtype == torch.bfloat16 else
                            "batched"] == 1
    y_r = tref.ttq_gemm_experts_ref(x, pk, S, Z, bits=4, group_size=32,
                                    dinv=dinv)
    if dtype == torch.bfloat16:
        _e_independent(x, pk, S, Z, dinv, 4, 32, y, shared)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_r.to(dtype).float(),
                               **_gemm_tol(d, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (3, 96, 2048, 64, 4, True), (3, 96, 2048, 128, 4, True),
    (3, 96, 2048, 256, 5, False), (2, 64, 1024, 1024, 4, True),
    (3, 100, 160, 32, 3, False), (2, 72, 96, 32, 12, True),
    (2, 130, 1408, 32, 17, False), (2, 40, 512, 32, 37, True),
    (5, 64, 2048, 32, 16, True), (1, 24, 256, 64, 9, False)],
    ids=["g64", "g128", "g256-T5", "g1024", "d160-ragged", "d96-T12",
         "ragged-T17", "T37", "T16", "E1-T9"])
@pytest.mark.parametrize("with_dinv", [True, False], ids=["dinv", "no-dinv"])
def test_gemm_experts_mma_cases(cuda, case, with_dinv):
    """The mma tile off the served shapes: g 64 to 1024 (groups across
    stages), d not a whole number of 128-k stages (a last stage of one to
    three 32-k units, S and Z copied 1 or 2 floats at a time), row counts
    that leave a ragged item, T past 16 (token chunks), and no D⁻¹: within
    the bf16 tolerance of the plain version, E-independent, repeatable."""
    E, dp, d, g, T, shared = case
    x, pk, S, Z, dinv = _experts_case(cuda, E, T, dp, d, 4, g, shared)
    if not with_dinv:
        dinv = None
    y, n, tiles = _experts_launch_counted(x, pk, S, Z, dinv, 4, g)
    assert n == 1 and tiles["mma"] == 1
    _e_independent(x, pk, S, Z, dinv, 4, g, y, shared)
    assert torch.equal(y, ttq_gemm_experts(x, pk, S, Z, dinv, bits=4,
                                           group_size=g))
    y_r = tref.ttq_gemm_experts_ref(x, pk, S, Z, bits=4, group_size=g,
                                    dinv=dinv).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_r.float(),
                               **_gemm_tol(d, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,g,bits", C2_CASES)
def test_quantize_kernel_other_group_sizes(cuda, d, g, bits, dtype):
    """C2: the quantize kernel at the reference's other group sizes (the
    generic walk, or the fast one where g allows): packed, S and Z bit for
    bit the plain version's, on a (2, 37, d) stack."""
    gen = torch.Generator(device=cuda).manual_seed(d + g + bits)
    W = torch.randn((2, 37, d), generator=gen, device=cuda).to(dtype)
    D = torch.exp(0.3 * torch.randn((2, d), generator=gen, device=cuda))
    kbuild.reset_launches()
    out = tops.ttq_quantize(W, D, bits=bits, group_size=g)
    assert kbuild.LAUNCHES["ttq_quantize"] == 1
    ref = tref.ttq_quantize_ref(W, D, bits=bits, group_size=g)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert _bitwise(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 5, 16])
@pytest.mark.parametrize("d,g,bits", C2_CASES)
def test_gemm_kernel_other_group_sizes(cuda, d, g, bits, T):
    """C2: the GEMM at the reference's other group sizes (the generic tile,
    split 1), 2-D and batched over 3 experts, within the GEMM's bf16
    tolerance of the plain version."""
    dp = 72
    x, pk, S, Z, dinv = _gemm_case(cuda, dp, d, bits, g, T, torch.bfloat16)
    y = tops.ttq_gemm(x, pk, S, Z, dinv, bits=bits, group_size=g)
    y_r = tref.ttq_gemm_ref(x, pk, S, Z, bits=bits, group_size=g,
                            dinv=dinv).to(torch.bfloat16)
    xe, pke, Se, Ze, dve = _experts_case(cuda, 3, T, dp, d, bits, g, False)
    ye = ttq_gemm_experts(xe, pke, Se, Ze, dve, bits=bits, group_size=g)
    ye_r = tref.ttq_gemm_experts_ref(xe, pke, Se, Ze, bits=bits, group_size=g,
                                     dinv=dve).to(torch.bfloat16)
    torch.cuda.synchronize()
    tol = _gemm_tol(d, torch.bfloat16)
    torch.testing.assert_close(y.float(), y_r.float(), **tol)
    torch.testing.assert_close(ye.float(), ye_r.float(), **tol)
