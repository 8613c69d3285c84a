#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit; builds the CUDA kernels of
   ``src/repro_torch/kernels/csrc/`` with nvcc (sm_90a) into ``build/``.
2. Each kernel against its plain PyTorch version at gemma-7b's main-path
   shapes, with its median time, its bound, the plain version's time and
   (for the GEMM) one PyTorch call of the same function.
3. The main path: ``TTQEngine`` on full-width gemma-7b (random weights from
   a seed) serves 8 requests through the three kernels; every kernel must
   have launched, and decode must not sync the host inside a block.  Then
   one kernel-path ``decode_step`` on 1, 7 and 28 layers is held against
   the plain-version one and against a kernel-free witness, with every
   kernel call of the 28-layer step held against its plain version.
4. A ``{"kernels": [...]}`` line, the card line, and ``{"ok": true, ...}``.

Any failed check exits non-zero before the last line is printed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
SEED = 0
N_REQUESTS, MAX_NEW = 8, 32
GEMM_SHAPES = {                # name: (d', d, launches per layer)
    "wq/wk/wv": (4096, 3072, 3), "wo": (3072, 4096, 1),
    "wg/wu": (24576, 3072, 2), "wd": (3072, 24576, 1)}
# kernel vs plain decode_step logits (relative L2), on the first L layers
# for L in DEPTHS.  Readings on an H100 (see PERF.md): kernels 3.14e-3 on 1
# layer and 1.62e-2 on 28; the plain path with its GEMM sums split in two
# halves (no kernel) 7.1e-4 and 1.57e-2; the plain path run twice, 0.  Past
# a few layers the distance is set by how the random weights amplify any
# change of one rounding, not by its size.  So one layer has a fixed bound
# (3x its reading), and full depth is held to the kernel-free witness
# (reading 1.03x) and to twice its reading.
DEPTHS = (1, 7, 28)
REL_L2_ONE_LAYER = 1e-2
WITNESS_RATIO = 1.5
REL_L2_BOUND = 3e-2


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=15, warmup=2, flush=None):
    """Median CUDA-event time of ``fn`` over ``iters`` calls; ``flush``
    (a buffer larger than L2) is rewritten before each call so weights are
    read from device memory, as in the decode loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------- phase 2

def kernel_quantize(torch, dev, flush):
    from repro_torch.core.qdq import unpack_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_quantize import ttq_quantize
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    ms = plain = bound = 0.0
    # whole 28-layer stacks, as one requant launches them: the four shapes
    # at bits 4 g 32 (checked, then timed) plus one bits-8 check
    cases = [(name, dp, d, 4, per_layer)
             for name, (dp, d, per_layer) in GEMM_SHAPES.items()]
    cases.append(("wq/wk/wv", 4096, 3072, 8, 0))
    for name, dp, d, bits, per_layer in cases:
        W = torch.randn((28, dp, d), generator=gen, device=dev).to(torch.bfloat16)
        D = torch.exp(0.3 * torch.randn((28, d), generator=gen, device=dev))
        pk, S, Z = ttq_quantize(W, D, bits=bits, group_size=32)
        pk_r, S_r, Z_r = ref.ttq_quantize_ref(W, D, bits=bits, group_size=32)
        torch.testing.assert_close(S, S_r, rtol=1e-5, atol=0)
        torch.testing.assert_close(Z, Z_r, rtol=1e-5, atol=1e-6)
        n_off = max_off = 0
        for i in range(28):        # one layer at a time: codes are 4 B each
            c, c_r = unpack_bits(pk[i], d, bits), unpack_bits(pk_r[i], d, bits)
            diff = (c - c_r).abs()
            n_off += int((diff > 0).sum())
            max_off = max(max_off, int(diff.max()))
            deq = c.float() * S[i].repeat_interleave(32, -1) \
                + Z[i].repeat_interleave(32, -1)
            deq_r = c_r.float() * S_r[i].repeat_interleave(32, -1) \
                + Z_r[i].repeat_interleave(32, -1)
            worst = max(worst, float((deq - deq_r).abs().max()))
            del c, c_r, diff, deq, deq_r
        share = n_off / (28 * dp * d)
        check(max_off <= 1 and share <= 2e-3,
              f"ttq_quantize codes (28,{dp},{d}) bits {bits}: max diff "
              f"{max_off}, share {share}")
        msg = (f"  ttq_quantize {name} (28,{dp},{d}) bits {bits}: codes off "
               f"by one at {n_off} of {28 * dp * d} (ties)")
        del pk, S, Z, pk_r, S_r, Z_r
        if bits == 4:
            t_k = time_ms(torch, lambda: ttq_quantize(W, D, bits=4,
                                                      group_size=32), iters=7)
            t_p = time_ms(torch, lambda: ref.ttq_quantize_ref(
                W, D, bits=4, group_size=32), iters=3, warmup=1)
            moved = nbytes(W, D) + 28 * dp * (d // 8 * 4 + 2 * (d // 32) * 4)
            b = max(moved / HBM_BYTES_PER_S,
                    28 * dp * d * 6 / F32_FLOP_PER_S) * 1e3
            msg += f"; {t_k:.3f} ms, bound {b:.3f} ms, plain {t_p:.3f} ms"
            ms += per_layer * t_k
            plain += per_layer * t_p
            bound += per_layer * b
        print(msg)
        del W, D
        torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bound,
                library_ms=None, bound_by="bytes")


def kernel_gemm(torch, dev, flush):
    from repro_torch.core.qdq import unpack_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_gemm import ttq_gemm
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0
    ms = plain = lib = bound = 0.0
    for name, (dp, d, per_layer) in GEMM_SHAPES.items():
        W = torch.randn((dp, d), generator=gen, device=dev) * d ** -0.5
        D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=dev))
        dinv = 1.0 / D
        scale = (d / 256) ** 0.5   # longer f32 sums: tolerance ∝ sqrt(d)
        for bits in (4, 8):
            pk, S, Z = ref.ttq_quantize_ref(W, D, bits=bits, group_size=32)
            for T in (1, 4, 16):
                x = torch.randn((T, d), generator=gen, device=dev)
                # f32 input: tests/test_kernels.py:52's rtol 2e-5 / atol 2e-4
                y = ttq_gemm(x, pk, S, Z, dinv, bits=bits, group_size=32)
                y_r = ref.ttq_gemm_ref(x, pk, S, Z, bits=bits, group_size=32,
                                       dinv=dinv)
                torch.testing.assert_close(y, y_r, rtol=2e-5 * scale,
                                           atol=2e-4 * scale)
                # bf16 input (the main path): plus one bf16 output rounding
                xb = x.to(torch.bfloat16)
                yb = ttq_gemm(xb, pk, S, Z, dinv, bits=bits, group_size=32)
                yb_r = ref.ttq_gemm_ref(xb, pk, S, Z, bits=bits, group_size=32,
                                        dinv=dinv)
                torch.testing.assert_close(yb.float(), yb_r, rtol=2 ** -7,
                                           atol=2e-4 * scale)
                if bits == 4 and T == 4:
                    worst = max(worst, float((yb.float() - yb_r).abs().max()))
        pk, S, Z = ref.ttq_quantize_ref(W, D, bits=4, group_size=32)
        xb = torch.randn((4, d), generator=gen, device=dev).to(torch.bfloat16)
        w_lib = ((unpack_bits(pk, d, 4).float() * S.repeat_interleave(32, 1)
                  + Z.repeat_interleave(32, 1)) * dinv).to(torch.bfloat16)
        t_k = time_ms(torch, lambda: ttq_gemm(xb, pk, S, Z, dinv, bits=4,
                                              group_size=32), flush=flush)
        t_p = time_ms(torch, lambda: ref.ttq_gemm_ref(
            xb, pk, S, Z, bits=4, group_size=32, dinv=dinv), flush=flush)
        t_l = time_ms(torch, lambda: torch.matmul(xb, w_lib.T), flush=flush)
        moved = nbytes(pk, S, Z, dinv, xb) + 4 * dp * 2
        b = max(moved / HBM_BYTES_PER_S, 2 * 4 * dp * d / F32_FLOP_PER_S) * 1e3
        print(f"  ttq_gemm {name} T=4 int4: {t_k * 1e3:.1f} us, bound "
              f"{b * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, torch.matmul "
              f"bf16 {t_l * 1e3:.1f} us")
        n = 28 * per_layer
        ms, plain, lib, bound = (ms + n * t_k, plain + n * t_p,
                                 lib + n * t_l, bound + n * b)
        del W, pk, S, Z, w_lib
        torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bound,
                library_ms=lib, bound_by="bytes")


def kernel_attention(torch, dev, flush, cur_main):
    from repro_torch.core.kvquant import quantize_kv
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_attn import ttq_decode_attention
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    B, H, S, Dh = 4, 16, 256, 256
    k = torch.randn((B, H, S, Dh), generator=gen, device=dev)
    v = torch.randn((B, H, S, Dh), generator=gen, device=dev)
    q = torch.randn((B, H, 1, Dh), generator=gen, device=dev)
    worst = 0.0
    out = {}
    for bits in (8, 4):
        kq, ks = quantize_kv(k, bits=bits)
        vq, vs = quantize_kv(v, bits=bits)
        for cur in ([0, 37, 128, 200], [S - 1] * B):   # empty tail / full
            pos = torch.tensor(cur, dtype=torch.int32, device=dev)
            o = ttq_decode_attention(q, kq, ks, vq, vs, pos, bits=bits)
            o_r = ref.kv_attn_ref(q, kq, ks, vq, vs, pos, bits=bits)
            # f32 softmax over the same dequantized values: 1e-5, as the
            # JAX package's kernel test (tests/test_kvquant.py:104)
            torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
            worst = max(worst, float((o - o_r).abs().max()))
        pos = torch.tensor(cur_main, dtype=torch.int32, device=dev)
        qb = q.to(torch.bfloat16)
        t_k = time_ms(torch, lambda: ttq_decode_attention(
            qb, kq, ks, vq, vs, pos, bits=bits), flush=flush)
        t_p = time_ms(torch, lambda: ref.kv_attn_ref(
            qb, kq, ks, vq, vs, pos, bits=bits), flush=flush)
        row = Dh * bits // 8 + 4                    # codes + one f32 scale
        moved = 2 * H * row * sum(c + 1 for c in cur_main) + 2 * nbytes(qb) \
            + nbytes(pos)
        ops = 4 * H * Dh * sum(c + 1 for c in cur_main)
        b = max(moved / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3
        print(f"  ttq_decode_attention int{bits} cur_pos={cur_main}: "
              f"{t_k * 1e3:.1f} us, bound {b * 1e3:.2f} us, plain "
              f"{t_p * 1e3:.1f} us")
        out[bits] = (t_k, t_p, b)
    t_k, t_p, b = out[8]                              # the main path: int8
    return dict(max_abs_err=worst, ms=28 * t_k, plain_ms=28 * t_p,
                bound_ms=28 * b, library_ms=None, bound_by="bytes")


# --------------------------------------------------------------- phase 3

def clone_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(torch, v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def make_prompts() -> list[list[int]]:
    """The main path's traffic: N_REQUESTS prompts of 16-64 tokens."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, 256000, size=int(n)).tolist()
            for n in rng.integers(16, 65, size=N_REQUESTS)]


def build_engine(torch, dev):
    """``TTQEngine`` on full-width gemma-7b (random weights, seed 0), int4
    g32 packed weights through the kernels, int8 KV, 4 slots x 256."""
    from repro_torch.configs import get
    from repro_torch.core import KernelConfig, KVCacheConfig, ttq_policy
    from repro_torch.models import lm
    from repro_torch.serving import EngineConfig, TTQEngine

    cfg = get("gemma_7b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    print(f"  init gemma-7b full width: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    policy = ttq_policy(bits=4, group_size=32, rank=0, packed=True,
                        kvcache=KVCacheConfig(dtype="int8"),
                        kernel=KernelConfig(use_pallas=True))
    ecfg = EngineConfig(max_slots=4, max_len=256, decode_chunk=0,
                        guards=False)
    return cfg, ecfg, TTQEngine(cfg, params, policy, ecfg, device=dev)


def split_sum_gemm(x, packed, scale, zero, dinv, *, bits, group_size):
    """The plain GEMM with its f32 sum over d taken in two halves: the same
    arithmetic as the plain version, in another order (as the kernel's is)."""
    from repro_torch.kernels import ref
    d = x.shape[-1]
    h, xr = d // group_size // 2 * group_size, x.reshape(-1, d)
    hw, hg = h * bits // 32, h // group_size
    y = ref.ttq_gemm_ref(xr[:, :h], packed[:, :hw], scale[:, :hg],
                         zero[:, :hg], bits=bits, group_size=group_size,
                         dinv=dinv[:h]) \
        + ref.ttq_gemm_ref(xr[:, h:], packed[:, hw:], scale[:, hg:],
                           zero[:, hg:], bits=bits, group_size=group_size,
                           dinv=dinv[h:])
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


@contextlib.contextmanager
def routed(gemm=None, attn=None):
    """Send the port's GEMM and KV-attention dispatch through other
    functions (None: leave it as it is) for the duration of the block."""
    from repro_torch.kernels import ops
    saved = ops.ttq_gemm, ops.kv_decode_attention
    ops.ttq_gemm = gemm or saved[0]
    ops.kv_decode_attention = attn or saved[1]
    try:
        yield
    finally:
        ops.ttq_gemm, ops.kv_decode_attention = saved


def held_to_plain(torch, gaps):
    """Dispatch functions that launch each kernel, hold its output against
    the plain version's on the same inputs (one bf16 rounding: rtol 2^-7;
    atol as in phase 2) and record per call shape [outputs, outputs that
    differ, largest |difference|] in ``gaps``."""
    from repro_torch.kernels import ops
    kernels = ops.ttq_gemm, ops.kv_decode_attention

    def held(kernel, key, atol):
        def run(*a, **kw):
            y = kernel(*a, **kw)
            y_r = kernel(*a, **{**kw, "use_pallas": False})
            diff = (y.float() - y_r.float()).abs()
            g = gaps.setdefault(key(*a), [0, 0, 0.0])
            g[0] += y.numel()
            g[1] += int((diff > 0).sum())
            g[2] = max(g[2], float(diff.max()))
            torch.testing.assert_close(y.float(), y_r.float(), rtol=2 ** -7,
                                       atol=atol(*a))
            return y
        return run
    gemm = held(kernels[0],
                lambda x, pk, *_: f"ttq_gemm {pk.shape[0]}x{x.shape[-1]}",
                lambda x, *_: 2e-4 * (x.shape[-1] / 256) ** 0.5)
    attn = held(kernels[1], lambda *_: "ttq_decode_attention",
                lambda *_: 1e-5)
    return gemm, attn


def depth_witness(torch, cfg, eng, r):
    """Relative L2 distance of one decode step's logits on the first L
    layers (L in DEPTHS) from the plain path's, on the same state and tree,
    for: both kernels; the GEMM kernel alone; the attention kernel alone;
    the plain path with its GEMM sums split in two halves (another f32
    order, no kernel); the plain path run again.  At full depth each kernel
    call of the "kernels" step is also held against its plain version."""
    from repro_torch.core import KernelConfig
    from repro_torch.models import lm
    from repro_torch.models.stack import layer_slice
    kvplain = dataclasses.replace(eng.kvcfg, use_pallas=False)
    on, off = KernelConfig(use_pallas=True), KernelConfig(use_pallas=False)
    variants = {"kernels": (eng.kvcfg, on, ()),
                "gemm kernel": (kvplain, on, ()),
                "attention kernel": (eng.kvcfg, off, ()),
                "split-sum plain": (kvplain, on, (split_sum_gemm,)),
                "plain again": (kvplain, off, ())}
    gaps = {}
    out = {}
    for L in DEPTHS:
        cfg_l = dataclasses.replace(cfg, n_layers=L)
        p_l = dict(eng.decode_params, stack=[
            layer_slice(run, slice(0, L)) for run in eng.decode_params["stack"]])
        st = {"stack": [layer_slice(run, slice(0, L))
                        for run in r.state["stack"]]}

        def step(kv, kc, route=()):
            with routed(*route):
                lg, _ = lm.decode_step(cfg_l, p_l, clone_tree(torch, st),
                                       r.cur_tok, r.pos, kvcfg=kv, kcfg=kc)
            return lg
        lg_p = step(kvplain, off)
        out[L] = {}
        for name, (kv, kc, route) in variants.items():
            if L == DEPTHS[-1] and name == "kernels":
                route = held_to_plain(torch, gaps)
            lg = step(kv, kc, route)
            check(lg.shape == (4, cfg.vocab) and bool(torch.isfinite(lg).all()),
                  f"{name} logits at {L} layers not finite / wrong shape")
            out[L][name] = float((lg - lg_p).norm() / lg_p.norm())
        print(f"  decode_step on {L:2d} layers, rel-L2 to plain: "
              + ", ".join(f"{k} {v:.2e}" for k, v in out[L].items()))
    for key, (n, n_diff, most) in gaps.items():
        print(f"  {key} in one {DEPTHS[-1]}-layer step: {n_diff} of {n} "
              f"outputs differ from the plain version's, by at most {most:.3g}")
    return out, gaps


def main_path(torch, dev, prompts):
    from repro_torch.kernels import build
    from repro_torch.models import lm

    cfg, ecfg, eng = build_engine(torch, dev)
    build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    out = eng.run_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(out[r]) for r in rids)
    check(all(len(out[r]) == MAX_NEW and not out[r].unfinished for r in rids),
          f"not every request produced {MAX_NEW} tokens")
    check(all(0 <= t < cfg.vocab for r in rids for t in out[r]),
          "token out of the vocabulary")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    res = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               requants=eng.n_requants, requant_dispatch_s=eng.requant_wall_s,
               host_syncs=eng.host_syncs,
               syncs_per_token=eng.host_syncs / n_tok, launches=launches,
               decode_chunk=eng.ecfg.decode_chunk,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  served {len(rids)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.1f} tok/s; requants {eng.n_requants} (dispatch "
          f"{eng.requant_wall_s * 1e3:.1f} ms); host syncs {eng.host_syncs} "
          f"({res['syncs_per_token']:.4f}/token); launches {launches}")

    # a second, warm run of the same traffic with each phase timed (a
    # synchronize around each call): where the wall time goes
    phase = {"prefill": 0.0, "requant": 0.0, "decode": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phase[key] += time.perf_counter() - t
            return out
        return run
    eng.runner.admit_group = timed(eng.runner.admit_group, "prefill")
    eng.runner.decode_block = timed(eng.runner.decode_block, "decode")
    eng._requantize = timed(eng._requantize, "requant")
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    out = eng.run_all()
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    res.update(warm_wall_s=wall2, warm_tok_per_s=n_tok / wall2,
               warm_phase_s=phase,
               decode_ms_per_step=phase["decode"] * 1e3 / (
                   N_REQUESTS // ecfg.max_slots
                   * -(-(MAX_NEW - 1) // eng.ecfg.decode_chunk)
                   * eng.ecfg.decode_chunk))
    print(f"  warm run: {n_tok / wall2:.1f} tok/s; phases (synced) "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phase.items())
          + f"; decode {res['decode_ms_per_step']:.2f} ms per step")
    del eng.runner.admit_group, eng.runner.decode_block, eng._requantize

    # one synced requant: its device time on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.qmodel.requantize()
    torch.cuda.synchronize()
    res["requant_synced_s"] = time.perf_counter() - t0
    print(f"  requant (synced): {res['requant_synced_s'] * 1e3:.1f} ms")

    # fresh admission of 4 prompts: a live decode state to check against
    for p in prompts[:4]:
        eng.submit(p, max_new=MAX_NEW)
    eng.admit()
    r = eng.runner
    # one fused block must not sync the host (the one transfer comes after)
    st = clone_tree(torch, r.state)
    torch.cuda.set_sync_debug_mode("error")
    try:
        (toks, _), _ = lm.decode_many(
            cfg, eng.decode_params, st, r.cur_tok.clone(), r.pos.clone(),
            r.done.clone(), r.remaining.clone(), None, K=r.K,
            max_len=ecfg.max_len, kvcfg=eng.kvcfg, kcfg=eng.kncfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(toks.shape == (4, r.K), f"decode_many tokens {tuple(toks.shape)}")
    del st

    wit, gaps = depth_witness(torch, cfg, eng, r)
    res["decode_step_rel_l2"] = wit
    res["kernel_gaps"] = gaps
    check(wit[1]["kernels"] <= REL_L2_ONE_LAYER,
          f"kernel vs plain decode_step on 1 layer: rel-L2 {wit[1]['kernels']}")
    full = wit[DEPTHS[-1]]
    check(full["kernels"] <= min(REL_L2_BOUND,
                                 WITNESS_RATIO * full["split-sum plain"]),
          f"kernel vs plain decode_step on {DEPTHS[-1]} layers: rel-L2 "
          f"{full['kernels']}, kernel-free witness {full['split-sum plain']}")
    check(full["plain again"] == 0.0, "the plain path is not deterministic")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {card} ({torch.cuda.device_count()} visible), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.lib()
    log = build.BUILD_DIR / "build.log"
    log.write_text(build.build_log)
    spills = [ln for ln in build.build_log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    print(f"    kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s; ptxas log {log}, "
          f"{len(spills)} kernels with spills)")

    prompts = make_prompts()
    cur_main = [len(p) + MAX_NEW // 2 for p in prompts[:4]]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > L2

    print("[2] kernels against their plain versions (gemma-7b shapes)")
    rows = {
        "ttq_quantize": ("src/repro_torch/kernels/csrc/ttq_quantize.cu",
                         "src/repro/kernels/ttq_quantize.py:66",
                         kernel_quantize(torch, dev, flush)),
        "ttq_gemm": ("src/repro_torch/kernels/csrc/ttq_gemm.cu",
                     "src/repro/kernels/ttq_gemm.py:125",
                     kernel_gemm(torch, dev, flush)),
        "ttq_decode_attention": ("src/repro_torch/kernels/csrc/ttq_attn.cu",
                                 "src/repro/kernels/ttq_attn.py:254",
                                 kernel_attention(torch, dev, flush, cur_main)),
    }
    del flush
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    print("[3] main path: TTQEngine, gemma-7b full width, int4 g32 weights, "
          "int8 KV")
    res = main_path(torch, dev, prompts)
    print("    main path: " + json.dumps(res))

    kernels = []
    for name, (src, replaces, m) in rows.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            launches=res["launches"][name], **m))
    print("[4] per kernel: ms per decode step (gemm, attention) or per "
          "requant (quantize)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
