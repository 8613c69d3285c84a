#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit; builds the CUDA kernels of
   ``src/repro_torch/kernels/csrc/`` with nvcc (sm_90a) into ``build/``;
   prints each attention and quantize instantiation's registers and
   spills, and fails if an attention one that the main path runs, or any
   quantize one, spills.
2. Each kernel against its plain PyTorch version at gemma-7b's main-path
   shapes (``ttq_quantize`` bit for bit on whole 28-layer stacks, with its
   grid and the share of its bound per family), with its median time, its
   bound, the plain version's time and
   one PyTorch call of the same function (``torch.matmul`` for the GEMM,
   ``scaled_dot_product_attention`` on the dequantized bf16 cache for
   both attention kernels); the GEMM also prints its K split, block count
   and time at every split per shape and must give bitwise equal results
   on two calls.  Both attention kernels are checked at every split C on
   f32 and bf16 q (within 1e-5 of the plain version, bf16 with one more
   rounding; paged bit for bit dense on the gathered cache; two calls
   bitwise equal) and print their time at every
   C beside the rule's; then the same at gemma-7b's own context (S = 8192,
   cur_pos = LONG_CUR), with the byte bound and the share of it reached.
3. The main path: ``TTQEngine`` on full-width gemma-7b (random weights from
   a seed) serves 8 requests through the three kernels of the dense slab,
   each decode block one replay of a captured CUDA graph; every kernel
   must have launched (counted per replay), and ``compiled_programs`` must
   not change over a warm rerun of the traffic.  A third run holds every
   graph block to an eager ``lm.decode_many`` on clones of the state it
   started from (tokens bit for bit) and times both, eager and graph
   blocks in turns.  One synced requant is split into its 7
   ``ttq_quantize`` launches' device time and the rest, beside one that
   builds a fresh tree instead of landing in place.  On 4 fresh
   admissions, an eager block and a replay must not sync the host, and
   one eager and one graph block under the profiler give device launches
   per step, host-side launches per block and the device's busy share.
   Then one kernel-path ``decode_step`` on 1, 7 and 28 layers is held
   against the plain-version one and against a kernel-free witness, with
   every kernel call of the 28-layer step held against its plain version.
3b. The paged main path: the same weights, policy and traffic through
   ``EngineConfig(kv_paged=True)`` (block 16, default pool): decode
   attention runs ``ttq_paged_decode_attention``, and the greedy tokens
   must equal 3's; the graph checks and readings of 3.
3c. Prefix cache and preemption at full width: full-precision weights,
   int8 KV, 8 prompts sharing a 32-token prefix, a pool small enough to
   preempt; then the same traffic on an unconstrained pool without the
   prefix cache, for a reading of how many leading tokens agree; and the
   same pair on the first layer alone, as its witness.  A rerun of the
   constrained traffic at full depth holds every graph block to the eager
   loop, through preemption and prefix hits.
3d. The reference's default policy (rank 16, delta gate, double buffer)
   at full width on DEPTH_3D layers, checks (a)-(e).
3e. Self-speculative decoding (``speculate_k=SPEC_W``): (a) [3d]'s policy
   and factors with its int4 rank-0 draft; (b) bf16 weights, int8 KV and
   an int4 g32 draft (draft-only quantization) at full depth, on the dense
   slab and on the paged pool; (c) (b) on the first layer.  Every
   speculative block is a graph replay held bit for bit to an eager
   ``speculate_many``; paged tokens equal dense ones; in (a), (b) and (c)
   each request's first disagreement with the non-speculative run must be
   a near-tie (its two tokens' logits closer than a recomputed decode step
   and verify window differ); every kernel
   launches on the path (``ttq_gemm`` at 4 and 16 rows); compiled programs
   flat over a warm rerun.  Prints acceptance, ms per block, warm tokens/s
   speculative and not, launches per block, captures, the draft requant's
   ``ttq_quantize`` time and peak memory.  [2] also times ``ttq_gemm`` at
   the verify window's 16 rows.
3f. Robustness and streaming on [3]'s policy at full width: (a) the
   default guards against guards=False (tokens and host syncs equal, ms
   per decode step in turns, the gated requant's wall); (b) a
   ``decode.logits`` fault on one lane, dense and paged, retried or failed
   alone; (c) ``requant.tree`` NaN once (retried) and twice (rolled back:
   the served tree bit for bit the last good one); (d) ``calib.stats`` nan
   and outlier quarantined, the next requant bit for bit a dropped
   update's; (e) ``pool.steal``: the degradation ladder to rung 3 and
   back, one K = 1 graph, tokens unchanged; (f) chunked prefill at
   max_len 512, dense and paged, every chunk replay bit for bit the eager
   chunk, tokens equal to the unchunked run's or near-ties, TTFT/ITL
   p50/p99; (g) ``TTQServer``: streams equal the batch engine's, graphs on
   the worker thread, a dropped stream cancelled, ``stop()`` drains; (h)
   ``python -m repro_torch.launch.serve`` in a subprocess, its summary
   parsed.  Prints each part's seconds.
4. A ``{"kernels": [...]}`` line, the card line, and ``{"ok": true, ...}``.

Any failed check exits non-zero before the last line is printed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
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
# phase 3c: a 32-token shared prefix (2 blocks of 16) with tails of 16-48
# tokens, and a pool of POOL_3C blocks (17 allocatable).  The scheduler is
# host-only and eos_token=-1 runs every request to max_new, so its
# preemptions and prefix hits do not depend on the model: on the CPU, with
# a tiny model of the same geometry, this traffic preempts 24 times with 72
# prefix-block hits and 61 misses, and pools of 20 blocks or more never
# preempt (tests/test_torch_paged.py::test_smoke_prefix_traffic_preempts).
BLOCK = 16
POOL_3C = 18
LONG_CUR = [8191, 6143, 4095, 2047]   # phase 2's long-context attention
# the attention instantiations gemma-7b's int8 KV runs (G = 1, Dh 256, one
# scale group per row)
MAIN_PATH_ATTN = ("attn_kernel<1,1,8,1>", "paged_attn_kernel<1,1,8,1>")
# the quantize instantiation a requant runs: bits 4, one vector per lane
# and group of 32 (four lanes), bf16 weights
MAIN_PATH_QUANT = "quant_kernel<4,1,1,__nv_bfloat16>"
SPIN_CYCLES = 4_000_000        # about 2 ms at the H100's clock (time_ms)
# host-side CUDA API calls that put work on a stream, as the profiler
# names them (with or without CUPTI's version suffix)
HOST_LAUNCH = re.compile(r"cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)\w*")
# phase 3d: the reference's default policy.  Exact top-16 SVD (cuSOLVER
# gesvd) takes 0.8-1.0 s per gemma-7b weight matrix on an H100, ~6 s per
# layer, so [3d] runs 8 of the 28 layers at full width (PERF.md).
DEPTH_3D = 8
RANK_3D = 16
THRESHOLD_3D = 0.05
SVD_TOL = 1e-4                 # relative, against a float64 CPU SVD
REL_L2_ONE_LAYER = 1e-2
WITNESS_RATIO = 1.5
REL_L2_BOUND = 3e-2
SPEC_W = 3                     # phase 3e: drafted tokens per window
# phase 3f: chunked prefill at max_len 512 in chunks of 64, two per round,
# 8 slots so the long prompts are ingested while the short ones decode;
# the pool theft of (e) takes every free block for 4 engine steps
CHUNK_3F, BUDGET_3F, MAXLEN_3F, SLOTS_3F = 64, 128, 512, 8
STEAL_3F = 64
NEVER = 10 ** 6                # a requant cadence that never fires: the
                               # tree is fixed by one manual requant


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
    """Median CUDA-event time of ``fn``'s device work over ``iters`` calls;
    ``flush`` (a buffer larger than L2) is rewritten before each call so
    weights are read from device memory, as in the decode loop.  A device
    spin of SPIN_CYCLES follows the flush, so the host has enqueued all of
    ``fn``'s launches (a wrapper's checks and argument casts included)
    before the start event fires: the window holds ``fn``'s device work
    back to back, not the host's enqueue time.  The wrapper's own small
    launches (a cast of q, say) stay inside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def demangle(sym: str) -> str:
    """``_ZN<n><namespace><m><name>I<args>E...`` → ``name<args>`` (the
    kernels' symbols: one namespace; int or bool template arguments
    ``L[ib]<v>E``, ``f`` for float, ``<len><name>`` for a named type)."""
    m = re.match(r"_ZN(\d+)", sym)
    if not m:
        return sym
    rest = sym[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return sym
    name = rest[m.end():m.end() + int(m.group(1))]
    rest = rest[m.end() + len(name):]
    if not rest.startswith("I"):
        return name
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        lit = re.match(r"L[ib](-?\d+)E", rest[i:])
        typ = re.match(r"(\d+)", rest[i:])
        if lit:
            args.append(lit.group(1))
            i += lit.end()
        elif rest[i] == "f":
            args.append("float")
            i += 1
        elif typ:
            j = i + typ.end()
            args.append(rest[j:j + int(typ.group(1))])
            i = j + int(typ.group(1))
        else:
            return name
    return f"{name}<{','.join(args)}>"


def ptxas_report(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ``-Xptxas -v`` log, names demangled to ``name<template args>``."""
    out = {}
    for m in re.finditer(r"Function properties for (\S+)\n\s*\d+ bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                         r"loads\n.*?Used (\d+) registers", log):
        name = demangle(m.group(1))
        out[name] = (int(m.group(4)), int(m.group(2)), int(m.group(3)))
    return out


# --------------------------------------------------------------- phase 2

def quant_mismatch(torch, out, ref, d, bits, g=32) -> tuple[int, bool, float]:
    """(codes that differ between two ``ttq_quantize`` results, S and Z
    bit for bit equal, the largest |difference| of the dequantized weights
    code·s + z); whole 28-layer stacks, a layer at a time."""
    from repro_torch.core.qdq import unpack_bits
    (pk, S, Z), (pk_r, S_r, Z_r) = out, ref
    sz = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
             for a, b in ((S, S_r), (Z, Z_r)))

    def deq(codes, s, z):
        return codes * s.repeat_interleave(g, -1) + z.repeat_interleave(g, -1)

    off, err = 0, 0.0
    for i in range(pk.shape[0]):
        c, c_r = unpack_bits(pk[i], d, bits), unpack_bits(pk_r[i], d, bits)
        off += int((c != c_r).sum())
        e = float((deq(c, S[i], Z[i]) - deq(c_r, S_r[i], Z_r[i])).abs().max())
        if not e <= err:                     # NaN propagates
            err = e
    return off, sz, err


def quant_bound_ms(n, dp, d, bits, g=32) -> float:
    """Least time of one ``ttq_quantize`` launch: the bf16 stack and D read
    once, codes and f32 S and Z written once, over 3.35 TB/s; or its f32
    operations (~6 per element) over 67 TFLOP/s, whichever is larger."""
    moved = n * (dp * d * 2 + d * 4 + dp * (d * bits // 8 + 2 * (d // g) * 4))
    return max(moved / HBM_BYTES_PER_S, n * dp * d * 6 / F32_FLOP_PER_S) * 1e3


def kernel_quantize(torch, dev, flush):
    """``ttq_quantize`` on whole 28-layer bf16 stacks, as one requant
    launches it: the four gemma-7b families at int4 g32, then a bits-8
    check.  Packed codes, S and Z must equal the plain version's bit for
    bit.  Each family prints its grid (``quant_blocks``), its median time,
    its bound and the share of it reached, and the plain version's time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels._checks import sm_count
    from repro_torch.kernels.ttq_quantize import quant_blocks, ttq_quantize
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ms = plain = bound = worst = 0.0
    cases = [(name, dp, d, 4, per_layer)
             for name, (dp, d, per_layer) in GEMM_SHAPES.items()]
    cases.append(("wq/wk/wv", 4096, 3072, 8, 0))
    for name, dp, d, bits, per_layer in cases:
        W = torch.randn((28, dp, d), generator=gen, device=dev).to(torch.bfloat16)
        D = torch.exp(0.3 * torch.randn((28, d), generator=gen, device=dev))
        off, sz, err = quant_mismatch(
            torch, ttq_quantize(W, D, bits=bits, group_size=32),
            ref.ttq_quantize_ref(W, D, bits=bits, group_size=32), d, bits)
        check(off == 0 and sz and err == 0.0,
              f"ttq_quantize (28,{dp},{d}) bits {bits}: {off} codes differ "
              f"from the plain version's, S and Z bitwise equal: {sz}, "
              f"dequantized weights differ by up to {err}")
        worst = max(worst, err)
        msg = (f"  ttq_quantize {name} (28,{dp},{d}) bits {bits}: codes, S "
               f"and Z bit for bit the plain version's (0 codes differ, "
               f"dequantized weights differ by {err})")
        if bits == 4:
            t_k = time_ms(torch, lambda: ttq_quantize(W, D, bits=4,
                                                      group_size=32), iters=7)
            t_p = time_ms(torch, lambda: ref.ttq_quantize_ref(
                W, D, bits=4, group_size=32), iters=3, warmup=1)
            b = quant_bound_ms(28, dp, d, 4)
            blocks = quant_blocks(28, dp, d, 2, sm_count(dev))
            msg += (f"; {blocks} blocks, {t_k:.3f} ms, bound {b:.3f} ms "
                    f"({b / t_k:.1%} of it reached), plain {t_p:.3f} ms")
            ms += per_layer * t_k
            plain += per_layer * t_p
            bound += per_layer * b
        print(msg)
        del W, D
        torch.cuda.empty_cache()
    print(f"  ttq_quantize per requant (7 launches): {ms:.3f} ms, bound "
          f"{bound:.3f} ms ({bound / ms:.1%} of it reached)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bound,
                library_ms=None, bound_by="bytes")


def kernel_gemm(torch, dev, flush):
    from repro_torch.core.qdq import unpack_bits
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.ttq_gemm import (ROW_TILE, TOKEN_TILE, gemm_splits,
                                              ttq_gemm)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
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
        # the cluster adds its partial sums in rank order: bitwise repeatable
        y1 = ttq_gemm(xb, pk, S, Z, dinv, bits=4, group_size=32)
        y2 = ttq_gemm(xb, pk, S, Z, dinv, bits=4, group_size=32)
        check(torch.equal(y1, y2), f"ttq_gemm {name}: two calls differ")
        t_k = time_ms(torch, lambda: ttq_gemm(xb, pk, S, Z, dinv, bits=4,
                                              group_size=32), flush=flush)
        t_p = time_ms(torch, lambda: ref.ttq_gemm_ref(
            xb, pk, S, Z, bits=4, group_size=32, dinv=dinv), flush=flush)
        t_l = time_ms(torch, lambda: torch.matmul(xb, w_lib.T), flush=flush)
        moved = nbytes(pk, S, Z, dinv, xb) + 4 * dp * 2
        b = max(moved / HBM_BYTES_PER_S, 2 * 4 * dp * d / F32_FLOP_PER_S) * 1e3
        split = gemm_splits(dp, d, 4, 4, 32, n_sm)
        print(f"  ttq_gemm {name} T=4 int4: {t_k * 1e3:.1f} us, bound "
              f"{b * 1e3:.1f} us ({b / t_k:.1%} of it reached), plain "
              f"{t_p * 1e3:.1f} us, torch.matmul bf16 {t_l * 1e3:.1f} us; "
              f"split {split}, {-(-dp // ROW_TILE) * split} blocks; two "
              f"calls bitwise equal; at every split (us): " + ", ".join(
                  f"{s} {t * 1e3:.1f}" for s, t in gemm_at_splits(
                      torch, build.lib(), xb, pk, S, Z, dinv, flush).items()))
        # the verify window of phase 3e: 4 slots x (SPEC_W + 1) rows
        Tv = 4 * (SPEC_W + 1)
        xv = torch.randn((Tv, d), generator=gen, device=dev).to(torch.bfloat16)
        yv = ttq_gemm(xv, pk, S, Z, dinv, bits=4, group_size=32)
        yv_r = ref.ttq_gemm_ref(xv, pk, S, Z, bits=4, group_size=32, dinv=dinv)
        torch.testing.assert_close(yv.float(), yv_r, rtol=2 ** -7,
                                   atol=2e-4 * scale)
        t_v = time_ms(torch, lambda: ttq_gemm(xv, pk, S, Z, dinv, bits=4,
                                              group_size=32), flush=flush)
        t_vp = time_ms(torch, lambda: ref.ttq_gemm_ref(
            xv, pk, S, Z, bits=4, group_size=32, dinv=dinv), flush=flush)
        split_v = gemm_splits(dp, d, Tv, 4, 32, n_sm)
        print(f"  ttq_gemm {name} T={Tv} int4 (the verify window): "
              f"{t_v * 1e3:.1f} us, plain {t_vp * 1e3:.1f} us; split "
              f"{split_v}, {-(-dp // ROW_TILE) * -(-Tv // TOKEN_TILE) * split_v}"
              f" blocks; within one bf16 rounding of the plain version (max "
              f"|diff| {float((yv.float() - yv_r).abs().max()):.3g})")
        n = 28 * per_layer
        ms, plain, lib, bound = (ms + n * t_k, plain + n * t_p,
                                 lib + n * t_l, bound + n * b)
        del W, pk, S, Z, w_lib
        torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bound,
                library_ms=lib, bound_by="bytes")


def gemm_at_splits(torch, lib, xb, pk, S, Z, dinv, flush):
    """``ttq_gemm``'s C entry at each split of SPLITS that divides K into
    whole groups of 32, int4, timed as ``time_ms`` does: what the wrapper's
    choice (``gemm_splits``) is held against.  Not counted as launches."""
    from repro_torch.kernels.ttq_gemm import SPLITS
    T, d = xb.shape
    dp = pk.shape[0]
    y = torch.empty((T, dp), dtype=xb.dtype, device=xb.device)
    stream = torch.cuda.current_stream(xb.device).cuda_stream

    def launch(s):
        check(lib.ttq_gemm_launch(
            xb.data_ptr(), 1, pk.data_ptr(), S.data_ptr(), Z.data_ptr(),
            dinv.data_ptr(), y.data_ptr(), T, dp, d, 4, 32, s, stream) == 0,
            f"ttq_gemm at split {s} refused")
    return {s: time_ms(torch, lambda: launch(s), flush=flush)
            for s in SPLITS if d % (32 * s) == 0}


def attn_bound_ms(H, Dh, bits, cur, *small) -> float:
    """Least time of one decode-attention launch: each live cached row's
    codes and one f32 scale, for k and v, read once; ``small`` (q, the
    output, cur_pos, a block table) once; or its f32 operations."""
    row = Dh * bits // 8 + 4
    moved = 2 * H * row * sum(c + 1 for c in cur) + nbytes(*small)
    ops = 4 * H * Dh * sum(c + 1 for c in cur)
    return max(moved / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3


def sdpa_ms(torch, qb, kq, ks, vq, vs, pos, bits, flush):
    """One ``scaled_dot_product_attention`` call on the same inputs: the
    cache dequantized to bf16 and sliced to max(cur_pos) + 1 rows, and a
    boolean mask from ``cur_pos``, both made outside the timer.  Returns
    (its median ms, its output); the port never calls it."""
    from repro_torch.core.kvquant import dequantize_kv
    F = torch.nn.functional
    n = int(pos.max()) + 1
    k, v = (dequantize_kv(c[:, :, :n], s_[:, :, :n], torch.bfloat16,
                          bits=bits).contiguous()
            for c, s_ in ((kq, ks), (vq, vs)))
    mask = (torch.arange(n, device=pos.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    t = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qb, k, v, attn_mask=mask), flush=flush)
    return t, F.scaled_dot_product_attention(qb, k, v, attn_mask=mask)


def attn_checked(torch, q, dense, pool, bt, pos, bits, what):
    """Both attention kernels at every split C of SPLITS, on f32 q and on
    bf16 q (the main path's: the kernels' bf16 load and store): within
    1e-5 of the plain version on the same q (as the JAX package's kernel
    test, tests/test_kvquant.py:104; bf16 adds one rounding of the output,
    rtol 2^-7, as ``held_to_plain``), the paged kernel bit for bit the
    dense one on the gathered cache ``dense``, and two calls of each
    wrapper bitwise equal.  Returns the largest |difference| from the plain
    version on f32 q."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_attn import (SPLITS, _launch,
                                              ttq_decode_attention,
                                              ttq_paged_decode_attention)
    worst = 0.0
    for x, tol in ((q, dict(rtol=1e-5, atol=1e-5)),
                   (q.to(torch.bfloat16), dict(rtol=2 ** -7, atol=1e-5))):
        o_r = ref.kv_attn_ref(x, *dense, pos, bits=bits)
        for c in SPLITS:
            o = _launch(x, *dense, None, pos, c, bits=bits)
            o_p = _launch(x, *pool, bt, pos, c, bits=bits)
            check(o.dtype == x.dtype, f"{what}: output {o.dtype}, q {x.dtype}")
            torch.testing.assert_close(o.float(), o_r.float(), **tol)
            check(torch.equal(o_p, o), f"{what} int{bits} {x.dtype} at C = "
                  f"{c}: paged is not bit for bit the dense kernel on the "
                  f"gathered cache")
            if x.dtype == torch.float32:
                worst = max(worst, float((o - o_r).abs().max()))
        for run in (lambda: ttq_decode_attention(x, *dense, pos, bits=bits),
                    lambda: ttq_paged_decode_attention(x, *pool, bt, pos,
                                                       bits=bits)):
            check(torch.equal(run(), run()), f"{what} int{bits} {x.dtype}: "
                  f"two calls differ")
    return worst


def attn_case(torch, dev, seed, nblk, cur, bits_list=(8, 4)):
    """4 slots × 16 heads of 256 in a pool of blocks of BLOCK rows under a
    seeded permuted block table (nblk blocks per slot), and the same cache
    gathered into the dense (4, 16, nblk·BLOCK, ·) layout; yields per bits
    (bits, f32 q, dense leaves, pool leaves, table, cur_pos)."""
    from repro_torch.core.kvquant import quantize_kv
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, H, Dh = 4, 16, 256
    NB = B * nblk + 1
    pk = torch.randn((NB, H, BLOCK, Dh), generator=gen, device=dev)
    pv = torch.randn((NB, H, BLOCK, Dh), generator=gen, device=dev)
    q = torch.randn((B, H, 1, Dh), generator=gen, device=dev)
    perm = np.random.default_rng(seed).permutation(np.arange(1, NB))
    bt = torch.from_numpy(perm.reshape(B, nblk).astype(np.int32)).to(dev)
    pos = torch.tensor(cur, dtype=torch.int32, device=dev)
    for bits in bits_list:
        pool = [*quantize_kv(pk, bits=bits), *quantize_kv(pv, bits=bits)]
        dense = [ref.gather_paged_kv(t, bt) for t in pool]
        yield bits, q, dense, pool, bt, pos
        del pool, dense
    del pk, pv
    torch.cuda.empty_cache()


def attn_timed(torch, qb, dense, pool, bt, pos, bits, flush):
    """Median times (ms) of both kernels at the rule's C (None) and at
    every C, the wrapper's checks and the folded q scale and output cast
    included."""
    from repro_torch.kernels.ttq_attn import SPLITS, _launch
    t = {}
    for c in (None, *SPLITS):
        t["dense", c] = time_ms(torch, lambda: _launch(
            qb, *dense, None, pos, c, bits=bits), flush=flush)
        t["paged", c] = time_ms(torch, lambda: _launch(
            qb, *pool, bt, pos, c, bits=bits), flush=flush)
    return t


def at_every_c(t, kind) -> str:
    from repro_torch.kernels.ttq_attn import SPLITS
    return ", ".join(f"{c} {t[kind, c] * 1e3:.1f}" for c in SPLITS)


def kernel_attention(torch, dev, flush, cur_main):
    """Both attention kernels at the main path's shapes: 4 slots of 16
    heads of 256, capacity 256 (16 blocks of 16 under a seeded permuted
    table, and the same cache gathered dense).  Checked at every C on an
    empty tail, full slots and the main path's ``cur_pos``; timed at the
    main path's ``cur_pos`` with bf16 q, beside the plain version and one
    ``scaled_dot_product_attention`` call.  Returns the dense and the
    paged kernel's rows of the kernels line (int8, the main path's)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_attn import attn_splits
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nblk = 256 // BLOCK
    c_rule = attn_splits(4, 16, nblk * BLOCK, n_sm)
    worst = 0.0
    rows = {}
    for cur in ([0, 37, 128, 200], [255] * 4):
        for bits, q, dense, pool, bt, pos in attn_case(torch, dev, SEED + 2,
                                                       nblk, cur):
            worst = max(worst, attn_checked(torch, q, dense, pool, bt, pos,
                                            bits, f"attention {cur}"))
    for bits, q, dense, pool, bt, pos in attn_case(torch, dev, SEED + 2, nblk,
                                                   cur_main):
        worst = max(worst, attn_checked(torch, q, dense, pool, bt, pos, bits,
                                        "attention main"))
        qb = q.to(torch.bfloat16)
        t = attn_timed(torch, qb, dense, pool, bt, pos, bits, flush)
        t_pd = time_ms(torch, lambda: ref.kv_attn_ref(
            qb, *dense, pos, bits=bits), flush=flush)
        t_pp = time_ms(torch, lambda: ref.kv_paged_attn_ref(
            qb, *pool, bt, pos, bits=bits), flush=flush)
        t_l, o_l = sdpa_ms(torch, qb, *dense, pos, bits, flush)
        o = ref.kv_attn_ref(qb, *dense, pos, bits=bits)
        b_d = attn_bound_ms(16, 256, bits, cur_main, qb, qb, pos)
        b_p = attn_bound_ms(16, 256, bits, cur_main, qb, qb, pos, bt)
        for kind, t_p, b in (("dense", t_pd, b_d), ("paged", t_pp, b_p)):
            print(f"  ttq_{'paged_' if kind == 'paged' else ''}decode_attention"
                  f" int{bits} cur_pos={cur_main}: {t[kind, None] * 1e3:.1f} "
                  f"us at C = {c_rule} ({4 * 16 * c_rule} blocks), bound "
                  f"{b * 1e3:.2f} us, plain {t_p * 1e3:.1f} us, "
                  f"scaled_dot_product_attention bf16 {t_l * 1e3:.1f} us "
                  f"(its max |diff| from the plain version "
                  f"{float((o_l.float() - o.float()).abs().max()):.3g}); at "
                  f"every C (us): {at_every_c(t, kind)}")
            rows[kind, bits] = (t[kind, None], t_p, b, t_l)
    print(f"  both kernels at every C, f32 and bf16 q, within 1e-5 of the "
          f"plain version (bf16: and one rounding); paged bit for bit "
          f"dense; two calls bitwise equal")
    out = []
    for kind in ("dense", "paged"):
        t_k, t_p, b, t_l = rows[kind, 8]                # the main path: int8
        out.append(dict(max_abs_err=worst, ms=28 * t_k, plain_ms=28 * t_p,
                        bound_ms=28 * b, library_ms=28 * t_l,
                        bound_by="bytes"))
    return out


def kernel_attention_long(torch, dev, flush):
    """Both attention kernels at gemma-7b's own context: 4 slots × 16 heads
    × S = 8192 × Dh 256 (512 blocks of 16 per slot under a seeded permuted
    table, and the same cache gathered dense), cur_pos = LONG_CUR.  Checked
    as at the main path's shape, at every C; timed with bf16 q at every C
    beside its byte bound and one ``scaled_dot_product_attention`` call.
    Returns {(kernel, bits): (ms at the rule's C, bound ms, sdpa ms)}."""
    from repro_torch.kernels.ttq_attn import attn_splits
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nblk = 8192 // BLOCK
    c_rule = attn_splits(4, 16, nblk * BLOCK, n_sm)
    res = {}
    for bits, q, dense, pool, bt, pos in attn_case(torch, dev, SEED + 4, nblk,
                                                   LONG_CUR):
        worst = attn_checked(torch, q, dense, pool, bt, pos, bits,
                             "attention long")
        qb = q.to(torch.bfloat16)
        t = attn_timed(torch, qb, dense, pool, bt, pos, bits, flush)
        t_l, _ = sdpa_ms(torch, qb, *dense, pos, bits, flush)
        for kind, extra in (("dense", ()), ("paged", (bt,))):
            b = attn_bound_ms(16, 256, bits, LONG_CUR, qb, qb, pos, *extra)
            t_k = t[kind, None]
            print(f"  long: ttq_{'paged_' if kind == 'paged' else ''}"
                  f"decode_attention int{bits} S=8192 cur_pos={LONG_CUR}: "
                  f"{t_k * 1e3:.1f} us at C = {c_rule}, bound {b * 1e3:.1f} "
                  f"us ({b / t_k:.1%} of it reached), "
                  f"scaled_dot_product_attention bf16 {t_l * 1e3:.1f} us; "
                  f"max |diff| from the plain version {worst:.3g}; at every "
                  f"C (us): {at_every_c(t, kind)}")
            res[kind, bits] = (t_k, b, t_l)
    return res


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


def prefix_prompts() -> list[list[int]]:
    """Phase 3c's traffic: N_REQUESTS prompts, a shared 32-token prefix and
    seeded tails of 16-48 tokens."""
    rng = np.random.default_rng(SEED + 1)
    sysp = rng.integers(0, 256000, size=2 * BLOCK).tolist()
    return [sysp + rng.integers(0, 256000, size=int(n)).tolist()
            for n in rng.integers(16, 49, size=N_REQUESTS)]


def init_gemma(torch, dev):
    """Full-width gemma-7b, random weights from seed 0."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    cfg = get("gemma_7b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    print(f"  init gemma-7b full width: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return cfg, params


def build_engine(torch, dev, cfg=None, params=None, policy=None,
                 engine_kw=None, **ecfg_kw):
    """``TTQEngine`` on full-width gemma-7b (random weights, seed 0; or the
    given ones), by default int4 g32 packed weights through the kernels,
    int8 KV, 4 slots x 256; ``ecfg_kw`` adds to the ``EngineConfig`` and
    ``engine_kw`` (``draft_policy``, ``lowrank``) to the engine's own."""
    from repro_torch.core import KernelConfig, KVCacheConfig, ttq_policy
    from repro_torch.serving import EngineConfig, TTQEngine

    if params is None:
        cfg, params = init_gemma(torch, dev)
    if policy is None:
        policy = ttq_policy(bits=4, group_size=32, rank=0, packed=True,
                            kvcache=KVCacheConfig(dtype="int8"),
                            kernel=KernelConfig(use_pallas=True))
    ecfg = EngineConfig(**{**dict(max_slots=4, max_len=256, decode_chunk=0,
                                  guards=False), **ecfg_kw})
    return cfg, ecfg, TTQEngine(cfg, params, policy, ecfg, device=dev,
                                **(engine_kw or {}))


def serve(torch, eng, prompts):
    """Submit ``prompts`` (max_new=MAX_NEW), run them all; (outputs in
    order, wall seconds)."""
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    out = eng.run_all()
    torch.cuda.synchronize()
    return [out[r] for r in rids], time.perf_counter() - t0


def check_outputs(cfg, outs, what):
    check(all(len(o) == MAX_NEW and not o.unfinished for o in outs),
          f"{what}: not every request produced {MAX_NEW} tokens")
    check(all(0 <= t < cfg.vocab for o in outs for t in o),
          f"{what}: token out of the vocabulary")


def traced(torch, fn, top=0) -> dict:
    """One call of ``fn`` (a decode block) under ``torch.profiler``: wall
    ms, device ms and busy share (the device rows' summed time over the
    wall: kernels and copies, never the host ops that launched them),
    device launches, the host-side launch calls by API name, and the
    ``top`` device rows by time as (name, µs, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev = [e for e in rows if e.device_type == DeviceType.CUDA
           and getattr(e, "self_device_time_total", 0.0) > 0]
    host = {e.key: e.count for e in rows if e.device_type == DeviceType.CPU
            and HOST_LAUNCH.fullmatch(e.key)}
    dev_us = sum(e.self_device_time_total for e in dev)
    dev.sort(key=lambda e: -e.self_device_time_total)
    return dict(wall_ms=wall * 1e3, device_ms=dev_us / 1e3,
                busy=dev_us / 1e6 / wall,
                device_launches=sum(e.count for e in dev),
                host_launches=sum(host.values()), host_apis=host,
                top=[(e.key, e.self_device_time_total, e.count)
                     for e in dev[:top]])


def copy_tree(dst, src):
    """Copy tree ``src`` into tree ``dst`` of the same structure, in place."""
    if isinstance(dst, dict):
        for k in dst:
            copy_tree(dst[k], src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            copy_tree(d, s)
    else:
        dst.copy_(src)


def snapshot(torch, r):
    """Clones of what a decode block reads from runner ``r``: the eager
    loop's inputs (state, token, pos, done, remaining)."""
    return (clone_tree(torch, r.state), r.cur_tok.clone(), r.pos.clone(),
            r.done.clone(), r.remaining.clone())


def eager_block(torch, cfg, eng, params, snap, draft=None):
    """One eager ``lm.decode_many`` block on ``snap`` (its state is
    consumed), or with ``draft`` one ``lm.speculate_many`` block, with the
    runner's one transfer: the (B, 2C+1) host array."""
    from repro_torch.models import lm
    r = eng.runner
    kw = dict(K=r.K, max_len=eng.ecfg.max_len, eos_token=eng.ecfg.eos_token,
              kvcfg=eng.kvcfg, kcfg=eng.kncfg)
    if draft is None:
        (toks, valid), (_, _, _, done, _, _) = lm.decode_many(
            cfg, params, *snap, r.generator,
            temperature=eng.ecfg.temperature, **kw)
    else:
        (toks, valid), (_, _, _, done, _, _) = lm.speculate_many(
            cfg, draft, params, *snap, r.generator, W=r.W, **kw)
    return torch.cat([toks, valid.to(torch.int32),
                      done.to(torch.int32)[:, None]], dim=1).cpu().numpy()


def block_syncs_nothing(torch, cfg, eng, prompts):
    """Admit 4 prompts, then run one fused decode block on a copy of the
    live state eagerly, and one replay of the runner's graph, each under
    ``set_sync_debug_mode("error")``: neither may sync the host (the one
    transfer comes after the block).  Then one eager block on another
    copy and one graph block under ``torch.profiler`` (:func:`traced`).
    The runner's state is then put back as admission left it, for the
    checks that follow.  Returns (the runner, {"eager": ..., "graph": ...}),
    launches per step and per block."""
    from repro_torch.models import lm
    for p in prompts[:4]:
        eng.submit(p, max_new=MAX_NEW)
    eng.admit()
    r = eng.runner
    params = eng.decode_params
    admitted = snapshot(torch, r)

    def block():
        st, *args = snapshot(torch, r)
        return lambda: lm.decode_many(
            cfg, params, st, *args, None, K=r.K,
            max_len=eng.ecfg.max_len, kvcfg=eng.kvcfg, kcfg=eng.kncfg)
    programs = eng.compiled_programs
    run = block()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (toks, _), _ = run()
        out = r.block(params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(toks.shape == (4, r.K) and out.shape == (4, 2 * r.K + 1),
          f"decode_many tokens {tuple(toks.shape)}, replay {tuple(out.shape)}")
    check(eng.compiled_programs == programs, f"the replay captured a graph: "
          f"{programs} → {eng.compiled_programs}")
    res = {"eager": traced(torch, block()),
           "graph": traced(torch, lambda: r.decode_block(params))}
    for k, t in res.items():
        check(t["device_launches"] > 0, f"the profiler recorded no device "
              f"launch in the {k} block")
        t["device_launches_per_step"] = t["device_launches"] / r.K
        print(f"  traced {k} block (K = {r.K}): wall {t['wall_ms']:.2f} ms, "
              f"device {t['device_ms']:.2f} ms, busy {t['busy']:.1%}; "
              f"{t['device_launches_per_step']:.2f} device launches per "
              f"step; host launch calls per block {t['host_launches']} "
              f"{t['host_apis']}")
    for dst, src in zip((r.state, r.cur_tok, r.pos, r.done, r.remaining),
                        admitted):
        copy_tree(dst, src)
    return r, res


def tree_equal(torch, a, b) -> bool:
    """Trees of tensors equal leaf for leaf, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(tree_equal(torch, x, y)
                                        for x, y in zip(a, b))
    return torch.equal(a, b)


def kv_equal(torch, eng, a, b) -> bool:
    """Two decode states of ``eng`` equal bit for bit, except a paged pool's
    sink block 0: pad rows past each prompt and done lanes write there, in
    an unspecified order (its rows are never read unmasked)."""
    if not eng.runner.paged:
        return tree_equal(torch, a, b)
    return torch.equal(a["block_table"], b["block_table"]) and all(
        torch.equal(x[:, 1:], y[:, 1:])
        for ra, rb in zip(a["stack"], b["stack"])
        for u in ra for x, y in zip(ra[u].values(), rb[u].values()))


def graph_vs_eager(torch, cfg, eng, prompts):
    """Serve ``prompts`` with every decode block held to an eager
    ``lm.decode_many`` on clones of the state the block started from
    (tokens, valid and done flags bit for bit; requants land in the tree
    between blocks), and every admission that replays a prefill graph held
    to the eager prefill body on a clone of the state it started from
    (first tokens, statistics and every state leaf after the cache writes,
    bit for bit); each synced and timed: the graph run, then the eager one.
    Blocks and admissions that captured a graph (their warm run is the
    eager one) are counted apart.  Returns ms per decode step and per
    admission of each, counts and the outputs."""
    r = eng.runner
    real, real_admit = r.decode_block, r.admit_group
    t = {"graph": 0.0, "eager": 0.0, "blocks": 0, "capture_blocks": 0}
    p = {"graph": 0.0, "eager": 0.0, "replayed": 0, "captured": 0,
         "shapes": set()}

    def run(params, draft=None, small_chunk=False):
        snap = snapshot(torch, r)
        programs = r.compiled_programs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, valid, done, fault = real(params, draft, small_chunk)
        t1 = time.perf_counter()
        want = eager_block(torch, cfg, eng, params, snap,
                           draft if r.W > 0 else None)
        t2 = time.perf_counter()
        C = toks.shape[1]
        check(np.array_equal(toks, want[:, :C])
              and np.array_equal(valid, want[:, C:2 * C].astype(bool))
              and np.array_equal(done, want[:, 2 * C].astype(bool)),
              f"graph block {t['blocks'] + t['capture_blocks']}: tokens "
              f"differ from the eager loop's")
        if r.compiled_programs != programs:
            t["capture_blocks"] += 1
        else:
            t["blocks"] += 1
            t["graph"] += t1 - t0
            t["eager"] += t2 - t1
        return toks, valid, done, fault

    def admit(params, group):
        snap = clone_tree(torch, r.state)
        programs = r.compiled_programs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, fin, stats = real_admit(params, group)
        t1 = time.perf_counter()
        if r.compiled_programs != programs:
            p["captured"] += 1
            return first, fin, stats
        inp = {k: torch.from_numpy(v).to(r.device)
               for k, v in r._prefill_inputs(group).items()}
        want, want_stats = r._prefill(params, snap, inp, group.prefix_len,
                                      None)
        want = want.cpu().numpy()
        t2 = time.perf_counter()
        shape = (group.bucket, len(group.requests), group.prefix_len)
        same = (np.array_equal(first, want),
                tree_equal(torch, stats, want_stats),
                kv_equal(torch, eng, r.state, snap))
        check(all(same), f"prefill graph {shape}: (first tokens, statistics, "
              f"KV rows) equal to the eager prefill's: {same}")
        p["replayed"] += 1
        p["shapes"].add(shape)
        p["graph"] += t1 - t0
        p["eager"] += t2 - t1
        return first, fin, stats
    check(eng.ecfg.temperature == 0, "the shadowed run samples greedily")
    r.decode_block, r.admit_group = run, admit
    try:
        outs, _ = serve(torch, eng, prompts)
    finally:
        del r.decode_block, r.admit_group
    steps = max(t["blocks"], 1) * r.K
    adm = max(p["replayed"], 1)
    res = dict(graph_ms_per_step=t["graph"] * 1e3 / steps,
               eager_ms_per_step=t["eager"] * 1e3 / steps,
               graph_ms_per_block=t["graph"] * 1e3 / max(t["blocks"], 1),
               eager_ms_per_block=t["eager"] * 1e3 / max(t["blocks"], 1),
               blocks_timed=t["blocks"], capture_blocks=t["capture_blocks"],
               prefill_graph_ms=p["graph"] * 1e3 / adm,
               prefill_eager_ms=p["eager"] * 1e3 / adm,
               prefills_replayed=p["replayed"],
               prefills_captured=p["captured"],
               prefill_shapes=sorted(p["shapes"]))
    print(f"  every graph block equal to the eager loop's, bit for bit "
          f"({t['blocks']} replayed, {t['capture_blocks']} capturing); ms "
          f"per decode step over the replayed blocks: graph "
          f"{res['graph_ms_per_step']:.2f}, eager "
          f"{res['eager_ms_per_step']:.2f}")
    print(f"  every graph prefill equal to the eager prefill, bit for bit "
          f"(first tokens, stats, KV rows; paged: but the sink block's): "
          f"{p['replayed']} replayed, "
          f"{p['captured']} capturing, at (bucket, group, prefix) "
          f"{res['prefill_shapes']}; ms per admission (synced): graph "
          f"{res['prefill_graph_ms']:.2f}, eager "
          f"{res['prefill_eager_ms']:.2f}")
    return res, outs


def graph_phases(torch, cfg, eng, prompts, n_tok) -> dict:
    """The graph readings shared by [3] and [3b], after the cold run:
    decode and prefill graphs, capture times (prefill per shape) and peak
    memory, a warm rerun, and the shadowed run of :func:`graph_vs_eager`.
    A rerun adds no decode graph, and a prefill graph only for a shape the
    cold run could not have had: a tail past a prefix the cold run left in
    the paged pool's cache.  Where the warm run added such graphs, it is
    run once more and must add none; the shadowed run adds none."""
    r = eng.runner
    cold = eng.compiled_programs
    shapes = {k[0] for k in r._prefills}
    res = dict(compiled_programs_cold=cold,
               peak_gb_cold=torch.cuda.max_memory_allocated() / 1e9)
    res.update(warm_phases(torch, eng, prompts, n_tok))
    added = {k[0] for k in r._prefills} - shapes
    check(all(pfx > 0 for _, _, pfx in added),
          f"the warm run captured prefill shapes the cold run had: {added}")
    if added:
        res["warm_run_prefix_captures"] = sorted(added)
        warm = eng.compiled_programs
        res.update(warm_phases(torch, eng, prompts, n_tok))
        check(eng.compiled_programs == warm, f"a second warm run captured: "
              f"{warm} → {eng.compiled_programs}")
    res.update(compiled_programs_warm=eng.compiled_programs,
               decode_graphs=len(r._graphs), prefill_graphs=len(r._prefills),
               capture_s=r.capture_s,
               prefill_capture_s={str(k): v for k, v in
                                  r.prefill_capture_s.items()})
    check(eng.compiled_programs == 1 + len(r._prefills)
          and len(r._graphs) == 1,
          f"compiled programs {eng.compiled_programs}: {len(r._graphs)} "
          f"decode graphs (want 1) and {len(r._prefills)} prefill graphs")
    shadow, _ = graph_vs_eager(torch, cfg, eng, prompts)
    check(eng.compiled_programs == res["compiled_programs_warm"],
          f"the shadowed run captured: {res['compiled_programs_warm']} → "
          f"{eng.compiled_programs}")
    res.update(shadow)
    print(f"  captures: {len(r._graphs)} decode graph (warm block and capture "
          f"{res['capture_s']:.3f} s), {len(r._prefills)} prefill graphs "
          f"(warm admission and capture, s per (bucket, group, prefix): "
          + ", ".join(f"{k} {v:.3f}" for k, v in r.prefill_capture_s.items())
          + f"); compiled programs {cold} after the cold run, "
          f"{res['compiled_programs_warm']} after the warm run"
          + (f" (prefix-hit tails {sorted(added)} captured in the first warm "
             f"run; the numbers above are the second's)" if added else "")
          + f"; peak memory after the cold run {res['peak_gb_cold']:.2f} GB")
    return res


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


def warm_phases(torch, eng, prompts, n_tok):
    """A second, warm run of the same traffic with each phase timed (a
    synchronize around each call): where the wall time goes."""
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
    try:
        _, wall2 = serve(torch, eng, prompts)
    finally:
        del eng.runner.admit_group, eng.runner.decode_block, eng._requantize
    K = eng.ecfg.decode_chunk
    res = dict(warm_wall_s=wall2, warm_tok_per_s=n_tok / wall2,
               warm_phase_s=phase,
               decode_ms_per_step=phase["decode"] * 1e3 / (
                   N_REQUESTS // eng.ecfg.max_slots
                   * -(-(MAX_NEW - 1) // K) * K))
    print(f"  warm run: {n_tok / wall2:.1f} tok/s; phases (synced) "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phase.items())
          + f"; decode {res['decode_ms_per_step']:.2f} ms per step")
    return res


def requant_split(torch, eng):
    """One synced ``QuantizedModel.requantize()``: its wall time, and the
    device time of its ``ttq_quantize`` launches (CUDA events around each
    call of the wrapper) apart from the rest (D from the stats, 1/D, the
    Python around them)."""
    from repro_torch.kernels import ops
    saved, events = ops.ttq_quantize, []

    def timed(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = saved(*a, **kw)
        e.record()
        events.append((s, e))
        return out
    ops.ttq_quantize = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.qmodel.requantize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.ttq_quantize = saved
    check(len(events) == 7, f"a requant made {len(events)} ttq_quantize "
          f"calls, not 7")
    kern = sum(s.elapsed_time(e) for s, e in events) / 1e3
    qm = eng.qmodel
    stats, count = qm.session.as_calib()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = qm._plan.run(qm.params, stats, count)
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t0
    del fresh
    print(f"  requant (synced, landing in the captured tree): "
          f"{wall * 1e3:.1f} ms, of which ttq_quantize {kern * 1e3:.3f} ms on "
          f"the device (7 launches) and the rest {(wall - kern) * 1e3:.1f} "
          f"ms; the same requant into a fresh tree {fresh_s * 1e3:.1f} ms")
    return dict(requant_synced_s=wall, requant_kernel_s=kern,
                requant_rest_s=wall - kern, requant_fresh_tree_s=fresh_s)


def main_path(torch, dev, prompts, cfg, params):
    from repro_torch.kernels import build

    cfg, ecfg, eng = build_engine(torch, dev, cfg, params)
    build.reset_launches()
    outs, wall = serve(torch, eng, prompts)
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    check_outputs(cfg, outs, "dense main path")
    on_path = ("ttq_quantize", "ttq_gemm", "ttq_decode_attention")
    check(all(launches[k] > 0 for k in on_path),
          f"a kernel of the main path never launched: {launches}")
    res = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               requants=eng.n_requants, requant_dispatch_s=eng.requant_wall_s,
               host_syncs=eng.host_syncs,
               syncs_per_token=eng.host_syncs / n_tok, launches=launches,
               decode_chunk=eng.ecfg.decode_chunk,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  served {len(prompts)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.1f} tok/s; requants {eng.n_requants} (dispatch "
          f"{eng.requant_wall_s * 1e3:.1f} ms); host syncs {eng.host_syncs} "
          f"({res['syncs_per_token']:.4f}/token); launches {launches}")

    res.update(graph_phases(torch, cfg, eng, prompts, n_tok))

    res.update(requant_split(torch, eng))

    # fresh admission of 4 prompts: a live decode state to check against
    r, res["traced"] = block_syncs_nothing(torch, cfg, eng, prompts)
    res["device_launches_per_step"] = \
        res["traced"]["graph"]["device_launches_per_step"]

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
    return res, [list(o) for o in outs]


def paged_path(torch, dev, prompts, cfg, params, dense):
    """Phase 3b: the main path with a paged KV pool (block 16, default
    pool): the same tokens as the dense run, through the paged kernel."""
    from repro_torch.kernels import build

    torch.cuda.reset_peak_memory_stats()
    cfg, ecfg, eng = build_engine(torch, dev, cfg, params, kv_paged=True,
                                  kv_block_size=BLOCK)
    build.reset_launches()
    outs, wall = serve(torch, eng, prompts)
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    check_outputs(cfg, outs, "paged main path")
    on_path = ("ttq_quantize", "ttq_gemm", "ttq_paged_decode_attention")
    check(all(launches[k] > 0 for k in on_path)
          and launches["ttq_decode_attention"] == 0,
          f"paged path launches {launches}")
    check([list(o) for o in outs] == dense["outputs"],
          f"paged greedy tokens differ from the dense run's: leading tokens "
          f"equal per request "
          f"{[leading_equal(o, d) for o, d in zip(outs, dense['outputs'])]}")
    check(eng.host_syncs == dense["host_syncs"],
          f"host syncs {eng.host_syncs} vs dense {dense['host_syncs']}")
    res = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               num_blocks=eng.num_blocks, host_syncs=eng.host_syncs,
               syncs_per_token=eng.host_syncs / n_tok, launches=launches,
               requants=eng.n_requants, preemptions=eng.preemptions,
               kv_pool_utilization=eng.kv_pool_utilization)
    print(f"  served {len(prompts)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.1f} tok/s; greedy tokens equal to the dense run's; "
          f"{eng.num_blocks} blocks, pool use {eng.kv_pool_utilization:.3f}; "
          f"host syncs {eng.host_syncs}; launches {launches}")
    res.update(graph_phases(torch, cfg, eng, prompts, n_tok))
    eng.allocator.assert_quiescent()
    _, res["traced"] = block_syncs_nothing(torch, cfg, eng, prompts)
    res["device_launches_per_step"] = \
        res["traced"]["graph"]["device_launches_per_step"]
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  peak {res['peak_gb']:.2f} GB")
    return res


def leading_equal(a, b) -> int:
    """How many leading elements ``a`` and ``b`` share."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def prefix_and_preemption(torch, dev, cfg, params):
    """Phase 3c: full-precision weights (no calibration can move them
    between runs), int8 KV through the paged kernel, 8 prompts sharing a
    32-token prefix, a pool of POOL_3C blocks.  Checks preemption, prefix
    hits, a quiescent allocator and complete requests; then reads how many
    leading tokens each request shares with an unconstrained,
    prefix-cache-free run of the same traffic.  Tail prefill and re-prefill
    change GEMM shapes, and at 28 layers the random weights amplify any
    rounding change (phase 3's witness), so this is a reading, not a check;
    the same pair of runs on the first layer alone is its witness."""
    from repro_torch.core import KVCacheConfig, NO_QUANT
    from repro_torch.kernels import build
    from repro_torch.models.stack import layer_slice

    prompts = prefix_prompts()
    policy = NO_QUANT.with_(kvcache=KVCacheConfig(dtype="int8"))
    one = (dataclasses.replace(cfg, n_layers=1),
           dict(params, stack=[layer_slice(run, slice(0, 1))
                               for run in params["stack"]]))
    runs = {}
    for depth, (cfg_d, params_d) in ((cfg.n_layers, (cfg, params)), (1, one)):
        for name, kw in (("constrained", dict(kv_pool_blocks=POOL_3C)),
                         ("unconstrained", dict(prefix_cache=False))):
            _, _, eng = build_engine(torch, dev, cfg_d, params_d, policy,
                                     kv_paged=True, kv_block_size=BLOCK, **kw)
            build.reset_launches()
            outs, wall = serve(torch, eng, prompts)
            check_outputs(cfg, outs, f"3c {name}, {depth} layers")
            eng.allocator.assert_quiescent()
            key = f"{name}, {depth} layers"
            runs[key] = dict(outs=[list(o) for o in outs], wall_s=wall,
                             num_blocks=eng.num_blocks,
                             preemptions=eng.preemptions,
                             prefix_hits=eng.allocator.prefix_hits,
                             prefix_misses=eng.allocator.prefix_misses,
                             prefix_hit_rate=eng.prefix_hit_rate,
                             kv_pool_utilization=eng.kv_pool_utilization,
                             prefill_tokens=eng.prefill_tokens,
                             paged_launches=build.LAUNCHES[
                                 "ttq_paged_decode_attention"])
            print(f"  {key}: " + ", ".join(
                f"{k} {v}" for k, v in runs[key].items() if k != "outs"))
            del eng
        con = runs[f"constrained, {depth} layers"]
        check(con["preemptions"] > 0 and con["prefix_hit_rate"] > 0
              and con["paged_launches"] > 0,
              f"3c at {depth} layers: preemptions {con['preemptions']}, "
              f"prefix hit rate {con['prefix_hit_rate']}, paged launches "
              f"{con['paged_launches']}")
        agree = [leading_equal(a, b) for a, b in zip(
            con["outs"], runs[f"unconstrained, {depth} layers"]["outs"])]
        runs[f"leading tokens equal, {depth} layers"] = agree
        print(f"  {depth} layers: leading tokens equal to the unconstrained "
              f"run, per request: {agree} of {MAX_NEW}")
    _, _, eng = build_engine(torch, dev, cfg, params, policy, kv_paged=True,
                             kv_block_size=BLOCK, kv_pool_blocks=POOL_3C)
    shadow, outs = graph_vs_eager(torch, cfg, eng, prompts)
    check_outputs(cfg, outs, "3c constrained, shadowed")
    check(eng.preemptions > 0 and len(eng.runner._graphs) == 1
          and shadow["prefills_replayed"] > 0,
          f"3c shadowed: preemptions {eng.preemptions}, decode graphs "
          f"{len(eng.runner._graphs)}, prefill replays "
          f"{shadow['prefills_replayed']}")
    eng.allocator.assert_quiescent()
    runs["graph vs eager, constrained"] = shadow
    del eng
    # the schedule is host-only: the same at every depth
    sched = ("preemptions", "prefix_hits", "prefix_misses", "prefill_tokens")
    check(all(runs[f"constrained, {cfg.n_layers} layers"][k]
              == runs["constrained, 1 layers"][k] for k in sched),
          "3c: the schedule depends on the model's depth")
    for r in runs.values():
        if isinstance(r, dict):
            r.pop("outs", None)
    return runs


def svd_against_f64(torch, params):
    """(a) Layer 0 of each weight shape: the f32 factors before the cast
    (``lowrank.svd_top``) against a float64 SVD on the CPU.  ‖W − B·A‖_F
    must be within SVD_TOL (relative) of the Eckart-Young optimum √(Σ_{i>r}
    σ_i²), and the singular values of B·A within SVD_TOL of the top r.
    Random weights have a nearly flat spectrum, so the top-r subspace itself
    is ill-determined and B·A is not compared element by element.  Returns
    each shape's SVD time (synced) and both errors."""
    from repro_torch.core.lowrank import svd_top
    out = {}
    for name, (grp, leaf) in (("wq/wk/wv", ("mix", "wq")),
                              ("wo", ("mix", "wo")), ("wg/wu", ("mlp", "wg")),
                              ("wd", ("mlp", "wd"))):
        W = params["stack"][0]["u0"][grp][leaf][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        B, A = svd_top(W, RANK_3D)
        torch.cuda.synchronize()
        svd_s = time.perf_counter() - t0
        s = torch.linalg.svdvals(W.double().cpu())
        opt = float(s[RANK_3D:].square().sum().sqrt())
        res = float((W.double() - B.double() @ A.double()).norm())
        _, Rb = torch.linalg.qr(B.double())
        _, Ra = torch.linalg.qr(A.double().T)
        sv = torch.linalg.svdvals(Rb @ Ra.T).cpu()
        e_res = abs(res - opt) / opt
        e_sv = float(((sv - s[:RANK_3D]).abs() / s[:RANK_3D]).max())
        out[name] = dict(shape=list(W.shape), svd_s=svd_s, resid_rel=e_res,
                         sigma_rel=e_sv)
        print(f"  (a) {name} {tuple(W.shape)}: top-{RANK_3D} SVD {svd_s:.3f} s; "
              f"‖W − BA‖_F {res:.6f} against the optimum {opt:.6f} (rel "
              f"{e_res:.2e}); singular values of BA rel {e_sv:.2e} from a "
              f"float64 CPU SVD's")
        check(e_res <= SVD_TOL and e_sv <= SVD_TOL,
              f"{name}: SVD factors off the float64 SVD (residual {e_res:.2e},"
              f" singular values {e_sv:.2e}, bound {SVD_TOL})")
    return out


def residual_quantize_checked(torch, eng) -> dict:
    """(b) ``ttq_quantize`` on the f32 residual W − B·A of every stack (D
    from the session's statistics, as the requant forms them) against its
    plain version: the dequantized weights differ by at most 0."""
    from repro_torch.core.lowrank import residual
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.api import _tree_get
    qm = eng.qmodel
    plan = qm._plan
    stats, count = qm.session.as_calib()
    out = {}
    for members in plan.families.values():
        for m in members:
            ba = _tree_get(qm.lowrank_tree, m.path)
            R = residual(_tree_get(qm.params, m.path), ba["B"], ba["A"])
            D = m.eff.quantizer.diag(plan._stat(stats, m).reshape(-1, m.d),
                                     count, m.eff.acfg, m.d)
            off, sz, err = quant_mismatch(
                torch, ops.ttq_quantize(R, D, bits=4, group_size=32),
                ref.ttq_quantize_ref(R, D, bits=4, group_size=32), m.d, 4)
            out[m.path_str] = dict(codes_differ=off, sz_equal=sz,
                                   max_abs_err=err)
            check(err == 0.0, f"{m.path_str}: ttq_quantize on the residual "
                  f"differs from its plain version by {err} ({off} codes)")
            del R
    print(f"  (b) ttq_quantize on the residual of every stack ({len(out)}): "
          f"dequantized weights equal to the plain version's (max |diff| "
          f"{max(v['max_abs_err'] for v in out.values())}; codes differing "
          f"{sum(v['codes_differ'] for v in out.values())})")
    return out


def recorded(eng, swaps=None):
    """Wrap ``eng``'s block count, its model's readiness check and its
    requants: the blocks before which the pending tree was swapped in are
    recorded (``swaps`` None), or forced to be exactly ``swaps``; and each
    requant's (layers requantized, layers skipped).  Undo with
    :func:`unrecorded`."""
    r, qm = eng.runner, eng.qmodel
    n = {"blocks": 0}
    log, per = [], []
    real_block, real_ready, real_rq = r.decode_block, qm._ready, eng._requantize

    def block(*a, **kw):
        out = real_block(*a, **kw)
        n["blocks"] += 1
        return out

    def ready():
        ok = real_ready() if swaps is None else n["blocks"] in swaps
        if ok:
            log.append(n["blocks"])
        return ok

    def rq():
        real_rq()
        per.append((qm.last_requant_layers, qm.last_skipped_layers))
    r.decode_block, qm._ready, eng._requantize = block, ready, rq
    return log, per


def unrecorded(eng):
    del eng.runner.decode_block, eng.qmodel._ready, eng._requantize


def requant_wall(torch, eng, threshold) -> dict:
    """One synced ``requantize(threshold=)`` of the double-buffered model:
    its wall time and its ``ttq_quantize`` launches' device time (events on
    the stream each launch runs on)."""
    from repro_torch.kernels import ops
    saved, events = ops.ttq_quantize, []

    def timed(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = saved(*a, **kw)
        e.record()
        events.append((s, e))
        return out
    qm = eng.qmodel
    ops.ttq_quantize = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qm.requantize(threshold=threshold)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.ttq_quantize = saved
    kern = sum(s.elapsed_time(e) for s, e in events) / 1e3
    return dict(wall_s=wall, kernel_s=kern, launches=len(events),
                requantized=qm.last_requant_layers,
                skipped=qm.last_skipped_layers)


def default_policy(torch, dev, cfg, params, base) -> dict:
    """Phase 3d: the reference's default serving policy, ttq_policy(bits=4,
    group_size=32, rank=16, packed=True) with the delta gate and the double
    buffer, at full width and DEPTH_3D layers, on [3]'s traffic.  Checks
    (a) the factors against a float64 SVD, (b) the residual's quantization
    against its plain version, (c) the double-buffered run's tokens against
    a rerun that forces each swap at the block where the first run saw it,
    (d) layers requantized and skipped per requant, (e) compiled programs
    flat after the cold run.  Times the factors, decode (beside rank 0 at
    the same depth and [3]) and a synced requant with and without the
    gate."""
    from repro_torch.core import KernelConfig, KVCacheConfig, ttq_policy
    from repro_torch.kernels import build
    from repro_torch.models.stack import layer_slice

    res = {"svd": svd_against_f64(torch, params)}
    cfg_d = dataclasses.replace(cfg, n_layers=DEPTH_3D)
    params_d = dict(params, stack=[layer_slice(run, slice(0, DEPTH_3D))
                                   for run in params["stack"]])
    policy = ttq_policy(bits=4, group_size=32, rank=RANK_3D, packed=True,
                        kvcache=KVCacheConfig(dtype="int8"),
                        kernel=KernelConfig(use_pallas=True))
    kw = dict(requant_threshold=THRESHOLD_3D, double_buffer=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, eng = build_engine(torch, dev, cfg_d, params_d, policy, **kw)
    torch.cuda.synchronize()
    res["factor_s"] = time.perf_counter() - t0
    print(f"  factors: {7 * DEPTH_3D} top-{RANK_3D} SVDs at engine "
          f"construction, {res['factor_s']:.1f} s")
    prompts = make_prompts()
    build.reset_launches()
    swaps, per = recorded(eng)
    outs, wall = serve(torch, eng, prompts)
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    check_outputs(cfg, outs, "3d")
    on_path = ("ttq_quantize", "ttq_gemm", "ttq_decode_attention")
    check(all(launches[k] > 0 for k in on_path),
          f"3d: a kernel of the path never launched: {launches}")
    res.update(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               launches=launches, requants=eng.n_requants,
               swap_blocks=list(swaps), requant_layers=[list(x) for x in per])
    print(f"  cold run: {n_tok} tokens in {wall:.2f} s ({n_tok / wall:.1f} "
          f"tok/s); requants {eng.n_requants}; the pending tree swapped in "
          f"before blocks {swaps}; launches {launches}")
    # (d) every requant covers the 7 stacks; the first quantizes them all
    check(len(per) == eng.n_requants >= 2 and per[0] == (7, 0)
          and all(a + b == 7 for a, b in per),
          f"3d: layers (requantized, skipped) per requant {per}")
    print(f"  (d) layers (requantized, skipped) per requant: {per}; "
          f"{eng.layers_requantized} requantized, {eng.layers_skipped} "
          f"skipped in all")
    check(len(swaps) >= 1, "3d: the double buffer never swapped")
    cold = eng.compiled_programs
    # (c) a rerun forcing the recorded swaps: the same tokens, bit for bit
    factors = eng.lowrank_tree                            # no second SVD
    _, _, again = build_engine(torch, dev, cfg_d, params_d, policy,
                               dict(lowrank=factors), **kw)
    forced, per2 = recorded(again, set(swaps))
    outs2, _ = serve(torch, again, prompts)
    check([list(o) for o in outs2] == [list(o) for o in outs]
          and forced == swaps and per2 == per,
          f"3d: the rerun forcing swaps {swaps} (got {forced}, requants "
          f"{per2}) emitted other tokens: leading tokens equal per request "
          f"{[leading_equal(a, b) for a, b in zip(outs2, outs)]}")
    print(f"  (c) double-buffered tokens equal, bit for bit, to a rerun that "
          f"forces each swap at the recorded block ({len(swaps)} swaps)")
    del again
    res["residual_quantize"] = residual_quantize_checked(torch, eng)
    # (e) and the readings: a warm rerun adds no program
    unrecorded(eng)
    res.update(warm_phases(torch, eng, prompts, n_tok))
    r = eng.runner
    res.update(compiled_programs_cold=cold,
               compiled_programs_warm=eng.compiled_programs,
               decode_graphs=len(r._graphs), prefill_graphs=len(r._prefills))
    check(eng.compiled_programs == cold and len(r._graphs) == 2,
          f"3d: compiled programs {cold} after the cold run, "
          f"{eng.compiled_programs} after the warm run; decode graphs "
          f"{len(r._graphs)} (want 2, one per tree)")
    print(f"  (e) compiled programs {cold} after the cold run and "
          f"{eng.compiled_programs} after the warm run: {len(r._graphs)} "
          f"decode graphs (one per tree), {len(r._prefills)} prefill graphs")
    res["requant_gated"] = requant_wall(torch, eng, THRESHOLD_3D)
    res["requant_full"] = requant_wall(torch, eng, 0.0)
    for k in ("requant_gated", "requant_full"):
        q = res[k]
        print(f"  synced requant, threshold "
              f"{THRESHOLD_3D if k == 'requant_gated' else 0.0}: "
              f"{q['wall_s'] * 1e3:.1f} ms wall, ttq_quantize "
              f"{q['kernel_s'] * 1e3:.3f} ms on the device ({q['launches']} "
              f"launches); layers requantized {q['requantized']}, skipped "
              f"{q['skipped']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _, _, flat = build_engine(torch, dev, cfg_d, params_d)
    o0, _ = serve(torch, flat, prompts)
    check_outputs(cfg, o0, "3d rank-0 baseline")
    res["rank0_same_depth"] = warm_phases(torch, flat, prompts, n_tok)
    print(f"  ms per decode step (warm, synced): rank {RANK_3D} with gate and "
          f"double buffer {res['decode_ms_per_step']:.2f} at {DEPTH_3D} "
          f"layers; rank 0 at {DEPTH_3D} layers "
          f"{res['rank0_same_depth']['decode_ms_per_step']:.2f}; [3] (rank 0, "
          f"{cfg.n_layers} layers) {base['decode_ms_per_step']:.2f}")
    del flat
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res, factors


# ------------------------------------------------------------- phase 3e

def cut(cfg, params, depth):
    """The first ``depth`` layers of the model (views, no copies)."""
    from repro_torch.models.stack import layer_slice
    return (dataclasses.replace(cfg, n_layers=depth),
            dict(params, stack=[layer_slice(run, slice(0, depth))
                                for run in params["stack"]]))


def clone_qt_tree(torch, tree):
    """A copy of a parameter tree with new storage for every field a
    requant writes (full-precision leaves and low-rank factors shared)."""
    from repro_torch.core.ttq import QuantizedTensor
    if isinstance(tree, dict):
        return {k: clone_qt_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_qt_tree(torch, v) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, **{
            f: getattr(tree, f).clone() for f in ("wint", "packed", "scale",
                                                  "zero", "dinv")
            if getattr(tree, f) is not None})
    return tree


def qt_tree_equal(torch, a, b) -> bool:
    from repro_torch.core.ttq import QuantizedTensor
    if isinstance(a, dict):
        return all(qt_tree_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, list):
        return all(qt_tree_equal(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, QuantizedTensor):
        return all((getattr(a, f) is None) == (getattr(b, f) is None)
                   and (getattr(a, f) is None
                        or torch.equal(getattr(a, f), getattr(b, f)))
                   for f in ("packed", "wint", "scale", "zero", "dinv"))
    return a is b or torch.equal(a, b)


def first_tree(torch, eng):
    """Record what the verify tree was until its first change: a clone of
    the tree of the first requant, and each request's tokens emitted before
    the second requant (until then every block read the first tree).
    Returns the record; ``before`` stays None if no second requant came."""
    rec = {"tree": None, "before": None}
    real, sch = eng._requantize, eng.scheduler

    def rq():
        if rec["tree"] is not None and rec["before"] is None:
            rec["before"] = {rid: len(q.out)
                             for rid, q in sch.finished.items()}
            rec["before"].update({q.rid: len(q.out) for q in sch.slot_req
                                  if q is not None})
        real()
        if rec["tree"] is None and eng.qmodel.qparams is not None:
            rec["tree"] = clone_qt_tree(torch, eng.qmodel.qparams)
    eng._requantize = rq
    return rec


def near_tie(torch, cfg, fp, tree, kvcfg, kcfg, prompts, i, t, a, b,
             drafts):
    """At request ``i``'s first disagreement (index ``t`` of its output; the
    runs chose ``a`` and ``b``), recompute its logits eagerly for the agreed
    prefix ``drafts[:t]`` two ways on ``tree``: one ``decode_step`` after the
    prefill and the decode of the prefix, and one ``verify_window`` from the
    same state (the window the agreed token and the next W of ``drafts``).
    At t = 0, the prompt's prefill alone and in the batch of every prompt.
    Returns (|logit a − logit b| in the decode logits, the largest |Δlogit|
    between the two sets)."""
    from repro_torch.models import lm
    dev = fp["embed"].device
    P = len(prompts[i])
    ML = 256
    if t == 0:
        lg1, _, _ = lm.prefill(cfg, fp, {"tokens": torch.tensor(
            [prompts[i]], device=dev)}, ML, collect_stats=False, kvcfg=kvcfg)
        toks = torch.zeros((len(prompts), 64), dtype=torch.long, device=dev)
        for j, p in enumerate(prompts):
            toks[j, :len(p)] = torch.tensor(p)
        lgb, _, _ = lm.prefill(cfg, fp, {"tokens": toks}, ML,
                               collect_stats=False, full_logits=True,
                               kvcfg=kvcfg)
        L_d, L_v = lg1[0], lgb[i, P - 1]
    else:
        _, st, _ = lm.prefill(cfg, fp, {"tokens": torch.tensor(
            [prompts[i]], device=dev)}, ML, collect_stats=False, kvcfg=kvcfg)
        tok = lambda x: torch.tensor([[x]], dtype=torch.int32, device=dev)
        at = lambda p: torch.tensor([p], dtype=torch.int32, device=dev)
        for j in range(t - 1):
            lm.decode_step(cfg, tree, st, tok(drafts[j]), at(P + j),
                           kvcfg=kvcfg, kcfg=kcfg)
        st_v = clone_tree(torch, st)
        L_d, _ = lm.decode_step(cfg, tree, st, tok(drafts[t - 1]),
                                at(P + t - 1), kvcfg=kvcfg, kcfg=kcfg)
        win = (list(drafts[t - 1:t + SPEC_W]) + [drafts[-1]] * SPEC_W)[
            :SPEC_W + 1]
        L_v, _ = lm.verify_window(cfg, tree, st_v, torch.tensor(
            [win], dtype=torch.int32, device=dev), at(P + t - 1),
            kvcfg=kvcfg, kcfg=kcfg)
        L_d, L_v = L_d[0], L_v[0, 0]
    return float((L_d[a] - L_d[b]).abs()), float((L_d - L_v).abs().max())


def spec_readings(torch, eng, label):
    """After a speculative run: one traced speculative replay (device
    launches per block, busy share), and one synced requant with each
    ``ttq_quantize`` launch timed by CUDA events, split into the verify and
    the draft tree's."""
    from repro_torch.kernels import ops
    r, qm = eng.runner, eng.qmodel
    params, draft = eng.decode_params, eng.draft_params
    r.block(params, draft)          # captures if a swap left a new pair
    programs = eng.compiled_programs
    tr = traced(torch, lambda: r.decode_block(params, draft))
    check(eng.compiled_programs == programs and tr["device_launches"] > 0,
          f"{label}: the traced block captured, or launched nothing")
    saved_q, saved_w, events = ops.ttq_quantize, qm._write, []
    tree = {"now": None}

    def timed(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = saved_q(*a, **kw)
        e.record()
        events.append((tree["now"], s, e))
        return out

    def write(t, *a, **kw):
        tree["now"] = "draft" if t is qm._d else "verify"
        return saved_w(t, *a, **kw)
    ops.ttq_quantize, qm._write = timed, write
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qm.requantize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.ttq_quantize = saved_q
        del qm._write
    split = {k: (sum(s.elapsed_time(e) for w, s, e in events if w == k),
                 sum(1 for w, *_ in events if w == k))
             for k in ("verify", "draft")}
    check(split["draft"][1] > 0, f"{label}: the draft requant launched no "
          f"ttq_quantize")
    print(f"  {label} traced speculative block: wall {tr['wall_ms']:.2f} ms, "
          f"device {tr['device_ms']:.2f} ms, busy {tr['busy']:.1%}, "
          f"{tr['device_launches']} device launches per block, host launch "
          f"calls {tr['host_launches']} {tr['host_apis']}; synced requant "
          f"{wall * 1e3:.1f} ms: ttq_quantize verify tree "
          f"{split['verify'][0]:.3f} ms ({split['verify'][1]} launches), "
          f"draft tree {split['draft'][0]:.3f} ms ({split['draft'][1]} "
          f"launches) on the device")
    return dict(traced=tr, requant_synced_ms=wall * 1e3,
                draft_quantize_ms=split["draft"][0],
                draft_quantize_launches=split["draft"][1],
                verify_quantize_ms=split["verify"][0],
                verify_quantize_launches=split["verify"][1])


def spec_case(torch, dev, cfg, params, policy, label, prompts, *,
              engine_kw=None, nonspec=True, tree_one=False, **ecfg_kw):
    """One speculative configuration, ``speculate_k=SPEC_W``: a cold run
    (launches, ``ttq_gemm`` rows per call, the draft tree's quantize
    launches, acceptance, captures), a warm rerun (tokens/s; no program
    added), a shadowed run holding every speculative graph block to an
    eager ``speculate_many`` on clones of its starting state, the readings
    of :func:`spec_readings`; then, with ``nonspec``, the same engine with
    ``speculate_k=0`` (cold and warm) and the leading tokens the two share
    per request.  Returns the readings and the outputs of both."""
    from repro_torch.kernels import build, ops
    torch.cuda.reset_peak_memory_stats()
    _, _, eng = build_engine(torch, dev, cfg, params, policy, engine_kw,
                             speculate_k=SPEC_W, **ecfg_kw)
    rec = first_tree(torch, eng) if tree_one else None
    rows, saved_g = set(), ops.ttq_gemm

    def gemm(x, *a, **kw):
        rows.add(x.numel() // x.shape[-1])
        return saved_g(x, *a, **kw)
    build.reset_launches()
    ops.ttq_gemm = gemm
    try:
        outs, wall = serve(torch, eng, prompts)
    finally:
        ops.ttq_gemm = saved_g
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    check_outputs(cfg, outs, label)
    r = eng.runner
    res = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               launches=launches, gemm_rows=sorted(rows),
               windows=eng.spec_windows, drafted=r.spec_drafted,
               accepted=r.spec_accepted,
               acceptance_rate=eng.spec_acceptance_rate,
               decode_chunk=eng.ecfg.decode_chunk, requants=eng.n_requants,
               host_syncs=eng.host_syncs, capture_s=r.capture_s,
               spec_graphs=len(r._graphs),
               compiled_programs_cold=eng.compiled_programs,
               peak_gb_cold=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  {label} cold run: {n_tok} tokens in {wall:.2f} s; acceptance "
          f"{eng.spec_acceptance_rate:.3f} ({r.spec_accepted} of "
          f"{r.spec_drafted} drafts, {eng.spec_windows} windows, "
          f"{eng.ecfg.decode_chunk} windows per block); ttq_gemm rows per "
          f"call {sorted(rows)}; launches {launches}; {len(r._graphs)} "
          f"speculative graphs (warm block and capture {r.capture_s:.3f} s), "
          f"compiled programs {eng.compiled_programs}; peak "
          f"{res['peak_gb_cold']:.2f} GB")
    # a warm rerun adds no speculative graph, and a prefill graph only for
    # a tail past a prefix the cold run left in the paged pool's cache (as
    # in graph_phases); where it added one, the next rerun adds nothing
    cold, n_graphs = eng.compiled_programs, len(r._graphs)
    shapes = {k[0] for k in r._prefills}
    res["warm"] = warm_phases(torch, eng, prompts, n_tok)
    added = {k[0] for k in r._prefills} - shapes
    check(len(r._graphs) == n_graphs and all(pfx > 0 for *_, pfx in added),
          f"{label}: the warm run captured speculative graphs "
          f"({n_graphs} → {len(r._graphs)}) or prefill shapes the cold run "
          f"had {added}")
    if added:
        res["warm_run_prefix_captures"] = sorted(added)
        cold = eng.compiled_programs
        res["warm"] = warm_phases(torch, eng, prompts, n_tok)
    check(eng.compiled_programs == cold, f"{label}: the warm run captured: "
          f"{cold} → {eng.compiled_programs}")
    shadow, _ = graph_vs_eager(torch, cfg, eng, prompts)
    check(eng.compiled_programs == cold and shadow["blocks_timed"] > 0,
          f"{label}: the shadowed run captured, or replayed no block")
    res["shadow"] = shadow
    print(f"  {label}: every speculative graph block ({shadow['blocks_timed']}"
          f" replayed) equal to an eager speculate_many, bit for bit; ms per "
          f"speculative block: graph {shadow['graph_ms_per_block']:.2f}, "
          f"eager {shadow['eager_ms_per_block']:.2f}")
    res.update(spec_readings(torch, eng, label))
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out = dict(spec=[list(o) for o in outs], tree=None if rec is None
               else rec, fp=eng.params, kvcfg=eng.kvcfg, kcfg=eng.kncfg)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if not nonspec:
        return res, out
    _, _, base = build_engine(torch, dev, cfg, params, policy, engine_kw,
                              **ecfg_kw)
    rec0 = first_tree(torch, base) if tree_one else None
    outs0, wall0 = serve(torch, base, prompts)
    check_outputs(cfg, outs0, label + " non-speculative")
    res["nonspec_tok_per_s"] = n_tok / wall0
    res["nonspec_warm"] = warm_phases(torch, base, prompts, n_tok)
    out["nonspec"], out["tree0"] = [list(o) for o in outs0], rec0
    agree = [leading_equal(a, b) for a, b in zip(out["spec"], out["nonspec"])]
    res["leading_equal"] = agree
    print(f"  {label} warm tokens/s: speculative "
          f"{res['warm']['warm_tok_per_s']:.1f}, non-speculative "
          f"{res['nonspec_warm']['warm_tok_per_s']:.1f}; leading tokens equal "
          f"to the non-speculative run, per request: {agree} of {MAX_NEW}")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return res, out


def near_ties(torch, cfg, out, prompts, label, tree_one) -> list:
    """Hold each request's first disagreement between the speculative and
    the non-speculative run to :func:`near_tie`: its two tokens' logits
    differ by no more than the recomputed decode and verify logits do.
    With ``tree_one`` (a quantized verify tree that requants as requests
    arrive) a disagreement is held only where both runs decoded the whole
    prefix on their first tree, which must be bit for bit the same in both;
    past it the two schedules read different trees and it is printed as
    such."""
    rows = []
    tree = out["fp"]
    if tree_one:
        r1, r0 = out["tree"], out["tree0"]
        check(r1["tree"] is not None and qt_tree_equal(torch, r1["tree"],
                                                       r0["tree"]),
              f"{label}: the first verify trees of the two runs differ")
        tree = r1["tree"]
    for i, (a, b) in enumerate(zip(out["nonspec"], out["spec"])):
        t = leading_equal(a, b)
        if t == len(a):
            continue
        if tree_one:
            # tokens before the second requant (index 0 is the prefill's)
            lim = min(len(a) if rec["before"] is None
                      else rec["before"].get(i, 1) for rec in (r1, r0))
            if t >= lim:
                rows.append(dict(request=i, t=t, held=False, first_tree=lim))
                print(f"  {label} request {i}: first disagreement at token "
                      f"{t}, after the verify tree changed (token {lim}): "
                      f"the schedules read different trees there, not held")
                continue
        margin, delta = near_tie(torch, cfg, out["fp"], tree, out["kvcfg"],
                                 out["kcfg"], prompts, i, t, a[t], b[t], b)
        rows.append(dict(request=i, t=t, held=True, margin=margin,
                         delta=delta))
        print(f"  {label} request {i}: first disagreement at token {t} "
              f"({a[t]} vs {b[t]}): their logits differ by {margin:.4g}, the "
              f"recomputed decode and verify logits by up to {delta:.4g}")
        check(margin <= delta, f"{label} request {i}: the disagreement at "
              f"token {t} is no near-tie ({margin} > {delta})")
    return rows


def speculation(torch, dev, cfg, params, factors) -> dict:
    """Phase 3e: self-speculative decoding, W = SPEC_W, at full width.
    (a) the reference's default policy (rank 16 with [3d]'s factors, gate,
    double buffer) on DEPTH_3D layers with its default int4 rank-0 draft;
    (b) draft-only, bf16 weights with an int4 g32 draft, at full depth on
    the dense slab and on the paged pool (block 16); (c) (b) on the first
    layer alone, the witness that rounding is not amplified there.
    Each through :func:`spec_case`; then the kernel checks over the path."""
    from repro_torch.core import KernelConfig, KVCacheConfig, NO_QUANT
    from repro_torch.core import ttq_policy
    t0 = time.perf_counter()
    prompts = make_prompts()
    kern, kv8 = KernelConfig(use_pallas=True), KVCacheConfig(dtype="int8")
    res, outs = {}, {}
    cfg_d, params_d = cut(cfg, params, DEPTH_3D)
    pol_a = ttq_policy(bits=4, group_size=32, rank=RANK_3D, packed=True,
                       kvcache=kv8, kernel=kern)
    res["a"], outs["a"] = spec_case(
        torch, dev, cfg_d, params_d, pol_a, "(a)", prompts,
        engine_kw=dict(lowrank=factors), tree_one=True,
        requant_threshold=THRESHOLD_3D, double_buffer=True)
    check(res["a"]["gemm_rows"] == [4, 4 * (SPEC_W + 1)],
          f"(a): ttq_gemm ran at rows {res['a']['gemm_rows']}, not at the "
          f"draft's 4 and the verify window's {4 * (SPEC_W + 1)}")
    res["a"]["near_ties"] = near_ties(torch, cfg_d, outs["a"], prompts,
                                      "(a)", True)
    del outs["a"]                   # the first trees' clones
    gc.collect()
    torch.cuda.empty_cache()
    pol_b = NO_QUANT.with_(kvcache=kv8, kernel=kern)
    draft = dict(draft_policy=ttq_policy(bits=4, group_size=32, rank=0,
                                         packed=True, kvcache=kv8,
                                         kernel=kern))
    res["b"], outs["b"] = spec_case(torch, dev, cfg, params, pol_b,
                                    "(b) dense", prompts, engine_kw=draft)
    res["b"]["near_ties"] = near_ties(torch, cfg, outs["b"], prompts,
                                      "(b) dense", False)
    res["b paged"], outs["b paged"] = spec_case(
        torch, dev, cfg, params, pol_b, "(b) paged", prompts,
        engine_kw=draft, nonspec=False, kv_paged=True, kv_block_size=BLOCK)
    check(outs["b paged"]["spec"] == outs["b"]["spec"],
          f"(b): paged tokens differ from the dense run's: leading tokens "
          f"equal per request {[leading_equal(a, b) for a, b in zip(outs['b paged']['spec'], outs['b']['spec'])]}")
    print("  (b) paged tokens equal to the dense run's, bit for bit")
    cfg_1, params_1 = cut(cfg, params, 1)
    res["c"], outs["c"] = spec_case(torch, dev, cfg_1, params_1, pol_b,
                                    "(c)", prompts, engine_kw=draft)
    # one layer amplifies no rounding, yet the logits are bf16 and 256000
    # wide, so exact ties are common and any rounding change of either
    # path can break one the other way: each first disagreement is held to
    # the near-tie check, like (a)'s and (b)'s
    res["c"]["near_ties"] = near_ties(torch, cfg_1, outs["c"], prompts,
                                      "(c)", False)
    agree = res["c"]["leading_equal"]
    print(f"  (c) one layer: {sum(agree)} of {MAX_NEW * len(agree)} tokens "
          f"before the requests' first disagreements, each a near-tie")
    # the four kernels on the speculative path
    la, lb, lp = (res[k]["launches"] for k in ("a", "b", "b paged"))
    check(la["ttq_gemm"] > 0 and la["ttq_decode_attention"] > 0
          and la["ttq_quantize"] > 0 and lb["ttq_decode_attention"] > 0
          and lp["ttq_paged_decode_attention"] > 0
          and lp["ttq_decode_attention"] == 0
          and res["a"]["draft_quantize_launches"] > 0
          and res["b"]["draft_quantize_launches"] > 0,
          f"a kernel of the speculative path never launched: (a) {la}, (b) "
          f"{lb}, paged {lp}")
    res["wall_s"] = time.perf_counter() - t0
    print(f"  [3e] wall {res['wall_s']:.1f} s")
    return res


# --------------------------------------------------------------- phase 3f

def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def guarded(torch, dev, cfg, params, faults=None, **ecfg_kw):
    """[3]'s engine with the default guards (and ``faults``)."""
    return build_engine(torch, dev, cfg, params, guards=True,
                        engine_kw=dict(faults=faults), **ecfg_kw)[2]


def fixed_tree(eng, prompts):
    """Admit ``prompts`` and requantize once: with ``recalibrate_every``
    at NEVER the engine decodes on that tree for the rest of its life."""
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    eng.admit()
    eng._requantize()
    return rids


def synced_requant(torch, eng) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._requantize()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def guards_on_off(torch, dev, cfg, params, prompts) -> tuple:
    """(a) [3]'s traffic and policy, the default guards against
    guards=False: greedy tokens bit for bit equal and the same host syncs
    (one per block and admission group); warm runs in turns (off, on, on,
    off) for ms per decode step; each engine's synced requant (the gated
    one writes the spare tree, validates it and swaps); the spare's
    one-time clone; decode graphs and peak memory."""
    from repro_torch.quant.model import _clone_written
    engs, res = {}, {}
    for name in ("off", "on"):
        free(torch)
        before = torch.cuda.memory_allocated()
        eng = (guarded(torch, dev, cfg, params) if name == "on" else
               build_engine(torch, dev, cfg, params)[2])
        outs, wall = serve(torch, eng, prompts)
        check_outputs(cfg, outs, f"[3f] (a) guards {name}")
        engs[name] = eng
        free(torch)
        res[name] = dict(outputs=[list(o) for o in outs], cold_s=wall,
                         host_syncs=eng.host_syncs,
                         held_gb=(torch.cuda.memory_allocated() - before)
                         / 1e9)
    check(res["on"]["outputs"] == res["off"]["outputs"],
          "[3f] (a): guarded tokens differ from the unguarded run's: "
          + str([leading_equal(a, b) for a, b in zip(
              res["on"]["outputs"], res["off"]["outputs"])]))
    check(res["on"]["host_syncs"] == res["off"]["host_syncs"],
          f"[3f] (a): host syncs {res['on']['host_syncs']} guarded vs "
          f"{res['off']['host_syncs']}")
    n_tok = sum(len(o) for o in res["on"]["outputs"])
    ms = {"on": [], "off": []}
    for name in ("off", "on", "on", "off"):
        ms[name].append(warm_phases(torch, engs[name], prompts,
                                    n_tok)["decode_ms_per_step"])
    rq = {k: [synced_requant(torch, engs[k]) for _ in range(2)]
          for k in ("off", "on")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spare = _clone_written(engs["on"].qparams)
    torch.cuda.synchronize()
    clone_s = time.perf_counter() - t0
    del spare
    graphs = {k: len(e.runner._graphs) for k, e in engs.items()}
    check(graphs == {"off": 1, "on": 2}, f"[3f] (a) decode graphs {graphs}: "
          f"want 1 unguarded, 2 guarded (its two alternating trees)")
    step = {k: statistics.mean(v) for k, v in ms.items()}
    out = dict(ms_per_step=ms, guard_cost=step["on"] / step["off"] - 1.0,
               requant_s=rq, spare_clone_s=clone_s, decode_graphs=graphs,
               host_syncs=res["on"]["host_syncs"],
               held_gb={k: v["held_gb"] for k, v in res.items()})
    print(f"  (a) guards on vs off: tokens bit for bit equal, host syncs "
          f"{res['on']['host_syncs']} each (one per block and admission "
          f"group); ms per decode step (warm, in turns off/on/on/off) off "
          f"{ms['off']}, on {ms['on']}: {out['guard_cost']:+.2%}; synced "
          f"requant ungated (in place) {[round(x * 1e3, 2) for x in rq['off']]}"
          f" ms, gated (spare, validate, swap) "
          f"{[round(x * 1e3, 2) for x in rq['on']]} ms; the spare's one-time "
          f"clone {clone_s * 1e3:.1f} ms; decode graphs {graphs}; device "
          f"memory each engine holds after its cold run (its trees, KV, "
          f"graph pools) {out['held_gb']} GB")
    del engs["off"]
    return out, engs["on"]


def lane_faults(torch, dev, cfg, params, prompts) -> dict:
    """(b) decode.logits on request 1's lane, dense and paged, max_retries
    1 and 0, against a fault-free run on the same fixed tree: only that
    request faults (then retries, or fails with "non-finite logits"), the
    others' tokens bit for bit the fault-free run's; the pool quiescent."""
    from repro_torch.quant import GuardConfig
    from repro_torch.serving import Fault, FaultInjector
    res = {}
    for paged in (False, True):
        kw = dict(kv_paged=True, kv_block_size=BLOCK) if paged else {}
        label = "paged" if paged else "dense"
        ref = None
        for retries in (None, 1, 0):
            faults = None if retries is None else FaultInjector(
                [Fault("decode.logits", rid=1, count=1)])
            eng = guarded(torch, dev, cfg, params, faults,
                          recalibrate_every=NEVER,
                          guard_cfg=GuardConfig(max_retries=retries or 0),
                          **kw)
            rids = fixed_tree(eng, prompts[:4])
            out = eng.run_all()
            outs = [out[r] for r in rids]
            if paged:
                eng.allocator.assert_quiescent()
            if retries is None:
                ref = [list(o) for o in outs]
                check(eng.lane_faults == 0 and not any(o.error for o in outs),
                      f"[3f] (b) {label}: the fault-free run faulted")
                del eng
                free(torch)
                continue
            want = ["", "" if retries else "non-finite logits", "", ""]
            others = [i for i in range(4) if i != 1]
            same = [list(outs[i]) == ref[i] for i in others]
            retried = leading_equal(outs[1], ref[1])
            check(eng.lane_faults == 1 and [o.error for o in outs] == want
                  and all(same),
                  f"[3f] (b) {label} max_retries={retries}: lane faults "
                  f"{eng.lane_faults}, errors {[o.error for o in outs]}, "
                  f"others equal to the fault-free run {same}")
            res[f"{label} retries {retries}"] = dict(
                lane_faults=eng.lane_faults, errors=want,
                request1_leading_equal=retried)
            print(f"  (b) {label}, max_retries={retries}: request 1 "
                  f"{'retried' if retries else 'failed: non-finite logits'}"
                  f", lane faults 1; requests 0, 2, 3 bit for bit the "
                  f"fault-free run's (the tree fixed by one requant)"
                  + (f"; request 1's retry equals it in its first "
                     f"{retried} of {len(ref[1])} tokens" if retries else "")
                  + ("; pool quiescent" if paged else ""))
            del eng
            free(torch)
    return res


def requant_faults(torch, eng, prompts) -> dict:
    """(c) requant.tree NaN on the guarded engine of (a): once (the
    gate's retry writes a clean tree and swaps it in; the tree it replaced
    is untouched) and twice (rolled back: the served tree, its storage and
    the gate's snapshots stay bit for bit what they were).  Then traffic
    again: no decode graph beyond the two of the alternating trees."""
    from repro_torch.serving import Fault, FaultInjector
    qm, r = eng.qmodel, eng.runner
    res = {}
    for count in (1, 2):
        served = qm.decode_params
        snap = clone_qt_tree(torch, served)
        by_path = dict(qm._qt_by_path)
        last_d = {k: v.clone() for k, v in qm._last_D.items()}
        n0, rej0, upd0 = qm.n_requants, qm.requant_rejections, \
            qm.session.n_updates
        qm._fault_hook = FaultInjector(
            [Fault("requant.tree", at=0, count=count)]).requant_hook
        try:
            wall = synced_requant(torch, eng)
        finally:
            qm._fault_hook = None
        check(qm.requant_rejections - rej0 == count,
              f"[3f] (c) {count} faults: {qm.requant_rejections - rej0} "
              f"rejections")
        if count == 2:
            check(qm.n_requants == n0 and qm.decode_params is served
                  and qm.session.n_updates == upd0 - 1
                  and qt_tree_equal(torch, served, snap)
                  and all(qm._qt_by_path[k] is v for k, v in by_path.items())
                  and all(torch.equal(qm._last_D[k], v)
                          for k, v in last_d.items()),
                  "[3f] (c) sustained: the served tree or the gate's "
                  "snapshots changed, or nothing was rolled back")
        else:
            stats, cnt = qm.session.as_calib()
            fresh = qm._plan.run(qm.params, stats, cnt)
            check(qm.n_requants == n0 + 1 and qm._spare is served
                  and qt_tree_equal(torch, served, snap)
                  and qt_tree_equal(torch, qm.decode_params, fresh),
                  "[3f] (c) transient: the retried tree is not a clean "
                  "requant's, or the tree it replaced changed")
            del fresh
        del snap
        free(torch)
        res[count] = dict(wall_s=wall, rejections=count)
    outs, _ = serve(torch, eng, prompts[:4])
    check(all(len(o) == MAX_NEW and not o.error for o in outs)
          and len(r._graphs) == 2,
          f"[3f] (c): after the faults {len(r._graphs)} decode graphs "
          f"(want 2), outputs {[len(o) for o in outs]}")
    print(f"  (c) requant.tree NaN once: rejected, retried, swapped in "
          f"({res[1]['wall_s'] * 1e3:.1f} ms synced, two candidates); twice: "
          f"rolled back, the served tree, its storage and the gate's "
          f"snapshots bit for bit the last good ones "
          f"({res[2]['wall_s'] * 1e3:.1f} ms); then 4 requests served, "
          f"decode graphs still 2; requant rejections "
          f"{qm.requant_rejections}")
    return res


def calib_faults(torch, dev, cfg, params, prompts) -> dict:
    """(d) calib.stats nan and outlier on the second admission group:
    quarantined with its provenance, and the next requant's codes bit for
    bit a run whose fault drops that update."""
    from repro_torch.serving import Fault, FaultInjector
    trees, res = {}, {}
    for kind in ("drop", "nan", "outlier"):
        faults = FaultInjector([Fault("calib.stats", at=1, kind=kind)])
        eng = guarded(torch, dev, cfg, params, faults,
                      recalibrate_every=NEVER)
        fixed_tree(eng, prompts)
        check(len(faults.fired) == 1, f"[3f] (d) {kind}: fired "
              f"{faults.fired}")
        q = [(x.reason, x.update_idx, x.provenance) for x in eng.quarantine]
        res[kind] = q
        if kind == "drop":
            trees["drop"] = eng.qparams
            check(not q, f"[3f] (d) drop quarantined {q}")
        else:
            reason = {"nan": "non-finite-stats",
                      "outlier": "outlier-stats"}[kind]
            check(q == [(reason, 1, (3,))] and qt_tree_equal(
                torch, eng.qparams, trees["drop"]),
                f"[3f] (d) {kind}: quarantine {q}, or the requant's codes "
                f"differ from the drop run's")
        del eng
        free(torch)
    print(f"  (d) calib.stats nan and outlier on the second admission group "
          f"(request 3): quarantined {res['nan']} / {res['outlier']}; the "
          f"next requant's codes, S, Z and 1/D bit for bit the drop run's")
    return res


def pool_theft(torch, dev, cfg, params, prompts) -> dict:
    """(e) pool.steal of every free block for 4 steps on the paged pool:
    the ladder climbs to rung 3 (speculation off, K = 1 blocks, cached
    prefixes dropped) and back to 0; the K = 1 graph is captured once; the
    tokens equal the unpressured run's bit for bit."""
    from repro_torch.serving import Fault, FaultInjector
    res = {}
    for theft in (False, True):
        faults = FaultInjector([Fault("pool.steal", at=1, magnitude=STEAL_3F,
                                      count=4)]) if theft else None
        eng = guarded(torch, dev, cfg, params, faults, kv_paged=True,
                      kv_block_size=BLOCK)
        levels, real = [], eng._update_ladder

        def ladder():
            real()
            levels.append(eng.degrade_level)
        eng._update_ladder = ladder
        outs, wall = serve(torch, eng, prompts)
        eng.allocator.assert_quiescent()
        k1 = sum(1 for k in eng.runner._graphs if k[0] == 1)
        res[theft] = dict(outputs=[list(o) for o in outs], levels=levels,
                          events=eng.degrade_events, k1_graphs=k1,
                          wall_s=wall)
        del eng, ladder
        free(torch)
    t = res[True]
    check(max(t["levels"]) == 3 and t["levels"][-1] == 0
          and t["events"] == 3 and t["k1_graphs"] == 1
          and res[False]["k1_graphs"] == 0,
          f"[3f] (e) ladder levels {t['levels']}, events {t['events']}, "
          f"K = 1 graphs {t['k1_graphs']}")
    check(t["outputs"] == res[False]["outputs"],
          "[3f] (e): tokens under pool theft differ from the unpressured "
          f"run's: {[leading_equal(a, b) for a, b in zip(t['outputs'], res[False]['outputs'])]}")
    print(f"  (e) pool.steal ({STEAL_3F} blocks, 4 steps): ladder levels per "
          f"step {t['levels']}, {t['events']} climbs, one K = 1 graph; "
          f"tokens bit for bit the unpressured run's; pool quiescent; wall "
          f"{t['wall_s']:.2f} s vs {res[False]['wall_s']:.2f} s")
    return dict(levels=t["levels"], events=t["events"],
                wall_s=[res[False]["wall_s"], t["wall_s"]])


def long_prompts(n, lo, hi, seed) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256000, size=int(k)).tolist()
            for k in rng.integers(lo, hi + 1, size=n)]


def chunk_shadowed(torch, eng) -> dict:
    """Hold every chunk replay of ``eng`` to the eager chunk body on a clone
    of the state it started from: the last real row's logits, the
    statistics and every state leaf after the writes (a paged pool's sink
    block aside), bit for bit."""
    r = eng.runner
    real = r._replay
    seen = {"replayed": 0}

    def replay(g):
        if not any(g is v for v in r._chunks.values()):
            return real(g)
        snap = clone_tree(torch, r.state)
        last, stats = real(g)
        start = next(k[1] for k, v in r._chunks.items() if v is g)
        inp = {k: v.clone() for k, v in g.inputs.items()}
        want, want_stats = r._chunk(eng.params, snap, inp, start)
        check(torch.equal(last, want) and tree_equal(torch, stats, want_stats)
              and kv_equal(torch, eng, r.state, snap),
              f"[3f] (f): chunk replay at start {start} differs from the "
              f"eager chunk")
        seen["replayed"] += 1
        return last, stats
    r._replay = replay
    return seen


def chunk_near_tie(torch, cfg, params, tree, kvcfg, kcfg, batch, i, agreed,
                   a, b) -> tuple:
    """At request ``i``'s first disagreement between the unchunked and the
    chunked run (tokens ``a``, ``b`` after ``agreed``; ``batch``: the
    prompts submitted with it), recompute its logits on ``tree`` two ways:
    prefilled as the unchunked engine did (in its admission group, padded
    to the group's bucket), and in chunks of CHUNK_3F over the rows written
    so far; each then decodes ``agreed``, on the dense slab (a paged
    read equals the dense one, [3b]).  Returns (|logit a − logit b| of the
    first, the largest |Δlogit| between the two)."""
    from repro_torch.models import lm
    from repro_torch.serving.runner import _gather_dense_prefix, _write_rows
    dev, ML = params["embed"].device, MAXLEN_3F
    kvcfg = dataclasses.replace(kvcfg, paged=False)
    prompt, P = batch[i], len(batch[i])

    def bucket(n):
        return next(x for x in (16, 32, 64, 128, 256) if n <= x)
    bk = bucket(P)
    group = [q for q in batch if bucket(len(q)) == bk]
    j = sum(1 for q in batch[:i] if bucket(len(q)) == bk)
    toks = torch.zeros((len(group), bk), dtype=torch.long, device=dev)
    for k, q in enumerate(group):
        toks[k, :len(q)] = torch.tensor(q)
    lg, st, _ = lm.prefill(cfg, params, {"tokens": toks}, ML,
                           collect_stats=False, full_logits=True, kvcfg=kvcfg)
    lw = lg[j:j + 1, P - 1]
    st_w = {"stack": [{u: {k: v[:, j:j + 1].clone() for k, v in run[u].items()}
                       for u in run} for run in st["stack"]]}
    del lg, st
    st_c = lm.init_decode_state(cfg, 1, ML, kvcfg, device=dev)
    slot = torch.zeros((1,), dtype=torch.long, device=dev)
    for start in range(0, P, CHUNK_3F):
        n = min(CHUNK_3F, P - start)
        toks = torch.zeros((1, CHUNK_3F), dtype=torch.long, device=dev)
        toks[0, :n] = torch.tensor(prompt[start:start + n])
        pkv = (_gather_dense_prefix(st_c["stack"], slot, start, kvcfg)
               if start else None)
        lg, cst, _ = lm.prefill(cfg, params, {"tokens": toks}, ML,
                                collect_stats=False, full_logits=True,
                                kvcfg=kvcfg, prefix_kv=pkv, pos0=start,
                                compact_state=True)
        _write_rows(st_c["stack"], cst["stack"], slot, start, ML)
    lc = lg[:, n - 1]
    tok = lambda x: torch.tensor([[x]], dtype=torch.int32, device=dev)
    at = lambda p: torch.tensor([p], dtype=torch.int32, device=dev)
    for k, x in enumerate(agreed):
        lw, _ = lm.decode_step(cfg, tree, st_w, tok(x), at(P + k),
                               kvcfg=kvcfg, kcfg=kcfg)
        lc, _ = lm.decode_step(cfg, tree, st_c, tok(x), at(P + k),
                               kvcfg=kvcfg, kcfg=kcfg)
    lw, lc = lw[0], lc[0]
    return float((lw[a] - lw[b]).abs()), float((lw - lc).abs().max())


def chunked_prefill(torch, dev, cfg, params, prompts) -> dict:
    """(f) max_len 512, SLOTS_3F slots, dense slab and paged pool (block
    16, no prefix cache so that a warm rerun admits as the cold run did):
    4 short prompts admitted and one requant fixing the tree, then 4
    prompts of 200-256 tokens, which the unchunked engine also takes,
    chunked (CHUNK_3F, BUDGET_3F padded tokens per round) while the short
    ones decode.  Tokens equal to the unchunked run's or, at a first
    disagreement, a near-tie (:func:`chunk_near_tie`); every chunk replay
    bit for bit the eager chunk; compiled programs flat over a warm rerun;
    TTFT and ITL p50/p99 of the warm runs, chunked and not.  Then one
    400-token prompt, which only the chunked engine takes."""
    shorts = prompts[:4]
    longs = long_prompts(4, 200, 256, SEED + 5)
    res = {}
    for paged in (False, True):
        kw = dict(kv_paged=True, kv_block_size=BLOCK, prefix_cache=False) \
            if paged else {}
        label = "paged" if paged else "dense"
        outs = {}
        for chunk in (0, CHUNK_3F):
            eng = guarded(torch, dev, cfg, params, max_slots=SLOTS_3F,
                          max_len=MAXLEN_3F, recalibrate_every=NEVER,
                          prefill_chunk=chunk,
                          prefill_budget=BUDGET_3F if chunk else 0, **kw)
            seen = chunk_shadowed(torch, eng)
            rids = fixed_tree(eng, shorts)
            rids += [eng.submit(p, max_new=MAX_NEW) for p in longs]
            t0 = time.perf_counter()
            out = eng.run_all()
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            outs[chunk] = [list(out[r]) for r in rids]
            check_outputs(cfg, [out[r] for r in rids],
                          f"[3f] (f) {label} chunk {chunk}")
            programs = eng.compiled_programs
            del eng.runner._replay          # the warm run is not shadowed
            eng.scheduler.finished.clear()
            warm, wall = serve(torch, eng, shorts + longs)
            check([list(o) for o in warm] == outs[chunk]
                  and eng.compiled_programs == programs,
                  f"[3f] (f) {label} chunk {chunk}: the warm rerun differs "
                  f"or captured ({programs} → {eng.compiled_programs})")
            lat = eng.latency_percentiles()
            row = dict(cold_s=cold, warm_s=wall, programs=programs,
                       latency=lat)
            if chunk:
                check(seen["replayed"] > 0 and eng.prefill_chunks > 0,
                      f"[3f] (f) {label}: no chunk replayed")
                row.update(chunks=eng.prefill_chunks,
                           chunk_graphs=len(eng.runner._chunks),
                           replays_held=seen["replayed"])
                if not paged:
                    v = long_prompts(1, 400, 400, SEED + 6)[0]
                    rid = eng.submit(v, max_new=MAX_NEW)
                    o = eng.run_all()[rid]
                    check_outputs(cfg, [o], "[3f] (f) 400-token prompt")
                    row["prompt_400_ok"] = True
                else:
                    eng.allocator.assert_quiescent()
                tree, kvcfg, kcfg = eng.decode_params, eng.kvcfg, eng.kncfg
            res[f"{label} chunk {chunk}"] = row
            print(f"  (f) {label}, prefill_chunk {chunk}: cold {cold:.2f} s, "
                  f"warm {wall:.2f} s; TTFT p50/p99 {lat['ttft_p50'] * 1e3:.1f}"
                  f"/{lat['ttft_p99'] * 1e3:.1f} ms, ITL p50/p99 "
                  f"{lat['itl_p50'] * 1e3:.2f}/{lat['itl_p99'] * 1e3:.2f} ms "
                  f"({lat['n_streams']} streams); compiled programs "
                  f"{programs}, flat over the warm run"
                  + (f"; {row['chunks']} chunks, {row['chunk_graphs']} chunk "
                     f"graphs, {row['replays_held']} replays bit for bit the "
                     f"eager chunk" if chunk else "")
                  + ("; a 400-token prompt served" if chunk and not paged
                     else ""))
            if not chunk or paged:
                del eng
                free(torch)
        ties = []
        for i, (a, b) in enumerate(zip(outs[0], outs[CHUNK_3F])):
            t = leading_equal(a, b)
            if t == len(a):
                continue
            batch, k = (shorts, i) if i < 4 else (longs, i - 4)
            margin, delta = chunk_near_tie(torch, cfg, params, tree, kvcfg,
                                           kcfg, batch, k, a[:t], a[t], b[t])
            ties.append(dict(request=i, t=t, margin=margin, delta=delta))
            check(margin <= delta, f"[3f] (f) {label} request {i}: the "
                  f"disagreement at token {t} is no near-tie ({margin} > "
                  f"{delta})")
        res[f"{label} ties"] = ties
        print(f"  (f) {label}: chunked tokens "
              + ("bit for bit the unchunked run's" if not ties else
                 f"equal to the unchunked run's but at {len(ties)} first "
                 f"disagreements, each a near-tie (margin / recomputed "
                 f"whole-vs-chunked |Δlogit|): "
                 + ", ".join(f"r{x['request']}@{x['t']} {x['margin']:.4g}/"
                             f"{x['delta']:.4g}" for x in ties)))
        del tree
        free(torch)
    return res


def server_phase(torch, dev, cfg, params) -> dict:
    """(g) TTQServer over a guarded paged engine (block 16, chunks of 16,
    no prefix cache) on a tree fixed by one requant: 8 streams of 17-64
    token prompts (each chunk-ingested alone, so arrival timing cannot
    change a prefill) equal the batch engine's tokens bit for bit; every
    capture and replay of the server run on its worker thread; a stream
    dropped mid-prefill cancels its request; ``stop()`` drains; the pool
    ends quiescent."""
    import asyncio
    import threading

    from repro_torch.serving import TTQServer
    prompts = long_prompts(N_REQUESTS, 17, 64, SEED + 7)
    eng = guarded(torch, dev, cfg, params, kv_paged=True, kv_block_size=BLOCK,
                  prefix_cache=False, prefill_chunk=16,
                  recalibrate_every=NEVER)
    fixed_tree(eng, prompts[:1])
    eng.run_all()
    want, wall_batch = serve(torch, eng, prompts)
    want = [list(o) for o in want]
    r = eng.runner
    threads = set()
    real_capture, real_replay = r._capture, r._replay

    def capture(*a, **k):
        threads.add(threading.get_ident())
        return real_capture(*a, **k)

    def replay(g):
        threads.add(threading.get_ident())
        return real_replay(g)
    r._capture, r._replay = capture, replay

    async def main():
        server = TTQServer(eng)
        await server.start()

        async def stream(p):
            return [t async for t in server.generate(p, max_new=MAX_NEW)]
        t0 = time.perf_counter()
        got = await asyncio.gather(*[stream(p) for p in prompts])
        wall = time.perf_counter() - t0
        dropped = asyncio.ensure_future(server.complete(
            long_prompts(1, 64, 64, SEED + 8)[0], max_new=MAX_NEW))
        await asyncio.sleep(0)
        dropped.cancel()
        try:
            await dropped
        except asyncio.CancelledError:
            pass
        last = asyncio.ensure_future(server.complete(prompts[0],
                                                     max_new=MAX_NEW))
        await asyncio.sleep(0)
        await server.stop()                 # drains the in-flight request
        return got, wall, await last, server._thread.ident

    got, wall, last, worker = asyncio.run(main())
    check(got == want, "[3f] (g): streamed tokens differ from the batch "
          f"engine's: {[leading_equal(a, b) for a, b in zip(got, want)]}")
    check(list(last) == want[0], "[3f] (g): stop() did not drain the "
          "in-flight request")
    check(threads == {worker} and worker != threading.get_ident(),
          f"[3f] (g): graphs captured or replayed off the worker thread")
    cancelled = [q for q in eng.scheduler.finished.values() if q.cancelled]
    check(len(cancelled) == 1, f"[3f] (g): {len(cancelled)} cancelled")
    eng.allocator.assert_quiescent()
    print(f"  (g) TTQServer: 8 streams bit for bit the batch engine's "
          f"({wall:.2f} s streamed, {wall_batch:.2f} s batch); every capture "
          f"and replay on the worker thread; a stream dropped mid-prefill "
          f"cancelled; stop() drained; pool quiescent")
    del eng
    free(torch)
    return dict(stream_s=wall, batch_s=wall_batch)


CLI_ARGS = ["--arch", "gemma_7b", "--kv-paged", "--kv-dtype", "int8",
            "--use-kernels", "--prefill-chunk", "64", "--deadline-s", "60",
            "--inject", "bad-requant"]


def cli_phase() -> dict:
    """(h) ``python -m repro_torch.launch.serve`` once at full width, in a
    subprocess (its own weights: this process has freed its engines): its
    summary lines must parse, every request finish, and the injected bad
    requant be caught."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *CLI_ARGS], cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       timeout=600)
    wall = time.perf_counter() - t0
    out = p.stdout.splitlines()
    check(p.returncode == 0, f"[3f] (h): the CLI exited {p.returncode}: "
          f"{p.stderr[-2000:]}")
    summ = next((ln for ln in out if ln.startswith("arch=")), "")
    kv = dict(re.findall(r"([\w/]+)=([^\s]+)", summ))
    lat = next((ln for ln in out if ln.startswith("latency:")), "")
    lat_ms = re.search(r"ttft p50/p99 ([\d.]+)/([\d.]+) ms, itl p50/p99 "
                       r"([\d.]+)/([\d.]+) ms", lat)
    g = dict(re.findall(r"(\w+)=(\d+)", next(
        (ln for ln in out if ln.startswith("guards: calib")), "")))
    check(kv.get("requests") == "8" and kv.get("tokens") == "96"
          and lat_ms is not None and g.get("requant_rejections") == "1"
          and any(ln.startswith("slo:") for ln in out)
          and any(ln.startswith("kv-pool:") for ln in out),
          f"[3f] (h): summary lines did not parse: {out}")
    print(f"  (h) CLI {' '.join(CLI_ARGS)}: {wall:.1f} s in a subprocess; "
          f"{summ}; {lat}; guards {g}")
    return dict(wall_s=wall, summary=kv,
                latency_ms=[float(x) for x in lat_ms.groups()], guards=g)


def robustness(torch, dev, cfg, params, prompts) -> dict:
    """Phase 3f: guards, fault isolation, chunked prefill, the server and
    the CLI at full width; each part's seconds.  The kernels' launches are
    counted over (a)-(g)."""
    from repro_torch.kernels import build
    build.reset_launches()
    res, secs = {}, {}
    t = time.perf_counter()
    res["a"], eng = guards_on_off(torch, dev, cfg, params, prompts)
    secs["a"] = time.perf_counter() - t
    t = time.perf_counter()
    res["c"] = requant_faults(torch, eng, prompts)
    secs["c"] = time.perf_counter() - t
    del eng
    free(torch)
    for key, fn in (("b", lane_faults), ("d", calib_faults),
                    ("e", pool_theft), ("f", chunked_prefill)):
        t = time.perf_counter()
        res[key] = fn(torch, dev, cfg, params, prompts)
        secs[key] = time.perf_counter() - t
    t = time.perf_counter()
    res["g"] = server_phase(torch, dev, cfg, params)
    secs["g"] = time.perf_counter() - t
    res["launches"] = dict(build.LAUNCHES)
    check(all(n > 0 for n in res["launches"].values()),
          f"[3f]: a kernel never launched: {res['launches']}")
    t = time.perf_counter()
    res["h"] = cli_phase()
    secs["h"] = time.perf_counter() - t
    res["seconds"] = secs
    print(f"  [3f] seconds per part: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
          + f"; launches {res['launches']}")
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
    ptx = ptxas_report(build.build_log)
    spilled = sorted(n for n, (_, st, ld) in ptx.items() if st or ld)
    print(f"    kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s; ptxas log {log}, "
          f"{len(spilled)} kernels with spills: {spilled})")
    attn_ptx = {n: v for n, v in ptx.items() if "attn_kernel" in n}
    print("    attention kernels (registers, spill stores, spill loads): "
          + "; ".join(f"{n} {v}" for n, v in sorted(attn_ptx.items())))
    check(len(attn_ptx) == 40, f"the ptxas log lists {len(attn_ptx)} "
          f"attention kernels, not 40")
    check(not any(n in spilled for n in MAIN_PATH_ATTN),
          f"an attention instantiation of the main path spills: {spilled}")
    quant_ptx = {n: v for n, v in ptx.items() if n.startswith("quant_kernel")}
    print("    quantize kernels (registers, spill stores, spill loads): "
          + "; ".join(f"{n} {v}" for n, v in sorted(quant_ptx.items())))
    check(len(quant_ptx) == 16, f"the ptxas log lists {len(quant_ptx)} "
          f"quantize kernels, not 16")
    check(MAIN_PATH_QUANT in quant_ptx
          and not any(n in spilled for n in quant_ptx),
          f"the main path's quantize instantiation {MAIN_PATH_QUANT} is "
          f"missing, or a quantize instantiation spills: {spilled}")

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
    }
    dense_row, paged_row = kernel_attention(torch, dev, flush, cur_main)
    rows["ttq_decode_attention"] = (
        "src/repro_torch/kernels/csrc/ttq_attn.cu",
        "src/repro/kernels/ttq_attn.py:254", dense_row)
    rows["ttq_paged_decode_attention"] = (
        "src/repro_torch/kernels/csrc/ttq_attn.cu",
        "src/repro/kernels/ttq_attn.py:203", paged_row)
    kernel_attention_long(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    print("[3] main path: TTQEngine, gemma-7b full width, int4 g32 weights, "
          "int8 KV")
    cfg, params = init_gemma(torch, dev)
    res, outs = main_path(torch, dev, prompts, cfg, params)
    print("    main path: " + json.dumps(res))
    gc.collect()                        # the dense engine goes before 3b's
    torch.cuda.empty_cache()

    print("[3b] paged main path: the same, with kv_paged=True (block 16, "
          "default pool)")
    paged = paged_path(torch, dev, prompts, cfg, params,
                       dict(outputs=outs, host_syncs=res["host_syncs"]))
    print("    paged main path: " + json.dumps(paged))
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[3c] prefix cache and preemption: NO_QUANT weights, int8 KV, "
          f"pool of {POOL_3C} blocks")
    pre = prefix_and_preemption(torch, dev, cfg, params)
    print("    prefix cache and preemption: " + json.dumps(pre))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    print(f"[3d] the reference's default policy: ttq_policy(bits=4, "
          f"group_size=32, rank={RANK_3D}, packed=True), int8 KV, "
          f"requant_threshold={THRESHOLD_3D}, double_buffer=True; gemma-7b "
          f"full width, {DEPTH_3D} of {cfg.n_layers} layers (exact SVD at "
          f"~6 s per layer)")
    dflt, factors = default_policy(torch, dev, cfg, params, res)
    print("    default policy: " + json.dumps(dflt))
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[3e] self-speculative decoding, speculate_k={SPEC_W}: (a) the "
          f"default policy of [3d] with its int4 rank-0 draft, {DEPTH_3D} "
          f"layers; (b) bf16 weights, int8 KV, an int4 g32 draft, "
          f"{cfg.n_layers} layers, dense and paged; (c) (b) on one layer")
    spec = speculation(torch, dev, cfg, params, factors)
    print("    speculation: " + json.dumps(spec))
    del factors
    free(torch)

    print(f"[3f] robustness and streaming: guards, faults, chunked prefill "
          f"(max_len {MAXLEN_3F}, chunks of {CHUNK_3F}, budget {BUDGET_3F}), "
          f"TTQServer and the CLI; gemma-7b full width, [3]'s policy")
    rob = robustness(torch, dev, cfg, params, prompts)
    print("    robustness: " + json.dumps(rob, default=str))

    print("[4] per kernel: ms per decode step (gemm, attention) or per "
          "requant (quantize); launches: the main path's ([3], paged from "
          "[3b]), the speculative path's ([3e]) and the robustness and "
          "streaming path's ([3f] (a)-(g)), counted per replay")
    kernels = []
    spec_cases = ("a", "b", "b paged", "c")
    for name, (src, replaces, m) in rows.items():
        main_n = (paged if name == "ttq_paged_decode_attention"
                  else res)["launches"][name]
        spec_n = sum(spec[k]["launches"][name] for k in spec_cases)
        rob_n = rob["launches"][name]
        print(f"  {name} launches: main path {main_n}, speculative path "
              f"{spec_n} ([3e] cold runs "
              + ", ".join(f"({k}) {spec[k]['launches'][name]}"
                          for k in spec_cases) + f"), robustness and "
              f"streaming path {rob_n}")
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            launches=main_n + spec_n + rob_n, **m))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
