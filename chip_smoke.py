#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--full-depth-3d]

1. Device: the card's name and power limit; builds the CUDA kernels of
   ``src/repro_torch/kernels/csrc/`` with nvcc (sm_90a) into ``build/``;
   prints each attention, quantize, experts and wide GEMM instantiation's
   registers and spills, and fails if an attention one that the main path
   runs, or any quantize, experts or wide GEMM one, spills.
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
   cur_pos = LONG_CUR), with the byte bound and the share of it reached;
   then both at [3g]'s GQA groups (G = 3, 12, 48, Dh 128; ATTN_GROUPS),
   checked the same way and timed against both bounds and SDPA.
3. The main path: ``TTQEngine`` on full-width gemma-7b (random weights from
   a seed) serves 8 requests through the three kernels of the dense slab,
   each decode block one replay of a captured CUDA graph; every kernel
   must have launched (counted per replay), every ``ttq_gemm`` launch on
   the split tile (``build.GEMM_TILES``), and ``compiled_programs`` must
   not change over a warm rerun of the traffic.  A third run holds every
   graph block to an eager ``lm.decode_many`` on clones of the state it
   started from (tokens bit for bit) and times both, eager and graph
   blocks in turns; WARM_REPEATS more warm runs give the median and spread
   of ms per decode step and tokens/s.  One synced requant is split into its 7
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
3c. Prefix cache and preemption at full width on DEPTH_3C layers:
   full-precision weights,
   int8 KV, 8 prompts sharing a 32-token prefix, a pool small enough to
   preempt; then the same traffic on an unconstrained pool without the
   prefix cache, for a reading of how many leading tokens agree; and the
   same pair on the first layer alone, as its witness.  A rerun of the
   constrained traffic at DEPTH_3C layers holds every graph block to the eager
   loop, through preemption and prefix hits.
3d. The reference's default policy (rank 16, delta gate, double buffer)
   at full width on DEPTH_3D layers (all 28 with ``--full-depth-3d``),
   checks (a)-(e).
3e. Self-speculative decoding (``speculate_k=SPEC_W``): (a) [3d]'s policy
   and factors with its int4 rank-0 draft; (b) bf16 weights, int8 KV and
   an int4 g32 draft (draft-only quantization) on DEPTH_3E_B layers, on
   the dense slab and on the paged pool; (c) (b) on the first layer.  Every
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
3f. Robustness and streaming on [3]'s policy at full width and DEPTH_3F
   layers: (a) the
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
3g. The other dense families at full width through [3]'s policy with the
   default guards, dense slab then paged pool: minitron-4b,
   starcoder2-15b and granite-34b at the depths of DEPTHS_3G.
   Per engine: every kernel of its path launched, greedy tokens printed (paged equal to dense), the graph
   readings and shadowed run of [3], two synced gated requants, peak
   memory; dense: a one-layer depth witness.
3h. The vlm and hybrid families and long prefill attention: (c) first, on
   an empty card: one layer's prefill attention at S = LONG_ATTN_S keys
   (gemma-7b's 16 heads at Dh 256; recurrentgemma's G = 16 at its window of
   2,048), ``attention``'s own dispatch (the KV-chunked online softmax)
   against ``full_attention`` on the same f32 q/k/v, with both times and
   peak memories; (a) recurrentgemma-9b at full width and HYBRID_DEPTH_3H
   layers through
   [3g]'s ``family_engine`` (dense slab; one prefill graph per distinct
   prompt length), then one prompt of HYBRID_LONG tokens past its window
   (the rolling layout in prefill, decode wrapping the 2,048-row slab):
   every kernel of the path launched, graph blocks and the prefill replay
   bit for bit eager, compiled programs flat over a warm rerun, and a
   one-unit (rec, rec, lattn) witness at the wrapped window; (b)
   chameleon-34b (qk-norm, G = 8) at VLM_DEPTH_3H layers, dense then
   paged, as [3g]; (d) (b)'s params with ``tie_embeddings=False``
   (``untied_head``): ``lm_head := embed`` serves (b)'s dense tokens with
   its first prefill's logits bit for bit, and an independent seeded
   ``lm_head`` (1 GiB) gives request 0's first-step logits bit for bit
   an eager ``lm.prefill``'s and within UNTIED_REL_L2 of an eager
   ``lm.forward``; its launches count in [3h]'s.
3i. The MoE family, [3]'s policy with the default guards through [3g]'s
   ``family_engine``: (a) deepseek-v2-lite (MLA, 64 experts top-6, 2
   shared) at full width and all 27 layers, dense slab only: every kernel
   of its path launched (``ttq_gemm``, the expert-batched
   ``ttq_gemm_experts`` 3 times per layer and decode step, each on the
   tensor-core tile, counted per
   replay, ``ttq_quantize``), graph blocks and prefill replays bit for bit
   eager, every ``wkv_b`` expansion of the latent cache on the wide tile
   and every other ``ttq_gemm`` launch on the split tile, the ms per step
   of the expansions on either tile, the three refusals (paged pool,
   speculation, chunked prefill), and a one-layer witness whose routing choices are held to the plain
   path's (each first disagreement of a token a near-tie of router
   probabilities); (b) llama4-scout (16 experts top-1 and a shared one, G
   = 5) at full width and ``fit_depth`` layers, dense then paged (paged
   tokens equal to dense).  Every ``ttq_gemm_experts`` launch of both
   configs must take the tensor-core tile (``build.EXPERTS_TILES``).  [2]
   also checks and times ``ttq_gemm_experts`` at both configs' expert
   shapes: the tensor-core tile against the plain version, expert e bit
   for bit the same in a launch over itself alone and over half the
   experts, and the batched CUDA-core tile timed beside it in turns.  [2]
   also holds and times the 2-D ``ttq_gemm`` at deepseek-v2-lite's ``wkv_b``
   expansion (T = 1,024 latent rows, 4,096 x 512, ``kernel_wkv_b``): the
   wide tile ``gemm_tile`` must choose, bitwise repeatable and row- and
   token-independent, beside the split tile forced at the same shape, its
   bound, ``torch.matmul``, the experts' tensor-core tile at E = 1 and the
   plain version, and both tiles at T = 64, 256 and 1,024.
3j. The SSM and encoder-decoder families, [3]'s policy with the default
   guards through [3g]'s ``family_engine``, dense slab only (neither
   family admits the pool): (a) mamba2-1.3b (Mamba2's chunked SSD, no
   attention) at full width and DEPTHS_3J layers: every kernel of its path
   launched (``ttq_gemm``, ``ttq_quantize``), graph blocks and prefill
   replays bit for bit eager (one prefill graph per distinct prompt
   length), compiled programs flat over a warm rerun, a one-layer witness,
   then one prompt of SSM_LONG tokens across two SSD chunks, and the
   three refusals (paged pool, speculation, chunked prefill); (b)
   whisper-medium (DEPTHS_3J encoder and decoder layers, cross-attention,
   learned positions) at full width, 8 requests each with its own frames
   from the seed: the same checks with ``ttq_decode_attention`` on the
   self-attention cache, then one prompt admitted twice with different
   frames, the second a replay of the first's prefill graph bit for bit
   the eager prefill on its own frames, and the three refusals.
3k. Training, which launches none of the kernels (its products are plain
   ``x @ wᵀ`` on bf16 weights): (a) gemma-7b at full width on the depth
   ``train_fit_depth`` gives (9 of 28 layers on an 80 GB card), batch 8 ×
   512 from ``token_stream`` in 2 microbatches, f32 masters, bf16 compute,
   AdamW, remat: one cold step and WARM_3K warm ones (every loss finite,
   the last below the first), ms per step, tokens/s, the model-FLOPs share
   of the dense bf16 peak and peak memory; then on RESTORE_DEPTH_3K layers
   a step after a save and restore through ``CheckpointManager`` equal to
   the live step (bit for bit, or within 2·lr); ``python -m
   repro_torch.launch.train --smoke --steps 3`` in process; (b) the
   reference example's 100m preset for STEPS_3K_B steps (fewer past
   TRAIN_BUDGET_3K_B seconds), then its held-out perplexity report: fp,
   and RTN / AWQ calibrated on domain 1 / TTQ (rank 16, zero calibration)
   at 4 and 3 bits, g32 (readings only).
3l. Tensor-parallel serving (``pctx``) of [3]'s policy and eight requests
   on gemma-7b at full width and TP_DEPTH_3L layers, on one tree
   requantized from fixed statistics
   (those of a [3]-cadence run): (a) world 1 over NCCL with CUDA graphs
   (``make_mesh(1, 1)``): tokens, every graph block's outputs and the tree
   bit for bit the ``pctx=None`` engine's; collectives per decode step
   (captured in the decode graph), ms per decode step against
   ``pctx=None`` (warm runs in turns), capture seconds.  (b) With nothing
   of the earlier phases on the card, world TP_WORLD_3L as processes
   sharing the card over gloo (eager blocks, collectives staged through
   pinned host buffers): each first holds the ``*_tp`` wrappers at
   gemma-7b's shard shapes (``ttq_gemm_tp`` row and col, both decode
   attentions on its heads) against the plain version at [2]'s
   tolerances, then builds the whole tree from the seed and keeps its
   slice; both ranks' tokens equal, and equal to (a)'s or a near-tie (the
   first disagreement's two logits within twice the largest gap between
   the teacher-forced world-1 and world-2 logits there); those
   teacher-forced logits within
   TP_DELTA_3L of each other at every position; each rank's codes, S, Z
   and D⁻¹ of every layer of every weight bit for bit its slice of (a)'s;
   ms per decode step and launches per step over the counted steps, peak
   GB per rank.
3m. The same for the five families beyond plain attention
   (FAMILIES_3M: recurrentgemma-9b, mamba2-1.3b, whisper-medium,
   deepseek-v2-lite, llama4-scout at full width and a depth holding every
   layer kind), N_3M requests each, one tree from the fixed statistics of
   a full-precision prefill: (a) world 1 over NCCL with CUDA graphs
   against ``pctx=None`` (MoE under ``moe_impl="dense"``): tokens, every
   block and the tree bit for bit; a MoE engine under ``"a2a"`` with its
   graph replays bit for bit its own eager run; deepseek-v2-lite's
   ``wkv_b`` expansions on the wide tile, every other ``ttq_gemm`` on the
   split tile; collectives per decode step by kind; ms per decode step
   against ``pctx=None``.  (b) World
   TP_WORLD_3L over gloo on the one card: ``ttq_gemm_tp`` at the RG-LRU,
   SSD and ``wkv_b`` shard shapes, the decode attentions at
   whisper-medium's rank heads and ``ttq_gemm_experts`` at E/n experts
   against their plain versions; per family the ranks' tokens equal (each
   ``moe_impl``), (a)'s or a near-tie, the teacher-forced logits within
   TP_DELTA_3M of (a)'s, every layer's codes bit for bit (a)'s slices;
   for MoE the router probabilities within ROUTE_DELTA_3M of (a)'s up to
   each request's first routing flip, and under ``"a2a"`` at capacity
   factor CF_3M (no assignment dropped) the teacher-forced logits within
   TP_DELTA_3M of (a)'s world-1 ``"a2a"`` ones; deepseek-v2-lite's
   ``wkv_b`` expansion per layer at world 1 and on one rank; ms per
   decode step, the staged collectives' ms, peak GB per rank.
3n. Data- and tensor-parallel training, which launches none of the
   kernels: gemma-7b at full width on DEPTH_3N layers with [3k] (a)'s
   batch, microbatches, remat and AdamW for STEPS_3N steps.  (a) A (1,1)
   mesh over NCCL: losses, grad norms and masters bit for bit the Trainer
   without a mesh; ms per step and peak GB of both.  Then two processes
   sharing the card over gloo (collectives staged through pinned host
   buffers): (b) (2,1) with ZeRO-1 and (c) (1,2): the ranks' losses equal
   and within DP_RTOL_3N of (a)'s, every rank's master slice within the
   DP rule of (a)'s, ms per step and the staged collectives' ms, peak GB
   and optimizer GB per rank ((b)'s below 0.6× (a)'s); (d) on
   RESTORE_DEPTH_3N layers, a save at (2,1) restored onto (1,2) by
   ``ElasticController.rescale``, every leaf bit for bit the live state's
   slice, the next step's loss within the DP rule of the live one's; (e)
   ``make_compressed_dp_step`` at (2,1) on the 100m preset, its masters
   within COMPRESSED_REL_3N (relative L2) of the uncompressed step's.
3o. Tensor-parallel training of the five families beyond plain attention,
   which launches none of the kernels: recurrentgemma-9b, mamba2-1.3b,
   whisper-medium, deepseek-v2-lite and llama4-scout at full width and
   the depths of FAMILIES_3O, BATCH_3O × SEQ_3O tokens in MB_3O
   microbatches, remat and AdamW for STEPS_3O steps, after a reckoning of
   each one's training bytes at world 1 (TRAIN_BYTES_PER_PARAM).  Two
   processes share the card over gloo: per family (a) world 1 on rank 0
   (no mesh, and for the MoE configs the (1,1) "a2a" context at CF_3M,
   whose losses are held to no mesh's), then (b) the (1,2) mesh on both
   ranks (deepseek-v2-lite under "dense" and "a2a", llama4-scout under
   "a2a"): the ranks' losses equal and within DP_RTOL_3N of (a)'s, every
   rank's master slice within the DP rule of (a)'s; ms per step, the
   staged collectives' share by kind, the collectives per step (of the
   all-reduces, the block entries' backward sums and the partial
   gradients' sums), peak and optimizer GB per rank.
4. A ``{"kernels": [...]}`` line, the card line, and ``{"ok": true, ...}``.
5. Seconds per phase and for the whole script.

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
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's datasheet rates (the napkin roofline's constants)
from repro_torch.launch.napkin import (  # noqa: E402
    H100_SXM_HBM_BW as HBM_BYTES_PER_S,
    H100_SXM_PEAK_FLOPS as DENSE_BF16_FLOP_PER_S)
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
DEPTH_3C = 14                  # of gemma-7b's 28 layers (28 before [3o])
LONG_CUR = [8191, 6143, 4095, 2047]   # phase 2's long-context attention
# phase 2's attention at [3g]'s groups: (config, kv heads, G), Dh 128
ATTN_GROUPS = (("minitron_4b", 8, 3), ("starcoder2_15b", 4, 12),
               ("granite_34b", 1, 48))
# the attention instantiations gemma-7b's int8 KV runs (G = 1, Dh 256, one
# scale group per row)
MAIN_PATH_ATTN = ("attn_kernel<1,1,8,1>", "paged_attn_kernel<1,1,8,1>")
# the one [3g]'s families run: G = 3, 12 and 48 at Dh 128 in tiles of 4
FAMILY_ATTN = ("attn_kernel<4,1,8,1>", "paged_attn_kernel<4,1,8,1>")
# the quantize instantiation a requant runs: bits 4, one vector per lane
# and group of 32 (four lanes), bf16 weights
MAIN_PATH_QUANT = "quant_kernel<4,1,1,__nv_bfloat16>"
# the experts' mma tile both MoE configs decode through: one n-tile of 4
# tokens (T <= 4), one 32-k unit per group (g32)
MAIN_PATH_EXPERTS = "experts_mma_kernel<1,1,0>"
# the wide tile's instantiations (csrc/ttq_gemm_wide.cu's served
# <WG, N, KC, STG, MULTI>): g = 32 (MLA's wkv_b expansion) and g > 32
MAIN_PATH_WIDE = ("wide_kernel<4,64,64,4,0>", "wide_kernel<4,64,64,4,1>")
SPIN_CYCLES = 4_000_000        # about 2 ms at the H100's clock (time_ms)
# host-side CUDA API calls that put work on a stream, as the profiler
# names them (with or without CUPTI's version suffix)
HOST_LAUNCH = re.compile(r"cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)\w*")
# phase 3d: the reference's default policy.  Exact top-16 SVD (cuSOLVER
# gesvd) takes 0.8-1.0 s per gemma-7b weight matrix on an H100, ~6 s per
# layer, so [3d] runs 4 of the 28 layers at full width (8 before [3n]
# needed the time; its near-tie checks pass at 4, tools/near_tie_probe.py,
# PERF.md).  [3e] (b) runs DEPTH_3E_B layers (28 before, likewise; at 8
# its paged warm rerun captured one more prefix-tail prefill graph than
# the first warm run, PERF.md).
DEPTH_3D = 4
DEPTH_3E_B = 14
RANK_3D = 16
THRESHOLD_3D = 0.05
SVD_TOL = 1e-4                 # relative, against a float64 CPU SVD
REL_L2_ONE_LAYER = 1e-2
WITNESS_RATIO = 1.5
REL_L2_BOUND = 3e-2
WARM_REPEATS = 10              # phase 3: warm runs for a median and spread
SPEC_W = 3                     # phase 3e: drafted tokens per window
# phase 3f: chunked prefill at max_len 512 in chunks of 64, two per round,
# 8 slots so the long prompts are ingested while the short ones decode;
# the pool theft of (e) takes every free block for 4 engine steps
CHUNK_3F, BUDGET_3F, MAXLEN_3F, SLOTS_3F = 64, 128, 512, 8
STEAL_3F = 64
# phase 3g: the other dense families at full width; granite-34b at the
# depth its weights and two quantized trees leave room for
FAMILIES_3G = ("minitron_4b", "starcoder2_15b", "granite_34b")
# [3g]'s depths at full width: granite-34b a reduced-depth witness of its
# G = 48 (fit_depth, which would give 57 layers on an 80 GB card, is held
# by chameleon-34b in [3h]); minitron-4b (32 layers) and starcoder2-15b
# (40) cut to 16 to pay for [3m], then all three to 8 to pay for [3n],
# then to 4 for [3o] (their checks are exact: paged tokens equal dense
# ones, replays equal eager blocks)
DEPTHS_3G = {"minitron_4b": 4, "starcoder2_15b": 4, "granite_34b": 4}
# the other earlier paths cut to pay for [3m] (full width kept):
# recurrentgemma-9b in [3h] (a) to 4 units of (rec, rec, lattn) of its 38
# layers, chameleon-34b in [3h] (b) to 16 of fit_depth's 31 (8 since
# [3n]), gemma-7b to 14 of its 28 layers in [3f] and in [3l]; then for
# [3o] recurrentgemma-9b to 2 units, chameleon-34b to 4 layers, and [3f]
# and [3l] to 8, once their first disagreements were held to the
# near-tie rule of [3e] and [3m] (2δ: PERF.md, ROADMAP C9)
HYBRID_DEPTH_3H = 6
VLM_DEPTH_3H = 4
# [3h] (d): an untied head's first-step logits (the engine's prefill graph's
# eager warm-up, int8 KV) are held bit for bit to the eager lm.prefill of the
# same prompt with the same KV config, and within this relative L2 of an
# eager lm.forward (no KV quantization: prefill attends over the int8
# cache's values, 1.25e-2 on the CPU smoke config;
# tests/test_torch_models.py's bf16 bound 3e-2)
UNTIED_REL_L2 = 3e-2
DEPTH_3F = 8
TP_DEPTH_3L = 8
FIT_RESERVE_GB = 8             # card memory kept from fit_depth's weights
# phase 3h: a prompt past recurrentgemma-9b's window of 2,048, and the key
# count of the long prefill attention (over gemma-7b's 8,192 chunk
# threshold, whole chunks of 1,024)
HYBRID_LONG = 2100
LONG_ATTN_S = 9216
NEVER = 10 ** 6                # a requant cadence that never fires: the
                               # tree is fixed by one manual requant
# phase 2 and 3i: the expert weights of the two MoE configs, (E, d', d,
# launches per layer); decode runs 4 slots, so T = 4
EXPERT_SHAPES = {
    "deepseek-v2-lite": (("wg/wu", 64, 1408, 2048, 2),
                         ("wd", 64, 2048, 1408, 1)),
    "llama4-scout": (("wg/wu", 16, 8192, 5120, 2),
                     ("wd", 16, 5120, 8192, 1))}
MOE_3I = ("deepseek_v2_lite_16b", "llama4_scout_17b_a16e")
# phase 3j: the last two families at full width, at half their depth
# since [3o] (mamba2-1.3b 24 of 48 layers, whisper-medium 12 + 12 of 24 +
# 24; the checks are exact: replays equal eager blocks and prefills), and
# a prompt that crosses two of mamba2-1.3b's SSD chunks of 256
FAMILIES_3J = ("mamba2_1p3b", "whisper_medium")
DEPTHS_3J = {"mamba2_1p3b": 24, "whisper_medium": 12}
SSM_LONG = 600
# phase 3k: training.  (a) gemma-7b at full width, batch 8 × seq 512 in
# two microbatches, at the depth TRAIN_BYTES_PER_PARAM leaves room for:
# f32 master, m and v (12 B), the bf16 compute copy and its gradient (4 B)
# and the f32 accumulated gradient (4 B) per parameter, beside the head's
# f32 logits of one microbatch and their exp, gradient and a spare
# (4 × 4 B per logit) and FIT_RESERVE_GB.  The save/restore check runs on
# RESTORE_DEPTH_3K layers: the whole opt state goes through np.savez.
# (b) the reference's 100m preset (examples/train_ttq_lm.py:24-29).
TRAIN_BYTES_PER_PARAM = 20
# phase 3l: tensor-parallel serving of [3]'s traffic on a requant tree from
# fixed statistics; (b) at world 2, two processes sharing the card over gloo
TP_WORLD_3L = 2
TP_TIMEOUT_3L = 600            # seconds for (b)'s ranks to finish
TP_TURNS_3L = 3                # warm runs per engine in turns, (a)
# (b): the largest |world-1 - world-2| logit over every teacher-forced
# position of every request.  Readings on an H100 (PERF.md): 0.09-0.11 at
# each request's first disagreement, 0.117 over all 256 positions (bf16
# roundings of the column sums moved through 28 random layers); a dropped
# collective or a wrong shard product moves the logits by their own size
# (units).  The bound is 3x the largest reading.
TP_DELTA_3L = 0.35
# [3m]: the five families beyond plain attention at full width and these
# depths (every layer kind once: recurrentgemma's (rec, rec, attn),
# whisper's 2 encoder + 2 decoder layers)
FAMILIES_3M = (("recurrentgemma_9b", 3), ("mamba2_1p3b", 4),
               ("whisper_medium", 2), ("deepseek_v2_lite_16b", 2),
               ("llama4_scout_17b_a16e", 2))
N_3M = 4                       # requests per family: one round of 4 slots
TP_TURNS_3M = 2                # warm runs per engine in turns, (a)
TP_TIMEOUT_3M = 420            # seconds for (b)'s ranks to finish
# (b): the largest |world-1 - world-2| teacher-forced logit per family,
# fixed before the first run: 2-4 layers round fewer column sums than
# [3l]'s 28 (0.117 there), so the readings should stay below it; a
# dropped collective, a wrong shard or a missing Σy² moves logits by
# units.  The same bound as TP_DELTA_3L.
TP_DELTA_3M = 0.35
# (b), MoE: the largest |world-1 - world-2| router probability of any
# token at any layer up to each request's first routing flip, and half the
# largest gap between the swapped experts' world-1 probabilities at that
# flip.  Readings on an H100 (PERF.md): 0.00135-0.00141 (deepseek-v2-lite,
# dense and a2a) and 0.00404 (llama4-scout), flip gaps up to 0.00118; a
# wrong expert slice moves a later layer's probabilities by their own size
# (1/E to 1).  The bound is 3x the largest reading
ROUTE_DELTA_3M = 0.0125
# (b), "a2a": the capacity factor at which world 2's all-to-all teacher
# forcing is held to world 1's.  The reference test's 8 drops prompt
# assignments of deepseek-v2-lite's random router at world 1 (5 on an
# H100, PERF.md); at 32, C = ⌊Tc·k/E·32⌋ ≥ Tc for both configs (E/k ≤
# 16), the most one expert can be sent, so no world drops any
CF_3M = 32.0
BATCH_3K, SEQ_3K, MB_3K, WARM_3K = 8, 512, 2, 10
RESTORE_DEPTH_3K = 1
PRESET_100M = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                   d_ff=2304, vocab=32768, seq=1024, batch=32)
STEPS_3K_B = 300
TRAIN_BUDGET_3K_B = 10.0       # seconds of (b)'s training before it stops
                               # (cut from 120 to 60 for [3l], then to 20
                               # for [3n], to 10 for [3o]; PERF.md)
# [3n]: data- and tensor-parallel training of gemma-7b at full width on
# DEPTH_3N layers (2 × 276.8M + the 786.4M tied embedding: 16.1 GB of f32
# masters and moments, ~8 GB per rank under ZeRO-1 at D = 2, so two ranks
# fit on the card; [3k] (a)'s 9 layers would not) with [3k] (a)'s batch;
# (d) on RESTORE_DEPTH_3N layers; (e) the 100m preset for STEPS_3N_E
# steps.  DP_RTOL_3N / DP_ATOL_3N: the reference's microbatch-equivalence
# tolerance (tests/test_training.py:57,62), the rule a mesh's losses and
# masters are held to against (a); COMPRESSED_REL_3N the reference's bound
# for the compressed step (tests/test_training.py:118)
DEPTH_3N = 2
STEPS_3N = 2                   # 3 before [3o]
RESTORE_DEPTH_3N = 1
STEPS_3N_E = 5
DP_RTOL_3N, DP_ATOL_3N = 2e-2, 2e-3
COMPRESSED_REL_3N = 0.05
TIMEOUT_3N = 600               # seconds for (b)-(e)'s ranks to finish
# [3o]: tensor-parallel training of the five families beyond plain
# attention at full width and [3m]'s depths, llama4-scout at 1 layer (5.44 B
# parameters at 2 layers would need 109 GB of training state at world 1,
# TRAIN_BYTES_PER_PARAM; 3.24 B at 1 layer need 65 GB), on a batch of
# BATCH_3O × SEQ_3O tokens in MB_3O microbatches (the batch is no width:
# it holds llama4's f32 logits, 202,048 per token, near 1.7 GB per
# microbatch), STEPS_3O steps; each (1,2) mesh held to its world 1 by
# [3n]'s DP rule; the MoE configs also under "a2a" at CF_3M (no drops),
# held to the (1,1) "a2a" context
FAMILIES_3O = (("recurrentgemma_9b", 3, (None,)), ("mamba2_1p3b", 4, (None,)),
               ("whisper_medium", 2, (None,)),
               ("deepseek_v2_lite_16b", 2, ("dense", "a2a")),
               ("llama4_scout_17b_a16e", 1, ("a2a",)))
BATCH_3O, SEQ_3O, MB_3O, STEPS_3O = 4, 256, 2, 2
TIMEOUT_3O = 600               # more seconds for [3n]'s ranks to finish it


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


def kernel_gemm_experts(torch, dev, flush, depths) -> dict:
    """``ttq_gemm_experts`` at both MoE configs' expert shapes, int4 g32, T
    = 4 bf16 tokens (shared by every expert for wg/wu, one set per expert
    for wd), L2 flushed.  The wrapper takes the mma tile
    (``csrc/ttq_gemm_experts.cu``): held against the plain version (one
    bf16 rounding), experts 0 and E-1 bit for bit a launch over that
    expert alone and over the half of the experts that holds it, two calls
    bitwise equal.  Timed in the same run, in turns (mma, batched, batched,
    mma; the mean of each tile's two medians): the batched CUDA-core tile
    through its C entry (``ttq_gemm_experts_launch`` at ``gemm_splits``'
    split, held to the same tolerance); then the plain version and one
    ``torch.bmm`` on the dequantized bf16 stack.  The bound: packed codes,
    S, Z, x, D⁻¹ and y over the memory rate, or the f32 operations, the
    larger.  Per decode step at ``depths`` (config → layers): the
    kernels-line row is deepseek-v2-lite's mma tile; every config's totals,
    the batched tile's beside, are returned."""
    from repro_torch.core.qdq import unpack_bits
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.ttq_gemm import (experts_tile, gemm_splits,
                                              ttq_gemm_experts)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, worst = {}, 0.0
    for cfg_name, shapes in EXPERT_SHAPES.items():
        tot = dict(ms=0.0, batched_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   library_ms=0.0, launches=0)
        for name, E, dp, d, per_layer in shapes:
            pk = torch.empty((E, dp, d // 8), dtype=torch.int32, device=dev)
            S = torch.empty((E, dp, d // 32), device=dev)
            Z = torch.empty_like(S)
            D = torch.exp(0.3 * torch.randn((E, d), generator=gen,
                                            device=dev))
            for e in range(E):              # one expert's f32 at a time
                W = torch.randn((dp, d), generator=gen, device=dev) \
                    * d ** -0.5
                pk[e], S[e], Z[e] = ref.ttq_quantize_ref(W, D[e], bits=4,
                                                         group_size=32)
            dinv = 1.0 / D
            shared = name != "wd"
            xb = torch.randn((4, d) if shared else (E, 4, d), generator=gen,
                             device=dev).to(torch.bfloat16)
            check(experts_tile(d, 32, 4, xb.dtype) == "mma",
                  f"ttq_gemm_experts {cfg_name} {name}: not the mma tile")
            y = ttq_gemm_experts(xb, pk, S, Z, dinv, bits=4, group_size=32)
            y2 = ttq_gemm_experts(xb, pk, S, Z, dinv, bits=4, group_size=32)
            y_r = ref.ttq_gemm_experts_ref(xb, pk, S, Z, bits=4,
                                           group_size=32, dinv=dinv)
            scale = (d / 256) ** 0.5
            torch.testing.assert_close(y.float(), y_r, rtol=2 ** -7,
                                       atol=2e-4 * scale)
            check(torch.equal(y, y2), f"ttq_gemm_experts {cfg_name} {name}: "
                  f"two calls differ")
            half = E // 2
            for e in (0, E - 1):
                for lo, hi in ((e, e + 1), (e // half * half,
                                            e // half * half + half)):
                    ys = ttq_gemm_experts(
                        xb if shared else xb[lo:hi], pk[lo:hi], S[lo:hi],
                        Z[lo:hi], dinv[lo:hi], bits=4, group_size=32)
                    check(torch.equal(y[e], ys[e - lo]),
                          f"ttq_gemm_experts {cfg_name} {name}: expert {e} "
                          f"of {E} differs from a launch over experts "
                          f"{lo}..{hi - 1}")
            split = gemm_splits(dp, d, 4, 4, 32, n_sm, E)
            y_b = torch.empty_like(y)

            def batched():
                check(build.lib().ttq_gemm_experts_launch(
                    xb.data_ptr(), 1, int(shared), pk.data_ptr(),
                    S.data_ptr(), Z.data_ptr(), dinv.data_ptr(),
                    y_b.data_ptr(), E, 4, dp, d, 4, 32, split, stream) == 0,
                    "the batched tile's launch refused")
            batched()
            torch.testing.assert_close(y_b.float(), y_r, rtol=2 ** -7,
                                       atol=2e-4 * scale)
            worst = max(worst, float((y.float() - y_r).abs().max()))
            w_lib = torch.stack([
                ((unpack_bits(pk[e], d, 4).float()
                  * S[e].repeat_interleave(32, 1)
                  + Z[e].repeat_interleave(32, 1)) * dinv[e]).to(
                      torch.bfloat16) for e in range(E)])
            xl = xb.expand(E, 4, d) if shared else xb

            def mma():
                return ttq_gemm_experts(xb, pk, S, Z, dinv, bits=4,
                                        group_size=32)
            turns = [time_ms(torch, fn, flush=flush)
                     for fn in (mma, batched, batched, mma)]
            t_k, t_b = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            t_p = time_ms(torch, lambda: ref.ttq_gemm_experts_ref(
                xb, pk, S, Z, bits=4, group_size=32, dinv=dinv), iters=3,
                warmup=1, flush=flush)
            t_l = time_ms(torch, lambda: torch.bmm(xl, w_lib.transpose(1, 2)),
                          flush=flush)
            moved = nbytes(pk, S, Z, dinv, xb) + E * 4 * dp * 2
            b = max(moved / HBM_BYTES_PER_S,
                    2 * E * 4 * dp * d / F32_FLOP_PER_S) * 1e3
            L = depths[cfg_name]
            n = L * per_layer
            for k, v in (("ms", t_k), ("batched_ms", t_b), ("plain_ms", t_p),
                         ("bound_ms", b), ("library_ms", t_l)):
                tot[k] += n * v
            tot["launches"] += n
            print(f"  ttq_gemm_experts {cfg_name} {name} E={E} {dp}x{d} T=4 "
                  f"int4: mma tile {t_k * 1e3:.1f} us ({b / t_k:.1%} of the "
                  f"bound; turns {turns[0] * 1e3:.1f}, {turns[3] * 1e3:.1f}), "
                  f"batched tile "
                  f"{t_b * 1e3:.1f} us ({b / t_b:.1%}; turns "
                  f"{turns[1] * 1e3:.1f}, {turns[2] * 1e3:.1f}; split "
                  f"{split}), bound {b * 1e3:.1f} us, plain "
                  f"{t_p * 1e3:.1f} us, torch.bmm bf16 {t_l * 1e3:.1f} us; "
                  f"experts 0 and {E - 1} bit for bit launches over "
                  f"themselves alone and over half the experts, two calls "
                  f"bitwise equal")
            del pk, S, Z, D, dinv, w_lib, xb, xl, y, y2, y_r, y_b
            torch.cuda.empty_cache()
        print(f"  ttq_gemm_experts {cfg_name} per decode step "
              f"({depths[cfg_name]} layers, {tot['launches']} launches): "
              f"mma tile {tot['ms']:.3f} ms ({tot['bound_ms'] / tot['ms']:.1%}"
              f" of the bound), batched tile {tot['batched_ms']:.3f} ms "
              f"({tot['bound_ms'] / tot['batched_ms']:.1%}), bound "
              f"{tot['bound_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"torch.bmm {tot['library_ms']:.3f} ms")
        rows[cfg_name] = tot
    main = rows["deepseek-v2-lite"]
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], library_ms=main["library_ms"],
                bound_by="bytes"), rows


def kernel_wkv_b(torch, dev, flush) -> dict:
    """MLA's latent expansion at deepseek-v2-lite's shape: the 2-D
    ``ttq_gemm`` over T = 4 slots x 256 rows = 1,024 bf16 latent rows,
    ``wkv_b`` (d' = 16 heads x (128 + 128) = 4,096, d = 512) int4 g32, L2
    flushed.  ``gemm_tile`` must send it to the wide tile
    (``csrc/ttq_gemm_wide.cu``), held to the plain version (one bf16
    rounding, [2]'s tolerance), two calls bitwise equal, a world-2 rank's
    rows (2,048 of them) and the first 515 tokens bit for bit the whole
    launch's.  Timed in the same run: the split tile forced at the same
    shape (``ttq_gemm._launch``, held to the same tolerance), the experts'
    tensor-core tile at E = 1 (``ttq_gemm_experts``), one ``torch.matmul``
    on the dequantized bf16 weight and the plain version; then T = 64, 256
    and 1,024 on both tiles and ``torch.matmul``.  The bound: codes, S, Z,
    D⁻¹, x and y over the memory rate, or the operations 2·T·d'·d over the
    bf16 tensor-core rate (the operands are bf16 activations and int4
    codes, and ``torch.matmul`` runs them there), the larger.  Per decode
    step: 27 launches, one per layer.  Not counted as launches: the main
    path's come from [3i]."""
    from repro_torch.configs import get
    from repro_torch.core.qdq import unpack_bits
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_gemm import (_launch, experts_tile,
                                              gemm_tile, ttq_gemm,
                                              ttq_gemm_experts)
    cfg = get(MOE_3I[0])
    m = cfg.mla
    dp, d = cfg.n_heads * (m.qk_nope_dim + m.v_head_dim), m.kv_lora_rank
    T, per_step = 4 * 256, cfg.n_layers
    check((dp, d, per_step) == (4096, 512, 27), f"wkv_b: shape {(dp, d)} "
          f"and {per_step} layers, not deepseek-v2-lite's (4096, 512), 27")
    check(gemm_tile(T, dp, d, 32, 4, torch.bfloat16) == "wide",
          "wkv_b: gemm_tile does not take the wide tile")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    W = torch.randn((dp, d), generator=gen, device=dev) * d ** -0.5
    D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=dev))
    dinv = 1.0 / D
    pk, S, Z = ref.ttq_quantize_ref(W, D, bits=4, group_size=32)
    xb = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
    scale = (d / 256) ** 0.5
    tol = dict(rtol=2 ** -7, atol=2e-4 * scale)
    y_r = ref.ttq_gemm_ref(xb, pk, S, Z, bits=4, group_size=32, dinv=dinv)
    y = ttq_gemm(xb, pk, S, Z, dinv, bits=4, group_size=32)
    torch.testing.assert_close(y.float(), y_r, **tol)
    check(torch.equal(y, ttq_gemm(xb, pk, S, Z, dinv, bits=4,
                                  group_size=32)),
          "wkv_b: two calls of the wide tile differ")
    half = dp // 2
    check(torch.equal(y[:, half:], ttq_gemm(
        xb, pk[half:], S[half:], Z[half:], dinv, bits=4, group_size=32)),
        "wkv_b: a world-2 rank's rows differ from the whole launch's")
    check(torch.equal(y[:515], ttq_gemm(xb[:515], pk, S, Z, dinv, bits=4,
                                        group_size=32)),
          "wkv_b: the first 515 tokens differ from the whole launch's")
    y_s = _launch(xb, pk, S, Z, dinv, 4, 32, "split")
    torch.testing.assert_close(y_s.float(), y_r, **tol)
    check(experts_tile(d, 32, 4, xb.dtype) == "mma",
          "wkv_b: experts_tile does not take the tensor-core tile")
    one = (pk[None], S[None], Z[None], dinv[None])
    y_m = ttq_gemm_experts(xb, *one, bits=4, group_size=32)
    torch.testing.assert_close(y_m[0].float(), y_r, **tol)
    err = float((y.float() - y_r).abs().max())
    w_lib = ((unpack_bits(pk, d, 4).float() * S.repeat_interleave(32, 1)
              + Z.repeat_interleave(32, 1)) * dinv).to(torch.bfloat16)

    def tiles_at(x):
        return (time_ms(torch, lambda: ttq_gemm(x, pk, S, Z, dinv, bits=4,
                                                group_size=32), flush=flush),
                time_ms(torch, lambda: _launch(x, pk, S, Z, dinv, 4, 32,
                                               "split"), flush=flush),
                time_ms(torch, lambda: torch.matmul(x, w_lib.T),
                        flush=flush))
    t_k, t_s, t_l = tiles_at(xb)
    t_m = time_ms(torch, lambda: ttq_gemm_experts(xb, *one, bits=4,
                                                  group_size=32), flush=flush)
    t_p = time_ms(torch, lambda: ref.ttq_gemm_ref(
        xb, pk, S, Z, bits=4, group_size=32, dinv=dinv), flush=flush)
    sweep = {n: tiles_at(xb[:n].clone()) for n in (64, 256)}
    sweep[T] = (t_k, t_s, t_l)
    moved = nbytes(pk, S, Z, dinv, xb) + T * dp * 2
    flops = 2 * T * dp * d
    b_bytes, b_ops = (moved / HBM_BYTES_PER_S * 1e3,
                      flops / DENSE_BF16_FLOP_PER_S * 1e3)
    b = max(b_bytes, b_ops)
    res = dict(T=T, dp=dp, d=d, launches_per_step=per_step, ms=t_k,
               split_ms=t_s, mma_ms=t_m, plain_ms=t_p, library_ms=t_l,
               bound_ms=b, bytes_bound_ms=b_bytes, ops_bound_ms=b_ops,
               max_abs_err=err, sweep_ms={n: dict(wide=v[0], split=v[1],
                                                  matmul=v[2])
                                          for n, v in sweep.items()},
               bound_by="operations" if b_ops > b_bytes else "bytes")
    print(f"  ttq_gemm wkv_b (MLA's latent expansion, deepseek-v2-lite) "
          f"T={T} {dp}x{d} int4 g32, gemm_tile 'wide': {t_k * 1e3:.1f} us "
          f"(the split tile {t_s * 1e3:.1f} us, {t_s / t_k:.1f}x), the "
          f"experts' mma tile at E = 1 {t_m * 1e3:.1f} us, torch.matmul bf16 "
          f"{t_l * 1e3:.1f} us, plain {t_p * 1e3:.1f} us; bound "
          f"{b * 1e3:.2f} us ({res['bound_by']}; bytes {b_bytes * 1e3:.2f} "
          f"us, bf16 tensor-core operations {b_ops * 1e3:.2f} us), "
          f"{b / t_k:.2%} of it reached; wide / torch.matmul "
          f"{t_k / t_l:.2f}x; every tile within one bf16 rounding of the "
          f"plain version (wide max |diff| {err:.3g}), two wide calls "
          f"bitwise equal, a world-2 rank's rows and the first 515 tokens "
          f"bit for bit the whole launch's; per decode step ({per_step} "
          f"launches): wide {t_k * per_step:.3f} ms, split "
          f"{t_s * per_step:.3f} ms, torch.matmul {t_l * per_step:.3f} ms, "
          f"bound {b * per_step:.3f} ms; by T (us, wide / split / "
          f"torch.matmul): " + ", ".join(
              f"{n} {v[0] * 1e3:.1f} / {v[1] * 1e3:.1f} / {v[2] * 1e3:.1f}"
              for n, v in sweep.items()))
    del W, pk, S, Z, w_lib, xb, y, y_s, y_m, y_r
    torch.cuda.empty_cache()
    return res


def attn_bounds_ms(Hkv, G, Dh, bits, cur, *small) -> tuple:
    """Least times of one decode-attention launch over ``Hkv`` kv heads of
    ``G`` query heads each: (bytes, operations).  Bytes: each live cached
    row's codes and one f32 scale, for k and v, read once, and ``small``
    (q, the output, cur_pos, a block table) once, over the memory rate;
    operations: 4·G f32 flops per cached element (a score and a weighted
    value for each query head), over the f32 rate outside the tensor
    cores."""
    rows = sum(c + 1 for c in cur)
    moved = 2 * Hkv * (Dh * bits // 8 + 4) * rows + nbytes(*small)
    ops = 4 * G * Hkv * Dh * rows
    return moved / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3


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
    kw = dict(enable_gqa=True) if qb.shape[1] != k.shape[1] else {}
    t = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qb, k, v, attn_mask=mask, **kw), flush=flush)
    return t, F.scaled_dot_product_attention(qb, k, v, attn_mask=mask, **kw)


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


def attn_case(torch, dev, seed, nblk, cur, bits_list=(8, 4), Hkv=16, G=1,
              Dh=256):
    """4 slots × Hkv kv heads of Dh (gemma-7b: 16 of 256, G = 1) in a pool
    of blocks of BLOCK rows under a seeded permuted block table (nblk blocks
    per slot), and the same cache gathered into the dense (4, Hkv,
    nblk·BLOCK, ·) layout; yields per bits (bits, f32 q of Hkv·G heads,
    dense leaves, pool leaves, table, cur_pos)."""
    from repro_torch.core.kvquant import quantize_kv
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = 4
    NB = B * nblk + 1
    pk = torch.randn((NB, Hkv, BLOCK, Dh), generator=gen, device=dev)
    pv = torch.randn((NB, Hkv, BLOCK, Dh), generator=gen, device=dev)
    q = torch.randn((B, Hkv * G, 1, Dh), generator=gen, device=dev)
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
        b_d = max(attn_bounds_ms(16, 1, 256, bits, cur_main, qb, qb, pos))
        b_p = max(attn_bounds_ms(16, 1, 256, bits, cur_main, qb, qb, pos,
                                 bt))
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
            b = max(attn_bounds_ms(16, 1, 256, bits, LONG_CUR, qb, qb, pos,
                                   *extra))
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


def kernel_attention_groups(torch, dev, flush, cur_main):
    """Both attention kernels at the GQA groups of [3g]'s families
    (ATTN_GROUPS: minitron-4b G = 3 over 8 kv heads, starcoder2-15b 12 over
    4, granite-34b 48 over 1; Dh 128), 4 slots of capacity 256 at the main
    path's ``cur_pos``, int8 and int4: checked as at gemma-7b's shape (every
    C, f32 and bf16 q, paged bit for bit dense, two calls bitwise equal);
    timed with bf16 q at the rule's C beside the plain version, both bounds
    (bytes, f32 operations) and one ``scaled_dot_product_attention`` call
    (``enable_gqa``) on the dequantized cache.  Returns {(kernel, G,
    bits): (ms, plain ms, bytes bound ms, operations bound ms, sdpa ms)}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_attn import _launch, attn_splits, head_tile
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nblk = 256 // BLOCK
    res = {}
    for arch, Hkv, G in ATTN_GROUPS:
        gt, tiles = head_tile(G, 128)
        c_rule = attn_splits(4, Hkv * tiles, nblk * BLOCK, n_sm)
        for bits, q, dense, pool, bt, pos in attn_case(
                torch, dev, SEED + 5 + G, nblk, cur_main, Hkv=Hkv, G=G,
                Dh=128):
            worst = attn_checked(torch, q, dense, pool, bt, pos, bits,
                                 f"attention G = {G}")
            qb = q.to(torch.bfloat16)
            for kind, tab in (("dense", None), ("paged", bt)):
                cache = pool if tab is not None else dense
                plain = ref.kv_paged_attn_ref if tab is not None else \
                    ref.kv_attn_ref
                targs = (tab,) if tab is not None else ()
                t_k = time_ms(torch, lambda: _launch(
                    qb, *cache, tab, pos, None, bits=bits), flush=flush)
                t_p = time_ms(torch, lambda: plain(
                    qb, *cache, *targs, pos, bits=bits), flush=flush)
                t_l, _ = sdpa_ms(torch, qb, *dense, pos, bits, flush)
                b_b, b_o = attn_bounds_ms(Hkv, G, 128, bits, cur_main, qb,
                                          qb, pos, *targs)
                name = f"ttq_{'paged_' if tab is not None else ''}" \
                    f"decode_attention"
                print(f"  {name} G = {G} ({arch}: {Hkv} kv heads of 128, "
                      f"{tiles} tiles of {gt}) int{bits} cur_pos={cur_main}: "
                      f"{t_k * 1e3:.1f} us at C = {c_rule} "
                      f"({4 * Hkv * tiles * c_rule} blocks), bound "
                      f"{max(b_b, b_o) * 1e3:.2f} us (bytes {b_b * 1e3:.2f}, "
                      f"operations {b_o * 1e3:.2f}), plain {t_p * 1e3:.1f} "
                      f"us, scaled_dot_product_attention bf16 "
                      f"{t_l * 1e3:.1f} us; max |diff| from the plain "
                      f"version {worst:.3g}")
                res[name, G, bits] = (t_k, t_p, b_b, b_o, t_l)
    print("  every group: both kernels at every C, f32 and bf16 q, within "
          "1e-5 of the plain version (bf16: and one rounding); paged bit "
          "for bit dense; two calls bitwise equal")
    return res


# --------------------------------------------------------------- phase 3

def clone_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(torch, v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def make_prompts(vocab: int = 256000) -> list[list[int]]:
    """The main path's traffic: N_REQUESTS prompts of 16-64 tokens drawn
    from a vocabulary of ``vocab`` (gemma-7b's by default)."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, size=int(n)).tolist()
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
    """The graph readings shared by [3], [3b] and [3g], after the cold run
    (one decode graph, or two under the guards: one per tree of the
    spare's swap):
    decode and prefill graphs, capture times (prefill per shape) and peak
    memory, a warm rerun, and the shadowed run of :func:`graph_vs_eager`.
    A rerun adds no decode graph, and a prefill graph only for a shape the
    cold run could not have had: a tail past a prefix the cold run left in
    the paged pool's cache.  Where the warm run added such graphs, it is
    run once more and must add none; the shadowed run adds none."""
    r = eng.runner
    decode_graphs = 2 if eng.ecfg.guards else 1
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
    check(eng.compiled_programs == decode_graphs + len(r._prefills)
          and len(r._graphs) == decode_graphs,
          f"compiled programs {eng.compiled_programs}: {len(r._graphs)} "
          f"decode graphs (want {decode_graphs}) and {len(r._prefills)} "
          f"prefill graphs")
    shadow, _ = graph_vs_eager(torch, cfg, eng, prompts)
    check(eng.compiled_programs == res["compiled_programs_warm"],
          f"the shadowed run captured: {res['compiled_programs_warm']} → "
          f"{eng.compiled_programs}")
    res.update(shadow)
    print(f"  captures: {len(r._graphs)} decode graphs (warm block and "
          f"capture {res['capture_s']:.3f} s), {len(r._prefills)} prefill graphs "
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


def split_sum_experts(x, packed, scale, zero, dinv, *, bits, group_size):
    """:func:`split_sum_gemm` on each expert of an expert-batched GEMM."""
    import torch
    return torch.stack([split_sum_gemm(
        x if x.dim() == 2 else x[e], packed[e], scale[e], zero[e], dinv[e],
        bits=bits, group_size=group_size) for e in range(packed.shape[0])])


@contextlib.contextmanager
def routed(gemm=None, attn=None, experts=None):
    """Send the port's GEMM, KV-attention and expert-GEMM dispatch through
    other functions (None: leave it as it is) for the duration of the
    block."""
    from repro_torch.kernels import ops
    saved = ops.ttq_gemm, ops.kv_decode_attention, ops.ttq_gemm_experts
    ops.ttq_gemm = gemm or saved[0]
    ops.kv_decode_attention = attn or saved[1]
    ops.ttq_gemm_experts = experts or saved[2]
    try:
        yield
    finally:
        ops.ttq_gemm, ops.kv_decode_attention, ops.ttq_gemm_experts = saved


@contextlib.contextmanager
def recorded_routes(torch, rec):
    """Append each MoE router call's (top-k indices, f32 probabilities) to
    ``rec`` for the duration of the block."""
    from repro_torch.models import layers
    real = layers._router

    def spy(cfg, p, x2, stats, prefix):
        top_p, top_i = real(cfg, p, x2, stats, prefix)
        rec.append((top_i, torch.softmax(x2.float() @ p["router"].float().T,
                                         dim=-1)))
        return top_p, top_i
    layers._router = spy
    try:
        yield rec
    finally:
        layers._router = real


def routing_agreement(torch, rec_k, rec_p, what) -> dict:
    """The kernel step's routing (``rec_k``) against the plain step's
    (``rec_p``), layer by layer: the share of (token, layer, k) choices
    equal, and each token's first disagreement held to a near-tie: the
    plain probabilities of the experts it swapped differ by no more than
    twice the largest change of any of that token's router probabilities
    between the two steps at that layer (the rounding that moved them).
    Later layers of a token that flipped are its consequence, not held."""
    equal = total = 0
    flipped, ties = set(), []
    for layer, ((ik, pk), (ip, pp)) in enumerate(zip(rec_k, rec_p)):
        ik, pk, ip, pp = (t.cpu() for t in (ik, pk, ip, pp))
        same = (ik[:, :, None] == ip[:, None, :]).any(-1)     # (T, k)
        equal += int(same.sum())
        total += same.numel()
        for t in range(ik.shape[0]):
            if bool(same[t].all()) or t in flipped:
                continue
            flipped.add(t)
            gone = set(ip[t].tolist()) - set(ik[t].tolist())
            came = set(ik[t].tolist()) - set(ip[t].tolist())
            gap = max(abs(float(pp[t, a] - pp[t, b]))
                      for a in gone for b in came)
            bound = 2 * float((pk[t] - pp[t]).abs().max())
            ties.append(dict(layer=layer, token=t, gap=gap, bound=bound))
            check(gap <= bound, f"{what}: routing of token {t} at layer "
                  f"{layer} differs from the plain path's by a probability "
                  f"gap {gap:.3g}, beyond twice the rounding's {bound / 2:.3g}")
    share = equal / max(total, 1)
    print(f"  {what}: routing {equal} of {total} (token, layer, k) choices "
          f"equal to the plain path's ({share:.2%}); {len(ties)} first "
          f"disagreements, each a near-tie: "
          + (", ".join(f"layer {x['layer']} token {x['token']} gap "
                       f"{x['gap']:.2e} <= {x['bound']:.2e}" for x in ties)
             or "none"))
    return dict(equal=equal, total=total, share=share, near_ties=ties)


def held_to_plain(torch, gaps):
    """Dispatch functions that launch each kernel, hold its output against
    the plain version's on the same inputs (one bf16 rounding: rtol 2^-7;
    atol as in phase 2) and record per call shape [outputs, outputs that
    differ, largest |difference|] in ``gaps``."""
    from repro_torch.kernels import ops
    kernels = ops.ttq_gemm, ops.kv_decode_attention, ops.ttq_gemm_experts

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
    experts = held(kernels[2], lambda x, pk, *_: f"ttq_gemm_experts "
                   f"{pk.shape[0]}x{pk.shape[1]}x{x.shape[-1]}",
                   lambda x, *_: 2e-4 * (x.shape[-1] / 256) ** 0.5)
    return gemm, attn, experts


def depth_witness(torch, cfg, eng, r, depths=DEPTHS):
    """Relative L2 distance of one decode step's logits on the first L
    layers (L in ``depths``; whole units of a hybrid pattern) from the plain
    path's, on the same state and tree,
    for: both kernels; the GEMM kernel alone; the attention kernel alone;
    the plain path with its GEMM sums split in two halves (another f32
    order, no kernel); the plain path run again.  At full depth each kernel
    call of the "kernels" step is also held against its plain version.  A
    MoE config's "kernels" step is also held to the plain step's routing
    (:func:`routing_agreement`; its ``routing`` entry)."""
    from repro_torch.core import KernelConfig
    from repro_torch.models import lm
    from repro_torch.models.stack import layer_slice, stack_spec
    kvplain = dataclasses.replace(eng.kvcfg, use_pallas=False)
    on, off = KernelConfig(use_pallas=True), KernelConfig(use_pallas=False)
    variants = {"kernels": (eng.kvcfg, on, ()),
                "gemm kernel": (kvplain, on, ()),
                "attention kernel": (eng.kvcfg, off, ()),
                "split-sum plain": (kvplain, on, (split_sum_gemm, None,
                                                  split_sum_experts)),
                "plain again": (kvplain, off, ())}
    gaps = {}
    out = {}
    for L in depths:
        cfg_l = dataclasses.replace(cfg, n_layers=L)
        cut = [n for _, n in stack_spec(cfg_l)]     # the first L layers
        p_l = dict(eng.decode_params, stack=[
            layer_slice(run, slice(0, n))
            for run, n in zip(eng.decode_params["stack"], cut)])
        st = {"stack": [layer_slice(run, slice(0, n))
                        for run, n in zip(r.state["stack"], cut)]}

        def step(kv, kc, route=()):
            with routed(*route):
                lg, _ = lm.decode_step(cfg_l, p_l, clone_tree(torch, st),
                                       r.cur_tok, r.pos, kvcfg=kv, kcfg=kc)
            return lg
        rec_p, rec_k = [], []
        with recorded_routes(torch, rec_p):
            lg_p = step(kvplain, off)
        out[L] = {}
        for name, (kv, kc, route) in variants.items():
            if L == depths[-1] and name == "kernels":
                route = held_to_plain(torch, gaps)
            with recorded_routes(torch, rec_k if name == "kernels" else []):
                lg = step(kv, kc, route)
            check(lg.shape == (r.pos.shape[0], cfg.vocab)
                  and bool(torch.isfinite(lg).all()),
                  f"{name} logits at {L} layers not finite / wrong shape")
            out[L][name] = float((lg - lg_p).norm() / lg_p.norm())
        print(f"  decode_step on {L:2d} layers, rel-L2 to plain: "
              + ", ".join(f"{k} {v:.2e}" for k, v in out[L].items()))
        if cfg.moe is not None:
            out[L]["routing"] = routing_agreement(
                torch, rec_k, rec_p, f"{cfg.name} decode_step on {L} layers")
    for key, (n, n_diff, most) in gaps.items():
        print(f"  {key} in one {depths[-1]}-layer step: {n_diff} of {n} "
              f"outputs differ from the plain version's, by at most {most:.3g}")
    return out, gaps


def warm_phases(torch, eng, prompts, n_tok, quiet=False):
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
    if quiet:
        return res
    print(f"  warm run: {n_tok / wall2:.1f} tok/s; phases (synced) "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phase.items())
          + f"; decode {res['decode_ms_per_step']:.2f} ms per step")
    return res


def warm_repeats(torch, eng, prompts, n_tok) -> dict:
    """WARM_REPEATS more warm runs of the same traffic back to back: the
    median and spread (min, max) of ms per decode step and tokens/s."""
    runs = [warm_phases(torch, eng, prompts, n_tok, quiet=True)
            for _ in range(WARM_REPEATS)]
    out = {}
    for key in ("decode_ms_per_step", "warm_tok_per_s"):
        xs = [r[key] for r in runs]
        out[key] = dict(median=statistics.median(xs), min=min(xs),
                        max=max(xs), runs=xs)
    d, t = out["decode_ms_per_step"], out["warm_tok_per_s"]
    print(f"  {WARM_REPEATS} warm runs: ms per decode step median "
          f"{d['median']:.3f} (min {d['min']:.3f}, max {d['max']:.3f}); "
          f"tokens/s median {t['median']:.1f} (min {t['min']:.1f}, max "
          f"{t['max']:.1f})")
    return out


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


@contextlib.contextmanager
def recorded_gemm_tiles():
    """Every 2-D ``ttq_gemm`` launch made from Python inside the block (an
    eager call, or one a graph's capture records: each replay repeats it)
    as (T, d', d, tile)."""
    import importlib
    # the module, not the function repro_torch.kernels re-exports by its name
    tg = importlib.import_module("repro_torch.kernels.ttq_gemm")
    real, rec = tg._launch, []

    def launch(x2, packed, scale, zero, dinv, bits, g, tile):
        rec.append((x2.shape[0], packed.shape[0], x2.shape[1], tile))
        return real(x2, packed, scale, zero, dinv, bits, g, tile)
    tg._launch = launch
    try:
        yield rec
    finally:
        tg._launch = real


def gemm_tiles_checked(cfg, rec, launches, what) -> dict:
    """The 2-D ``ttq_gemm``'s tiles in a run: the tiles counted
    (``build.GEMM_TILES``, replays included) add up to its launches; every
    recorded launch (:func:`recorded_gemm_tiles`) at an MLA config's
    ``wkv_b`` expansion (its d' x kv_lora_rank, T >= WIDE_MIN_T) took the
    wide tile, at least one did, and every other launch took the split
    tile."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ttq_gemm import WIDE_MIN_T
    tiles = dict(build.GEMM_TILES)
    wkv_b = None
    if cfg.mla is not None:
        m = cfg.mla
        wkv_b = (cfg.n_heads * (m.qk_nope_dim + m.v_head_dim), m.kv_lora_rank)
    bad = sorted({r for r in rec if (r[3] == "wide")
                  != (r[1:3] == wkv_b and r[0] >= WIDE_MIN_T)})
    check(sum(tiles.values()) == launches["ttq_gemm"] and not bad
          and (tiles["wide"] > 0) == (wkv_b is not None),
          f"{what}: ttq_gemm tiles {tiles} in {launches['ttq_gemm']} "
          f"launches; launches (T, d', d, tile) on the wrong tile: {bad}")
    return tiles


def main_path(torch, dev, prompts, cfg, params):
    from repro_torch.kernels import build

    cfg, ecfg, eng = build_engine(torch, dev, cfg, params)
    build.reset_launches()
    with recorded_gemm_tiles() as rec:
        outs, wall = serve(torch, eng, prompts)
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    check_outputs(cfg, outs, "dense main path")
    on_path = ("ttq_quantize", "ttq_gemm", "ttq_decode_attention")
    check(all(launches[k] > 0 for k in on_path),
          f"a kernel of the main path never launched: {launches}")
    tiles = gemm_tiles_checked(cfg, rec, launches, "dense main path")
    res = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               requants=eng.n_requants, requant_dispatch_s=eng.requant_wall_s,
               host_syncs=eng.host_syncs,
               syncs_per_token=eng.host_syncs / n_tok, launches=launches,
               gemm_tiles=tiles,
               decode_chunk=eng.ecfg.decode_chunk,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  served {len(prompts)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.1f} tok/s; requants {eng.n_requants} (dispatch "
          f"{eng.requant_wall_s * 1e3:.1f} ms); host syncs {eng.host_syncs} "
          f"({res['syncs_per_token']:.4f}/token); launches {launches}, "
          f"ttq_gemm tiles {tiles}")

    res.update(graph_phases(torch, cfg, eng, prompts, n_tok))
    res["warm_repeats"] = warm_repeats(torch, eng, prompts, n_tok)

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
    with recorded_gemm_tiles() as rec:
        outs, wall = serve(torch, eng, prompts)
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    check_outputs(cfg, outs, "paged main path")
    on_path = ("ttq_quantize", "ttq_gemm", "ttq_paged_decode_attention")
    check(all(launches[k] > 0 for k in on_path)
          and launches["ttq_decode_attention"] == 0,
          f"paged path launches {launches}")
    tiles = gemm_tiles_checked(cfg, rec, launches, "paged main path")
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
               kv_pool_utilization=eng.kv_pool_utilization, gemm_tiles=tiles)
    print(f"  served {len(prompts)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.1f} tok/s; greedy tokens equal to the dense run's; "
          f"{eng.num_blocks} blocks, pool use {eng.kv_pool_utilization:.3f}; "
          f"host syncs {eng.host_syncs}; launches {launches}, ttq_gemm tiles "
          f"{tiles}")
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
    plain version: the dequantized weights differ by at most 0.  Each
    stack is checked a chunk of layers at a time (at most 1 GiB of f32
    residual), so the plain version's temporaries fit beside the trees at
    full depth."""
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
            W = _tree_get(qm.params, m.path)
            D = m.eff.quantizer.diag(plan._stat(stats, m).reshape(-1, m.d),
                                     count, m.eff.acfg, m.d)
            step = max(1, (1 << 30) // (m.dp * m.d * 4))
            off, sz, err = 0, True, 0.0
            for i in range(0, W.shape[0], step):
                j = slice(i, i + step)
                R = residual(W[j], ba["B"][j], ba["A"][j])
                o, z, e = quant_mismatch(
                    torch, ops.ttq_quantize(R, D[j], bits=4, group_size=32),
                    ref.ttq_quantize_ref(R, D[j], bits=4, group_size=32),
                    m.d, 4)
                off, sz = off + o, sz and z
                if not e <= err:                 # NaN propagates
                    err = e
                del R
            out[m.path_str] = dict(codes_differ=off, sz_equal=sz,
                                   max_abs_err=err)
            check(err == 0.0, f"{m.path_str}: ttq_quantize on the residual "
                  f"differs from its plain version by {err} ({off} codes)")
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


def default_policy(torch, dev, cfg, params, base, depth=DEPTH_3D) -> dict:
    """Phase 3d: the reference's default serving policy, ttq_policy(bits=4,
    group_size=32, rank=16, packed=True) with the delta gate and the double
    buffer, at full width and ``depth`` layers, on [3]'s traffic.  Checks
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
    cfg_d = dataclasses.replace(cfg, n_layers=depth)
    params_d = dict(params, stack=[layer_slice(run, slice(0, depth))
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
    print(f"  factors: {7 * depth} top-{RANK_3D} SVDs at engine "
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
          f"double buffer {res['decode_ms_per_step']:.2f} at {depth} "
          f"layers; rank 0 at {depth} layers "
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


def first_layers(tree, depth):
    """The first ``depth`` layers of a stacked tree whose leaves may be
    None (a low-rank factor tree from a deeper [3d] run; views)."""
    if isinstance(tree, dict):
        return {k: first_layers(v, depth) for k, v in tree.items()}
    return None if tree is None else tree[:depth]


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
             drafts, rows=4):
    """At request ``i``'s first disagreement (index ``t`` of its output; the
    runs chose ``a`` and ``b``), recompute its logits eagerly for the agreed
    prefix ``drafts[:t]`` on ``tree``: one ``decode_step`` after the prefill
    and the decode of the prefix, and one ``verify_window`` from the same
    state (the window the agreed token and the next W of ``drafts``), each
    for one copy of the request and for ``rows`` copies (the engine's
    slots: a decode step of that many rows and a verify window of ``rows``
    · (W + 1), as the two runs have).  At t = 0, the prompt's prefill
    alone and in the batch of every prompt.  Returns (|logit a − logit b|
    in the one-copy decode logits, the largest |Δlogit| between any two of
    the sets, and for t > 0 each set's logit a − logit b)."""
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
        return (float((L_d[a] - L_d[b]).abs()),
                float((L_d - L_v).abs().max()), {})
    win = (list(drafts[t - 1:t + SPEC_W]) + [drafts[-1]] * SPEC_W)[
        :SPEC_W + 1]
    sets = {}
    for n in (1, rows):
        _, st, _ = lm.prefill(cfg, fp, {"tokens": torch.tensor(
            [prompts[i]] * n, device=dev)}, ML, collect_stats=False,
            kvcfg=kvcfg)
        tok = lambda x: torch.full((n, 1), x, dtype=torch.int32, device=dev)
        at = lambda p: torch.full((n,), p, dtype=torch.int32, device=dev)
        for j in range(t - 1):
            lm.decode_step(cfg, tree, st, tok(drafts[j]), at(P + j),
                           kvcfg=kvcfg, kcfg=kcfg)
        st_v = clone_tree(torch, st)
        L_d, _ = lm.decode_step(cfg, tree, st, tok(drafts[t - 1]),
                                at(P + t - 1), kvcfg=kvcfg, kcfg=kcfg)
        L_v, _ = lm.verify_window(cfg, tree, st_v, torch.tensor(
            [win] * n, dtype=torch.int32, device=dev), at(P + t - 1),
            kvcfg=kvcfg, kcfg=kcfg)
        sets[f"decode x{n}"], sets[f"verify x{n}"] = L_d[0], L_v[0, 0]
    L = list(sets.values())
    delta = max(float((x - y).abs().max()) for k, x in enumerate(L)
                for y in L[k + 1:])
    return (float((L[0][a] - L[0][b]).abs()), delta,
            {k: float(v[a] - v[b]) for k, v in sets.items()})


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
    differ by no more than twice the largest gap between the recomputed
    decode and verify logits at one copy and at the engine's slots (the
    rounding of the shapes the two runs compute at).
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
        margin, delta, sets = near_tie(
            torch, cfg, out["fp"], tree, out["kvcfg"], out["kcfg"], prompts,
            i, t, a[t], b[t], b)
        rows.append(dict(request=i, t=t, held=True, margin=margin,
                         delta=delta, a_minus_b=sets))
        print(f"  {label} request {i}: first disagreement at token {t} "
              f"({a[t]} vs {b[t]}): their logits differ by {margin:.4g}, the "
              f"recomputed logits by up to {delta:.4g}"
              + (" (logit a - logit b: " + ", ".join(
                  f"{k} {v:.4g}" for k, v in sets.items()) + ")"
                 if sets else ""))
        # two sets of logits at most δ apart entry by entry can order two
        # tokens differently only within 2δ of each other
        check(margin <= 2 * delta, f"{label} request {i}: the disagreement "
              f"at token {t} is no near-tie ({margin} > 2 x {delta})")
    return rows


def speculation(torch, dev, cfg, params, factors) -> dict:
    """Phase 3e: self-speculative decoding, W = SPEC_W, at full width.
    (a) the reference's default policy (rank 16 with [3d]'s factors of its
    first DEPTH_3D layers, gate, double buffer) on DEPTH_3D layers with its
    default int4 rank-0 draft;
    (b) draft-only, bf16 weights with an int4 g32 draft, on DEPTH_3E_B
    layers on the dense slab and on the paged pool (block 16); (c) (b) on
    the first
    layer alone, the witness that rounding is not amplified there.
    Each through :func:`spec_case`; then the kernel checks over the path."""
    from repro_torch.core import KernelConfig, KVCacheConfig, NO_QUANT
    from repro_torch.core import ttq_policy
    t0 = time.perf_counter()
    prompts = make_prompts()
    kern, kv8 = KernelConfig(use_pallas=True), KVCacheConfig(dtype="int8")
    res, outs = {}, {}
    cfg_d, params_d = cut(cfg, params, DEPTH_3D)
    factors = dict(factors, stack=[first_layers(run, DEPTH_3D)
                                   for run in factors["stack"]])
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
    cfg_b, params_b = cut(cfg, params, DEPTH_3E_B)
    res["b"], outs["b"] = spec_case(torch, dev, cfg_b, params_b, pol_b,
                                    "(b) dense", prompts, engine_kw=draft)
    res["b"]["near_ties"] = near_ties(torch, cfg_b, outs["b"], prompts,
                                      "(b) dense", False)
    res["b paged"], outs["b paged"] = spec_case(
        torch, dev, cfg_b, params_b, pol_b, "(b) paged", prompts,
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
            # two sets of logits at most δ apart entry by entry can order
            # two tokens differently only within 2δ of each other
            check(margin <= 2 * delta, f"[3f] (f) {label} request {i}: the "
                  f"disagreement at token {t} is no near-tie ({margin} > "
                  f"2 x {delta})")
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
    check(all(n > 0 for k, n in res["launches"].items()
              if k != "ttq_gemm_experts"),
          f"[3f]: a kernel of gemma-7b's path never launched: "
          f"{res['launches']}")
    t = time.perf_counter()
    res["h"] = cli_phase()
    secs["h"] = time.perf_counter() - t
    res["seconds"] = secs
    print(f"  [3f] seconds per part: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
          + f"; launches {res['launches']}")
    return res


# ------------------------------------------------------------- phase 3l

def blocks_equal(a, b) -> bool:
    """Two runs' recorded blocks (:func:`record_blocks`) equal, bit for
    bit."""
    return len(a) == len(b) and all(
        all((x is None and y is None) or np.array_equal(x, y)
            for x, y in zip(ba, bb)) for ba, bb in zip(a, b))


def collectives_per_step(eng) -> dict:
    """Collectives per decode step by kind, from the decode graph's
    captured counts."""
    g = next(iter(eng.runner._graphs.values()), None)
    K = eng.ecfg.decode_chunk
    return {} if g is None else {k[1]: n / K for k, n in g.launches.items()
                                 if isinstance(k, tuple) and k[0] == "comm"}


def tp_engine(torch, dev, cfg, params, pctx):
    """[3]'s engine (int4 g32 packed, rank 0, int8 KV, 4 slots x 256,
    graphs where the backend allows) under ``pctx``, with a cadence that
    never requantizes: :func:`fixed_stats_tree` gives it its one tree."""
    return build_engine(torch, dev, cfg, params, recalibrate_every=NEVER,
                        engine_kw=dict(pctx=pctx))[2]


def fixed_stats_tree(eng, stats, count):
    """Fold ``stats`` (the rank's slice under tensor parallelism) into the
    session and requantize once: the tree every block then reads."""
    eng.qmodel.calibrate(stats, tokens=count)
    eng._requantize()


def record_blocks(eng) -> list:
    """Every decode block's host outputs (tokens, valid, done, fault), in
    order, from now on."""
    blocks, inner = [], eng.runner.decode_block

    def rec(*a, **kw):
        out = inner(*a, **kw)
        blocks.append(tuple(None if x is None else x.copy() for x in out))
        return out
    eng.runner.decode_block = rec
    return blocks


def teacher_logits(torch, cfg, params, tree, kvcfg, kcfg, prompts, tokens,
                   pctx=None) -> np.ndarray:
    """(R, T, V) f32 on the host: the logits behind each request's tokens,
    teacher-forced on ``tokens`` — the prompts' batched full-precision
    prefill (each prompt's last row), then T - 1 decode steps on ``tree``
    with per-slot positions (under ``pctx`` on every rank: SPMD)."""
    from repro_torch.models import lm
    dev = tree["embed"].device
    R, T = len(prompts), len(tokens[0])
    toks = torch.zeros((R, max(len(p) for p in prompts)), dtype=torch.long,
                       device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    plen = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    lg, st, _ = lm.prefill(cfg, params, {"tokens": toks}, 256,
                           collect_stats=False, full_logits=True,
                           kvcfg=kvcfg, pctx=pctx)
    out = np.empty((R, T, cfg.vocab), np.float32)
    out[:, 0] = lg[torch.arange(R, device=dev), plen.long() - 1].cpu()
    del lg
    for t in range(1, T):
        tok = torch.tensor([[tk[t - 1]] for tk in tokens], dtype=torch.int32,
                           device=dev)
        L, st = lm.decode_step(cfg, tree, st, tok, plen + t - 1, kvcfg=kvcfg,
                               kcfg=kcfg, pctx=pctx)
        out[:, t] = L.cpu()
    return out


def tree_hashes(torch, tree, world=1, pctx=None) -> dict:
    """sha256 of every layer of every requantized field (codes, S, Z, D⁻¹)
    of every weight; with ``pctx`` (a layout bound for ``world`` ranks), of
    each rank's slice (its rows, columns or whole experts): {(rank, path,
    field, layer): digest}."""
    import hashlib
    from repro_torch.core.ttq import QuantizedTensor
    from repro_torch.parallel.rules import split_of
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif isinstance(t, QuantizedTensor):
            ps = ".".join(map(str, path))
            sp = split_of(ps, pctx) if pctx is not None else None
            for f in ("packed", "scale", "zero", "dinv"):
                x = getattr(t, f)
                for layer in range(x.shape[0]):
                    for r in range(world):
                        y = x[layer]
                        dim = {"row": -2, "col": -1, "expert": 0}.get(sp)
                        if dim is not None and not (f == "dinv"
                                                    and sp == "row"):
                            k = y.shape[dim] // world
                            y = y.narrow(dim, r * k, k)
                        out[(r, ps, f, layer)] = hashlib.sha256(
                            y.contiguous().cpu().numpy().tobytes()).hexdigest()
    walk(tree, ())
    return out


def tp_kernel_checks(torch, dev, pctx, gemms=None, attn=(16, 256)) -> dict:
    """The ``*_tp`` wrappers at shard shapes on this rank, held to the plain
    version on the same inputs at [2]'s tolerances (bf16 x: rtol 2^-7, atol
    2e-4·sqrt(d/256); bf16 q: rtol 2^-7, atol 1e-5).  ``gemms``: (name, d',
    d, role) of whole weights, by default gemma-7b's; ``ttq_gemm_tp`` row
    (the rank's rows) against ``ttq_gemm_ref`` on that shard; col (the
    rank's input slice, then the all-reduce) against ``ttq_gemm_ref`` on
    the whole weight.  ``attn`` (Hkv, Dh) at G 1: both decode-attention
    wrappers on the rank's heads against ``kv_attn_ref`` on every head,
    the paged one bit for bit the dense one.  Every rank draws the same
    whole inputs from one seed.  Returns {call: max |difference|}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import (kv_decode_attention_tp,
                                         kv_paged_decode_attention_tp,
                                         ttq_gemm_tp)
    n, r = pctx.world, pctx.rank
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    if gemms is None:
        role = {"wq/wk/wv": "row", "wo": "col", "wg/wu": "row", "wd": "col"}
        gemms = [(name, dp, d, role[name])
                 for name, (dp, d, _) in GEMM_SHAPES.items()]
    out = {}
    for name, dp, d, role in gemms:
        W = torch.randn((dp, d), generator=gen, device=dev) * d ** -0.5
        D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=dev))
        dinv = 1.0 / D
        xb = torch.randn((4, d), generator=gen, device=dev).to(torch.bfloat16)
        pk, S, Z = ref.ttq_quantize_ref(W, D, bits=4, group_size=32)
        del W, D
        if role == "row":
            k = dp // n
            sl = [t[r * k:(r + 1) * k] for t in (pk, S, Z)]
            y = ttq_gemm_tp(xb, *sl, dinv, bits=4, group_size=32, pctx=pctx,
                            tp="row")
            y_r = ref.ttq_gemm_ref(xb, *sl, bits=4, group_size=32, dinv=dinv)
            shape = (k, d)
        else:
            k = d // n
            cols = slice(r * k, (r + 1) * k)
            sl = (pk[:, r * k // 8:(r + 1) * k // 8],
                  S[:, r * k // 32:(r + 1) * k // 32],
                  Z[:, r * k // 32:(r + 1) * k // 32])
            y = ttq_gemm_tp(xb[:, cols], *(t.contiguous() for t in sl),
                            dinv[cols], bits=4, group_size=32, pctx=pctx,
                            tp="col")
            y_r = ref.ttq_gemm_ref(xb, pk, S, Z, bits=4, group_size=32,
                                   dinv=dinv)
            shape = (dp, k)
        torch.testing.assert_close(y.float(), y_r, rtol=2 ** -7,
                                   atol=2e-4 * (d / 256) ** 0.5)
        out[f"ttq_gemm_tp {role} {name} {shape}"] = float(
            (y.float() - y_r).abs().max())
        del pk, S, Z, y, y_r
    Hkv, Dh = attn
    h = Hkv // n
    heads = slice(r * h, (r + 1) * h)
    for bits, q, dense, pool, bt, pos in attn_case(
            torch, dev, SEED + 6, 256 // BLOCK, [0, 37, 128, 200], Hkv=Hkv,
            Dh=Dh):
        qb = q.to(torch.bfloat16)
        o_r = ref.kv_attn_ref(qb, *dense, pos, bits=bits)[:, heads]
        o = kv_decode_attention_tp(
            qb[:, heads].contiguous(),
            *(t[:, heads].contiguous() for t in dense), pos, pctx=pctx,
            bits=bits)
        o_p = kv_paged_decode_attention_tp(
            qb[:, heads].contiguous(),
            *(t[:, heads].contiguous() for t in pool), bt, pos, pctx=pctx,
            bits=bits)
        torch.testing.assert_close(o.float(), o_r.float(), rtol=2 ** -7,
                                   atol=1e-5)
        check(torch.equal(o_p, o), f"kv_paged_decode_attention_tp int{bits} "
              f"on {h} heads of {Dh} is not bit for bit the dense wrapper's")
        out[f"kv_decode_attention_tp int{bits} {h} heads of {Dh}"] = float(
            (o.float() - o_r.float()).abs().max())
    torch.cuda.empty_cache()
    return out


def tp_rank(payload) -> dict:
    """One rank of [3l] (b), in its own process: full-width gemma-7b from
    the seed (the whole tree, then the rank's slice: the engine keeps only
    that), the tree from the fixed statistics' slice, [3]'s traffic, a
    warm rerun, and the teacher-forced logits behind (a)'s tokens, each
    position's held to (a)'s (``payload["L1"]``, a .npy file); before all
    that, the ``*_tp`` wrappers at the shard shapes (:func:`tp_kernel_checks`,
    not counted)."""
    import torch
    from repro_torch import bridge
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    from repro_torch.parallel.rules import shard_stats
    dev = torch.device(payload["device"])
    if dev.type == "cuda":
        build.lib()
    pctx = make_ctx(make_mesh(1, payload["world"], device=dev.type))
    cfg = payload["cfg"]
    kernel_err = tp_kernel_checks(torch, dev, pctx)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    eng = tp_engine(torch, dev, cfg, params, pctx)
    del params                          # the engine holds the rank's slice
    free(torch)
    stats = bridge.params_from_jax(payload["stats"], device=dev)
    build.reset_launches()
    fixed_stats_tree(eng, shard_stats(stats, eng.pctx), payload["count"])
    del stats
    quant_launches = build.LAUNCHES["ttq_quantize"]
    hashes = tree_hashes(torch, eng.decode_params)
    prompts = payload["prompts"]
    build.reset_launches()
    c0, s0 = dict(comm.COUNTS), dict(comm.STAGED_S)
    blocks = record_blocks(eng)
    # one timed run: eager blocks have nothing to capture, so no rerun
    warm = warm_phases(torch, eng, prompts, N_REQUESTS * MAX_NEW,
                       quiet=True)
    tokens = [list(v) for _, v in sorted(eng.scheduler.results().items())]
    steps = sum(b[0].shape[1] for b in blocks)   # the steps the run took
    launches = {k: v / steps for k, v in build.LAUNCHES.items()
                if k != "ttq_quantize"}
    coll = {k: (comm.COUNTS[k] - c0[k]) for k in c0}
    staged = {k: comm.STAGED_S[k] - s0[k] for k in s0}
    L2 = teacher_logits(torch, cfg, eng.params, eng.decode_params, eng.kvcfg,
                        eng.kncfg, prompts, payload["tokens"], eng.pctx)
    L1 = np.load(payload["L1"], mmap_mode="r")
    delta = np.stack([np.abs(L1[i] - L2[i]).max(axis=-1)
                      for i in range(len(L2))])
    return dict(tokens=tokens, delta=delta, hashes=hashes,
                kernel_err=kernel_err, wall_s=warm["warm_wall_s"],
                phase_s=warm["warm_phase_s"], staged_s=staged, steps=steps,
                quant_launches=quant_launches,
                decode_ms_per_step=warm["warm_phase_s"]["decode"] * 1e3
                / steps,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step=launches, collectives=coll,
                graph_mode=eng.runner.graph_mode, rank=eng.pctx.rank,
                backend=eng.pctx.mesh.backend)


RANK_FN = tp_rank


def tensor_parallel(torch, dev, cfg, params, prompts) -> dict:
    """[3l]: (a) world 1 over NCCL with CUDA graphs against ``pctx=None``;
    then, with every tensor of this process freed, (b) world 2 as two
    processes on the one card over gloo."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.parallel import ParallelCtx, comm
    from repro_torch.parallel.ctx import Mesh
    from repro_torch.parallel.rules import bind, col_align
    t_all = time.perf_counter()
    res = {"a": {}, "b": {}}
    # the fixed statistics: [3]'s traffic through a default-cadence engine
    eng0 = build_engine(torch, dev, cfg, params)[2]
    serve(torch, eng0, prompts)
    stats, count = eng0.qmodel.session.as_calib()
    stats = clone_tree(torch, stats)
    policy = eng0.policy
    del eng0
    free(torch)

    mesh = make_mesh(1, 1, device=dev.type)
    print(f"  (a) make_mesh(1, 1): backend {mesh.backend} on {mesh.device}")
    check(mesh.backend == "nccl", f"(a) chose {mesh.backend}, not nccl")
    runs = {}
    for name, pctx in (("none", None), ("world 1", make_ctx(mesh))):
        eng = tp_engine(torch, dev, cfg, params, pctx)
        build.reset_launches()
        fixed_stats_tree(eng, stats, count)
        blocks = record_blocks(eng)
        c0 = dict(comm.COUNTS)
        outs, wall = serve(torch, eng, prompts)
        del eng.runner.decode_block
        check_outputs(cfg, outs, f"[3l] (a) {name}")
        runs[name] = dict(eng=eng, tokens=[list(o) for o in outs],
                          blocks=blocks, launches=dict(build.LAUNCHES),
                          coll={k: comm.COUNTS[k] - c0[k] for k in c0},
                          wall=wall)
    a, b = runs["none"], runs["world 1"]
    same_blocks = blocks_equal(a["blocks"], b["blocks"])
    same_tree = qt_tree_equal(torch, a["eng"].decode_params,
                              b["eng"].decode_params)
    check(b["tokens"] == a["tokens"], "[3l] (a) world-1 tokens differ from "
          "pctx=None's")
    check(same_blocks, "[3l] (a) a world-1 block's outputs differ from "
          "pctx=None's")
    check(same_tree, "[3l] (a) the world-1 tree differs from pctx=None's")
    e1 = b["eng"]
    check(e1.runner.graphs and e1.compiled_programs > 0,
          "[3l] (a) world 1 over NCCL ran no CUDA graphs")
    check(all(b["launches"][k] > 0 for k in
              ("ttq_quantize", "ttq_gemm", "ttq_decode_attention")),
          f"[3l] (a) a kernel of the path never launched: {b['launches']}")
    per_step = collectives_per_step(e1)
    check(per_step.get("all_reduce", 0) > 0, "[3l] (a) the decode graph "
          "captured no all-reduce")
    ms = {"none": [], "world 1": []}
    n_tok = N_REQUESTS * MAX_NEW
    for _ in range(TP_TURNS_3L):
        for name in ms:
            ms[name].append(warm_phases(torch, runs[name]["eng"], prompts,
                                        n_tok, quiet=True)
                            ["decode_ms_per_step"])
    med = {k: statistics.median(v) for k, v in ms.items()}
    res["a"] = dict(tokens_equal=True, blocks=len(b["blocks"]),
                    blocks_equal=same_blocks, tree_equal=same_tree,
                    collectives_per_step=per_step,
                    collectives_cold_run=b["coll"],
                    decode_ms_per_step=med, turns=ms,
                    capture_s=e1.runner.capture_s,
                    prefill_capture_s=sum(e1.runner.prefill_capture_s
                                          .values()),
                    compiled_programs=e1.compiled_programs,
                    launches=b["launches"])
    print(f"  (a) world 1 over NCCL: tokens, {len(b['blocks'])} graph "
          f"blocks and the tree bit for bit pctx=None's; collectives per "
          f"decode step {per_step} (captured in the decode graph); ms per "
          f"decode step world 1 {med['world 1']:.3f} vs pctx=None "
          f"{med['none']:.3f} (median of {TP_TURNS_3L} warm runs in turns: "
          f"{ms}); capture s: decode {e1.runner.capture_s:.2f}, prefill "
          f"{res['a']['prefill_capture_s']:.2f}")
    # what (b) is held to: (a)'s tokens, the logits behind them, and the
    # world-2 slices of (a)'s tree
    tokens = a["tokens"]
    L1 = teacher_logits(torch, cfg, params, e1.decode_params, e1.kvcfg,
                        e1.kncfg, prompts, tokens)
    shape_ctx = bind(ParallelCtx(mesh=Mesh(shape={"data": 1,
                                                  "model": TP_WORLD_3L})),
                     cfg, col_align(policy))
    want = tree_hashes(torch, e1.decode_params, TP_WORLD_3L, shape_ctx)
    tmp = tempfile.mkdtemp(prefix="ttq_3l_")
    np.save(os.path.join(tmp, "L1.npy"), L1)     # read by each rank
    payload = dict(world=TP_WORLD_3L, count=count, prompts=prompts,
                   device=dev.type, cfg=cfg, L1=os.path.join(tmp, "L1.npy"),
                   tokens=tokens,
                   stats=[{k: v.cpu().numpy() for k, v in run.items()}
                          for run in stats["stack"]])
    payload["stats"] = {"stack": payload["stats"]}
    del runs, a, b, e1, stats, params
    res["a"]["seconds"] = time.perf_counter() - t_all
    return res, dict(payload=payload, L1=L1, want=want, tmp=tmp)


def tensor_parallel_b(torch, res, held) -> dict:
    """[3l] (b), with nothing of the earlier phases left on the card."""
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    free(torch)
    print(f"  (b) world {TP_WORLD_3L}: {TP_WORLD_3L} processes on the one "
          f"card; card memory held here before the spawn "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    try:
        ranks = spawn(RANK_FN, TP_WORLD_3L, held["payload"],
                      device=held["payload"]["device"], timeout=TP_TIMEOUT_3L)
    finally:
        shutil.rmtree(held["tmp"], ignore_errors=True)
    r0 = ranks[0]
    check(all(r["tokens"] == r0["tokens"] for r in ranks),
          "[3l] (b) the ranks emitted different tokens")
    check(r0["backend"] == "gloo", f"(b) chose {r0['backend']}, not gloo")
    check(all(r["quant_launches"] > 0 and r["launches_per_step"]["ttq_gemm"]
              > 0 and r["launches_per_step"]["ttq_decode_attention"] > 0
              for r in ranks), "[3l] (b) a kernel of the path never "
          "launched on a rank")
    for r in ranks:
        for (rank, ps, f, layer), h in held["want"].items():
            if rank == r["rank"]:
                check(r["hashes"].get((0, ps, f, layer)) == h,
                      f"[3l] (b) rank {rank}: {ps}.{f} layer {layer} is not "
                      f"the slice of (a)'s")
    for r in ranks:
        print(f"  (b) rank {r['rank']}: the *_tp wrappers at shard shapes "
              f"against the plain version, max |difference|: "
              + ", ".join(f"{k} {v:.3g}" for k, v in r["kernel_err"].items()))
    # (a)'s teacher-forced logits against world 2's at every position
    L1, ties = held["L1"], []
    for r in ranks:
        worst = float(r["delta"].max())
        check(worst <= TP_DELTA_3L, f"[3l] (b) rank {r['rank']}: world 1 and "
              f"world {TP_WORLD_3L} teacher-forced logits {worst} apart (bound "
              f"{TP_DELTA_3L})")
    delta = r0["delta"]
    print(f"  (b) teacher-forced logits, world 1 against world {TP_WORLD_3L}, "
          f"at all {delta.size} positions: max |difference| per request "
          f"{[round(float(x), 4) for x in delta.max(axis=1)]} (bound "
          f"{TP_DELTA_3L}), median {float(np.median(delta)):.4g}")
    for i, (a_t, b_t) in enumerate(zip(held["payload"]["tokens"],
                                       r0["tokens"])):
        t = leading_equal(a_t, b_t)
        if t == len(a_t):
            continue
        a, b = a_t[t], b_t[t]
        margin = float(abs(L1[i, t, a] - L1[i, t, b]))
        ties.append(dict(request=i, t=t, margin=margin,
                         delta=float(delta[i, t])))
        print(f"  (b) request {i}: first disagreement with (a) at token {t} "
              f"({a} vs {b}): logits {margin:.4g} apart, world 1 and world "
              f"{TP_WORLD_3L} logits up to {delta[i, t]:.4g} apart")
        # the two worlds' logits at most δ apart entry by entry can swap
        # two tokens only within 2δ of each other
        check(margin <= 2 * delta[i, t], f"[3l] (b) request {i}: the "
              f"disagreement at token {t} is no near-tie ({margin} > 2 x "
              f"{delta[i, t]})")
    res["b"] = dict(
        tokens_equal_a=sum(r0["tokens"][i] == held["payload"]["tokens"][i]
                           for i in range(N_REQUESTS)),
        near_ties=ties, codes_bit_equal=True,
        logits_max_diff=float(max(r["delta"].max() for r in ranks)),
        logits_median_diff=float(np.median(delta)),
        tp_kernel_err=[r["kernel_err"] for r in ranks],
        decode_steps=[r["steps"] for r in ranks],
        decode_ms_per_step=[r["decode_ms_per_step"] for r in ranks],
        peak_gb=[r["peak_gb"] for r in ranks],
        launches_per_step=r0["launches_per_step"],
        quantize_launches_per_requant=[r["quant_launches"] for r in ranks],
        collectives=r0["collectives"], graph_mode=r0["graph_mode"],
        phase_s=[r["phase_s"] for r in ranks],
        staged_ms_per_step=[{k: v * 1e3 / r["steps"] for k, v in
                             r["staged_s"].items()} for r in ranks],
        wall_s=[r["wall_s"] for r in ranks],
        seconds=time.perf_counter() - t0)
    print(f"  (b) world {TP_WORLD_3L} over gloo, {r0['graph_mode']}: both "
          f"ranks' tokens equal, {res['b']['tokens_equal_a']} of "
          f"{N_REQUESTS} requests equal to (a) (the rest near-ties); every "
          f"rank's codes, S, Z and D⁻¹ (every layer of every weight) bit "
          f"for bit its slice of (a)'s; ms per decode step "
          f"{res['b']['decode_ms_per_step']} (one timed run of "
          f"{r0['steps']} counted steps, of it in the "
          f"staged collectives {res['b']['staged_ms_per_step']}); peak GB "
          f"per rank "
          f"{res['b']['peak_gb']}; launches per decode step at shard shapes "
          f"{r0['launches_per_step']}; collectives over the cold run "
          f"{r0['collectives']}; {res['b']['seconds']:.1f} s")
    return res


# ------------------------------------------------------------- phase 3m

def init_3m(torch, dev, arch, depth):
    """Full-width ``arch`` at ``depth`` layers (an encoder-decoder's
    encoder too), random weights from seed 0."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    cfg = dataclasses.replace(get(arch), n_layers=depth)
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=depth))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    return cfg, params


def traffic_3m(cfg):
    """[3m]'s traffic: [3]'s first N_3M prompts (one block of 4 slots) in
    ``cfg``'s vocabulary, with frames from the seed for an
    encoder-decoder."""
    prompts = make_prompts(cfg.vocab)[:N_3M]
    frames = None
    if cfg.encdec is not None:
        frames = np.random.default_rng(SEED + 5).standard_normal(
            (N_3M, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    return prompts, frames


def batch_of(torch, dev, prompt, frames, i):
    b = {"tokens": torch.tensor([prompt], device=dev)}
    if frames is not None:
        b["frames"] = torch.from_numpy(frames[i:i + 1]).to(dev)
    return b


def fixed_stats_3m(torch, cfg, params, prompts, frames):
    """The fixed statistics: a ``pctx=None`` full-precision prefill of the
    first prompt (MoE statistics gate-weighted), and its token count."""
    from repro_torch.models import lm
    dev = params["embed"].device
    _, _, stats = lm.prefill(cfg, params, batch_of(torch, dev, prompts[0],
                                                   frames, 0), 256)
    return stats, float(len(prompts[0]))


def engine_3m(torch, dev, cfg, params, pctx, prompts, frames, stats, count):
    """[3l]'s engine (:func:`tp_engine`) with its one tree from the fixed
    statistics (the rank's slice under ``pctx``; under ``"a2a"`` without
    the router's) and the frames."""
    from repro_torch.parallel.rules import shard_stats
    eng = tp_engine(torch, dev, cfg, params, pctx)
    with_frames(eng, prompts, frames)
    if cfg.moe is not None and pctx is not None and pctx.moe_impl == "a2a":
        # the all-to-all path taps no router (as the reference's): the
        # session's tree keeps the keys its own prefills give
        stats = {k: [{kk: v for kk, v in run.items()
                      if not kk.endswith("mlp.router")} for run in runs]
                 for k, runs in stats.items()}
    fixed_stats_tree(eng, stats if pctx is None or pctx.world == 1
                     else shard_stats(stats, eng.pctx), count)
    return eng


def steps_3m(eng) -> int:
    """Decode steps of one round of N_3M ≤ max_slots requests."""
    K = eng.ecfg.decode_chunk
    return -(-(MAX_NEW - 1) // K) * K


def teacher_3m(torch, cfg, params, tree, kvcfg, kcfg, prompts, frames,
               tokens, pctx=None) -> tuple:
    """(R, T, V) f32 on the host: the logits behind each request's tokens,
    teacher-forced request by request (an exact-length prefill, as the
    engine's for a recurrent stack), then T - 1 decode steps on ``tree``
    (under ``pctx`` on every rank); and for a MoE stack the routing behind
    each position ([request][position] → every layer's (top-k indices,
    router probabilities) of the tokens that call read), else None."""
    from repro_torch.models import lm
    dev = params["embed"].device
    out = np.empty((len(prompts), len(tokens[0]), cfg.vocab), np.float32)
    rec, routes = [], [] if cfg.moe is not None else None

    def since(n):
        return [(a.cpu().numpy(), b.cpu().numpy()) for a, b in rec[n:]]
    with recorded_routes(torch, rec):
        for i, p in enumerate(prompts):
            n = len(rec)
            lg, st, _ = lm.prefill(cfg, params, batch_of(torch, dev, p,
                                                         frames, i), 256,
                                   collect_stats=False, kvcfg=kvcfg,
                                   pctx=pctx)
            out[i, 0] = lg[0].cpu()
            row = [since(n)]
            for t in range(1, len(tokens[i])):
                tok = torch.tensor([[tokens[i][t - 1]]], dtype=torch.int32,
                                   device=dev)
                pos = torch.tensor([len(p) + t - 1], dtype=torch.int32,
                                   device=dev)
                n = len(rec)
                L, st = lm.decode_step(cfg, tree, st, tok, pos, kvcfg=kvcfg,
                                       kcfg=kcfg, pctx=pctx)
                out[i, t] = L[0].cpu()
                row.append(since(n))
            if routes is not None:
                routes.append(row)
    return out, routes


def first_flips(r1, r2, what) -> tuple:
    """Per request, the first teacher-forced position whose routing (any
    layer, any token its call read) differs between world 1 (``r1``) and
    world 2 (``r2``), None where none does.  Every router call up to and
    including the one that flips is held: each probability within
    ROUTE_DELTA_3M of world 1's, and each flip a near-tie, world 1's
    probabilities of the swapped experts within 2 · ROUTE_DELTA_3M.  A
    flip moves that position's logits by an expert's share, and the later
    layers and positions of the request read it: they are its
    consequence, and only the positions before it are held to the logit
    bound.  Returns (the flips, the largest |Δp| and the largest gap
    held)."""
    firsts, dp, gap_max = [], 0.0, 0.0
    for i, (row1, row2) in enumerate(zip(r1, r2)):
        first = None
        for t, (calls1, calls2) in enumerate(zip(row1, row2)):
            for (i1, p1), (i2, p2) in zip(calls1, calls2):
                d = float(np.abs(p2 - p1).max())
                dp = max(dp, d)
                check(d <= ROUTE_DELTA_3M, f"{what} request {i} position "
                      f"{t}: router probabilities {d:.3g} from world 1's "
                      f"(bound {ROUTE_DELTA_3M})")
                same = (i1[:, :, None] == i2[:, None, :]).any(-1).all(-1)
                for tok in np.nonzero(~same)[0]:
                    gone = set(i1[tok].tolist()) - set(i2[tok].tolist())
                    came = set(i2[tok].tolist()) - set(i1[tok].tolist())
                    gap = max(abs(float(p1[tok, a] - p1[tok, b]))
                              for a in gone for b in came)
                    gap_max = max(gap_max, gap)
                    check(gap <= 2 * ROUTE_DELTA_3M, f"{what} request {i} "
                          f"position {t}: routing differs between the worlds "
                          f"by a probability gap {gap:.3g}, beyond "
                          f"2 x {ROUTE_DELTA_3M}")
                if not same.all():
                    first = t
                    break
            if first is not None:
                break
        firsts.append(first)
    return firsts, dp, gap_max


def chunk_routes(ranks, r1):
    """World 2's routing under ``"a2a"`` as world 1's calls read it: each
    rank routes its chunk of ⌈T/n⌉ tokens, so a call's rows are the ranks'
    chunks in rank order, cut to world 1's T."""
    return [[[tuple(np.concatenate([rk[i][t][c][j] for rk in ranks])
                    [:len(call[0])] for j in range(2))
              for c, call in enumerate(calls)]
             for t, calls in enumerate(row)] for i, row in enumerate(r1)]


@contextlib.contextmanager
def dropped(torch, rec):
    """Append the assignments each all-to-all MoE call drops past its
    capacity to ``rec`` for the duration of the block (a sync per call)."""
    from repro_torch.models import layers
    real = layers.a2a_slots

    def spy(top_i, n_experts, C):
        slot, valid = real(top_i, n_experts, C)
        rec.append(int((~valid).sum()))
        return slot, valid
    layers.a2a_slots = spy
    try:
        yield rec
    finally:
        layers.a2a_slots = real


def teacher_a2a(torch, cfg, eng, prompts, frames, tokens) -> tuple:
    """:func:`teacher_3m` on ``eng``'s tree under its ``"a2a"`` context at
    capacity factor CF_3M, the assignments dropped counted: (logits,
    routes, drops)."""
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CF_3M))
    with dropped(torch, []) as drops:
        L, routes = teacher_3m(torch, cfg8, eng.params, eng.decode_params,
                               eng.kvcfg, eng.kncfg, prompts, frames, tokens,
                               eng.pctx)
    return L, routes, sum(drops)


def tp_family_a(torch, dev, arch, depth, mesh) -> tuple:
    """[3m] (a) for one family: ``pctx=None`` against a world-1 NCCL
    context (MoE under ``"dense"``) in CUDA graphs, each on the tree from
    the fixed statistics: tokens, every block and the tree bit for bit;
    for MoE, an ``"a2a"`` world-1 engine in graphs against the same engine
    with every block eager, bit for bit; collectives per decode step by
    kind; ms per decode step world 1 against ``pctx=None`` (TP_TURNS_3M
    warm runs each, in turns).  Returns the readings, the launches of the
    world-1 engines' cold runs and what (b) is held to."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.parallel import ParallelCtx, comm
    from repro_torch.parallel.ctx import Mesh
    from repro_torch.parallel.rules import bind, col_align
    cfg, params = init_3m(torch, dev, arch, depth)
    prompts, frames = traffic_3m(cfg)
    stats, count = fixed_stats_3m(torch, cfg, params, prompts, frames)
    ctxs = [("none", None), ("world 1", make_ctx(mesh, moe_impl="dense"))]
    if cfg.moe is not None:
        ctxs += [("a2a", make_ctx(mesh)), ("a2a eager", make_ctx(mesh))]
    runs, launches = {}, {}
    for name, pctx in ctxs:
        build.reset_launches()          # the requant's launches count
        eng = engine_3m(torch, dev, cfg, params, pctx, prompts, frames,
                        stats, count)
        if name == "a2a eager":
            eng.runner.graphs = False
        blocks = record_blocks(eng)
        with recorded_gemm_tiles() as rec:
            outs, _ = serve(torch, eng, prompts)
        del eng.runner.decode_block
        check_outputs(cfg, outs, f"[3m] (a) {cfg.name} {name}")
        if cfg.mla is not None:     # the wkv_b expansions wide, the rest split
            gemm_tiles_checked(cfg, rec, build.LAUNCHES,
                               f"[3m] (a) {cfg.name} {name}")
        runs[name] = dict(eng=eng, tokens=[list(o) for o in outs],
                          blocks=blocks)
        if name in ("world 1", "a2a"):
            for k, v in build.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v
    a, b = runs["none"], runs["world 1"]
    e1 = b["eng"]
    res = dict(layers=depth, blocks=len(b["blocks"]),
               tokens_equal=b["tokens"] == a["tokens"],
               blocks_equal=blocks_equal(a["blocks"], b["blocks"]),
               tree_equal=qt_tree_equal(torch, a["eng"].decode_params,
                                        e1.decode_params),
               collectives_per_step={"world 1": collectives_per_step(e1)})
    for key in ("tokens_equal", "blocks_equal", "tree_equal"):
        check(res[key], f"[3m] (a) {cfg.name}: world 1 {key} is False "
              f"against pctx=None")
    check(e1.runner.graphs and e1.compiled_programs > 0,
          f"[3m] (a) {cfg.name}: world 1 over NCCL ran no CUDA graphs")
    check(res["collectives_per_step"]["world 1"].get("all_reduce", 0) > 0,
          f"[3m] (a) {cfg.name}: the decode graph captured no all-reduce")
    if cfg.moe is not None:
        g, e = runs["a2a"], runs["a2a eager"]
        res["a2a"] = dict(replays_equal_eager=g["tokens"] == e["tokens"]
                          and blocks_equal(g["blocks"], e["blocks"]),
                          graphs=g["eng"].compiled_programs,
                          eager_graphs=e["eng"].compiled_programs)
        res["collectives_per_step"]["a2a"] = collectives_per_step(g["eng"])
        check(res["a2a"]["replays_equal_eager"], f"[3m] (a) {cfg.name}: "
              f"the a2a engine's graph replays differ from its eager run")
        check(res["a2a"]["eager_graphs"] == 0 and res["a2a"]["graphs"] > 0,
              f"[3m] (a) {cfg.name}: a2a graphs {res['a2a']}")
        check(res["collectives_per_step"]["a2a"].get("all_to_all", 0) > 0,
              f"[3m] (a) {cfg.name}: the a2a decode graph captured no "
              f"all-to-all")
        L1a, routes_a, drops = teacher_a2a(torch, cfg, g["eng"], prompts,
                                           frames, a["tokens"])
        check(drops == 0, f"[3m] (a) {cfg.name}: a2a at capacity factor "
              f"{CF_3M} dropped {drops} assignments")
        del runs["a2a"], runs["a2a eager"], g, e
    ms = {"none": [], "world 1": []}
    n_tok = N_3M * MAX_NEW
    for _ in range(TP_TURNS_3M):
        for name in ms:
            w = warm_phases(torch, runs[name]["eng"], prompts, n_tok,
                            quiet=True)
            ms[name].append(w["warm_phase_s"]["decode"] * 1e3
                            / steps_3m(runs[name]["eng"]))
    res["decode_ms_per_step"] = {k: statistics.median(v)
                                 for k, v in ms.items()}
    res["turns"] = ms
    if cfg.mla is not None:
        res["expansion"] = expansion_ms(torch, cfg, e1)
    tokens = a["tokens"]
    L1, routes = teacher_3m(torch, cfg, params, e1.decode_params, e1.kvcfg,
                            e1.kncfg, prompts, frames, tokens)
    shape_ctx = bind(ParallelCtx(mesh=Mesh(shape={"data": 1,
                                                  "model": TP_WORLD_3L})),
                     cfg, col_align(e1.policy))
    want = tree_hashes(torch, e1.decode_params, TP_WORLD_3L, shape_ctx)
    res["layout_world2"] = str(shape_ctx.layout)
    print(f"  [3m] (a) {cfg.name}, {depth} layers: world 1 over NCCL in "
          f"graphs bit for bit pctx=None (tokens, {res['blocks']} blocks, "
          f"the tree); collectives per decode step "
          f"{res['collectives_per_step']}; ms per decode step world 1 "
          f"{res['decode_ms_per_step']['world 1']:.3f} vs pctx=None "
          f"{res['decode_ms_per_step']['none']:.3f} ({ms})"
          + (f"; a2a graph replays bit for bit its eager run"
             if cfg.moe is not None else "")
          + (f"; wkv_b expansion over {res['expansion']['rows']} latent "
             f"rows {res['expansion']['ms_per_layer']:.4f} ms per layer "
             f"(the split tile {res['expansion']['split_ms_per_layer']:.4f}), "
             f"every launch at wkv_b on the wide tile, every other split"
             if cfg.mla is not None else "")
          + f"; world-2 layout {shape_ctx.layout}")
    held = dict(cfg=cfg, stats={k: [{kk: vv.cpu().numpy()
                                     for kk, vv in run.items()}
                                    for run in v]
                                for k, v in stats.items()},
                count=count, prompts=prompts, frames=frames, tokens=tokens,
                impls=("dense", "a2a") if cfg.moe is not None
                else ("dense",))
    a2a = None if cfg.moe is None else dict(L1=L1a, routes=routes_a)
    del runs, a, b, e1, params, stats
    free(torch)
    return res, launches, held, L1, want, routes, a2a


def tp_checks_3m(torch, dev, pctx) -> dict:
    """[3m] (b)'s kernels at the new shard shapes against their plain
    versions at [2]'s tolerances: ``ttq_gemm_tp`` at recurrentgemma-9b's
    RG-LRU (w_in rows, w_out columns), mamba2-1.3b's SSD (w_x rows, w_out
    columns) and deepseek-v2-lite's ``wkv_b`` rows, the decode-attention
    wrappers at whisper-medium's rank heads (16 / n of Dh 64), and
    ``ttq_gemm_experts`` on the rank's E/n experts of deepseek-v2-lite's
    and llama4-scout's gate projections."""
    from repro_torch.kernels import ops, ref
    out = tp_kernel_checks(torch, dev, pctx, gemms=[
        ("rec w_in", 4096, 4096, "row"), ("rec w_out", 4096, 4096, "col"),
        ("ssd w_x", 4096, 2048, "row"), ("ssd w_out", 2048, 4096, "col"),
        ("mla wkv_b", 4096, 512, "row")], attn=(16, 64))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for name, E, dp, d in (("deepseek-v2-lite experts.wg", 64, 1408, 2048),
                           ("llama4-scout experts.wg", 16, 8192, 5120)):
        El = E // pctx.world
        W = torch.randn((El, dp, d), generator=gen, device=dev) * d ** -0.5
        D = torch.exp(0.3 * torch.randn((El, d), generator=gen, device=dev))
        parts = [ref.ttq_quantize_ref(W[e], D[e], bits=4, group_size=32)
                 for e in range(El)]
        pk, S, Z = (torch.stack([p[i] for p in parts]) for i in range(3))
        dinv = 1.0 / D
        del W, D, parts
        xb = torch.randn((4, d), generator=gen, device=dev).to(torch.bfloat16)
        y = ops.ttq_gemm_experts(xb, pk, S, Z, dinv, bits=4, group_size=32)
        y_r = ref.ttq_gemm_experts_ref(xb, pk, S, Z, bits=4, group_size=32,
                                       dinv=dinv)
        torch.testing.assert_close(y.float(), y_r.float(), rtol=2 ** -7,
                                   atol=2e-4 * (d / 256) ** 0.5)
        out[f"ttq_gemm_experts {name} ({El} of {E})"] = float(
            (y.float() - y_r.float()).abs().max())
        del pk, S, Z, y, y_r
    torch.cuda.empty_cache()
    return out


def tp_rank_3m(payload) -> dict:
    """One rank of [3m] (b), in its own process: the kernels at the new
    shard shapes (:func:`tp_checks_3m`, not counted), then per family the
    full-width model at (a)'s depth from the seed, an engine per
    ``moe_impl`` on the slice of the fixed statistics, (a)'s traffic in
    one timed eager run and, under ``"dense"``, the tree's hashes and the
    teacher-forced logits behind (a)'s tokens, each position's held to
    (a)'s (``L1``, a .npy file per family); under ``"a2a"`` the same at
    capacity factor CF_3M, held to (a)'s world-1 ``"a2a"`` logits
    (``L1a``); deepseek-v2-lite's ``wkv_b`` expansion timed on each rank
    while the other waits."""
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    dev = torch.device(payload["device"])
    if dev.type == "cuda":
        build.lib()
    pctx = make_ctx(make_mesh(1, payload["world"], device=dev.type))
    out = dict(kernel_err=tp_checks_3m(torch, dev, pctx), rank=pctx.rank,
               backend=pctx.mesh.backend, families={})
    for fam in payload["families"]:
        cfg = fam["cfg"]
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)
        stats = bridge.params_from_jax(fam["stats"], device=dev)
        res = {}
        for impl in fam["impls"]:
            ctx = dataclasses.replace(pctx, moe_impl=impl)
            eng = engine_3m(torch, dev, cfg, params, ctx, fam["prompts"],
                            fam["frames"], stats, fam["count"])
            r = dict(graph_mode=eng.runner.graph_mode)
            if impl == "dense":
                r["hashes"] = tree_hashes(torch, eng.decode_params)
            build.reset_launches()
            c0, s0 = dict(comm.COUNTS), dict(comm.STAGED_S)
            w = warm_phases(torch, eng, fam["prompts"], N_3M * MAX_NEW,
                            quiet=True)
            steps = steps_3m(eng)
            if impl == "dense" and cfg.mla is not None:
                # the ranks share the card: each times its slice alone
                for rank in range(pctx.world):
                    dist.barrier()
                    if rank == pctx.rank:
                        r["expansion"] = expansion_ms(torch, cfg, eng)
                dist.barrier()
            r.update(
                tokens=[list(v) for _, v in
                        sorted(eng.scheduler.results().items())],
                decode_ms_per_step=w["warm_phase_s"]["decode"] * 1e3 / steps,
                wall_s=w["warm_wall_s"], steps=steps,
                staged_ms_per_step={k: (comm.STAGED_S[k] - s0[k]) * 1e3
                                    / steps for k in s0},
                collectives={k: comm.COUNTS[k] - c0[k] for k in c0},
                launches_per_step={k: v / steps for k, v in
                                   build.LAUNCHES.items()})
            if impl == "dense":
                L2, r["routes"] = teacher_3m(
                    torch, cfg, eng.params, eng.decode_params, eng.kvcfg,
                    eng.kncfg, fam["prompts"], fam["frames"], fam["tokens"],
                    eng.pctx)
                L1 = np.load(fam["L1"], mmap_mode="r")
                r["delta"] = np.stack([np.abs(L1[i] - L2[i]).max(axis=-1)
                                       for i in range(len(L2))])
            if impl == "a2a":
                L2, r["routes"], r["drops"] = teacher_a2a(
                    torch, cfg, eng, fam["prompts"], fam["frames"],
                    fam["tokens"])
                L1 = np.load(fam["L1a"], mmap_mode="r")
                r["delta"] = np.stack([np.abs(L1[i] - L2[i]).max(axis=-1)
                                       for i in range(len(L2))])
            res[impl] = r
            del eng
            free(torch)
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["families"][cfg.name] = res
        del params, stats
        free(torch)
    return out


RANK_FN_3M = tp_rank_3m


def tp_families(torch, dev) -> dict:
    """[3m]: tensor- and expert-parallel serving of the five families
    beyond plain attention, each at full width and the depth of
    FAMILIES_3M: (a) world 1 over NCCL with CUDA graphs against
    ``pctx=None`` (:func:`tp_family_a`), one family on the card at a time;
    then, with every tensor of this process freed, (b) world 2 as two
    processes on the one card over gloo (:func:`tp_rank_3m`): the ranks'
    tokens equal, (a)'s tokens but for near-ties (a first disagreement
    whose world-1 margin is within twice the two worlds' teacher-forced
    logit gap there, or that follows a routing near-tie of its request,
    :func:`first_flips`), the teacher-forced logits within TP_DELTA_3M of
    (a)'s at every position held, every layer's
    codes, S, Z and D⁻¹ bit for bit (a)'s slices (dense; an a2a engine's
    tree comes from the same statistics but is not held)."""
    from repro_torch.launch.mesh import make_mesh, spawn
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, device=dev.type)
    check(mesh.backend == "nccl", f"[3m] (a) chose {mesh.backend}, not nccl")
    res = {"a": {}, "b": {}, "launches": {}}
    tmp = tempfile.mkdtemp(prefix="ttq_3m_")
    fams, held = [], {}
    for arch, depth in FAMILIES_3M:
        r, launches, h, L1, want, routes, a2a = tp_family_a(
            torch, dev, arch, depth, mesh)
        res["a"][h["cfg"].name] = r
        for k, v in launches.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
        h["L1"] = os.path.join(tmp, f"{arch}.npy")
        np.save(h["L1"], L1)
        if a2a is not None:
            h["L1a"] = os.path.join(tmp, f"{arch}_a2a.npy")
            np.save(h["L1a"], a2a.pop("L1"))
        held[h["cfg"].name] = dict(L1=L1, want=want, tokens=h["tokens"],
                                   routes=routes, a2a=a2a)
        fams.append(h)
    res["a_seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    free(torch)
    try:
        ranks = spawn(RANK_FN_3M, TP_WORLD_3L,
                      dict(world=TP_WORLD_3L, device=dev.type,
                           families=fams),
                      device=dev.type, timeout=TP_TIMEOUT_3M)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    check(r0["backend"] == "gloo", f"[3m] (b) chose {r0['backend']}, "
          f"not gloo")
    for r in ranks:
        print(f"  [3m] (b) rank {r['rank']}: kernels at the new shard shapes "
              f"against the plain version, max |difference|: "
              + ", ".join(f"{k} {v:.3g}" for k, v in r["kernel_err"].items()))
    for name, want in held.items():
        fr = [r["families"][name] for r in ranks]
        out = {}
        for impl in fr[0]:
            if impl == "peak_gb":
                continue
            check(all(f[impl]["tokens"] == fr[0][impl]["tokens"]
                      for f in fr), f"[3m] (b) {name} {impl}: the ranks "
                  f"emitted different tokens")
            out[impl] = {k: [f[impl][k] for f in fr] for k in (
                "decode_ms_per_step", "staged_ms_per_step")}
            out[impl].update(launches_per_step=fr[0][impl]
                             ["launches_per_step"],
                             collectives=fr[0][impl]["collectives"],
                             graph_mode=fr[0][impl]["graph_mode"])
        for f, r in zip(fr, ranks):
            for (rank, ps, fld, layer), hsh in want["want"].items():
                if rank == r["rank"]:
                    check(f["dense"]["hashes"].get((0, ps, fld, layer))
                          == hsh, f"[3m] (b) {name} rank {rank}: {ps}.{fld} "
                          f"layer {layer} is not the slice of (a)'s")
        flips, route = [None] * N_3M, {}
        if want["routes"] is not None:
            flips, route["dp"], route["gap"] = first_flips(
                want["routes"], fr[0]["dense"]["routes"], f"[3m] (b) {name}")
        held_pos = [slice(None) if x is None else slice(0, x) for x in flips]
        check(any(sl.stop != 0 for sl in held_pos), f"[3m] (b) {name}: "
              f"every request's routing flips in its prompt, no position "
              f"held")
        for f, r in zip(fr, ranks):
            worst = max(float(f["dense"]["delta"][i, sl].max(initial=0.0))
                        for i, sl in enumerate(held_pos))
            check(worst <= TP_DELTA_3M, f"[3m] (b) {name} rank {r['rank']}: "
                  f"teacher-forced logits {worst} from (a)'s (bound "
                  f"{TP_DELTA_3M})")
        if want["a2a"] is not None:
            # under "a2a" each rank routes its own chunk of the tokens
            drops = [f["a2a"]["drops"] for f in fr]
            check(drops == [0] * len(fr), f"[3m] (b) {name}: a2a at "
                  f"capacity factor {CF_3M} dropped {drops} assignments")
            fa, dpa, gapa = first_flips(
                want["a2a"]["routes"], chunk_routes(
                    [f["a2a"]["routes"] for f in fr], want["a2a"]["routes"]),
                f"[3m] (b) {name} a2a")
            held_a = [slice(None) if x is None else slice(0, x) for x in fa]
            check(any(sl.stop != 0 for sl in held_a), f"[3m] (b) {name} "
                  f"a2a: every request's routing flips in its prompt")
            worst = max(float(f["a2a"]["delta"][i, sl].max(initial=0.0))
                        for f in fr for i, sl in enumerate(held_a))
            check(worst <= TP_DELTA_3M, f"[3m] (b) {name} a2a: teacher-"
                  f"forced logits {worst} from (a)'s world-1 a2a (bound "
                  f"{TP_DELTA_3M})")
            route.update(a2a_flips=fa, a2a_dp=dpa, a2a_gap=gapa,
                         a2a_logits_max_diff=worst)
        delta, ties = fr[0]["dense"]["delta"], []
        for i, (a_t, b_t) in enumerate(zip(want["tokens"],
                                           fr[0]["dense"]["tokens"])):
            t = leading_equal(a_t, b_t)
            if t == len(a_t):
                continue
            x, y = a_t[t], b_t[t]
            margin = float(abs(want["L1"][i, t, x] - want["L1"][i, t, y]))
            routed = flips[i] is not None and flips[i] <= t
            ties.append(dict(request=i, t=t, margin=margin,
                             delta=float(delta[i, t]),
                             after_routing_tie=routed))
            # the two worlds' logits at most δ apart entry by entry can
            # swap two tokens only within 2δ of each other
            check(routed or margin <= 2 * delta[i, t], f"[3m] (b) {name} "
                  f"request {i}: the disagreement at token {t} is no "
                  f"near-tie ({margin} > 2 x {delta[i, t]})")
        out.update(tokens_equal_a=sum(a == b for a, b in zip(
            want["tokens"], fr[0]["dense"]["tokens"])), near_ties=ties,
            codes_bit_equal=True, routing_first_flips=flips,
            logits_max_diff=max(float(f["dense"]["delta"][i, sl].max(
                initial=0.0)) for f in fr for i, sl in enumerate(held_pos)),
            logits_max_diff_all=float(max(f["dense"]["delta"].max()
                                          for f in fr)),
            logits_median_diff=float(np.median(delta)),
            peak_gb=[f["peak_gb"] for f in fr], routing=route)
        if "expansion" in fr[0]["dense"]:
            out["expansion"] = [f["dense"]["expansion"] for f in fr]
        res["b"][name] = out
        print(f"  [3m] (b) {name}, world {TP_WORLD_3L} over gloo, eager: "
              f"ranks' tokens equal; {out['tokens_equal_a']} of {N_3M} "
              f"requests equal to (a) (the rest near-ties: {ties}); "
              f"teacher-forced logits within {out['logits_max_diff']:.4g} of "
              f"(a)'s (median {out['logits_median_diff']:.4g}, bound "
              f"{TP_DELTA_3M}"
              + (f"; routing's first flip per request {flips}, each a "
                 f"near-tie, the positions from it on not held: "
                 f"{out['logits_max_diff_all']:.4g} over all; router "
                 f"probabilities held within {route['dp']:.3g} of (a)'s, "
                 f"flip gaps up to {route['gap']:.3g} (bound "
                 f"{ROUTE_DELTA_3M}, 2 x)"
                 if want["routes"] is not None else "")
              + (f"; a2a at capacity factor {CF_3M}, no assignment dropped: "
                 f"teacher-forced logits within "
                 f"{route['a2a_logits_max_diff']:.4g} of (a)'s world-1 a2a "
                 f"(first flips {route['a2a_flips']}, probabilities within "
                 f"{route['a2a_dp']:.3g}, gaps up to {route['a2a_gap']:.3g})"
                 if want["a2a"] is not None else "")
              + ("; wkv_b expansion per layer on each rank "
                 + ", ".join(f"{x['ms_per_layer']:.4f} ms over {x['rows']} "
                             f"rows" for x in out["expansion"])
                 if "expansion" in out else "")
              + "); codes bit for bit (a)'s slices; "
              + "; ".join(f"{impl}: ms per decode step "
                          f"{[round(x, 2) for x in out[impl]['decode_ms_per_step']]}"
                          f", staged {out[impl]['staged_ms_per_step'][0]}, "
                          f"collectives {out[impl]['collectives']}, launches "
                          f"per step {out[impl]['launches_per_step']}"
                          for impl in fr[0] if impl != "peak_gb")
              + f"; peak GB per rank {out['peak_gb']}")
    res["b_seconds"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    res["kernel_err"] = [r["kernel_err"] for r in ranks]
    print(f"  [3m] seconds: (a) {res['a_seconds']:.1f}, (b) "
          f"{res['b_seconds']:.1f}; launches of (a)'s world-1 engines "
          f"{res['launches']}")
    return res


# ------------------------------------------------------------- phase 3g

def layer_params(cfg, kind) -> tuple:
    """(linear parameters, bytes of the parameters kept unquantized) of one
    layer of ``kind``: the mixer's linears (attention's four; MLA's wq,
    wkv_a, wkv_b and wo; an RG-LRU block's three, beside its gates and conv
    in bf16) and the MLP's (a GLU 3·D·F, a plain one 2·D·F; a MoE layer's
    experts 3·E·D·F_e and shared GLU 3·D·F_e·n_shared, beside its router
    kept in f32, 4 B per parameter)."""
    D, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    if cfg.moe is not None:
        e = cfg.moe
        mlp = 3 * D * e.d_ff_expert * (e.n_experts + e.n_shared)
        kept = 4 * e.n_experts * D
    else:
        mlp, kept = (3 if cfg.mlp == "glu" else 2) * D * cfg.d_ff, 0
    if kind == "rec":
        dr = cfg.hybrid.d_rnn or D
        return (3 * D * dr + mlp,
                kept + 2 * (2 * dr * dr // 16 + cfg.hybrid.conv_width * dr))
    if kind == "mla":
        m = cfg.mla
        return (D * H * (m.qk_nope_dim + m.qk_rope_dim)
                + D * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                + H * m.v_head_dim * D + mlp, kept)
    return 2 * D * H * hd + 2 * D * cfg.n_kv_heads * hd + mlp, kept


def fit_depth(torch, cfg) -> int:
    """The most layers of ``cfg`` the card holds beside its quantized trees
    under the guards: each layer's bf16 weights (2 B per parameter) and two
    int4 g32 trees of its linears (the served one and the guards' spare,
    0.75 B per parameter each: packed codes and f32 S, Z per 32), after the
    bf16 embedding and FIT_RESERVE_GB for the KV cache, the graphs' pools,
    activations and the allocator.  A hybrid stack that does not fit whole
    is cut to whole units of its pattern."""
    from repro_torch.models.stack import stack_spec
    kinds = [k for ks, n in stack_spec(cfg) for _ in range(n) for k in ks]
    total = torch.cuda.get_device_properties(0).total_memory
    room = total - cfg.vocab * cfg.d_model * 2 - FIT_RESERVE_GB * 1e9
    n = 0
    for kind in kinds:
        lin, kept = layer_params(cfg, kind)
        room -= lin * (2 + 2 * 0.75) + kept
        if room < 0:
            break
        n += 1
    if cfg.family == "hybrid" and n < len(kinds):
        n -= n % len(cfg.hybrid.pattern)
    return n


def init_family(torch, dev, arch, depth=None):
    """Full-width ``arch`` (the first ``depth`` layers, None: all; an
    encoder-decoder's encoder too), random weights from seed 0."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    cfg = get(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
        if cfg.encdec is not None:
            cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
                cfg.encdec, n_enc_layers=depth))
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    print(f"  init {cfg.name} full width, {cfg.n_layers} layers: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return cfg, params


def attends(cfg) -> bool:
    """Whether ``cfg``'s decoder stack reads a KV cache through the decode
    attention kernels (MLA reads its latent cache through plain
    attention; an SSM stack has no attention)."""
    from repro_torch.models.stack import stack_spec
    return cfg.mla is None and any(k in ("attn", "lattn", "xdec")
                                   for ks, _ in stack_spec(cfg) for k in ks)


def with_frames(eng, prompts, frames):
    """Make every ``eng.submit`` of one of ``prompts`` carry its frames
    (the encoder-decoder family's input), so the shared phases' traffic
    needs no change; ``frames`` None leaves ``eng`` as it is."""
    if frames is None:
        return eng
    table = {tuple(p): f for p, f in zip(prompts, frames)}
    real = eng.submit
    eng.submit = lambda p, **kw: real(p, frames=table[tuple(p)], **kw)
    return eng


def family_engine(torch, dev, cfg, params, prompts, paged, dense=None,
                  phase="[3g]", frames=None):
    """[3]'s policy (int4 g32 packed, rank 0, int8 KV) under the default
    guards on the dense slab or the paged pool (block 16): the cold run
    (every kernel of the path launched, no other: an MLA stack reads its
    latent cache through plain attention, an SSM stack attends nowhere, a
    MoE stack's experts run ``ttq_gemm_experts`` on its tensor-core tile
    3 times per layer and decode
    step; paged tokens equal ``dense``'s; ``frames``, one per prompt, go
    with each request of an encoder-decoder family),
    greedy tokens printed, the graph readings of [3] (a warm run, every
    graph block and prefill replay bit for bit eager on a copy), two synced
    gated requants, peak memory, and (dense) a one-layer depth witness on
    4 fresh admissions with every kernel call held to its plain version."""
    from repro_torch.kernels import build
    what = f"{phase} {cfg.name} {'paged' if paged else 'dense'}"
    torch.cuda.reset_peak_memory_stats()
    kw = dict(kv_paged=True, kv_block_size=BLOCK) if paged else {}
    _, _, eng = build_engine(torch, dev, cfg, params, guards=True, **kw)
    with_frames(eng, prompts, frames)
    build.reset_launches()
    with counted_steps(eng) as steps, recorded_gemm_tiles() as rec:
        outs, wall = serve(torch, eng, prompts)
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    check_outputs(cfg, outs, what)
    if cfg.mla is not None:     # the wkv_b expansions wide, the rest split
        gemm_tiles = gemm_tiles_checked(cfg, rec, launches, what)
    want = {"ttq_quantize", "ttq_gemm"}
    if attends(cfg):
        want.add("ttq_paged_decode_attention" if paged
                 else "ttq_decode_attention")
    if cfg.moe is not None:
        want.add("ttq_gemm_experts")
    check(all((launches[k] > 0) == (k in want) for k in launches),
          f"{what}: launches {launches}, want {sorted(want)}")
    tiles = dict(build.EXPERTS_TILES)
    if cfg.moe is not None:
        check(launches["ttq_gemm_experts"] == 3 * cfg.n_layers * steps["n"],
              f"{what}: {launches['ttq_gemm_experts']} ttq_gemm_experts "
              f"launches in {steps['n']} decode steps of {cfg.n_layers} MoE "
              f"layers (want 3 per layer and step)")
        check(tiles == {"mma": launches["ttq_gemm_experts"], "batched": 0},
              f"{what}: ttq_gemm_experts took the tiles {tiles} in "
              f"{launches['ttq_gemm_experts']} launches (want the mma tile "
              f"every time)")
    outs = [list(o) for o in outs]
    if dense is not None:
        check(outs == dense["outputs"], f"{what}: greedy tokens differ from "
              f"the dense run's: leading tokens equal per request "
              f"{[leading_equal(o, d) for o, d in zip(outs, dense['outputs'])]}")
    res = dict(outputs=outs, tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
               requants=eng.n_requants, launches=launches,
               host_syncs=eng.host_syncs)
    if cfg.moe is not None:
        res["experts_tiles"] = tiles
    if cfg.mla is not None:
        res["gemm_tiles"] = gemm_tiles
    print(f"  {what}: served {len(prompts)} requests, {n_tok} tokens in "
          f"{wall:.2f} s cold ({n_tok / wall:.1f} tok/s); requants "
          f"{eng.n_requants}; launches {launches}"
          + (f", ttq_gemm_experts tiles {tiles}" if cfg.moe else "")
          + (f", ttq_gemm tiles {gemm_tiles} (the wkv_b expansions wide, "
             f"the rest split)" if cfg.mla else "")
          + ("; greedy tokens equal to the dense run's" if dense else ""))
    for i, o in enumerate(outs):
        print(f"    greedy tokens, request {i}: {o}")
    res.update(graph_phases(torch, cfg, eng, prompts, n_tok))
    rq = [synced_requant(torch, eng) * 1e3 for _ in range(2)]
    res["requant_synced_ms"] = rq
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {what}: warm ms per decode step "
          f"{res['decode_ms_per_step']:.2f}, warm prefill "
          f"{res['warm_phase_s']['prefill']:.3f} s, synced gated requant "
          f"{', '.join(f'{x:.1f}' for x in rq)} ms; peak "
          f"{res['peak_gb']:.2f} GB")
    if paged:
        eng.allocator.assert_quiescent()
        return res
    for p in prompts[:4]:
        eng.submit(p, max_new=MAX_NEW)
    eng.admit()
    if cfg.mla is not None:
        exp = res["wkv_b_expansion"] = expansion_ms(torch, cfg, eng)
        print(f"  {what}: the {cfg.n_layers} wkv_b expansions of the latent "
              f"cache ({exp['rows']} rows each) take {exp['ms_per_step']:.3f}"
              f" ms per decode step on the wide tile "
              f"({exp['ms_per_layer'] * 1e3:.1f} us each), "
              f"{exp['ms_per_step'] / res['decode_ms_per_step']:.1%} of the "
              f"warm step's {res['decode_ms_per_step']:.2f} ms; the split "
              f"tile on the same cache {exp['split_ms_per_step']:.3f} ms "
              f"({exp['split_ms_per_layer'] * 1e3:.1f} us each)")
    res.update(unit_witness(torch, cfg, eng, what))
    return res


@contextlib.contextmanager
def counted_steps(eng):
    """Count the decode steps of ``eng``'s blocks (K each, 1 for a K = 1
    ladder block) in ``["n"]``."""
    r = eng.runner
    real, n = r.decode_block, {"n": 0}

    def run(params, draft=None, small_chunk=False):
        n["n"] += 1 if small_chunk else r.K
        return real(params, draft, small_chunk)
    r.decode_block = run
    try:
        yield n
    finally:
        del r.decode_block


def unit_witness(torch, cfg, eng, what) -> dict:
    """:func:`depth_witness` on the first unit of the stack (one layer, or
    a hybrid's (rec, rec, lattn)) of the admitted slots, held to
    REL_L2_ONE_LAYER, every kernel call to its plain version."""
    from repro_torch.models.stack import stack_spec
    L = len(stack_spec(cfg)[0][0])
    wit, gaps = depth_witness(torch, cfg, eng, eng.runner, depths=(L,))
    check(wit[L]["kernels"] <= REL_L2_ONE_LAYER,
          f"{what}: kernel vs plain decode_step on {L} layers: rel-L2 "
          f"{wit[L]['kernels']}")
    check(wit[L]["plain again"] == 0.0, f"{what}: the plain path is not "
          f"deterministic")
    return dict(decode_step_rel_l2=wit, kernel_gaps=gaps)


# ------------------------------------------------------------- phase 3i

def refusals(torch, dev, cfg, params, phase="[3i]") -> list:
    """The reference's ValueErrors of a family without plain attention:
    the paged pool, speculation and chunked prefill."""
    out = []
    for kw, match in ((dict(kv_paged=True), "paged KV cache supports plain"),
                      (dict(speculate_k=2), "speculate_k needs a plain"),
                      (dict(prefill_chunk=16), "prefill_chunk needs a plain")):
        try:
            build_engine(torch, dev, cfg, params, guards=True, **kw)
        except ValueError as e:
            check(match in str(e), f"{phase} {cfg.name} {kw}: {e}")
            out.append(f"{next(iter(kw))}: {e}")
            continue
        check(False, f"{phase} {cfg.name}: {kw} did not raise")
    print(f"  {phase} {cfg.name} refuses: " + "; ".join(out))
    return out


def expansion_ms(torch, cfg, eng) -> dict:
    """MLA's decode expands the whole latent cache through ``wkv_b`` every
    step (the reference's math): one ``ttq_gemm`` over the B·max_len latent
    rows per layer, timed alone (CUDA events, median) on the served tree
    and the live cache, times the layer count, beside the warm decode step
    it is part of; on the wide tile the wrapper takes, and on the split
    tile forced (``ttq_gemm._launch``) at the same shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ttq_gemm import _launch
    qt = eng.decode_params["stack"][0]["u0"]["mix"]["wkv_b"]
    lat = eng.runner.state["stack"][0]["u0"]["latent"][0]
    x = lat.reshape(-1, lat.shape[-1])
    one = (x, qt.packed[0], qt.scale[0], qt.zero[0], qt.dinv[0])
    wide = time_ms(torch, lambda: ops.ttq_gemm(
        *one, bits=qt.bits, group_size=qt.group_size), iters=20)
    split = time_ms(torch, lambda: _launch(*one, qt.bits, qt.group_size,
                                           "split"), iters=20)
    return dict(rows=x.shape[0], ms_per_layer=wide,
                ms_per_step=wide * cfg.n_layers, split_ms_per_layer=split,
                split_ms_per_step=split * cfg.n_layers)


def moe_family(torch, dev) -> dict:
    """Phase 3i: (a) deepseek-v2-lite at full width and depth, dense slab
    (MLA has no paged pool), through :func:`family_engine`, then the
    ``wkv_b`` expansion's time and the three refusals; (b) llama4-scout at
    :func:`fit_depth` layers, dense then paged.  Returns the readings,
    each part's seconds and the kernels' launches over the engines."""
    from repro_torch.configs import get
    out, secs, launches = {}, {}, {}
    t = time.perf_counter()
    cfg, params = init_family(torch, dev, MOE_3I[0])
    prompts = make_prompts(cfg.vocab)
    dense = family_engine(torch, dev, cfg, params, prompts, False,
                          phase="[3i]")
    free(torch)
    dense["refusals"] = refusals(torch, dev, cfg, params)
    del params
    free(torch)
    out["a"] = dict(layers=cfg.n_layers, dense=dense)
    secs["a"] = time.perf_counter() - t

    t = time.perf_counter()
    depth = fit_depth(torch, get(MOE_3I[1]))
    cfg, params = init_family(torch, dev, MOE_3I[1], depth)
    prompts = make_prompts(cfg.vocab)
    dense_l = family_engine(torch, dev, cfg, params, prompts, False,
                            phase="[3i]")
    free(torch)
    paged_l = family_engine(torch, dev, cfg, params, prompts, True, dense_l,
                            phase="[3i]")
    del params
    free(torch)
    out["b"] = dict(layers=cfg.n_layers, dense=dense_l, paged=paged_l)
    secs["b"] = time.perf_counter() - t
    for r in (dense, dense_l, paged_l):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"], out["seconds"] = launches, secs
    print(f"  [3i] seconds per part: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
          + f"; llama4-scout at {depth} of 48 layers; launches {launches}")
    return out


def families(torch, dev) -> dict:
    """Phase 3g: minitron-4b, starcoder2-15b and granite-34b at the depths
    of DEPTHS_3G, each at full width through
    :func:`family_engine` on the dense slab and then the paged pool (the
    weights of one family on the card at a time).  Returns per family its
    readings and the kernels' launches over all of them."""
    from repro_torch.configs import get
    out, launches = {}, {}
    for arch in FAMILIES_3G:
        depth = DEPTHS_3G[arch]
        print(f"  [3g] {arch} at {depth} of {get(arch).n_layers} layers "
              f"(fit_depth: {fit_depth(torch, get(arch))})")
        cfg, params = init_family(torch, dev, arch, depth)
        prompts = make_prompts(cfg.vocab)
        t0 = time.perf_counter()
        dense = family_engine(torch, dev, cfg, params, prompts, False)
        free(torch)
        paged = family_engine(torch, dev, cfg, params, prompts, True, dense)
        del params
        free(torch)
        for r in (dense, paged):
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        out[arch] = dict(layers=cfg.n_layers, dense=dense, paged=paged,
                         seconds=time.perf_counter() - t0)
        print(f"  [3g] {cfg.name}: {cfg.n_layers} layers, "
              f"{out[arch]['seconds']:.1f} s for both engines")
    out["launches"] = launches
    return out


# ------------------------------------------------------------- phase 3h

def long_attention(torch, dev) -> dict:
    """[3h] (c): one layer's prefill attention over LONG_ATTN_S keys on f32
    q/k/v: ``attention``'s own dispatch, which must take the KV-chunked
    online softmax, against ``full_attention`` (its (B, Hkv, G, S, Sk) f32
    scores are 5.4 GB here), at gemma-7b's 16 heads of Dh 256 (causal) and
    at recurrentgemma-9b's G = 16 over one kv head at its window of 2,048.
    Each path's median time (CUDA events) and peak memory above what was
    allocated before it."""
    from repro_torch.models import common
    S, out = LONG_ATTN_S, {}
    real, calls = common.chunked_attention, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    cases = (("gemma-7b causal", 16, 16, 0),
             ("recurrentgemma-9b window 2048", 16, 1, 2048))
    for name, H, Hkv, window in cases:
        free(torch)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q = torch.randn((1, H, S, 256), generator=gen, device=dev)
        k, v = (torch.randn((1, Hkv, S, 256), generator=gen, device=dev)
                for _ in range(2))
        paths = {"chunked": lambda: common.attention(q, k, v, window=window),
                 "full": lambda: common.full_attention(q, k, v,
                                                       window=window)}
        res = {}
        common.chunked_attention = counted
        try:
            for path, fn in paths.items():
                calls.clear()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                o = fn()
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 1e9
                check(len(calls) == (path == "chunked"), f"[3h] (c) {name}: "
                      f"the {path} path made {len(calls)} chunked calls")
                res[path] = dict(ms=time_ms(torch, fn, iters=3, warmup=1),
                                 peak_gb=peak)
                res[path]["out"] = o
        finally:
            common.chunked_attention = real
        oc, of = res["chunked"].pop("out"), res["full"].pop("out")
        check(bool(torch.isfinite(oc).all()), f"[3h] (c) {name}: not finite")
        err = float((oc - of).abs().max())
        rel = float((oc - of).norm() / of.norm())
        res.update(max_abs_err=err, rel_l2=rel)
        check(err <= 1e-4 and rel <= 1e-5, f"[3h] (c) {name}: chunked vs "
              f"full attention max |diff| {err}, rel-L2 {rel}")
        print(f"  [3h] (c) {name}, S = {S}: chunked {res['chunked']['ms']:.2f}"
              f" ms, peak {res['chunked']['peak_gb']:.2f} GB; full "
              f"{res['full']['ms']:.2f} ms, peak {res['full']['peak_gb']:.2f}"
              f" GB; max |diff| {err:.2e}, rel-L2 {rel:.2e}")
        out[name] = res
        del q, k, v, oc, of
    free(torch)
    return out


def long_prompt(torch, dev, cfg, params, length, phase) -> dict:
    """One prompt of ``length`` tokens plus MAX_NEW through [3]'s policy
    under the default guards (one slot, exact-length prefill): [3h] (a)'s
    past recurrentgemma-9b's window (the prefill stores the rolling layout
    and decode wraps the 2,048-row slab), [3j] (a)'s across two of
    mamba2-1.3b's SSD chunks (the scan's chunk recurrence, and the dt = 0
    padding to a whole chunk).  The cold run (every kernel of the path
    launched), a rerun (the spare tree's decode graph), a timed warm run
    (no new graph), the shadowed run of :func:`graph_vs_eager` (every block
    and the prefill replay bit for bit eager), and the one-unit witness on
    the admitted prompt, whose first decode step reads the state the long
    prefill left."""
    from repro_torch.kernels import build
    what = f"{phase} {cfg.name} {length}-token prompt"
    prompt = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, size=length).tolist()
    torch.cuda.reset_peak_memory_stats()
    _, _, eng = build_engine(torch, dev, cfg, params, guards=True,
                             max_slots=1, max_len=length + 2 * MAX_NEW)
    build.reset_launches()
    outs, wall = serve(torch, eng, [prompt])
    launches = dict(build.LAUNCHES)
    check_outputs(cfg, outs, what)
    want = {"ttq_quantize", "ttq_gemm"} | (
        {"ttq_decode_attention"} if attends(cfg) else set())
    check(all((launches[k] > 0) == (k in want) for k in launches),
          f"{what}: launches {launches}, want {sorted(want)}")
    cold = eng.compiled_programs
    # one admission per run, one requant each: the cold run decodes on one
    # tree of the guards' swap, the first rerun on the other (its graph)
    serve(torch, eng, [prompt])
    r = eng.runner
    programs = eng.compiled_programs
    check(len(r._graphs) == 2 and len(r._prefills) == 1 and programs == 3,
          f"{what}: compiled programs {cold} cold, {programs} after a "
          f"rerun: {len(r._graphs)} decode and {len(r._prefills)} prefill "
          f"graphs (want 2 and 1)")
    warm = warm_phases(torch, eng, [prompt], MAX_NEW, quiet=True)
    K = eng.ecfg.decode_chunk
    step_ms = warm["warm_phase_s"]["decode"] * 1e3 / (
        -(-(MAX_NEW - 1) // K) * K)
    check(eng.compiled_programs == programs, f"{what}: the warm run "
          f"captured: {programs} → {eng.compiled_programs}")
    shadow, _ = graph_vs_eager(torch, cfg, eng, [prompt])
    check(shadow["prefills_replayed"] == 1
          and eng.compiled_programs == programs,
          f"{what}: prefill replays {shadow['prefills_replayed']}, programs "
          f"{programs} → {eng.compiled_programs}")
    res = dict(outputs=[list(o) for o in outs], cold_wall_s=wall,
               launches=launches, compiled_programs=programs,
               decode_ms_per_step=step_ms,
               warm_prefill_s=warm["warm_phase_s"]["prefill"],
               prefill_graph_ms=shadow["prefill_graph_ms"],
               prefill_capture_s={str(k): v for k, v in
                                  eng.runner.prefill_capture_s.items()},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  {what}: greedy tokens {res['outputs'][0]}; warm ms per decode "
          f"step {step_ms:.2f}, warm prefill {res['warm_prefill_s']:.3f} s "
          f"(graph replay {shadow['prefill_graph_ms']:.1f} ms); compiled "
          f"programs {cold} cold, {programs} after a rerun and flat over two "
          f"more; peak {res['peak_gb']:.2f} GB")
    eng.submit(prompt, max_new=MAX_NEW)
    eng.admit()
    res.update(unit_witness(torch, cfg, eng, what))
    return res


@contextlib.contextmanager
def first_prefill_logits():
    """Keep the logits the runner's first prefill samples its first tokens
    from, in ``[0]`` ((n, V) f32, the admission group's last rows): at a
    new group shape that prefill is the graph's eager warm-up run, so the
    tensor is its own and no replay overwrites it."""
    from repro_torch.serving import runner
    seen, real = [], runner.sample_logits

    def keep(logits, *a, **kw):
        if not seen:
            seen.append(logits)
        return real(logits, *a, **kw)
    runner.sample_logits = keep
    try:
        yield seen
    finally:
        runner.sample_logits = real


def untied_head(torch, dev, cfg, params, prompts, dense, first_tied) -> dict:
    """[3h] (d): chameleon-34b with ``tie_embeddings=False`` on (b)'s
    params, [3]'s policy under the default guards, dense slab, CUDA graphs.
    The control ``lm_head := embed`` serves (b)'s traffic with (b)'s dense
    engine's tokens, and its first prefill's logits are bit for bit that
    engine's (``first_tied``, from :func:`first_prefill_logits`).  An
    independent seeded ``lm_head`` (V, D) ~ N(0, 1/D), 1 GiB in bf16:
    request 0 admitted alone first, its first-step logits (the engine's
    prefill) bit for bit an eager ``lm.prefill``'s and within UNTIED_REL_L2
    of an eager ``lm.forward`` on the same params; then the rest of the
    traffic, whose tokens differ from (b)'s.
    Returns both runs' readings and their kernel launches."""
    from repro_torch.kernels import build
    from repro_torch.models import lm
    ucfg = dataclasses.replace(cfg, tie_embeddings=False)
    want = {"ttq_quantize", "ttq_gemm", "ttq_decode_attention"}
    res, launches = {}, {}

    def run(params_u, what, alone_first):
        with first_prefill_logits() as seen:
            _, _, eng = build_engine(torch, dev, ucfg, params_u, guards=True)
            build.reset_launches()
            t0 = time.perf_counter()
            rids = []
            if alone_first:                # a group of one: request 0
                rids.append(eng.submit(prompts[0], max_new=MAX_NEW))
                eng.admit()
            rids += [eng.submit(p, max_new=MAX_NEW)
                     for p in prompts[len(rids):]]
            done = eng.run_all()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = dict(build.LAUNCHES)
        outs = [done[r] for r in rids]
        check_outputs(ucfg, outs, what)
        check(all((got[k] > 0) == (k in want) for k in got),
              f"{what}: launches {got}, want {sorted(want)}")
        check(len(eng.runner._graphs) > 0 and len(eng.runner._prefills) > 0,
              f"{what}: decode graphs {len(eng.runner._graphs)}, prefill "
              f"graphs {len(eng.runner._prefills)} (want CUDA graphs)")
        check(eng.decode_params["lm_head"] is params_u["lm_head"],
              f"{what}: the decode tree's head is not the fp lm_head")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return eng, [list(o) for o in outs], seen[0], wall, got

    what = "[3h] (d) chameleon-34b untied, lm_head := embed"
    eng, outs, first, wall, got = run(dict(params, lm_head=params["embed"]),
                                      what, False)
    check(outs == dense["outputs"], f"{what}: greedy tokens differ from (b)'s "
          f"dense engine's: leading tokens equal per request "
          f"{[leading_equal(o, d) for o, d in zip(outs, dense['outputs'])]}")
    check(torch.equal(first, first_tied), f"{what}: first prefill's logits "
          f"differ from (b)'s dense engine's (max |diff| "
          f"{float((first - first_tied).abs().max()):.3g})")
    res["control"] = dict(wall_s=wall, launches=got, outputs=outs)
    print(f"  {what}: served {len(prompts)} requests in {wall:.2f} s cold; "
          f"tokens equal to (b)'s dense engine's, first prefill's logits "
          f"({tuple(first.shape)}) bit for bit; launches {got}")
    del eng, first
    free(torch)

    what = "[3h] (d) chameleon-34b untied, an independent lm_head"
    head = lm.draw_table(cfg.vocab, cfg.d_model, cfg.d_model ** -0.5,
                         torch.Generator(device=dev).manual_seed(SEED + 31),
                         dev)
    pu = dict(params, lm_head=head)
    eng, outs, first, wall, got = run(pu, what, True)
    tok0 = torch.tensor([prompts[0]], device=dev)
    with torch.no_grad():
        fwd = lm.forward(ucfg, pu, {"tokens": tok0})[0][0, -1]
        pre = lm.prefill(ucfg, pu, {"tokens": tok0}, eng.ecfg.max_len,
                         collect_stats=False, kvcfg=eng.kvcfg)[0][0]

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    rel, rel_pre = rel_l2(first[0], fwd), rel_l2(first[0], pre)
    diff = float((first[0] - fwd).abs().max())
    check(torch.equal(first[0], pre.to(first.dtype)) and rel <= UNTIED_REL_L2,
          f"{what}: request 0's first-step logits {rel_pre:.3g} (relative "
          f"L2) from the eager prefill's (want bit for bit), {rel:.3g} from "
          f"lm.forward's (bound {UNTIED_REL_L2})")
    differ = sum(o != d for o, d in zip(outs, dense["outputs"]))
    check(differ > 0, f"{what}: every request's tokens equal the tied "
          f"engine's")
    res["independent"] = dict(wall_s=wall, launches=got, outputs=outs,
                              first_rel_l2=rel, first_max_abs=diff,
                              first_rel_l2_prefill=rel_pre,
                              requests_differing=differ)
    print(f"  {what} ({head.numel() * 2 / 2 ** 30:.2f} GiB bf16): served "
          f"{len(prompts)} requests in {wall:.2f} s cold, request 0 first, "
          f"alone; its first-step logits {rel_pre:.3g} relative L2 from the "
          f"eager lm.prefill (int8 KV), {rel:.3g} (max |diff| {diff:.3g}) "
          f"from an eager lm.forward; {differ} of "
          f"{len(prompts)} requests' tokens differ from the tied engine's; "
          f"launches {got}")
    for i, o in enumerate(outs):
        print(f"    greedy tokens, request {i}: {o}")
    del eng, first, head, pu, fwd, pre
    free(torch)
    res["launches"] = launches
    return res


def hybrid_and_vlm(torch, dev) -> dict:
    """Phase 3h: (c) long prefill attention; (a) recurrentgemma-9b at full
    width and HYBRID_DEPTH_3H layers, [3g]'s engine readings on the dense
    slab plus :func:`long_prompt`; (b) chameleon-34b at VLM_DEPTH_3H
    layers, dense then paged; (d) (b)'s params untied
    (:func:`untied_head`).  Returns the readings, each part's seconds and
    the kernels' launches over (a), (b) and (d)'s engines."""
    from repro_torch.configs import get
    from repro_torch.models.stack import stack_spec
    out, secs, launches = {}, {}, {}
    t = time.perf_counter()
    out["c"] = long_attention(torch, dev)
    secs["c"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg, params = init_family(torch, dev, "recurrentgemma_9b",
                              HYBRID_DEPTH_3H)
    prompts = make_prompts(cfg.vocab)
    dense = family_engine(torch, dev, cfg, params, prompts, False,
                          phase="[3h]")
    lens = {len(p) for p in prompts}
    check(dense["prefill_graphs"] == len(lens), f"[3h] {cfg.name}: "
          f"{dense['prefill_graphs']} prefill graphs for {len(lens)} "
          f"distinct prompt lengths")
    print(f"  [3h] {cfg.name}: {dense['prefill_graphs']} prefill captures "
          f"for {len(lens)} distinct prompt lengths (exact-length prefill); "
          f"stack {stack_spec(cfg)}")
    free(torch)
    long = long_prompt(torch, dev, cfg, params, HYBRID_LONG, "[3h]")
    del params
    free(torch)
    out["a"] = dict(layers=cfg.n_layers, dense=dense, long=long,
                    distinct_prompt_lengths=len(lens))
    secs["a"] = time.perf_counter() - t

    t = time.perf_counter()
    depth = VLM_DEPTH_3H
    print(f"  [3h] chameleon-34b at {depth} layers (fit_depth: "
          f"{fit_depth(torch, get('chameleon_34b'))})")
    cfg, params = init_family(torch, dev, "chameleon_34b", depth)
    prompts = make_prompts(cfg.vocab)
    with first_prefill_logits() as first_tied:
        dense_v = family_engine(torch, dev, cfg, params, prompts, False,
                                phase="[3h]")
    free(torch)
    paged_v = family_engine(torch, dev, cfg, params, prompts, True, dense_v,
                            phase="[3h]")
    free(torch)
    out["b"] = dict(layers=cfg.n_layers, dense=dense_v, paged=paged_v)
    secs["b"] = time.perf_counter() - t

    t = time.perf_counter()
    out["d"] = untied_head(torch, dev, cfg, params, prompts, dense_v,
                           first_tied[0])
    del params, first_tied
    free(torch)
    secs["d"] = time.perf_counter() - t
    for r in (dense, long, dense_v, paged_v, out["d"]):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"], out["seconds"] = launches, secs
    print(f"  [3h] seconds per part: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
          + f"; chameleon-34b at {depth} of 48 layers; launches {launches}")
    return out


# ------------------------------------------------------------- phase 3j

def frames_replay(torch, dev, cfg, params) -> dict:
    """[3j] (b)'s frames check: one prompt admitted twice at one prefill
    key (one slot) with frames drawn apart from the seed.  The second
    admission replays the graph the first captured, and must give the
    eager prefill's results on its own frames bit for bit (first token,
    statistics, every state leaf: the self cache, the cross k/v and
    ``enc_out``), with an ``enc_out`` unlike the first's."""
    r_frames = np.random.default_rng(SEED + 6).standard_normal(
        (2, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    _, _, eng = build_engine(torch, dev, cfg, params, guards=True,
                             max_slots=1)
    r = eng.runner
    prompt = make_prompts(cfg.vocab)[0]
    outs, enc = [], []
    real_admit = r.admit_group
    seen = {}

    def admit(p, group):
        snap, n = clone_tree(torch, r.state), len(r._prefills)
        first, fin, stats = real_admit(p, group)
        if len(r._prefills) == n:
            inp = {k: torch.from_numpy(v).to(dev)
                   for k, v in r._prefill_inputs(group).items()}
            want, want_stats = r._prefill(p, snap, inp, 0, None)
            seen["same"] = (np.array_equal(first, want.cpu().numpy()),
                            tree_equal(torch, stats, want_stats),
                            tree_equal(torch, r.state, snap))
        return first, fin, stats
    r.admit_group = admit
    try:
        for f in r_frames:
            rid = eng.submit(prompt, max_new=MAX_NEW, frames=f)
            outs.append(list(eng.run_all()[rid]))
            enc.append(r.state["enc_out"][0].clone())
    finally:
        del r.admit_group
    check(len(r._prefills) == 1 and "same" in seen,
          f"[3j] {cfg.name}: the second admission did not replay the "
          f"prefill graph ({len(r._prefills)} prefill graphs)")
    check(all(seen["same"]), f"[3j] {cfg.name}: the replay on new frames "
          f"(first token, statistics, state) equal to the eager prefill on "
          f"them: {seen['same']}")
    check(not torch.equal(enc[0], enc[1]), f"[3j] {cfg.name}: enc_out did "
          f"not change with the frames")
    res = dict(replay_equal_eager=True, tokens_differ=outs[0] != outs[1],
               leading_equal=leading_equal(outs[0], outs[1]))
    print(f"  [3j] {cfg.name}: one prompt admitted twice with different "
          f"frames: the second admission replayed the first's prefill "
          f"graph, bit for bit the eager prefill on its own frames (first "
          f"token, statistics, self cache, cross k/v, enc_out); greedy "
          f"tokens {'differ' if res['tokens_differ'] else 'equal'} "
          f"({res['leading_equal']} leading tokens equal)")
    return res


def ssm_and_encdec(torch, dev) -> dict:
    """Phase 3j: (a) mamba2-1.3b at full width and DEPTHS_3J layers, dense
    slab (its SSD state admits no pool), through :func:`family_engine`
    (one prefill graph per distinct prompt length), then one prompt of
    SSM_LONG tokens across two SSD chunks (:func:`long_prompt`) and the
    three refusals; (b) whisper-medium at full width and DEPTHS_3J
    encoder and decoder layers,
    dense slab, 8 requests with their own frames from the seed, then
    :func:`frames_replay` and the three refusals.  Returns the readings,
    each part's seconds and the kernels' launches over the engines."""
    from repro_torch.models.stack import stack_spec
    out, secs, launches = {}, {}, {}
    t = time.perf_counter()
    cfg, params = init_family(torch, dev, FAMILIES_3J[0],
                              DEPTHS_3J[FAMILIES_3J[0]])
    prompts = make_prompts(cfg.vocab)
    dense = family_engine(torch, dev, cfg, params, prompts, False,
                          phase="[3j]")
    lens = {len(p) for p in prompts}
    check(dense["prefill_graphs"] == len(lens), f"[3j] {cfg.name}: "
          f"{dense['prefill_graphs']} prefill graphs for {len(lens)} "
          f"distinct prompt lengths")
    print(f"  [3j] {cfg.name}: {dense['prefill_graphs']} prefill captures "
          f"for {len(lens)} distinct prompt lengths (exact-length prefill); "
          f"stack {stack_spec(cfg)}")
    free(torch)
    long = long_prompt(torch, dev, cfg, params, SSM_LONG, "[3j]")
    free(torch)
    dense["refusals"] = refusals(torch, dev, cfg, params, "[3j]")
    del params
    free(torch)
    out["a"] = dict(layers=cfg.n_layers, dense=dense, long=long)
    secs["a"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg, params = init_family(torch, dev, FAMILIES_3J[1],
                              DEPTHS_3J[FAMILIES_3J[1]])
    prompts = make_prompts(cfg.vocab)
    frames = np.random.default_rng(SEED + 5).standard_normal(
        (len(prompts), cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    dense_w = family_engine(torch, dev, cfg, params, prompts, False,
                            phase="[3j]", frames=frames)
    free(torch)
    dense_w["frames"] = frames_replay(torch, dev, cfg, params)
    free(torch)
    dense_w["refusals"] = refusals(torch, dev, cfg, params, "[3j]")
    del params
    free(torch)
    out["b"] = dict(layers=cfg.n_layers,
                    encoder_layers=cfg.encdec.n_enc_layers, dense=dense_w)
    secs["b"] = time.perf_counter() - t
    for r in (dense, long, dense_w):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"], out["seconds"] = launches, secs
    print(f"  [3j] seconds per part: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
          + f"; launches {launches}")
    return out


def train_fit_depth(torch, cfg, tokens_per_mb: int) -> int:
    """The most layers of ``cfg`` the card trains at TRAIN_BYTES_PER_PARAM
    per parameter, after the tied embedding's share, the head's f32 logits
    of one microbatch (4 × 4 B per logit) and FIT_RESERVE_GB."""
    total = torch.cuda.get_device_properties(0).total_memory
    room = (total - cfg.vocab * cfg.d_model * TRAIN_BYTES_PER_PARAM
            - 16 * tokens_per_mb * cfg.vocab - FIT_RESERVE_GB * 1e9)
    per_layer = layer_params(cfg, "attn")[0] * TRAIN_BYTES_PER_PARAM
    return int(room // per_layer)


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (PaLM's count): 6 per parameter
    per token over the layers' linears and the tied head (V·D), plus
    12·L·H·hd·S per token for attention (no causal halving); remat's
    recomputation is not counted."""
    lin = cfg.n_layers * layer_params(cfg, "attn")[0] + cfg.vocab * cfg.d_model
    return tokens * (6 * lin + 12 * cfg.n_layers * cfg.n_heads * cfg.hd * seq)


def state_digest(torch, opt_state) -> list:
    """Host copies of the masters, to compare two runs of one step."""
    from repro_torch._tree import tree_leaves
    return [t.detach().cpu() for t in tree_leaves(opt_state["master"])]


def restored_step(torch, dev, cfg, tc, dc) -> dict:
    """Train 2 steps, save the opt state through ``CheckpointManager``, run
    step 3 (live); restore the checkpoint into the trainer and run step 3
    again on the same batch.  Its loss and masters must equal the live
    ones: bit for bit when the card repeats its arithmetic, else within
    2·lr (one AdamW step moves a master by at most ~lr)."""
    import shutil
    import tempfile
    from repro_torch.data import token_stream
    from repro_torch.training import Trainer
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        tc = dataclasses.replace(tc, checkpoint_every=2, checkpoint_dir=tmp)
        tr = Trainer(cfg, tc, token_stream(dc, 0, device=dev), device=dev)
        t0 = time.perf_counter()
        tr.run(2)
        save_s = time.perf_counter() - t0 - sum(m["time_s"]
                                                for m in tr.metrics_log)
        live = tr.run(1)[-1]
        live_m = state_digest(torch, tr.opt_state)
        check(tr.ckpt.latest_step() == 2, "[3k] no checkpoint at step 2")
        t0 = time.perf_counter()
        tr.data = token_stream(dc, 0, start_step=2, device=dev)
        check(tr.restore_if_available() and tr.step == 2,
              "[3k] the restore did not find step 2")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        again = tr.run(1)[-1]
        again_m = state_digest(torch, tr.opt_state)
        bitwise = again["loss"] == live["loss"] and all(
            torch.equal(a, b) for a, b in zip(live_m, again_m))
        diff = max(float((a - b).abs().max()) for a, b in zip(live_m, again_m))
        nbytes_ = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(tmp) for f in fs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(abs(again["loss"] - live["loss"]) <= 1e-5 * abs(live["loss"])
          and diff <= 2 * live["lr"],
          f"[3k] the restored step differs from the live one: loss "
          f"{again['loss']} vs {live['loss']}, max |master diff| {diff}")
    out = dict(layers=cfg.n_layers, loss_live=live["loss"],
               loss_restored=again["loss"], max_master_diff=diff,
               bitwise=bitwise, checkpoint_gb=nbytes_ / 1e9,
               save_s=save_s, restore_s=restore_s)
    print(f"  [3k] (a) save/restore at {cfg.n_layers} layer(s): "
          f"{nbytes_ / 1e9:.2f} GB on disk, saved in {save_s:.1f} s, restored "
          f"in {restore_s:.1f} s; step 3 loss live {live['loss']!r} restored "
          f"{again['loss']!r}, max |master diff| {diff:.3g}, bit for bit "
          f"{bitwise}")
    return out


def train_gemma(torch, dev) -> dict:
    """Phase 3k (a): gemma-7b at full width trained with the reference's
    defaults (f32 masters, bf16 compute, AdamW, remat, 2 microbatches) at
    ``train_fit_depth`` layers on batches from ``token_stream`` (domain
    0): one cold step, then WARM_3K warm ones; then the save/restore check
    on RESTORE_DEPTH_3K layers and the train CLI for 3 steps."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.launch import train as train_cli
    from repro_torch.training import TrainConfig, Trainer
    full = get("gemma_7b")
    tokens = BATCH_3K * SEQ_3K
    depth = min(full.n_layers, train_fit_depth(torch, full, tokens // MB_3K))
    cfg = dataclasses.replace(full, n_layers=depth)
    dc = DataConfig(vocab=cfg.vocab, seq_len=SEQ_3K, batch=BATCH_3K,
                    seed=SEED)
    tc = TrainConfig(n_microbatches=MB_3K, remat=True, warmup=2,
                     total_steps=100)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, token_stream(dc, 0, device=dev), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tr.opt_state["master"]))
    print(f"  [3k] (a) {cfg.name} full width, {depth} of {full.n_layers} "
          f"layers (train_fit_depth at {TRAIN_BYTES_PER_PARAM} B per "
          f"parameter); {n_params / 1e9:.3f} B parameters; init {init_s:.1f} s"
          f", {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    log = tr.run(1 + WARM_3K)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in log]
    check(all(np.isfinite(losses)), f"[3k] (a) a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"[3k] (a) the loss did not fall: {losses}")
    warm = [m["time_s"] * 1e3 for m in log[1:]]
    ms = statistics.median(warm)
    flops = train_flops(cfg, tokens, SEQ_3K)
    out = dict(layers=depth, params=n_params, cold_ms=log[0]["time_s"] * 1e3,
               ms=ms, ms_min=min(warm), ms_max=max(warm),
               tokens_per_s=tokens / ms * 1e3, flops=flops,
               mfu=flops / (ms / 1e3) / DENSE_BF16_FLOP_PER_S, peak_gb=peak,
               losses=losses)
    print(f"  [3k] (a) cold step {out['cold_ms']:.1f} ms; warm ms per step "
          f"{ms:.2f} (min {min(warm):.2f}, max {max(warm):.2f}, "
          f"{WARM_3K} steps); {out['tokens_per_s']:.0f} tokens/s; model "
          f"FLOPs {flops:.4g} per step (train_flops) = "
          f"{out['mfu'] * 100:.1f}% of the dense bf16 peak; peak "
          f"{peak:.2f} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    del tr
    free(torch)
    out["restore"] = restored_step(
        torch, dev, dataclasses.replace(full, n_layers=RESTORE_DEPTH_3K), tc,
        dc)
    free(torch)
    t0 = time.perf_counter()
    cli = train_cli.main(["--arch", "gemma_7b", "--smoke", "--steps", "3"])
    cli_losses = [m["loss"] for m in cli.metrics_log]
    check(cli.step == 3 and all(np.isfinite(cli_losses))
          and cli.device.type == "cuda",
          f"[3k] the train CLI: step {cli.step}, losses {cli_losses}")
    out["cli"] = dict(steps=cli.step, losses=cli_losses,
                      seconds=time.perf_counter() - t0)
    print(f"  [3k] (a) python -m repro_torch.launch.train --arch gemma_7b "
          f"--smoke --steps 3 on the card: losses {cli_losses}")
    del cli
    free(torch)
    return out


def held_out(dc, domain: int, n: int, batch: int, seed0: int, dev) -> list:
    """The reference example's held-out batches (benchmarks/common.py:
    eval_batches): n batches of domain ``domain`` at steps seed0 + 131·i +
    domain of the stream's seeding, far past the steps trained on."""
    from repro_torch.data.pipeline import (batch_generator, make_domain,
                                           sample_batch)
    spec = make_domain(dc, domain)
    return [{"tokens": sample_batch(
        spec, batch_generator(dc.seed, seed0 + 131 * i + domain, domain),
        batch, dc.seq_len).to(dev)} for i in range(n)]


def perplexity(torch, cfg, params_of, batches) -> float:
    """exp of the mean next-token NLL over ``batches``; ``params_of(b)``
    gives the parameters that score batch b."""
    from repro_torch.models import lm
    tot, cnt = 0.0, 0.0
    with torch.no_grad():
        for b in batches:
            loss, aux = lm.loss_fn(cfg, params_of(b), b)
            tot += float(loss) * float(aux["tokens"])
            cnt += float(aux["tokens"])
    return float(np.exp(tot / cnt))


def calib_stats(torch, cfg, params, batches):
    from repro_torch.models import lm
    from repro_torch.quant import CalibrationSession
    sess = CalibrationSession()
    with torch.no_grad():
        for b in batches:
            _, _, st = lm.prefill(cfg, params, b,
                                  max_len=b["tokens"].shape[1],
                                  collect_stats=True)
            sess.update(st, tokens=float(b["tokens"].numel()))
    return sess


def train_100m(torch, dev) -> dict:
    """Phase 3k (b): the reference example's 100m preset trained on domain
    0 for STEPS_3K_B steps (fewer past TRAIN_BUDGET_3K_B seconds), then its
    report (examples/train_ttq_lm.py:59-73) with the port's own
    ``CalibrationSession``, ``QuantizedModel``, ``ttq_policy`` and
    ``loss_fn``: held-out perplexity on domain 0 in full precision, and at
    4 and 3 bits g32 for RTN, AWQ calibrated on domain 1 and TTQ (rank 16,
    zero calibration, requantized per batch).  Readings only."""
    from repro_torch.core import ttq_policy
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.models.config import ModelConfig
    from repro_torch.quant import QuantizedModel
    from repro_torch.training import TrainConfig, Trainer
    p = PRESET_100M
    cfg = ModelConfig(name="ttq-lm-100m", family="dense",
                      n_layers=p["n_layers"], d_model=p["d_model"],
                      n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                      d_ff=p["d_ff"], vocab=p["vocab"])
    dc = DataConfig(vocab=p["vocab"], seq_len=p["seq"], batch=p["batch"],
                    seed=11)
    tc = TrainConfig(n_microbatches=2, remat=True, total_steps=STEPS_3K_B,
                     warmup=max(10, STEPS_3K_B // 10))
    tr = Trainer(cfg, tc, token_stream(dc, 0, device=dev), device=dev)
    t0 = time.perf_counter()
    while tr.step < STEPS_3K_B and time.perf_counter() - t0 < TRAIN_BUDGET_3K_B:
        tr.run(min(10, STEPS_3K_B - tr.step))
    train_s = time.perf_counter() - t0
    log = tr.metrics_log
    losses = [m["loss"] for m in log]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[3k] (b) the loss did not fall or is not finite: "
          f"{losses[0]} -> {losses[-1]}")
    warm = sorted(m["time_s"] for m in log[1:])
    print(f"  [3k] (b) {cfg.name}: {cfg.param_count() / 1e6:.1f}M parameters, "
          f"{tr.step} of {STEPS_3K_B} steps in {train_s:.1f} s (median "
          f"{warm[len(warm) // 2] * 1e3:.1f} ms per step); loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    params = tr.params
    del tr
    free(torch)
    ev = held_out(dc, 0, 2, 4, 9000, dev)
    cal = held_out(dc, 1, 2, 4, 321, dev)
    table = {"fp": perplexity(torch, cfg, lambda b: params, ev)}
    print(f"  [3k] (b) held-out ppl fp: {table['fp']:.2f}")
    calib = calib_stats(torch, cfg, params, cal)
    for bits in (4, 3):
        row = {}
        for method in ("rtn", "awq"):
            pol = ttq_policy(bits=bits, group_size=32, rank=0,
                             packed=False).with_(method=method)
            qm = QuantizedModel(params, pol, session=calib.snapshot()
                                if method == "awq" else None)
            qp = qm.requantize()
            row[method] = perplexity(torch, cfg, lambda b: qp, ev)
        qm = QuantizedModel(params, ttq_policy(bits=bits, group_size=32,
                                               rank=16, packed=False))

        def per_batch(b):           # TTQ: requantized from b's own stats
            qm.session = calib_stats(torch, cfg, params, [b])
            return qm.requantize()
        row["ttq"] = perplexity(torch, cfg, per_batch, ev)
        table[f"{bits}-bit"] = row
        print(f"  [3k] (b) {bits}-bit g=32  RTN {row['rtn']:.2f} | AWQ "
              f"(shifted calib) {row['awq']:.2f} | TTQ (r=16, zero calib) "
              f"{row['ttq']:.2f}")
    return dict(steps=len(log), train_s=train_s, loss_first=losses[0],
                loss_last=losses[-1], ppl=table)


def training(torch, dev) -> dict:
    """Phase 3k: (a) then (b); prints each part's seconds.  The training
    path launches none of the CUDA kernels (its products are plain
    ``x @ wᵀ`` on bf16 weights, as the reference's outside Pallas)."""
    out, secs = {}, {}
    for part, fn in (("a", train_gemma), ("b", train_100m)):
        t = time.perf_counter()
        out[part] = fn(torch, dev)
        secs[part] = time.perf_counter() - t
        free(torch)
    out["seconds"] = secs
    print("  [3k] seconds per part: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
    return out


# --------------------------------------------------------------- phase 3n

def opt_bytes(opt_state) -> int:
    """Bytes of the optimizer state's leaves on this rank."""
    from repro_torch._tree import tree_leaves
    return sum(t.numel() * t.element_size() for k in ("master", "m", "v")
               for t in tree_leaves(opt_state[k]))


def dp_rule(torch, want, got) -> float:
    """The largest |got − want| / (DP_ATOL_3N + DP_RTOL_3N·|want|): ≤ 1 is
    within the reference's microbatch-equivalence tolerance."""
    want, got = want.float(), got.float()
    return float(((got - want).abs()
                  / (DP_ATOL_3N + DP_RTOL_3N * want.abs())).max())


def held_masters(torch, tr, masters_dir) -> float:
    """The worst DP-rule ratio of the rank's master slices against (a)'s
    whole masters on disk (one .npy per leaf, leaf order)."""
    from repro_torch._tree import tree_leaves
    worst = 0.0
    for i, (t, sh) in enumerate(zip(tree_leaves(tr.opt_state["master"]),
                                    tree_leaves(tr.oshard["master"]))):
        whole = np.load(os.path.join(masters_dir, f"{i}.npy"),
                        mmap_mode="r")
        want = torch.from_numpy(np.array(whole[sh.index(whole.shape)])).to(
            t.device)
        worst = max(worst, dp_rule(torch, want, t))
        del want
    return worst


def mesh_train_3n(torch, dev, payload, data, model) -> dict:
    """[3n] (b), (c): the (data, model) mesh's Trainer on the rank's rows,
    STEPS_3N steps; losses, ms per step and the staged collectives' ms
    over the warm steps, peak GB, optimizer bytes, and the worst DP-rule
    ratio of the rank's masters against (a)'s."""
    from repro_torch.data import token_stream
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.parallel import comm
    from repro_torch.training import Trainer
    pctx = make_ctx(make_mesh(data, model, device=dev.type))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(payload["cfg"], payload["tc"],
                 token_stream(payload["dc"], 0, host_id=pctx.dp_rank,
                              n_hosts=pctx.dp_world, device=dev),
                 pctx=pctx, device=dev)
    init_s = time.perf_counter() - t0
    tr.run(1)
    s0 = dict(comm.STAGED_S)
    tr.run(STEPS_3N - 1)
    warm = [m["time_s"] * 1e3 for m in tr.metrics_log[1:]]
    staged = {k: (comm.STAGED_S[k] - s0[k]) * 1e3 / len(warm) for k in s0
              if comm.STAGED_S[k] > s0[k]}
    out = dict(loss=[m["loss"] for m in tr.metrics_log],
               grad_norm=[m["grad_norm"] for m in tr.metrics_log],
               cold_ms=tr.metrics_log[0]["time_s"] * 1e3,
               ms=statistics.median(warm), staged_ms=staged,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               opt_gb=opt_bytes(tr.opt_state) / 1e9, init_s=init_s,
               rank=(pctx.dp_rank, pctx.rank), backend=pctx.mesh.backend)
    out["master_ratio"] = held_masters(torch, tr, payload["masters"])
    del tr
    free(torch)
    return out


def mesh_digest(torch, t, sh, shape) -> int:
    """A 64-bit digest of the whole leaf of global ``shape`` whose slice
    this rank holds as ``t`` (by ``sh``): Σ wᵢ·bitsᵢ over the slice, wᵢ an
    odd function of the element's global index, wrapping in int64, summed
    over the mesh's ranks.  Two partitions of the same bits give the same
    digest; one element that differs always changes it (w odd)."""
    from repro_torch.parallel import comm
    bits = t.contiguous().view({4: torch.int32, 2: torch.int16}[
        t.element_size()]).long().reshape(t.shape)
    idx = sh.index(shape)
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    rows = max(1, (1 << 24) // max(1, bits[0].numel() if bits.dim() else 1))
    for r0 in range(0, bits.shape[0] if bits.dim() else 1, rows):
        part = bits[r0:r0 + rows] if bits.dim() else bits
        g = torch.zeros((), dtype=torch.int64, device=t.device)
        for d in range(part.dim()):
            start = idx[d].start + (r0 if d == 0 else 0)
            ar = torch.arange(start, start + part.shape[d],
                              dtype=torch.int64, device=t.device)
            g = g + (ar * strides[d]).view(
                [-1 if j == d else 1 for j in range(part.dim())])
        w = g * 0x9E3779B97F4A7C1 * 2 + 1          # odd
        total += (w * part).sum()
    for axis in ("model", "data"):
        if sh.dims(axis):               # a replicated axis holds it whole
            total = comm.all_reduce(total, sh.pctx, axis=axis)
    return int(total)


def elastic_3n(torch, dev, payload) -> dict:
    """[3n] (d), on RESTORE_DEPTH_3N layers: a ZeRO-1 Trainer at (2,1)
    takes a step and writes its own checkpoint (the optimizer state;
    every rank takes part, rank 0 writes); ``ElasticController.rescale``
    restores it onto (1,2) (no parameters: the Trainer's are its masters
    cast), and every restored leaf is held to the live one by
    :func:`mesh_digest` (the same 64-bit digest of the whole leaf from
    either partition); then step 2 live at (2,1) and restored at (1,2) on
    the same global batch."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.data import token_stream
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import param_sharding
    from repro_torch.parallel.rules import bind
    from repro_torch.runtime import ElasticController
    from repro_torch.training import Trainer
    from repro_torch.training.trainer import opt_sharding
    cfg, dc = payload["cfg1"], payload["dc"]
    tc = dataclasses.replace(payload["tc1"], checkpoint_every=1)
    p21 = make_ctx(make_mesh(2, 1, device=dev.type))
    p12 = bind(make_ctx(make_mesh(1, 2, device=dev.type)), cfg)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, token_stream(dc, 0, host_id=p21.dp_rank,
                                       n_hosts=2, device=dev),
                 pctx=p21, device=dev)
    t0 = time.perf_counter()
    tr.run(1)                           # the step, then its checkpoint
    save_s = time.perf_counter() - t0 - tr.metrics_log[-1]["time_s"]
    whole = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    like = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                          device=dev).expand(p.shape),
                    whole)              # global shapes, no memory
    del whole
    opt_like = {"step": torch.zeros((), dtype=torch.int32),
                "master": like, "m": like, "v": like}
    mgr, tr.ckpt = tr.ckpt, None        # the live step writes no second
    t0 = time.perf_counter()
    _, opt = ElasticController.rescale(
        mgr, 1, {}, opt_like, p12,
        lambda o, _, c: opt_sharding(o, param_sharding(like, c), c, True))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    new_sh = opt_sharding(opt_like, param_sharding(like, p12), p12, True)
    exact, leaves = True, 0
    for old, osh, got, nsh, shape in zip(
            tree_leaves(tr.opt_state), tree_leaves(tr.oshard),
            tree_leaves(opt), tree_leaves(new_sh), tree_leaves(opt_like)):
        exact &= mesh_digest(torch, old, osh, shape.shape) \
            == mesh_digest(torch, got, nsh, shape.shape)
        leaves += 1
    live_step = tr.run(1)[-1]
    ckpt_gb = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(mgr.dir) for f in fs) / 1e9
    del tr
    free(torch)
    tr2 = Trainer(cfg, payload["tc"], token_stream(dc, 0, start_step=1,
                                                   device=dev),
                  pctx=p12, device=dev)
    tr2.opt_state, tr2.step = opt, 1
    del opt
    again = tr2.run(1)[-1]
    out = dict(exact=exact, leaves=leaves, save_s=save_s,
               restore_s=restore_s, loss_live=live_step["loss"],
               loss_restored=again["loss"], checkpoint_gb=ckpt_gb,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del tr2
    free(torch)
    return out


def compressed_3n(torch, dev, payload) -> dict:
    """[3n] (e): ``make_compressed_dp_step`` at (2,1) on the 100m preset
    for STEPS_3N_E steps on the rank's rows of each batch; rank 0 then runs
    the uncompressed step at world 1 on the whole batches."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.data import token_stream
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init, compress_state_init
    from repro_torch.training import make_train_step
    from repro_torch.training.trainer import make_compressed_dp_step
    cfg, dc, tc = payload["cfg_m"], payload["dc_m"], payload["tc_e"]
    pctx = make_ctx(make_mesh(2, 1, device=dev.type))
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    opt_c, err = adamw_init(params), compress_state_init(params)
    step = make_compressed_dp_step(cfg, tc, pctx)
    rows = token_stream(dc, 0, host_id=pctx.dp_rank, n_hosts=2, device=dev)
    p, losses, ms = params, [], []
    for _ in range(STEPS_3N_E):
        t0 = time.perf_counter()
        p, opt_c, err, m = step(p, opt_c, err, next(rows))
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(loss=losses, ms=statistics.median(ms[1:]), cold_ms=ms[0],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if pctx.dp_rank == 0:
        opt_u = adamw_init(params)
        unc = make_train_step(cfg, tc, param_dtypes=tree_map(
            lambda t: t.dtype, params))
        whole = token_stream(dc, 0, device=dev)
        for _ in range(STEPS_3N_E):
            opt_u, mu = unc(opt_u, next(whole))
        num = den = 0.0
        for a, b in zip(tree_leaves(opt_c["master"]),
                        tree_leaves(opt_u["master"])):
            num += float(((a - b).double() ** 2).sum())
            den += float((b.double() ** 2).sum())
        out["rel_l2"] = (num / den) ** 0.5
        out["loss_uncompressed"] = float(mu["loss"])
    del params, p, opt_c, err
    free(torch)
    return out


def train_rank_3n(payload) -> dict:
    """One rank of [3n] (b)-(e), then of [3o] (part "o",
    :func:`train_rank_3o`), in its own process sharing the card over gloo
    (collectives staged through pinned host buffers): the two phases share
    the processes, so [3o] pays no process start or first step of its
    own."""
    import torch
    dev = torch.device(payload["device"])
    out, secs = {}, {}
    for part, fn in (("e", lambda: compressed_3n(torch, dev, payload)),
                     ("b", lambda: mesh_train_3n(torch, dev, payload, 2, 1)),
                     ("c", lambda: mesh_train_3n(torch, dev, payload, 1, 2)),
                     ("d", lambda: elastic_3n(torch, dev, payload)),
                     ("o", lambda: train_rank_3o(dev))):
        t0 = time.perf_counter()
        out[part] = fn()
        secs[part] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


RANK_FN_3N = train_rank_3n


def parallel_training(torch, dev) -> dict:
    """Phase 3n: data- and tensor-parallel training of gemma-7b at full
    width on DEPTH_3N layers ([3k] (a)'s batch, microbatches, remat and
    AdamW): (a) a (1,1) mesh over NCCL against the Trainer without a mesh,
    bit for bit; then two processes sharing the card over gloo: (b) (2,1)
    with ZeRO-1, (c) (1,2), each held to (a) by the DP rule; (d) a save at
    (2,1) restored onto (1,2) by ``ElasticController.rescale``; (e) the
    compressed data-parallel step on the 100m preset against the
    uncompressed one.  The same processes then run [3o]'s ranks, after its
    reckoning (:func:`reckon_all_3o`).  Returns ([3n]'s readings, each
    rank's [3o] results, [3o]'s reckoning)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.launch.mesh import make_ctx, make_mesh, spawn
    from repro_torch.models.config import ModelConfig
    from repro_torch.training import TrainConfig, Trainer
    t_all = time.perf_counter()
    full = get("gemma_7b")
    cfg = dataclasses.replace(full, n_layers=DEPTH_3N)
    dc = DataConfig(vocab=cfg.vocab, seq_len=SEQ_3K, batch=BATCH_3K,
                    seed=SEED)
    tc = TrainConfig(n_microbatches=MB_3K, remat=True, warmup=2,
                     total_steps=100)
    runs = {}
    mesh = make_mesh(1, 1, device=dev.type)
    check(mesh.backend == "nccl", f"[3n] (a) chose {mesh.backend}, not nccl")
    for name, pctx in (("none", None), ("(1,1)", make_ctx(mesh))):
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, tc, token_stream(dc, 0, device=dev), pctx=pctx,
                     device=dev)
        log = tr.run(STEPS_3N)
        runs[name] = dict(loss=[m["loss"] for m in log],
                          grad_norm=[m["grad_norm"] for m in log],
                          ms=statistics.median(m["time_s"] * 1e3
                                               for m in log[1:]),
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          opt_gb=opt_bytes(tr.opt_state) / 1e9,
                          master=tree_leaves(tr.opt_state["master"]))
        del tr, log
        free(torch)
    a, b = runs["none"], runs["(1,1)"]
    same = (a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
            and all(torch.equal(x, y) for x, y in zip(a["master"],
                                                       b["master"])))
    check(same, f"[3n] (a) the (1,1) mesh is not pctx=None bit for bit: "
          f"losses {a['loss']} vs {b['loss']}")
    n_params = sum(t.numel() for t in a["master"])
    print(f"  [3n] (a) {cfg.name} full width, {DEPTH_3N} of {full.n_layers} "
          f"layers, {n_params / 1e9:.3f} B parameters: the (1,1) mesh over "
          f"NCCL bit for bit pctx=None (losses {a['loss']}, grad norms, "
          f"masters); ms per step {b['ms']:.1f} vs {a['ms']:.1f}; peak "
          f"{b['peak_gb']:.2f} vs {a['peak_gb']:.2f} GB; optimizer state "
          f"{a['opt_gb']:.2f} GB")
    out = {"a": dict(loss=a["loss"], grad_norm=a["grad_norm"],
                     ms={"none": a["ms"], "(1,1)": b["ms"]},
                     peak_gb={"none": a["peak_gb"], "(1,1)": b["peak_gb"]},
                     opt_gb=a["opt_gb"], params=n_params, bitwise=same)}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        for i, t in enumerate(a["master"]):    # what each rank is held to
            np.save(os.path.join(tmp, f"{i}.npy"), t.cpu().numpy())
        del runs, a, b
        free(torch)
        p = PRESET_100M
        payload = dict(
            device=dev.type, cfg=cfg, tc=tc, dc=dc, masters=tmp,
            cfg1=dataclasses.replace(full, n_layers=RESTORE_DEPTH_3N),
            tc1=dataclasses.replace(tc, checkpoint_dir=os.path.join(
                tmp, "ckpt")),
            cfg_m=ModelConfig(name="ttq-lm-100m", family="dense",
                              n_layers=p["n_layers"], d_model=p["d_model"],
                              n_heads=p["n_heads"],
                              n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
                              vocab=p["vocab"]),
            dc_m=DataConfig(vocab=p["vocab"], seq_len=p["seq"],
                            batch=p["batch"], seed=11),
            tc_e=TrainConfig(n_microbatches=1, remat=True, warmup=1,
                             total_steps=100))
        reckoning = reckon_all_3o(torch)
        t0 = time.perf_counter()
        ranks = spawn(RANK_FN_3N, 2, payload, device=dev.type,
                      timeout=TIMEOUT_3N + TIMEOUT_3O)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    la = out["a"]["loss"]
    for part, mesh_name in (("b", "(2,1) ZeRO-1"), ("c", "(1,2)")):
        rs = [r[part] for r in ranks]
        for x in rs:
            check(x["backend"] == "gloo", f"[3n] ({part}) chose "
                  f"{x['backend']}, not gloo")
            check(x["loss"] == rs[0]["loss"], f"[3n] ({part}) the ranks' "
                  f"losses differ: {[y['loss'] for y in rs]}")
            check(bool(np.allclose(x["loss"], la, rtol=DP_RTOL_3N, atol=0)),
                  f"[3n] ({part}) losses {x['loss']} not within rtol "
                  f"{DP_RTOL_3N} of (a)'s {la}")
            check(x["master_ratio"] <= 1.0, f"[3n] ({part}) rank "
                  f"{x['rank']}: masters at {x['master_ratio']:.3f} of the "
                  f"DP tolerance of (a)'s")
        out[part] = dict(loss=rs[0]["loss"], grad_norm=rs[0]["grad_norm"],
                         ms=[x["ms"] for x in rs],
                         staged_ms=[sum(x["staged_ms"].values()) for x in rs],
                         staged_by_kind=rs[0]["staged_ms"],
                         cold_ms=[x["cold_ms"] for x in rs],
                         peak_gb=[x["peak_gb"] for x in rs],
                         opt_gb=[x["opt_gb"] for x in rs],
                         master_ratio=[x["master_ratio"] for x in rs])
        o = out[part]
        print(f"  [3n] ({part}) {mesh_name}, 2 processes on the card over "
              f"gloo: losses {o['loss']} against (a)'s {la} (rtol "
              f"{DP_RTOL_3N}); masters at most "
              f"{max(o['master_ratio']):.3f} of the DP tolerance; ms per "
              f"step {o['ms']} (staged collectives {o['staged_ms']} ms; "
              f"rank 0 by kind {o['staged_by_kind']}); "
              f"cold step {o['cold_ms']} ms; peak GB per rank "
              f"{o['peak_gb']} (a: {out['a']['peak_gb']['none']:.2f}); "
              f"optimizer GB per rank {o['opt_gb']} (a: "
              f"{out['a']['opt_gb']:.2f})")
    check(max(out["b"]["opt_gb"]) < 0.6 * out["a"]["opt_gb"],
          f"[3n] (b) ZeRO-1 holds {out['b']['opt_gb']} GB of optimizer "
          f"state per rank against (a)'s {out['a']['opt_gb']:.2f}")
    d = [r["d"] for r in ranks]
    check(all(x["exact"] for x in d), "[3n] (d) a restored leaf is not the "
          "live state's slice bit for bit")
    check(all(abs(x["loss_restored"] - x["loss_live"])
              <= DP_RTOL_3N * abs(x["loss_live"]) for x in d),
          f"[3n] (d) the restored step's loss {d[0]['loss_restored']} is not "
          f"within rtol {DP_RTOL_3N} of the live one's {d[0]['loss_live']}")
    out["d"] = d[0]
    print(f"  [3n] (d) {RESTORE_DEPTH_3N} layer(s): saved at (2,1) "
          f"({d[0]['checkpoint_gb']:.2f} GB on disk) in "
          f"{d[0]['save_s']:.1f} s, ElasticController.rescale onto (1,2) in "
          f"{max(x['restore_s'] for x in d):.1f} s; {d[0]['leaves']} leaves "
          f"bit for bit the live state (digests of every whole leaf from "
          f"either mesh equal); step 2 loss live "
          f"{d[0]['loss_live']!r} restored {d[0]['loss_restored']!r}; peak "
          f"GB per rank {[x['peak_gb'] for x in d]}")
    e = ranks[0]["e"]
    check(e["rel_l2"] < COMPRESSED_REL_3N, f"[3n] (e) the compressed step's "
          f"masters are {e['rel_l2']:.4f} (relative L2) from the "
          f"uncompressed step's")
    out["e"] = dict(e, ms=[r["e"]["ms"] for r in ranks])
    print(f"  [3n] (e) make_compressed_dp_step at (2,1) on the 100m preset, "
          f"{STEPS_3N_E} steps: masters {e['rel_l2']:.3g} (relative L2) from "
          f"the uncompressed step's (bound {COMPRESSED_REL_3N}); losses "
          f"{e['loss']}; ms per step {out['e']['ms']} (cold {e['cold_ms']:.0f}"
          f"); peak GB "
          f"{e['peak_gb']:.2f}")
    out["seconds"] = dict(ranks[0]["seconds"], spawn=spawn_s,
                          total=time.perf_counter() - t_all)
    print("  [3n] seconds per part ((o): [3o] in the same processes): "
          + ", ".join(f"({k}) {v:.1f}" for k, v in out["seconds"].items()))
    return out, [r["o"] for r in ranks], reckoning


def cfg_3o(arch, depth, impl):
    """Full-width ``arch`` at ``depth`` layers (an encoder-decoder's
    encoder too), under "a2a" at capacity factor CF_3M."""
    from repro_torch.configs import get
    cfg = dataclasses.replace(get(arch), n_layers=depth)
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=depth))
    if impl == "a2a":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF_3M))
    return cfg


def stream_3o(cfg, dev):
    """[3o]'s global batch on every rank (a (1,2) mesh has one data row),
    with frames for the encoder-decoder family."""
    from repro_torch.data import DataConfig, token_stream
    dc = DataConfig(vocab=cfg.vocab, seq_len=SEQ_3O, batch=BATCH_3O,
                    seed=SEED)
    fr = (cfg.encdec.n_frames, cfg.d_model) if cfg.encdec else None
    return token_stream(dc, 0, device=dev, frames=fr)


def reckon_3o(torch, cfg) -> dict:
    """Training bytes at world 1 (TRAIN_BYTES_PER_PARAM per parameter and
    4 × 4 B per f32 logit of a microbatch) against the card's memory less
    FIT_RESERVE_GB."""
    n = cfg.param_count()
    state = n * TRAIN_BYTES_PER_PARAM
    logits = 16 * BATCH_3O // MB_3O * SEQ_3O * cfg.vocab
    room = torch.cuda.get_device_properties(0).total_memory \
        - FIT_RESERVE_GB * 1e9
    return dict(params=n, state_gb=state / 1e9, logits_gb=logits / 1e9,
                room_gb=room / 1e9, fits=state + logits <= room)


def ref_3o(impl) -> str:
    """The (a) run a (b) run under ``impl`` is held to."""
    return "a2a" if impl == "a2a" else "none"


def world1_3o(torch, dev, cfg, pctx, keep: bool) -> tuple:
    """[3o] (a): the Trainer without a mesh (or on the (1,1) "a2a"
    context), STEPS_3O steps: (its readings, and with ``keep`` its whole
    masters on the host, leaf order, for (b)'s comparison)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.training import TrainConfig, Trainer
    tc = TrainConfig(n_microbatches=MB_3O, remat=True, warmup=2,
                     total_steps=100)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, stream_3o(cfg, dev), pctx=pctx, device=dev)
    log = tr.run(STEPS_3O)
    masters = ([t.cpu() for t in tree_leaves(tr.opt_state["master"])]
               if keep else None)
    out = dict(loss=[m["loss"] for m in log],
               grad_norm=[m["grad_norm"] for m in log],
               ms=[m["time_s"] * 1e3 for m in log],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               opt_gb=opt_bytes(tr.opt_state) / 1e9)
    del tr
    free(torch)
    return out, masters


def masters_3o(torch, tr, want):
    """The worst DP-rule ratio of each model rank's master slices against
    (a)'s whole masters ``want`` (rank 0's, on the host): rank 1 sends its
    slices to rank 0 leaf by leaf over the process group, rank 0 holds
    both against their slices of ``want``.  [ratio of rank 0, of rank 1]
    on rank 0, None on rank 1."""
    import torch.distributed as dist
    from repro_torch._tree import tree_leaves
    from repro_torch.parallel import NamedSharding
    pctx = tr.pctx
    leaves = tree_leaves(tr.opt_state["master"])
    specs = [sh.spec for sh in tree_leaves(tr.oshard["master"])]
    if pctx.rank != 0:
        for t in leaves:
            dist.send(t.detach().cpu().contiguous(), dst=0)
        return None
    other = dataclasses.replace(pctx, mesh=dataclasses.replace(pctx.mesh,
                                                               rank=1))
    worst = [0.0, 0.0]
    for t, spec, w in zip(leaves, specs, want):
        mine = w[NamedSharding(pctx, spec).index(w.shape)]
        worst[0] = max(worst[0], dp_rule(torch, mine.to(t.device), t))
        theirs = w[NamedSharding(other, spec).index(w.shape)]
        got = torch.empty(theirs.shape, dtype=t.dtype)
        dist.recv(got, src=1)
        worst[1] = max(worst[1], dp_rule(torch, theirs.to(t.device),
                                         got.to(t.device)))
    return worst


def mesh_train_3o(torch, dev, cfg, pctx, want) -> dict:
    """[3o] (b): the (1,2) mesh's Trainer, STEPS_3O steps; losses, ms per
    step and the staged collectives' ms per step by kind over the last
    step, the collectives per step by kind (of the all-reduces: the block
    entries' backward sums and the partial gradients' sums), peak GB,
    optimizer GB, and (rank 0) both ranks' worst DP-rule ratio of their
    masters against (a)'s ``want`` (:func:`masters_3o`)."""
    from repro_torch.parallel import comm
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.training.trainer import _MeshStep
    tc = TrainConfig(n_microbatches=MB_3O, remat=True, warmup=2,
                     total_steps=100)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, stream_3o(cfg, dev), pctx=pctx, device=dev)
    entries = [0]
    real = comm._Enter.backward

    def counted(ctx, g):
        entries[0] += 1
        return real(ctx, g)
    comm._Enter.backward = staticmethod(counted)
    try:
        tr.run(STEPS_3O - 1)
        s0, c0, e0 = dict(comm.STAGED_S), dict(comm.COUNTS), entries[0]
        tr.run(1)
    finally:
        comm._Enter.backward = staticmethod(real)
    log = tr.metrics_log
    partial = sum(_MeshStep(tr.pctx, tr.oshard["master"]).partial)
    out = dict(loss=[m["loss"] for m in log],
               grad_norm=[m["grad_norm"] for m in log],
               ms=[m["time_s"] * 1e3 for m in log],
               staged_ms={k: (comm.STAGED_S[k] - s0[k]) * 1e3 for k in s0
                          if comm.STAGED_S[k] > s0[k]},
               collectives={k: comm.COUNTS[k] - c0[k] for k in c0
                            if comm.COUNTS[k] > c0[k]},
               entries=entries[0] - e0, partial=partial,
               layout=str(tr.pctx.layout),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               opt_gb=opt_bytes(tr.opt_state) / 1e9,
               rank=tr.pctx.rank, backend=tr.pctx.mesh.backend)
    out["master_ratio"] = masters_3o(torch, tr, want)
    del tr
    free(torch)
    return out


def train_rank_3o(dev) -> dict:
    """[3o] on one of the two processes of [3n]: per family, rank 0 runs
    (a) while rank 1 waits, then both run (b) on the (1,2) mesh under each
    ``moe_impl``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_ctx, make_mesh
    solo = make_mesh(1, 1, device=dev.type)
    pair = make_ctx(make_mesh(1, 2, device=dev.type))
    out = {}
    for arch, depth, impls in FAMILIES_3O:
        t0 = time.perf_counter()
        fam, want = {"a": {}, "b": {}}, {}
        held = {ref_3o(i) for i in impls}       # what (b) is held to
        if pair.rank == 0:
            for ref in ("none", "a2a") if "a2a" in impls else ("none",):
                ctx = None if ref == "none" else make_ctx(solo,
                                                          moe_impl="a2a")
                fam["a"][ref], want[ref] = world1_3o(
                    torch, dev, cfg_3o(arch, depth, ref), ctx, ref in held)
        dist.barrier()
        for impl in impls:
            ctx = pair if impl is None else dataclasses.replace(
                pair, moe_impl=impl)
            fam["b"][impl] = mesh_train_3o(
                torch, dev, cfg_3o(arch, depth, impl), ctx,
                want.get(ref_3o(impl)))
        del want
        fam["seconds"] = time.perf_counter() - t0
        out[arch] = fam
    return out


def reckon_all_3o(torch) -> dict:
    """[3o]'s reckoning, printed before its first run: each family's
    training bytes at world 1 must fit the card (:func:`reckon_3o`)."""
    out = {}
    for arch, depth, _ in FAMILIES_3O:
        r = out[arch] = reckon_3o(torch, cfg_3o(arch, depth, None))
        print(f"  [3o] {arch} at {depth} layer(s): {r['params'] / 1e9:.3f} B "
              f"parameters, {r['state_gb']:.1f} GB of training state at "
              f"{TRAIN_BYTES_PER_PARAM} B per parameter + "
              f"{r['logits_gb']:.2f} GB of f32 logits per microbatch at "
              f"world 1, against {r['room_gb']:.1f} GB of the card less "
              f"{FIT_RESERVE_GB} GB")
        check(r["fits"], f"[3o] {arch} at {depth} layer(s) does not fit "
              f"the card at world 1")
    return out


def parallel_training_families(torch, ranks, reckoning) -> dict:
    """Phase 3o: tensor-parallel training of the five families beyond plain
    attention at full width (FAMILIES_3O), run by [3n]'s two processes
    sharing the card over gloo (``ranks``: each one's
    :func:`train_rank_3o`): (a) each family's world 1 without a mesh (and
    the MoE configs' (1,1) "a2a" context at CF_3M), (b) its (1,2) mesh
    under each ``moe_impl`` of FAMILIES_3O, the ranks' losses equal and
    within DP_RTOL_3N of (a)'s, every rank's masters within the DP rule of
    (a)'s."""
    out = {"reckoning": reckoning}
    secs = {}
    for arch, depth, impls in FAMILIES_3O:
        a = ranks[0][arch]["a"]
        for impl in impls:
            ref = ref_3o(impl)
            want = a[ref]["loss"]
            rs = [r[arch]["b"][impl] for r in ranks]
            what = f"[3o] (b) {arch}" + (f" {impl}" if impl else "")
            for x in rs:
                check(x["backend"] == "gloo", f"{what} chose {x['backend']}")
                check(x["loss"] == rs[0]["loss"], f"{what}: the ranks' "
                      f"losses differ: {[y['loss'] for y in rs]}")
                check(bool(np.allclose(x["loss"], want, rtol=DP_RTOL_3N,
                                       atol=0)),
                      f"{what}: losses {x['loss']} not within rtol "
                      f"{DP_RTOL_3N} of (a)'s {want}")
            x = rs[0]
            check(max(x["master_ratio"]) <= 1.0, f"{what}: masters at "
                  f"{x['master_ratio']} (rank 0, rank 1) of the DP "
                  f"tolerance of (a)'s")
            warm = x["ms"][-1]
            share = {k: round(v / warm, 3) for k, v in x["staged_ms"].items()}
            print(f"  [3o] (b) {arch} ({depth} layer(s))"
                  + (f", moe_impl {impl!r}" if impl else "")
                  + f", (1,2) over gloo, {x['layout']}: losses {x['loss']} "
                  f"against (a)'s {want} ({'the (1,1) a2a context' if ref == 'a2a' else 'no mesh'}; "
                  f"ms per step {[round(m, 1) for m in a[ref]['ms']]}); "
                  f"masters at most {max(x['master_ratio']):.3f} of the "
                  f"DP tolerance; ms per step {[round(m, 1) for m in x['ms']]}, "
                  f"the last one's staged collectives' share by kind {share}; "
                  f"collectives per step {x['collectives']} (all-reduces: "
                  f"{x['entries']} block entries' backward, {x['partial']} "
                  f"partial gradients); peak GB per rank "
                  f"{[round(y['peak_gb'], 2) for y in rs]} (a: "
                  f"{a[ref]['peak_gb']:.2f}); optimizer GB per rank "
                  f"{[round(y['opt_gb'], 2) for y in rs]} (a: "
                  f"{a[ref]['opt_gb']:.2f})")
        if "a2a" in a:
            check(bool(np.allclose(a["a2a"]["loss"], a["none"]["loss"],
                                   rtol=DP_RTOL_3N, atol=0)),
                  f"[3o] (a) {arch}: the (1,1) a2a context's losses "
                  f"{a['a2a']['loss']} not within rtol {DP_RTOL_3N} of no "
                  f"mesh's {a['none']['loss']}")
            print(f"  [3o] (a) {arch}: the (1,1) a2a context's losses "
                  f"{a['a2a']['loss']} beside no mesh's {a['none']['loss']} "
                  f"(ms per step {[round(m, 1) for m in a['a2a']['ms']]} vs "
                  f"{[round(m, 1) for m in a['none']['ms']]})")
        secs[arch] = ranks[0][arch]["seconds"]
        out[arch] = dict(a=a, b={str(k): [r[arch]["b"][k] for r in ranks]
                                 for k in impls})
    out["seconds"] = dict(secs, total=sum(secs.values()))
    print("  [3o] seconds per family (in [3n]'s processes): "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items()))
    return out

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--full-depth-3d", action="store_true",
                    help="run [3d] (the default policy, rank 16) at all 28 "
                         f"of gemma-7b's layers instead of {DEPTH_3D} "
                         "(about 3 minutes more of exact SVD)")
    args = ap.parse_args(argv)
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
    check(not any(n in spilled for n in MAIN_PATH_ATTN + FAMILY_ATTN),
          f"an attention instantiation of the main path or of [3g]'s "
          f"families spills: {spilled}")
    gemm_ptx = {n: v for n, v in ptx.items() if n.startswith("gemm_")}
    print("    gemm kernels (registers, spill stores, spill loads): "
          + "; ".join(f"{n} {v}" for n, v in sorted(gemm_ptx.items())))
    mma_ptx = {n: v for n, v in ptx.items()
               if n.startswith("experts_mma_kernel") and n.endswith(",0>")}
    print("    experts mma kernels (registers, spill stores, spill loads): "
          + "; ".join(f"{n} {v}" for n, v in sorted(mma_ptx.items())))
    check(len(mma_ptx) == 16 and MAIN_PATH_EXPERTS in mma_ptx
          and not any(n in spilled for n in mma_ptx),
          f"the ptxas log lists {len(mma_ptx)} experts mma kernels, not 16, "
          f"or misses the served one {MAIN_PATH_EXPERTS}, or one spills: "
          f"{spilled}")
    wide_ptx = {n: v for n, v in ptx.items() if n.startswith("wide_kernel")}
    print("    wide gemm kernels (registers, spill stores, spill loads): "
          + "; ".join(f"{n} {v}" for n, v in sorted(wide_ptx.items())))
    check(all(n in wide_ptx and n not in spilled for n in MAIN_PATH_WIDE),
          f"the ptxas log misses a wide gemm tile {MAIN_PATH_WIDE}, or one "
          f"spills: {spilled}")
    quant_ptx = {n: v for n, v in ptx.items() if n.startswith("quant_kernel")}
    print("    quantize kernels (registers, spill stores, spill loads): "
          + "; ".join(f"{n} {v}" for n, v in sorted(quant_ptx.items())))
    check(len(quant_ptx) == 16, f"the ptxas log lists {len(quant_ptx)} "
          f"quantize kernels, not 16")
    check(MAIN_PATH_QUANT in quant_ptx
          and not any(n in spilled for n in quant_ptx),
          f"the main path's quantize instantiation {MAIN_PATH_QUANT} is "
          f"missing, or a quantize instantiation spills: {spilled}")

    phase_s, mark = {"[1]": time.perf_counter() - t0}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now

    prompts = make_prompts()
    cur_main = [len(p) + MAX_NEW // 2 for p in prompts[:4]]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > L2

    print("[2] kernels against their plain versions (gemma-7b shapes)")
    rows = {
        "ttq_quantize": ("src/repro_torch/kernels/csrc/ttq_quantize.cu",
                         "src/repro/kernels/ttq_quantize.py:66",
                         kernel_quantize(torch, dev, flush)),
        "ttq_gemm": ("src/repro_torch/kernels/csrc/ttq_gemm.cu, "
                     "src/repro_torch/kernels/csrc/ttq_gemm_wide.cu",
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
    groups = kernel_attention_groups(torch, dev, flush, cur_main)
    from repro_torch.configs import get
    moe_depths = {"deepseek-v2-lite": get(MOE_3I[0]).n_layers,
                  "llama4-scout": fit_depth(torch, get(MOE_3I[1]))}
    experts_row, experts_by_cfg = kernel_gemm_experts(torch, dev, flush,
                                                      moe_depths)
    rows["ttq_gemm_experts"] = (
        "src/repro_torch/kernels/csrc/ttq_gemm_experts.cu",
        "src/repro/kernels/ttq_gemm.py:125", experts_row)
    print("    wkv_b: " + json.dumps(kernel_wkv_b(torch, dev, flush)))
    del flush
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("[2]")

    print("[3] main path: TTQEngine, gemma-7b full width, int4 g32 weights, "
          "int8 KV")
    cfg, params = init_gemma(torch, dev)
    res, outs = main_path(torch, dev, prompts, cfg, params)
    print("    main path: " + json.dumps(res))
    lap("[3]")
    gc.collect()                        # the dense engine goes before 3b's
    torch.cuda.empty_cache()

    print("[3b] paged main path: the same, with kv_paged=True (block 16, "
          "default pool)")
    paged = paged_path(torch, dev, prompts, cfg, params,
                       dict(outputs=outs, host_syncs=res["host_syncs"]))
    print("    paged main path: " + json.dumps(paged))
    lap("[3b]")
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[3c] prefix cache and preemption: NO_QUANT weights, int8 KV, "
          f"pool of {POOL_3C} blocks; gemma-7b full width, {DEPTH_3C} of "
          f"{cfg.n_layers} layers")
    pre = prefix_and_preemption(torch, dev, *cut(cfg, params, DEPTH_3C))
    print("    prefix cache and preemption: " + json.dumps(pre))
    lap("[3c]")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    depth_3d = cfg.n_layers if args.full_depth_3d else DEPTH_3D
    print(f"[3d] the reference's default policy: ttq_policy(bits=4, "
          f"group_size=32, rank={RANK_3D}, packed=True), int8 KV, "
          f"requant_threshold={THRESHOLD_3D}, double_buffer=True; gemma-7b "
          f"full width, {depth_3d} of {cfg.n_layers} layers (exact SVD at "
          f"~6 s per layer)")
    dflt, factors = default_policy(torch, dev, cfg, params, res, depth_3d)
    print("    default policy: " + json.dumps(dflt))
    lap("[3d]")
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[3e] self-speculative decoding, speculate_k={SPEC_W}: (a) the "
          f"default policy of [3d] (its first {DEPTH_3D} layers' factors) "
          f"with its int4 rank-0 draft, {DEPTH_3D} "
          f"layers; (b) bf16 weights, int8 KV, an int4 g32 draft, "
          f"{DEPTH_3E_B} layers, dense and paged; (c) (b) on one layer")
    spec = speculation(torch, dev, cfg, params, factors)
    print("    speculation: " + json.dumps(spec))
    lap("[3e]")
    del factors
    free(torch)

    print(f"[3f] robustness and streaming: guards, faults, chunked prefill "
          f"(max_len {MAXLEN_3F}, chunks of {CHUNK_3F}, budget {BUDGET_3F}), "
          f"TTQServer and the CLI; gemma-7b full width, {DEPTH_3F} of "
          f"{cfg.n_layers} layers, [3]'s policy")
    rob = robustness(torch, dev, *cut(cfg, params, DEPTH_3F), prompts)
    print("    robustness: " + json.dumps(rob, default=str))
    lap("[3f]")
    free(torch)

    print(f"[3l] tensor-parallel serving: gemma-7b full width, "
          f"{TP_DEPTH_3L} of {cfg.n_layers} layers, [3]'s policy and traffic "
          f"on a tree from fixed statistics; (a) world 1 over NCCL with CUDA "
          f"graphs against pctx=None; (b) world {TP_WORLD_3L}: "
          f"{TP_WORLD_3L} processes sharing the card over gloo, eager "
          f"blocks")
    del params                          # (b)'s ranks draw the same seed
    free(torch)
    cfg, params = init_family(torch, dev, "gemma_7b", TP_DEPTH_3L)
    tp, held = tensor_parallel(torch, dev, cfg, params, prompts)
    del params                          # nothing of [3]-[3l] (a) is left
    tp = tensor_parallel_b(torch, tp, held)
    del held
    print("    tensor parallel: " + json.dumps(tp, default=str))
    lap("[3l]")
    free(torch)

    print(f"[3m] tensor- and expert-parallel serving of the five families "
          f"beyond plain attention, full width at reduced depth "
          f"({', '.join(f'{a} {d}' for a, d in FAMILIES_3M)} layers), [3]'s "
          f"policy on a tree from fixed statistics: (a) world 1 over NCCL "
          f"with CUDA graphs against pctx=None (MoE under dense; a2a graph "
          f"replays against its eager run); (b) world {TP_WORLD_3L}: "
          f"{TP_WORLD_3L} processes sharing the card over gloo, eager")
    tpf = tp_families(torch, dev)
    print("    tp families: " + json.dumps(tpf, default=str))
    lap("[3m]")
    free(torch)

    print(f"[3g] the other dense families at full width: "
          f"{', '.join(f'{a} {d}' for a, d in DEPTHS_3G.items())} layers, "
          f"[3]'s "
          f"policy with the default guards, dense slab and paged pool")
    fam = families(torch, dev)
    print("    families: " + json.dumps(fam, default=str))
    lap("[3g]")
    free(torch)

    print(f"[3h] the vlm and hybrid families: (c) prefill attention over "
          f"{LONG_ATTN_S} keys, chunked against full; (a) recurrentgemma-9b "
          f"full width, {HYBRID_DEPTH_3H} layers, dense slab, then a "
          f"{HYBRID_LONG}-token prompt past its window; (b) chameleon-34b "
          f"at {VLM_DEPTH_3H} layers, dense slab and paged pool; (d) (b) "
          f"with an untied head, dense slab; [3]'s policy, default guards")
    hyb = hybrid_and_vlm(torch, dev)
    print("    hybrid and vlm: " + json.dumps(hyb, default=str))
    lap("[3h]")
    free(torch)

    print(f"[3i] the MoE family: (a) deepseek-v2-lite (MLA, 64 experts "
          f"top-6) full width and depth, dense slab; (b) llama4-scout (16 "
          f"experts top-1, G = 5) full width at the depth the card holds, "
          f"dense slab and paged pool; [3]'s policy, default guards")
    moe = moe_family(torch, dev)
    print("    moe: " + json.dumps(moe, default=str))
    lap("[3i]")
    free(torch)

    d_m, d_w = (DEPTHS_3J[a] for a in FAMILIES_3J)
    print(f"[3j] the SSM and encoder-decoder families: (a) mamba2-1.3b "
          f"full width, {d_m} layers, dense slab, then a {SSM_LONG}-token "
          f"prompt across two SSD chunks; (b) whisper-medium full width, "
          f"{d_w} + {d_w} layers, dense slab, requests with frames from the "
          f"seed, then one "
          f"prompt on two frames through one prefill graph; [3]'s policy, "
          f"default guards")
    ssm = ssm_and_encdec(torch, dev)
    print("    ssm and encdec: " + json.dumps(ssm, default=str))
    lap("[3j]")
    free(torch)

    print(f"[3k] training: (a) gemma-7b full width at the depth the card "
          f"trains, batch {BATCH_3K} x {SEQ_3K} in {MB_3K} microbatches, "
          f"f32 masters, bf16 compute, AdamW, remat; a save/restore step on "
          f"{RESTORE_DEPTH_3K} layer(s); the train CLI; (b) the reference's "
          f"100m preset, {STEPS_3K_B} steps (at most {TRAIN_BUDGET_3K_B:.0f} "
          f"s), then its RTN / AWQ / TTQ perplexity report")
    trn = training(torch, dev)
    print("    training: " + json.dumps(trn, default=str))
    lap("[3k]")
    free(torch)

    print(f"[3n] data- and tensor-parallel training: gemma-7b full width, "
          f"{DEPTH_3N} layers, batch {BATCH_3K} x {SEQ_3K} in {MB_3K} "
          f"microbatches, remat, AdamW, {STEPS_3N} steps: (a) a (1,1) mesh "
          f"over NCCL against no mesh; then 2 processes sharing the card "
          f"over gloo: (b) (2,1) with ZeRO-1, (c) (1,2), (d) save at (2,1), "
          f"ElasticController.rescale onto (1,2) ({RESTORE_DEPTH_3N} layer), "
          f"(e) the compressed DP step on the 100m preset")
    print(f"[3o] tensor-parallel training of the five families beyond plain "
          f"attention: full width, "
          f"{', '.join(f'{a} {d}' for a, d, _ in FAMILIES_3O)} layers, batch "
          f"{BATCH_3O} x {SEQ_3O} in {MB_3O} microbatches, remat, AdamW, "
          f"{STEPS_3O} steps; [3n]'s 2 processes sharing the card over gloo "
          f"run it after [3n] (b)-(e): (a) world 1 (and the MoE configs' "
          f"(1,1) a2a context, cf {CF_3M:g}), (b) the (1,2) mesh (deepseek "
          f"under dense and a2a, llama4 under a2a)")
    ptr, o_ranks, reckoning = parallel_training(torch, dev)
    print("    parallel training: " + json.dumps(ptr, default=str))
    lap("[3n]")
    free(torch)
    ptf = parallel_training_families(torch, o_ranks, reckoning)
    print("    parallel training of the families: "
          + json.dumps(ptf, default=str))
    lap("[3o]")
    # [3o] ran inside [3n]'s spawn: its ranks' seconds are [3o]'s
    phase_s["[3n]"] -= ptf["seconds"]["total"]
    phase_s["[3o]"] += ptf["seconds"]["total"]

    print("[4] per kernel: ms per decode step (gemm, attention) or per "
          "requant (quantize); launches: the main path's ([3], paged from "
          "[3b]), the speculative path's ([3e]), the robustness and "
          "streaming path's ([3f] (a)-(g)), the families' ([3g], "
          "[3h], [3i], [3j]) and the tensor-parallel paths' ([3l] (a), "
          "[3m] (a)'s world-1 engines), counted per replay; "
          "ttq_gemm_experts per decode step at "
          "deepseek-v2-lite's 27 layers")
    kernels = []
    spec_cases = ("a", "b", "b paged", "c")
    for name, (src, replaces, m) in rows.items():
        main_n = (paged if name == "ttq_paged_decode_attention"
                  else res)["launches"][name]
        spec_n = sum(spec[k]["launches"][name] for k in spec_cases)
        rob_n = rob["launches"][name]
        fam_n = fam["launches"][name]
        hyb_n = hyb["launches"][name]
        moe_n = moe["launches"][name]
        ssm_n = ssm["launches"][name]
        tp_n = tp["a"]["launches"].get(name, 0)
        tpf_n = tpf["launches"].get(name, 0)
        check(tpf_n > 0 or name == "ttq_paged_decode_attention",
              f"{name} never launched in [3m] (a)")
        if name != "ttq_gemm_experts":
            check(fam_n > 0, f"{name} never launched in [3g]")
            check(hyb_n > 0, f"{name} never launched in [3h]")
        check(moe_n > 0, f"{name} never launched in [3i]")
        if name in ("ttq_gemm", "ttq_quantize", "ttq_decode_attention"):
            check(ssm_n > 0, f"{name} never launched in [3j]")
        print(f"  {name} launches: main path {main_n}, speculative path "
              f"{spec_n} ([3e] cold runs "
              + ", ".join(f"({k}) {spec[k]['launches'][name]}"
                          for k in spec_cases) + f"), robustness and "
              f"streaming path {rob_n}, families {fam_n} ([3g]), "
              f"{hyb_n} ([3h]), {moe_n} ([3i]), {ssm_n} ([3j]) and "
              f"tensor-parallel {tp_n} ([3l] (a), world 1) + {tpf_n} ([3m] "
              f"(a), world 1)")
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            launches=main_n + spec_n + rob_n + fam_n + hyb_n
                            + moe_n + ssm_n + tp_n + tpf_n, **m))
    for cfg_name, t in experts_by_cfg.items():
        print(f"  ttq_gemm_experts per decode step at {cfg_name} "
              f"({moe_depths[cfg_name]} layers): {t['ms']:.3f} ms (the "
              f"batched tile's {t['batched_ms']:.3f}), bound "
              f"{t['bound_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"torch.bmm {t['library_ms']:.3f} ms")
    for (name, G, bits), (t_k, t_p, b_b, b_o, t_l) in groups.items():
        print(f"  {name} at G = {G} int{bits}: {t_k:.4f} ms, bound "
              f"{max(b_b, b_o):.4f} ms ({'operations' if b_o > b_b else 'bytes'}"
              f"; bytes {b_b:.4f}, operations {b_o:.4f}), plain {t_p:.4f} ms, "
              f"scaled_dot_product_attention {t_l:.4f} ms")
    lap("[4]")
    print(f"[5] seconds per phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; the whole script {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
