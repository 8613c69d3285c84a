"""Serving launcher — TTQEngine over a seeded synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_7b \\
        --smoke --device cpu --requests 8 --bits 4 --rank 16

Runs on the card unless ``--device cpu``.  The flags and summary lines are
the reference launcher's (``repro.launch.serve``):

* policy: ``--bits``, ``--group-size``, ``--rank``, ``--no-quant``, mixed
  precision through ``--attn-bits``/``--mlp-bits`` overrides, ``--packed``;
  ``--use-kernels`` packs the codes and runs every decode matmul through
  ``ttq_gemm``;
* KV cache: ``--kv-dtype bf16|int8|int4``, ``--kv-group-size``,
  ``--kv-no-pallas`` (plain read), ``--kv-paged`` with ``--kv-block-size``,
  ``--kv-pool-blocks`` and ``--no-prefix-cache``;
* cadence: ``--decode-chunk K`` (0 = auto), ``--recal-every``,
  ``--recal-tokens``, ``--requant-threshold`` (the delta gate),
  ``--double-buffer``; ``--speculate-k W`` with ``--draft-bits``;
* robustness: ``--deadline-s``, ``--inject <recipe>``
  (:func:`~repro_torch.serving.faults.demo_injector`), ``--no-guards``;
* streaming: ``--prefill-chunk``, ``--prefill-budget``, ``--max-queue``.

``--arch`` takes the ported configs (``configs.ARCH_IDS``); ``--mesh N > 1``
(tensor-parallel serving) is refused.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.serving.faults import RECIPES

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=32)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--decode-chunk", type=int, default=0,
                    help="K fused decode steps per host sync (0 = auto per "
                         "slot count)")
    ap.add_argument("--recal-tokens", type=int, default=0,
                    help="requantize every N processed tokens instead of "
                         "every --recal-every admissions (0 = off)")
    ap.add_argument("--recal-every", type=int, default=1,
                    help="requantize after every N admissions")
    ap.add_argument("--use-kernels", action="store_true",
                    help="packed int weights, ttq_gemm on every decode "
                         "matmul")
    ap.add_argument("--packed", action="store_true",
                    help="pack weight codes (implied by --use-kernels)")
    ap.add_argument("--requant-threshold", type=float, default=-1.0,
                    help="delta gate: requantize only families whose "
                         "activation diagonal drifted >= T (relative L2; "
                         "<0 = everything)")
    ap.add_argument("--double-buffer", action="store_true",
                    help="requant into the tree decode is not reading, "
                         "swap when ready (tokens depend on device timing)")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--attn-bits", type=int, default=0,
                    help="bits for attention projections (0 = base)")
    ap.add_argument("--mlp-bits", type=int, default=0,
                    help="bits for MLP projections (0 = base)")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "int8", "int4"),
                    help="KV-cache storage dtype (int4 packed 8 per int32)")
    ap.add_argument("--kv-group-size", type=int, default=0,
                    help="KV scale group along the head dim (0 = per "
                         "head-token)")
    ap.add_argument("--kv-no-pallas", action="store_true",
                    help="plain PyTorch read of a quantized KV cache")
    ap.add_argument("--kv-paged", action="store_true",
                    help="block-paged KV pool, prefix cache, preemption")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per paged pool block")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="pool blocks per layer incl. the sink (0 = as "
                         "many as the dense slab holds)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="no shared prompt-prefix blocks")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="self-speculative decoding: W drafted tokens per "
                         "window (0 = off; greedy only)")
    ap.add_argument("--draft-bits", type=int, default=0,
                    help="draft-tree bits (rank 0, g32); 0 = the policy's "
                         "int4 draft variant")
    ap.add_argument("--mesh", type=int, default=1,
                    help="model-parallel mesh size; only 1 is ported")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline in seconds; an expired "
                         "request fails with error='deadline' (0 = none)")
    ap.add_argument("--inject", default="", choices=("", *sorted(RECIPES)),
                    help="a named fault-injection recipe; the summary says "
                         "what fired and what the guards caught")
    ap.add_argument("--no-guards", action="store_true",
                    help="the unguarded engine: no calibration guard, "
                         "health gate, lane fault isolation or ladder")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="ingest prompt tails longer than C tokens in "
                         "C-token chunks between decode blocks (0 = whole; "
                         "a paged pool needs C to divide by its block size)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="padded prefill tokens per engine round (0 = one "
                         "chunk)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="submit() raises QueueFull at this queue depth "
                         "(0 = unbounded)")
    return ap


def build_policy(args):
    """The flags' QuantPolicy, mixed precision as overrides."""
    from repro_torch.quant import (KVCacheConfig, KernelConfig, NO_QUANT,
                                   override, ttq_policy)

    kvcache = KVCacheConfig(dtype=args.kv_dtype,
                            group_size=args.kv_group_size,
                            use_pallas=not args.kv_no_pallas)
    kernel = KernelConfig(use_pallas=args.use_kernels)
    if args.no_quant:
        return NO_QUANT.with_(kvcache=kvcache, kernel=kernel)
    policy = ttq_policy(bits=args.bits, group_size=args.group_size,
                        rank=args.rank, kvcache=kvcache, kernel=kernel,
                        packed=args.use_kernels or args.packed)
    ovr = []
    if args.attn_bits:
        ovr.append(override("*.mix.*", bits=args.attn_bits))
    if args.mlp_bits:
        ovr.append(override("*.mlp.*", bits=args.mlp_bits))
    return policy.with_overrides(*ovr) if ovr else policy


def engine_config(args):
    from repro_torch.serving import EngineConfig
    return EngineConfig(max_slots=args.slots, max_len=args.max_len,
                        decode_chunk=args.decode_chunk,
                        recalibrate_every=args.recal_every,
                        recalibrate_tokens=args.recal_tokens,
                        requant_threshold=args.requant_threshold,
                        double_buffer=args.double_buffer,
                        kv_paged=args.kv_paged or None,
                        kv_block_size=args.kv_block_size
                        if args.kv_paged else 0,
                        kv_pool_blocks=args.kv_pool_blocks,
                        prefix_cache=not args.no_prefix_cache,
                        speculate_k=args.speculate_k,
                        guards=not args.no_guards,
                        deadline_s=args.deadline_s,
                        prefill_chunk=args.prefill_chunk,
                        prefill_budget=args.prefill_budget,
                        max_queue=args.max_queue)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: tensor-parallel serving (ROADMAP A10) is "
            f"not ported yet; run with --mesh 1")

    import numpy as np
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.serving import TTQEngine, demo_injector

    dev = resolve_device(args.device)
    cfg = get(args.arch, smoke=args.smoke)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    policy = build_policy(args)
    faults = demo_injector(args.inject) if args.inject else None
    draft_policy = None
    if args.speculate_k > 0 and args.draft_bits > 0:
        from repro_torch.quant import ttq_policy
        draft_policy = ttq_policy(bits=args.draft_bits, group_size=32,
                                  rank=0, kvcache=policy.kvcache,
                                  kernel=policy.kernel,
                                  packed=args.use_kernels or args.packed)
    eng = TTQEngine(cfg, params, policy, engine_config(args), device=dev,
                    draft_policy=draft_policy, faults=faults)
    layout = (f"paged block={eng.kvcfg.block_size} "
              f"pool={eng.num_blocks} blocks/layer "
              f"prefix_cache={not args.no_prefix_cache}"
              if eng.kvcfg.paged else "dense slab")
    print(f"kv-cache: dtype={eng.kvcfg.dtype} "
          f"group_size={eng.kvcfg.group_size or 'per-head-token'} "
          f"pallas={eng.kvcfg.use_pallas} layout={layout}")
    gate = (f"delta-gate >= {args.requant_threshold}"
            if args.requant_threshold >= 0 else "always-full")
    print(f"weight kernels: pallas={eng.kncfg.use_pallas} "
          f"packed={policy.packed}, requant: {gate}")
    cadence = (f"every {args.recal_tokens} tokens" if args.recal_tokens
               else f"every {args.recal_every} admissions")
    unit = "windows" if eng.ecfg.speculate_k > 0 else "tokens"
    print(f"decode-chunk: {eng.ecfg.decode_chunk} {unit}/dispatch, "
          f"requant cadence: {cadence}")
    if eng.ecfg.speculate_k > 0:
        dp = eng.draft_policy
        dd = (f"int{dp.qcfg.bits} g{dp.qcfg.group_size}"
              if dp is not None and dp.any_enabled else "fp (no-quant)")
        print(f"speculate: W={eng.ecfg.speculate_k} drafted tokens/window, "
              f"draft tree {dd}")
    dl = f"{args.deadline_s:.1f}s" if args.deadline_s > 0 else "none"
    print(f"guards: {'off' if args.no_guards else 'on'} deadline={dl} "
          f"inject={args.inject or 'none'}")
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(4, min(24, args.max_len // 2)))
        prompt = [int(t) for t in rng.integers(1, cfg.vocab, size=plen)]
        eng.submit(prompt, max_new=args.max_new)
    outs = eng.run_all()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = sum(len(v) for v in outs.values())
    skipped = eng.layers_skipped
    total_layers = eng.layers_skipped + eng.layers_requantized
    print(f"arch={cfg.name} requests={len(outs)} tokens={toks} "
          f"wall={dt:.1f}s requants={eng.n_requants} "
          f"host_syncs/token={eng.host_syncs / max(toks, 1):.2f} "
          f"requant_wall={eng.requant_wall_s:.2f}s "
          f"gate_skipped_layers={skipped}/{total_layers}")
    lat = eng.latency_percentiles()
    print(f"latency: ttft p50/p99 {lat['ttft_p50'] * 1e3:.1f}/"
          f"{lat['ttft_p99'] * 1e3:.1f} ms, itl p50/p99 "
          f"{lat['itl_p50'] * 1e3:.1f}/{lat['itl_p99'] * 1e3:.1f} ms "
          f"({lat['n_streams']} streams)")
    if eng.ecfg.prefill_chunk > 0 or eng.ecfg.max_queue > 0:
        print(f"slo: prefill_chunks={eng.prefill_chunks} "
              f"queue_rejections={eng.queue_rejections} "
              f"queue_depth={eng.queue_depth}")
    if eng.ecfg.speculate_k > 0:
        print(f"speculate: windows={eng.spec_windows} "
              f"acceptance={eng.spec_acceptance_rate:.2f} "
              f"(accepted drafts / drafted tokens)")
    if eng.kvcfg.paged:
        print(f"kv-pool: util_peak={eng.kv_pool_utilization:.2f} "
              f"prefix_hit_rate={eng.prefix_hit_rate:.2f} "
              f"preemptions={eng.preemptions} "
              f"prefill_tokens={eng.prefill_tokens:.0f}")
    if not args.no_guards:
        print(f"guards: calib_rejections={eng.calib_rejections} "
              f"requant_rejections={eng.requant_rejections} "
              f"lane_faults={eng.lane_faults} "
              f"deadline_expirations={eng.deadline_expirations} "
              f"admission_failures={eng.admission_failures} "
              f"degrade_events={eng.degrade_events}")
    if faults is not None:
        fired = ", ".join(f"{s}@{n}" for s, n, _ in faults.fired) or "none"
        print(f"faults fired: {fired}")
        failed = [r for r, v in sorted(outs.items()) if v.error]
        if failed:
            print(f"  failed rids: {failed}")
    for rid, v in sorted(outs.items())[:4]:
        print(f"  rid={rid}: {v[:10]}{'…' if len(v) > 10 else ''}")
    return eng, outs


if __name__ == "__main__":
    main()
