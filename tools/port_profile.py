"""Where a decode step's time goes in the PyTorch/CUDA port, on one card.

    python3 tools/port_profile.py [--arch deepseek_v2_lite_16b]

Builds the engine of ``chip_smoke.py``'s main path (full-width gemma-7b,
random weights, int4 g32 packed weights, int8 KV, 4 slots x 256) with that
script's own setup, admits its first 4 prompts and runs one decode block
(the warm block and the capture of the runner's CUDA graph).  Then, for
the eager loop (``lm.decode_many`` on a copy of the state) and for the
graph (``DeviceRunner.decode_block``, one replay): one block timed
untraced, and one more under ``torch.profiler``.  The same on the paged
main path (``kv_paged=True``, block 16, default pool), with the same
weights.  Prints for each block its wall time, the summed device time of
the device-side rows (kernels and copies, never the host ops that
launched them), so the device's busy and idle shares, the device launches
per decode step, the host-side launch calls per block, and the rows that
take the most device time with their mean time per call.

Then one admission group's prefill (the first group of those 4 prompts, its
graph captured at admission) the same way: the eager prefill body on a copy
of the state, and one replay of the group's prefill graph.

``--arch`` another config: the same at its full width and depth
(``chip_smoke.init_family``) with [3i]'s engine (the default guards), on
the dense slab only (deepseek-v2-lite's MLA has no paged pool).
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def profile_block(torch, cfg, eng, prompts, what):
    """Trace one eager and one graph decode block of ``eng`` over 4
    admitted prompts."""
    from chip_smoke import MAX_NEW, eager_block, snapshot, traced

    for p in prompts[:4]:
        eng.submit(p, max_new=MAX_NEW)
    eng.admit()
    r, params = eng.runner, eng.decode_params
    K = r.K
    r.decode_block(params)                      # warm block + capture
    blocks = {
        "eager": lambda snap: eager_block(torch, cfg, eng, params, snap),
        "graph": lambda snap: r.decode_block(params)}
    for kind, block in blocks.items():
        snap = snapshot(torch, r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block(snap)
        wall = time.perf_counter() - t0
        snap = snapshot(torch, r)
        t = traced(torch, lambda: block(snap), top=12)
        print(f"{what}, {kind}: decode block K={K}, 4 slots: wall "
              f"{wall * 1e3:.2f} ms untraced ({wall * 1e3 / K:.2f} ms per "
              f"step), {t['wall_ms']:.2f} ms traced")
        if not t["device_launches"]:
            print("profiler: no device time recorded — device busy share "
                  "not measured")
            continue
        print(f"{what}, {kind}: device time {t['device_ms']:.2f} ms in the "
              f"traced block: busy {t['busy']:.1%}, idle {1 - t['busy']:.1%}; "
              f"{t['device_launches']} device launches, "
              f"{t['device_launches'] / K:.0f} per step; host launch calls "
              f"per block {t['host_launches']} {t['host_apis']}")
        print(f"{what}, {kind}: top device rows (ms in the block, calls, us "
              f"per call):")
        for key, us, n in t["top"]:
            print(f"  {us / 1e3:8.3f} ms  {n:6d}  {us / n:8.2f} us  "
                  f"{key[:80]}")


def profile_prefill(torch, eng, params, group, what):
    """Trace one eager prefill of ``group`` (the runner's prefill body on a
    copy of the state) beside one replay of its prefill graph."""
    from chip_smoke import clone_tree, traced

    r = eng.runner
    host = r._prefill_inputs(group)
    inp = {k: torch.from_numpy(v).to(r.device) for k, v in host.items()}
    shape = (group.bucket, len(group.requests), group.prefix_len)
    runs = {
        "eager": lambda: r._prefill(params, clone_tree(torch, r.state), inp,
                                    group.prefix_len, None)[0].cpu(),
        "graph": lambda: r._prefill_graph(params, host, group)[0].cpu()}
    for kind, fn in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        t = traced(torch, fn, top=8)
        print(f"{what}, prefill {kind}, (bucket, group, prefix) {shape}: wall "
              f"{wall * 1e3:.2f} ms untraced, {t['wall_ms']:.2f} ms traced")
        if not t["device_launches"]:
            print("profiler: no device time recorded — device busy share "
                  "not measured")
            continue
        print(f"{what}, prefill {kind}: device time {t['device_ms']:.2f} ms: "
              f"busy {t['busy']:.1%}; {t['device_launches']} device launches; "
              f"host launch calls {t['host_launches']} {t['host_apis']}")
        for key, us, n in t["top"]:
            print(f"  {us / 1e3:8.3f} ms  {n:6d}  {us / n:8.2f} us  "
                  f"{key[:80]}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma_7b",
                    help="config to trace (default: the main path's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import (BLOCK, build_engine, card_line, init_family,
                            init_gemma, make_prompts)

    dev = torch.device("cuda")
    print(f"card: {card_line()}")
    if args.arch == "gemma_7b":
        cfg, params = init_gemma(torch, dev)
        variants = (("dense", {}),
                    ("paged", dict(kv_paged=True, kv_block_size=BLOCK)))
    else:
        cfg, params = init_family(torch, dev, args.arch)
        variants = ((f"{cfg.name} dense", dict(guards=True)),)
    prompts = make_prompts(cfg.vocab)
    for what, kw in variants:
        _, _, eng = build_engine(torch, dev, cfg, params, **kw)
        groups = []
        real = eng.runner.admit_group
        eng.runner.admit_group = lambda p, g: groups.append((p, g)) or real(
            p, g)
        profile_block(torch, cfg, eng, prompts, what)
        del eng.runner.admit_group
        profile_prefill(torch, eng, *groups[0], what)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
