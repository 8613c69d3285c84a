"""Where a decode step's time goes in the PyTorch/CUDA port, on one card.

    python3 tools/port_profile.py

Builds the engine of ``chip_smoke.py``'s main path (full-width gemma-7b,
random weights, int4 g32 packed weights, int8 KV, 4 slots x 256) with that
script's own setup, admits its first 4 prompts, runs one warm decode block,
then traces one more under ``torch.profiler``; then the same on the paged
main path (``kv_paged=True``, block 16, default pool), with the same
weights.  Prints for each the block's wall time, the summed device time of
the device-side rows (kernels and copies, never the host ops that launched
them), so the device's busy and idle shares, the device launches per
decode step, and the rows that take the most device time with their mean
time per call.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def profile_block(torch, eng, prompts, what):
    """Trace one warm decode block of ``eng`` over 4 admitted prompts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MAX_NEW

    for p in prompts[:4]:
        eng.submit(p, max_new=MAX_NEW)
    eng.admit()
    K = eng.runner.K
    eng.runner.decode_block(eng.decode_params)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.runner.decode_block(eng.decode_params)
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.runner.decode_block(eng.decode_params)
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    # device rows only: an aten:: row's self device time repeats that of
    # the kernels it launched, which have rows of their own
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and getattr(e, "self_device_time_total", 0.0) > 0),
                  key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    print(f"{what}: decode block K={K}, 4 slots: wall "
          f"{wall_plain * 1e3:.2f} ms untraced, {wall_traced * 1e3:.2f} ms "
          f"traced ({wall_plain * 1e3 / K:.2f} ms per step untraced)")
    if not dev_us:
        print("profiler: no device time recorded — device busy share not "
              "measured")
        return
    busy = dev_us / 1e6 / wall_traced
    print(f"{what}: device time {dev_us / 1e3:.2f} ms in the traced block: "
          f"busy {busy:.1%}, idle {1 - busy:.1%}; {n_kern} device launches, "
          f"{n_kern / K:.0f} per step")
    print(f"{what}: top device rows (ms in the block, calls, us per call):")
    for e in kern[:12]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d}  "
              f"{e.self_device_time_total / e.count:8.2f} us  {e.key[:80]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import BLOCK, build_engine, card_line, init_gemma, make_prompts

    dev = torch.device("cuda")
    print(f"card: {card_line()}")
    cfg, params = init_gemma(torch, dev)
    prompts = make_prompts()
    for what, kw in (("dense", {}),
                     ("paged", dict(kv_paged=True, kv_block_size=BLOCK))):
        _, _, eng = build_engine(torch, dev, cfg, params, **kw)
        profile_block(torch, eng, prompts, what)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
