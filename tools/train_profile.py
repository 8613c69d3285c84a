"""Where a training step's time goes in the PyTorch/CUDA port, on one card.

    python3 tools/train_profile.py

Builds the two trainers of ``chip_smoke.py`` phase [3k] with that script's
own settings: (a) gemma-7b at full width and ``train_fit_depth`` layers,
batch 8 x 512 in two microbatches; (b) the reference example's 100m
preset, batch 32 x 1024 in two microbatches.  For each: two warm steps,
one step timed untraced, then one more under ``torch.profiler``: its wall,
the device's busy share, device launches, and the rows that take the most
device time.  Also times the host's draw of one batch from
``token_stream``.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def profile_trainer(torch, dev, cfg, dc, tc, what):
    from chip_smoke import free, traced
    from repro_torch.data import token_stream
    from repro_torch.training import Trainer
    stream = token_stream(dc, 0, device=dev)
    t0 = time.perf_counter()
    next(stream)
    draw = time.perf_counter() - t0
    tr = Trainer(cfg, tc, stream, device=dev)
    tr.run(2)
    batch = tr._next_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.opt_state, m = tr.step_fn(tr.opt_state, batch)
    float(m["loss"])
    wall = time.perf_counter() - t0

    def step():
        tr.opt_state, mm = tr.step_fn(tr.opt_state, batch)
        float(mm["loss"])
    t = traced(torch, step, top=15)
    print(f"{what}: {cfg.n_layers} layers, batch {dc.batch} x {dc.seq_len}, "
          f"{tc.n_microbatches} microbatches: step {wall * 1e3:.1f} ms "
          f"untraced, {t['wall_ms']:.1f} ms traced, device busy "
          f"{t['busy'] * 100:.1f}%, {t['device_launches']} device launches; "
          f"host draw of one batch {draw * 1e3:.1f} ms")
    for name, us, calls in t["top"]:
        print(f"    {us / 1e3:9.2f} ms  {calls:6d} x  {name[:110]}")
    del tr
    free(torch)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.data import DataConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.training import TrainConfig
    dev = torch.device("cuda")
    print(cs.card_line())
    full = get("gemma_7b")
    depth = min(full.n_layers, cs.train_fit_depth(
        torch, full, cs.BATCH_3K * cs.SEQ_3K // cs.MB_3K))
    tc = TrainConfig(n_microbatches=cs.MB_3K, remat=True, warmup=2,
                     total_steps=100)
    profile_trainer(torch, dev, dataclasses.replace(full, n_layers=depth),
                    DataConfig(vocab=full.vocab, seq_len=cs.SEQ_3K,
                               batch=cs.BATCH_3K, seed=cs.SEED), tc,
                    "(a) gemma-7b")
    p = cs.PRESET_100M
    cfg = ModelConfig(name="ttq-lm-100m", family="dense",
                      n_layers=p["n_layers"], d_model=p["d_model"],
                      n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                      d_ff=p["d_ff"], vocab=p["vocab"])
    profile_trainer(torch, dev, cfg,
                    DataConfig(vocab=p["vocab"], seq_len=p["seq"],
                               batch=p["batch"], seed=11),
                    TrainConfig(n_microbatches=2, remat=True,
                                total_steps=cs.STEPS_3K_B, warmup=30),
                    "(b) 100m preset")
    return 0


if __name__ == "__main__":
    sys.exit(main())
