"""Training launcher — the Trainer over the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_7b \\
        --smoke --device cpu --steps 20

Runs on the card unless ``--device cpu``.  The flags and the printed
metric lines (the first three and the last three steps) are the reference
launcher's (``repro.launch.train``).  ``--data-parallel`` or
``--model-parallel`` above 1 (a mesh) is refused: data- and
tensor-parallel training wait for ROADMAP A10 (d) (tensor-parallel
serving is ported: ``launch/serve.py --mesh N``).
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--deadline-s", type=float, default=0.0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.data_parallel * args.model_parallel > 1:
        raise NotImplementedError(
            f"--data-parallel {args.data_parallel} --model-parallel "
            f"{args.model_parallel}: data- and tensor-parallel training "
            f"(ROADMAP A10 (d)) is not ported yet; run with both at 1")

    from repro_torch._device import resolve_device
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.training import TrainConfig, Trainer

    dev = resolve_device(args.device)
    cfg = get(args.arch, smoke=args.smoke)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                    seed=0)
    tc = TrainConfig(n_microbatches=args.microbatches, remat=True, zero1=True,
                     total_steps=max(args.steps, 100),
                     warmup=max(5, args.steps // 10),
                     checkpoint_every=max(10, args.steps // 3),
                     checkpoint_dir=args.ckpt,
                     step_deadline_s=args.deadline_s)
    tr = Trainer(cfg, tc, token_stream(dc, 0, device=dev), device=dev)
    if args.resume:
        tr.restore_if_available()
    log = tr.run(args.steps)
    for m in log[:3] + log[-3:]:
        print({k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in m.items()})
    if tr.skipped_steps:
        print(f"straggler violations: {len(tr.skipped_steps)}")
    return tr


if __name__ == "__main__":
    main()
