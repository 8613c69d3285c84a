"""Training launcher — the Trainer over the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_7b \\
        --smoke --device cpu --steps 20 [--data-parallel 2 --model-parallel 2]

Runs on the card unless ``--device cpu``.  The flags and the printed
metric lines (the first three and the last three steps, then the
straggler count) are the reference launcher's (``repro.launch.train``).
``--data-parallel D --model-parallel M`` above one rank spawns D·M
processes (``launch/mesh.py:spawn``), each on ``make_ctx(make_mesh(D,
M))`` with the reference's ``moe_impl`` default, each data row drawing
its rows of the global batch; rank 0's lines are printed.  ``M > 1``
trains tensor-parallel, every family.  The encoder-decoder family's
batches carry the stub front end's frames, drawn from the stream's seed
(``data.token_stream(frames=)``).
"""
from __future__ import annotations

import argparse
import sys
import types


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


def _train(args, pctx=None):
    """The reference launcher's run on this process (its rank of ``pctx``):
    (the Trainer, the lines to print)."""
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.training import TrainConfig, Trainer

    cfg = get(args.arch, smoke=args.smoke)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                    seed=0)
    frames = (cfg.encdec.n_frames, cfg.d_model) if cfg.encdec else None
    tc = TrainConfig(n_microbatches=args.microbatches, remat=True, zero1=True,
                     total_steps=max(args.steps, 100),
                     warmup=max(5, args.steps // 10),
                     checkpoint_every=max(10, args.steps // 3),
                     checkpoint_dir=args.ckpt,
                     step_deadline_s=args.deadline_s)
    host, hosts = (0, 1) if pctx is None else (pctx.dp_rank, pctx.dp_world)
    dev = args.device if pctx is None else pctx.mesh.device
    tr = Trainer(cfg, tc, token_stream(dc, 0, host_id=host, n_hosts=hosts,
                                       device=dev, frames=frames),
                 pctx=pctx, device=dev)
    if args.resume:
        tr.restore_if_available()
    log = tr.run(args.steps)
    lines = [str({k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in m.items()}) for m in log[:3] + log[-3:]]
    if tr.skipped_steps:
        lines.append(f"straggler violations: {len(tr.skipped_steps)}")
    return tr, lines


def _rank(argv):
    """One rank of a ``--data-parallel``/``--model-parallel`` run: the
    Trainer's record (picklable) and the lines."""
    from repro_torch.launch.mesh import make_ctx, make_mesh
    args = build_parser().parse_args(argv)
    pctx = make_ctx(make_mesh(args.data_parallel, args.model_parallel))
    tr, lines = _train(args, pctx)
    return dict(step=tr.step, metrics_log=tr.metrics_log,
                skipped_steps=tr.skipped_steps, device=tr.device,
                lines=lines)


def main(argv=None):
    """Train; returns the Trainer (above one rank, rank 0's record: its
    ``step``, ``metrics_log``, ``skipped_steps``, ``device``)."""
    args = build_parser().parse_args(argv)
    from repro_torch._device import resolve_device

    dev = resolve_device(args.device)
    world = args.data_parallel * args.model_parallel
    if world > 1:
        from repro_torch.launch.mesh import spawn
        out = spawn(_rank, world, sys.argv[1:] if argv is None else argv,
                    device=dev.type)[0]
        for line in out.pop("lines"):
            print(line)
        return types.SimpleNamespace(**out)
    tr, lines = _train(args)
    for line in lines:
        print(line)
    return tr


if __name__ == "__main__":
    main()
