"""What a staged collective costs on the card's host: the copies between
the card and pinned or pageable host memory, and gloo's all-reduce,
all-gather and reduce-scatter between two processes sharing the card.

    python3 tools/stage_probe.py [--gb 1]

Two ranks (``launch/mesh.py:spawn``), each with a ``--gb`` GB f32 tensor
on the card: three rounds each of a fresh pinned buffer, a fresh
pageable one and a reused pinned one (seconds to copy in, then out),
then three rounds of each gloo collective on a pinned buffer.  Prints
the card's name and power limit, then each rank's seconds.  These are
the costs behind ``parallel/comm.py``'s staged collectives ([3l], [3m],
[3n] of ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rank(nbytes: int) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh(1, 2, device="cuda")
    n = nbytes // 4
    t = torch.randn(n, device="cuda")
    out = {}
    torch.cuda.synchronize()
    reused = torch.empty(n, pin_memory=True)
    for name in ("pinned", "pageable", "reused"):
        rounds = []
        for _ in range(3):
            t0 = time.perf_counter()
            h = {"pinned": lambda: torch.empty(n, pin_memory=True),
                 "pageable": lambda: torch.empty(n),
                 "reused": lambda: reused}[name]()
            h.copy_(t)
            t1 = time.perf_counter()
            back = h.to("cuda")
            torch.cuda.synchronize()
            rounds.append((t1 - t0, time.perf_counter() - t1))
            del back
        out[name] = rounds
    h = reused
    h.copy_(t)
    parts = list(torch.empty(2 * n, pin_memory=True).chunk(2))
    half = torch.empty(n // 2, pin_memory=True)
    for name, op in (
            ("all_reduce", lambda: dist.all_reduce(h, group=m.group)),
            ("all_gather", lambda: dist.all_gather(parts, h, group=m.group)),
            ("reduce_scatter", lambda: dist.reduce_scatter_tensor(
                half, h, group=m.group))):
        dist.barrier(group=m.group)
        rounds = []
        for _ in range(3):
            t0 = time.perf_counter()
            op()
            rounds.append(time.perf_counter() - t0)
        out[name] = rounds
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gb", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("stage_probe: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for r, res in enumerate(spawn(rank, 2, int(args.gb * (1 << 30)),
                                  device="cuda")):
        print(f"rank {r}: " + "; ".join(
            f"{k} " + ", ".join(
                f"{x[0]:.3f}+{x[1]:.3f}" if isinstance(x, tuple)
                else f"{x:.3f}" for x in v) for k, v in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
