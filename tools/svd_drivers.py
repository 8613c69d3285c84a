"""Accuracy and time of cuSOLVER's SVD methods at gemma-7b's weight shapes.

    python3 tools/svd_drivers.py

For one random matrix of each shape (bf16 weights, N(0, 1/d), from a seed)
and each of ``torch.linalg.svd``'s CUDA methods ``gesvd`` (QR iteration,
what ``core/lowrank.py:svd_top`` uses) and the default (Jacobi,
``gesvdj``): the synced time of the f32 SVD, the rank-16 residual
‖W − B·A‖_F relative to the Eckart-Young optimum √(Σ_{i>16} σ_i²), and the
largest relative error of the top 16 singular values, both against a
float64 SVD on the CPU.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
import time

SHAPES = {"wq/wk/wv": (4096, 3072), "wo": (3072, 4096),
          "wg/wu": (24576, 3072), "wd": (3072, 24576)}
RANK = 16


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("svd_drivers: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (m, n) in SHAPES.items():
        W = (torch.randn((m, n), generator=gen, device=dev) * n ** -0.5
             ).bfloat16().float()
        ref = torch.linalg.svdvals(W.double().cpu())
        opt = float(ref[RANK:].square().sum().sqrt())
        for method in ("gesvd", None):
            torch.linalg.svd(W[:64, :64], driver=method)       # warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            U, s, Vh = torch.linalg.svd(W, full_matrices=False, driver=method)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            sr = s[:RANK].sqrt()
            B, A = U[:, :RANK] * sr[None, :], sr[:, None] * Vh[:RANK]
            res = float((W.double() - B.double() @ A.double()).norm())
            sig = float(((s[:RANK].double().cpu() - ref[:RANK]).abs()
                         / ref[:RANK]).max())
            print(f"{name} {m}x{n} {method or 'default (gesvdj)'}: "
                  f"{dt:.3f} s; residual rel {abs(res - opt) / opt:.2e}; "
                  f"top-{RANK} singular values rel {sig:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
