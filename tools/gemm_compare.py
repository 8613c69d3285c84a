"""Time the 2-D ``ttq_gemm`` kernel of several checkouts of this repo on one
card, in turns.

    python3 tools/gemm_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (this one, or an older commit unpacked
with ``git archive``).  In the order given, a subprocess imports that
tree's ``repro_torch``, builds its kernels, prints the registers and spills
of its ``gemm_kernel`` instantiations at T <= 4 and int4 (the decode path's,
from the ptxas log), and times its ``ttq_gemm`` wrapper (its own split
rule) on this tree's ``chip_smoke.py`` phase-2 shapes: gemma-7b's four
decode GEMMs at int4 g32, T = 4 bf16 tokens, L2 flushed.  Times are
``chip_smoke.time_ms`` medians; each output is held to the tree's plain
version within one bf16 rounding.  Give the trees as A B B A to read a
change against its parent.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: str):
    """In this process: time ``tree``'s GEMM wrapper; prints a line per
    shape and one JSON line."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                      # imports repro_torch lazily
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.ttq_gemm import ttq_gemm
    build.lib()
    regs = {n: v for n, v in cs.ptxas_report(build.build_log).items()
            if n.startswith("gemm_kernel<") and n.split("<")[1][0] in "124"
            and n.split(",")[1] == "4"}
    print(f"  {tree}: " + "; ".join(f"{n} {v}" for n, v in
                                    sorted(regs.items())), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    out, total = {}, 0.0
    for name, (dp, d, per_layer) in cs.GEMM_SHAPES.items():
        W = torch.randn((dp, d), generator=gen, device=dev) * d ** -0.5
        D = torch.exp(0.3 * torch.randn((d,), generator=gen, device=dev))
        pk, S, Z = ref.ttq_quantize_ref(W, D, bits=4, group_size=32)
        xb = torch.randn((4, d), generator=gen, device=dev).to(torch.bfloat16)
        y = ttq_gemm(xb, pk, S, Z, 1.0 / D, bits=4, group_size=32)
        y_r = ref.ttq_gemm_ref(xb, pk, S, Z, bits=4, group_size=32,
                               dinv=1.0 / D)
        torch.testing.assert_close(y.float(), y_r, rtol=2 ** -7,
                                   atol=2e-4 * (d / 256) ** 0.5)
        t = cs.time_ms(torch, lambda: ttq_gemm(xb, pk, S, Z, 1.0 / D, bits=4,
                                               group_size=32), flush=flush)
        out[name] = t
        total += 28 * per_layer * t
        print(f"  {tree}: {name} ({dp}x{d}) T=4 int4 {t * 1e3:.1f} us",
              flush=True)
        del W, pk, S, Z
        torch.cuda.empty_cache()
    print(f"  {tree}: per decode step {total:.3f} ms", flush=True)
    print(json.dumps({"tree": tree, "us": {k: v * 1e3 for k, v in out.items()},
                      "per_step_ms": total, "registers": regs}))


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        run_tree(argv[2])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("gemm_compare: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line
    print(f"card: {card_line()}", flush=True)
    for tree in argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
