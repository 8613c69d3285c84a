"""Time the ``ttq_quantize`` kernel of several checkouts of this repo on one
card, in turns.

    python3 tools/quant_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (this one, or an older commit unpacked
with ``git archive``).  In the order given, a subprocess imports that
tree's ``repro_torch``, builds its kernels and times its ``ttq_quantize``
wrapper (the grid, if the tree has a rule for one, as its own rule picks
it) on this tree's ``chip_smoke.py`` phase-2 shapes: gemma-7b's four weight
families as whole 28-layer bf16 stacks, int4 g32, one requant's launches.
Times are ``chip_smoke.time_ms`` medians.  Every reading is held against
the tree's plain version on the same inputs: codes within one step at ties
(on at most 2e-3 of them), S and Z within rtol 1e-5; the line says how many
codes differ and whether S and Z are bit for bit.  Give the trees as A B B
A to read a change against its parent.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: str):
    """In this process: time ``tree``'s quantize wrapper; prints a line per
    family and one JSON line."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                      # imports repro_torch lazily
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_quantize import ttq_quantize
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    out, total = {}, 0.0
    for name, (dp, d, per_layer) in cs.GEMM_SHAPES.items():
        W = torch.randn((28, dp, d), generator=gen, device=dev).to(torch.bfloat16)
        D = torch.exp(0.3 * torch.randn((28, d), generator=gen, device=dev))
        res, res_r = (f(W, D, bits=4, group_size=32)
                      for f in (ttq_quantize, ref.ttq_quantize_ref))
        off, sz, _ = cs.quant_mismatch(torch, res, res_r, d, 4)
        cs.check(off <= 2e-3 * W.numel(), f"{tree} {name}: {off} codes differ")
        for a, b in zip(res[1:], res_r[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        del res, res_r
        t = cs.time_ms(torch, lambda: ttq_quantize(W, D, bits=4, group_size=32),
                       iters=7)
        b = cs.quant_bound_ms(28, dp, d, 4)
        out[name] = t
        total += per_layer * t
        print(f"  {tree}: {name} (28,{dp},{d}) {t:.3f} ms, bound {b:.3f} ms "
              f"({b / t:.1%}); {off} codes differ from the plain version's, "
              f"S and Z bitwise: {sz}", flush=True)
        del W, D
        torch.cuda.empty_cache()
    print(f"  {tree}: per requant {total:.3f} ms", flush=True)
    print(json.dumps({"tree": tree, "ms": out, "per_requant_ms": total}))


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        run_tree(argv[2])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("quant_compare: needs a CUDA card", file=sys.stderr)
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
