"""Time the decode-attention kernels of several checkouts of this repo on one
card, in turns.

    python3 tools/attn_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (this one, or an older commit unpacked
with ``git archive``).  In the order given, a subprocess imports that
tree's ``repro_torch``, builds its kernels and times its
``ttq_decode_attention`` and ``ttq_paged_decode_attention`` wrappers (the
split, if the tree has one, as its own rule picks it) on the cases of this
tree's ``chip_smoke.py`` phase 2 (``attn_case``): gemma-7b's main path
(capacity 256, cur_pos MAIN_CUR) and its own context (S = 8192, cur_pos
``chip_smoke.LONG_CUR``), int8 and int4, with bf16 q.  Times are
``chip_smoke.time_ms`` medians (L2 flushed before each call); every
reading is held against the tree's plain version (1e-5, f32 q).  Give the
trees as A B B A to read a change against its parent.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_CUR = [73, 63, 57, 45]


def run_tree(tree: str):
    """In this process: time ``tree``'s attention wrappers; prints a line
    per reading and one JSON line."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                      # imports repro_torch lazily
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import ref
    from repro_torch.kernels.ttq_attn import (ttq_decode_attention,
                                              ttq_paged_decode_attention)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    out = {}
    for shape, seed, cap, cur in (("main", cs.SEED + 2, 256, MAIN_CUR),
                                  ("long", cs.SEED + 4, 8192, cs.LONG_CUR)):
        for bits, q, dense, pool, bt, pos in cs.attn_case(
                torch, dev, seed, cap // cs.BLOCK, cur):
            o_r = ref.kv_attn_ref(q, *dense, pos, bits=bits)
            for kind, fn in (
                    ("dense", lambda x: ttq_decode_attention(
                        x, *dense, pos, bits=bits)),
                    ("paged", lambda x: ttq_paged_decode_attention(
                        x, *pool, bt, pos, bits=bits))):
                torch.testing.assert_close(fn(q).float(), o_r, rtol=1e-5,
                                           atol=1e-5)
                qb = q.to(torch.bfloat16)
                t = cs.time_ms(torch, lambda: fn(qb), flush=flush)
                out[f"{shape} {kind} int{bits}"] = t * 1e3
                print(f"  {tree}: {shape} {kind} int{bits} {t * 1e3:.1f} us",
                      flush=True)
    print(json.dumps({"tree": tree, "us": out}))


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        run_tree(argv[2])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("attn_compare: needs a CUDA card", file=sys.stderr)
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
