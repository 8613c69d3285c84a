"""Hold the speculative path's first disagreements to ``chip_smoke.py``'s
near-tie check at depths other than [3e]'s, on one card.

    python3 tools/near_tie_probe.py [--depth-a 4] [--depth-b 14]

(a) runs [3d]'s default policy (rank 16, gate, double buffer) on
gemma-7b's first ``--depth-a`` layers for its factors, then [3e] (a) on
those layers: the speculative and non-speculative engines on [3]'s
traffic.  (b) runs [3e] (b) (bf16 weights, int4 g32 draft, dense slab) on
the first ``--depth-b`` layers.  Each request's first disagreement goes
through ``chip_smoke.near_tie``: its margin, the largest gap between the
recomputed decode and verify logits at one copy of the request and at the
engine's four slots, and logit a − logit b in each of those four sets.  A
disagreement beyond the check is printed, not raised, and the next case
runs.  Prints the card's name and power limit and one JSON line of the
readings.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth-a", type=int, default=4)
    ap.add_argument("--depth-b", type=int, default=14)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("near_tie_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import (KernelConfig, KVCacheConfig, NO_QUANT,
                                  ttq_policy)
    from repro_torch.kernels import build
    build.lib()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    cfg, params = cs.init_gemma(torch, dev)
    prompts = cs.make_prompts()
    kern, kv8 = KernelConfig(use_pallas=True), KVCacheConfig(dtype="int8")
    out = {}

    def held(label, cfg_x, outs, tree_one):
        try:
            rows = cs.near_ties(torch, cfg_x, outs, prompts, label, tree_one)
            out[label] = dict(rows=rows, failed=None)
        except cs.CheckFailed as e:
            print(f"  {label}: {e}", flush=True)
            out[label] = dict(failed=str(e))

    _, factors = cs.default_policy(torch, dev, cfg, params,
                                   {"decode_ms_per_step": float("nan")},
                                   args.depth_a)
    cfg_a, params_a = cs.cut(cfg, params, args.depth_a)
    pol_a = ttq_policy(bits=4, group_size=32, rank=cs.RANK_3D, packed=True,
                       kvcache=kv8, kernel=kern)
    _, outs = cs.spec_case(torch, dev, cfg_a, params_a, pol_a,
                           f"(a) {args.depth_a} layers", prompts,
                           engine_kw=dict(lowrank=factors), tree_one=True,
                           requant_threshold=cs.THRESHOLD_3D,
                           double_buffer=True)
    held(f"(a) {args.depth_a} layers", cfg_a, outs, True)
    del outs, factors, params_a
    cs.free(torch)
    cfg_b, params_b = cs.cut(cfg, params, args.depth_b)
    draft = dict(draft_policy=ttq_policy(bits=4, group_size=32, rank=0,
                                         packed=True, kvcache=kv8,
                                         kernel=kern))
    _, outs = cs.spec_case(torch, dev, cfg_b, params_b,
                           NO_QUANT.with_(kvcache=kv8, kernel=kern),
                           f"(b) {args.depth_b} layers", prompts,
                           engine_kw=draft)
    held(f"(b) {args.depth_b} layers", cfg_b, outs, False)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
