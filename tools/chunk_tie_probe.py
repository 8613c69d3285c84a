"""Read the engines' own logits at each first disagreement of
``chip_smoke.py`` [3f] (f), chunked prefill against unchunked, on one card.

    python3 tools/chunk_tie_probe.py [--depth 8]

Runs [3f] (f)'s traffic on gemma-7b's first ``--depth`` layers, on the
dense slab and the paged pool: each of the unchunked and the chunked
engine (``prefill_chunk`` CHUNK_3F) first as [3f] runs it (CUDA graphs),
then again with its runner eager and every decode step's logits
recorded per request and token; the eager tokens must equal the graph
run's (a replay is bit for bit its eager block), so the recorded rows are
the engines' own.  At each request's first disagreement (token t ≥ 1,
tokens a and b) it prints the unchunked engine's logit a − logit b, the
chunked engine's logit b − logit a, the largest |Δlogit| between the two
rows (δ_own), and [3f]'s recomputed margin and δ
(``chip_smoke.chunk_near_tie``).  Two rows at most δ_own apart can order
a and b apart only within 2·δ_own; a margin past it would put the fault
in the chunked path.  A first disagreement at token 0 (the prefill's
sample) is printed with the recompute only.  Prints the card's name and
power limit and one JSON line of the readings.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def recorded_run(torch, cs, lm, dev, cfg, params, chunk, kw, shorts, longs):
    """One engine of [3f] (f), eager, with every decode step's logits kept
    on the card: (tokens per request, {(request index, token index):
    logits row})."""
    eng = cs.guarded(torch, dev, cfg, params, max_slots=cs.SLOTS_3F,
                     max_len=cs.MAXLEN_3F, recalibrate_every=cs.NEVER,
                     prefill_chunk=chunk,
                     prefill_budget=cs.BUDGET_3F if chunk else 0, **kw)
    eng.runner.graphs = False
    rows, real = {}, lm.decode_step
    index = {}

    def step(*a, **k):
        logits, state = real(*a, **k)
        pos = a[4].cpu().tolist()
        for s, req in enumerate(eng.scheduler.slot_req):
            if req is not None and req.rid in index:
                i = index[req.rid]
                rows.setdefault((i, pos[s] - req.orig_len + 1),
                                logits[s].clone())
        return logits, state
    lm.decode_step = step
    try:
        rids = cs.fixed_tree(eng, shorts)
        rids += [eng.submit(p, max_new=cs.MAX_NEW) for p in longs]
        index.update({r: i for i, r in enumerate(rids)})
        out = eng.run_all()
    finally:
        lm.decode_step = real
    toks = [list(out[r]) for r in rids]
    tree, kvcfg, kcfg = eng.decode_params, eng.kvcfg, eng.kncfg
    del eng
    cs.free(torch)
    return toks, rows, (tree, kvcfg, kcfg)


def graph_tokens(torch, cs, dev, cfg, params, chunk, kw, shorts, longs):
    eng = cs.guarded(torch, dev, cfg, params, max_slots=cs.SLOTS_3F,
                     max_len=cs.MAXLEN_3F, recalibrate_every=cs.NEVER,
                     prefill_chunk=chunk,
                     prefill_budget=cs.BUDGET_3F if chunk else 0, **kw)
    rids = cs.fixed_tree(eng, shorts)
    rids += [eng.submit(p, max_new=cs.MAX_NEW) for p in longs]
    out = eng.run_all()
    toks = [list(out[r]) for r in rids]
    del eng
    cs.free(torch)
    return toks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=8)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chunk_tie_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import lm
    build.lib()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    cfg, params = cs.cut(*cs.init_gemma(torch, dev), args.depth)
    prompts = cs.make_prompts()
    shorts, longs = prompts[:4], cs.long_prompts(4, 200, 256, cs.SEED + 5)
    out = {}
    for paged in (False, True):
        label = "paged" if paged else "dense"
        kw = dict(kv_paged=True, kv_block_size=cs.BLOCK,
                  prefix_cache=False) if paged else {}
        runs = {}
        for chunk in (0, cs.CHUNK_3F):
            g = graph_tokens(torch, cs, dev, cfg, params, chunk, kw, shorts,
                             longs)
            toks, rows, tp = recorded_run(torch, cs, lm, dev, cfg, params,
                                          chunk, kw, shorts, longs)
            runs[chunk] = dict(toks=toks, rows=rows, eager_equal=toks == g)
            if chunk:
                tree, kvcfg, kcfg = tp
        print(f"{label}: eager tokens equal the graph run's: unchunked "
              f"{runs[0]['eager_equal']}, chunked "
              f"{runs[cs.CHUNK_3F]['eager_equal']}", flush=True)
        ties = []
        u, c = runs[0], runs[cs.CHUNK_3F]
        for i, (a_t, b_t) in enumerate(zip(u["toks"], c["toks"])):
            t = cs.leading_equal(a_t, b_t)
            if t == len(a_t):
                continue
            a, b = a_t[t], b_t[t]
            batch, k = (shorts, i) if i < 4 else (longs, i - 4)
            margin, delta = cs.chunk_near_tie(torch, cfg, params, tree, kvcfg,
                                              kcfg, batch, k, a_t[:t], a, b)
            row = dict(request=i, t=t, a=a, b=b, recompute_margin=margin,
                       recompute_delta=delta)
            if t >= 1:
                lw, lc = u["rows"][i, t], c["rows"][i, t]
                row.update(own_margin_unchunked=float(lw[a] - lw[b]),
                           own_margin_chunked=float(lc[b] - lc[a]),
                           own_delta=float((lw - lc).abs().max()),
                           own_argmax=(int(lw.argmax()), int(lc.argmax())))
            ties.append(row)
            print(f"  {label} request {i} token {t} ({a} vs {b}): "
                  + (f"own rows: unchunked a-b {row['own_margin_unchunked']:.4g}"
                     f", chunked b-a {row['own_margin_chunked']:.4g}, δ_own "
                     f"{row['own_delta']:.4g}; " if t >= 1 else "")
                  + f"recomputed margin {margin:.4g}, δ {delta:.4g} "
                  f"(margin/δ {margin / delta if delta else float('inf'):.3g})",
                  flush=True)
        out[label] = dict(eager_equal=[u["eager_equal"], c["eager_equal"]],
                          ties=ties)
        del tree, runs, u, c
        cs.free(torch)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
