"""Layer stack — the ``attn`` kind (dense decoder families).

Parameters keep the reference's stacked layout: ``stack[run]["u0"][...]``
holds every layer of a run with a leading layer dim, e.g.
``stack[0]["u0"]["mix"]["wq"]`` is (L, H·hd, D).  The reference's
``lax.scan`` over layers is a Python loop over :func:`layer_slice`.
Stats leaves come back stacked (L, d) under the same path keys
(``u0.mix.wq``); decode states are (L, B, ...).
"""
from __future__ import annotations

import torch

from repro_torch.core.ttq import QuantizedTensor, qt_index

from . import layers as L
from .common import glu_mlp, norm
from .config import ModelConfig


def mixer_kinds(cfg: ModelConfig) -> set:
    """The reference's layer kinds of a family (``stack_spec`` there),
    ported or not: what self-speculative decoding checks before refusing a
    family without plain attention."""
    if cfg.family == "hybrid":
        return {"lattn" if k == "attn" else k for k in cfg.hybrid.pattern}
    kind = {"ssm": "ssd", "encdec": "xdec"}.get(cfg.family)
    if kind is None:
        kind = "mla" if cfg.mla is not None else "attn"
    return {kind}


def stack_spec(cfg: ModelConfig):
    """[(unit_kinds, n_repeat)]: one run of plain attention layers."""
    if cfg.family not in ("dense", "vlm") or cfg.mla is not None \
            or cfg.moe is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} (MoE/MLA/recurrent/SSM/enc-dec layers) "
            f"is ported in a later slice")
    return [(("attn",), cfg.n_layers)]


def layer_slice(tree, i):
    """Layer ``i`` of a stacked param/state tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return qt_index(tree, i)
    return tree[i]


def init_layer(gen, cfg: ModelConfig, kind: str, n: int, device):
    """``n`` stacked layers of ``kind``."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r}: later slice")
    if cfg.mlp != "glu" or cfg.norm != "rms":
        raise NotImplementedError("only the RMSNorm + GLU MLP block is ported")
    D, F = cfg.d_model, cfg.d_ff
    zeros = lambda: torch.zeros((n, D), dtype=torch.float32, device=device)
    return {"ln1": {"gamma": zeros()},
            "mix": L.init_attn(gen, cfg, n, device),
            "ln2": {"gamma": zeros()},
            "mlp": {"wg": L.init_linear(gen, n, F, D, device),
                    "wu": L.init_linear(gen, n, F, D, device),
                    "wd": L.init_linear(gen, n, D, F, device)}}


def init_stack(gen, cfg: ModelConfig, spec, device):
    return [{f"u{j}": init_layer(gen, cfg, kind, n, device)
             for j, kind in enumerate(kinds)} for kinds, n in spec]


def layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                kvcfg=None, num_blocks: int = 0, device="cuda"):
    """One layer's decode state.  A paged cache holds plain attention
    layers only (windowed, latent and recurrent states stay dense)."""
    if kvcfg is not None and kvcfg.paged and kind != "attn":
        raise ValueError(f"paged KV cache supports plain attention layers "
                         f"only, got {kind!r}")
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r}: later slice")
    return L.attn_init_state(cfg, batch, max_len, kvcfg, device, num_blocks)


def init_stack_state(cfg: ModelConfig, spec, batch: int, max_len: int,
                     kvcfg=None, device="cuda", num_blocks: int = 0):
    out = []
    for kinds, n in spec:
        unit = {}
        for j, kind in enumerate(kinds):
            one = layer_state(cfg, kind, batch, max_len, kvcfg, num_blocks,
                              device)
            unit[f"u{j}"] = {k: torch.zeros((n, *v.shape), dtype=v.dtype,
                                            device=v.device)
                             for k, v in one.items()}
        out.append(unit)
    return out


def _mlp_apply(cfg, p, x, stats, prefix, kcfg=None):
    h = norm(x, p["ln2"])
    return x + glu_mlp(h, p["mlp"], stats, prefix + "mlp", cfg.act, kcfg)


def apply_layer_seq(cfg: ModelConfig, kind: str, p, x, stats, prefix, *,
                    want_state: bool = False, max_len: int = 0, kvcfg=None,
                    kcfg=None, pos0: int = 0, kv_prefix=None,
                    compact_state: bool = False):
    """Prefill through one layer.  Returns (x, state|None).  ``kv_prefix``
    (k, v) is cached context in front of this call's tokens, which start at
    ``pos0``.  A paged cache (or ``compact_state``) returns this call's
    k/v rows at the storage dtype instead of a max_len slab; the runner
    writes them into the pool or the slab."""
    h = norm(x, p["ln1"])
    st = None
    if want_state:
        y, (k, v) = L.attn_apply(cfg, p["mix"], h, stats, prefix + "mix.",
                                 pos0=pos0, return_kv=True,
                                 kv_prefix=kv_prefix, kvcfg=kvcfg, kcfg=kcfg)
        if compact_state or (kvcfg is not None and kvcfg.paged):
            st = L.build_kv_compact(k, v, kvcfg)
        else:
            S = min(k.shape[2], max_len)
            st = L.build_kv_state(cfg, x.shape[0], max_len, k[:, :, -S:],
                                  v[:, :, -S:], kvcfg)
    else:
        y = L.attn_apply(cfg, p["mix"], h, stats, prefix + "mix.", pos0=pos0,
                         kv_prefix=kv_prefix, kvcfg=kvcfg, kcfg=kcfg)
    x = x + y
    return _mlp_apply(cfg, p, x, stats, prefix, kcfg), st


def apply_layer_decode(cfg: ModelConfig, kind: str, p, x, state, pos, *,
                       kvcfg=None, kcfg=None, block_table=None, rows=None):
    """One token through one layer; ``state`` is updated in place."""
    h = norm(x, p["ln1"])
    y, st = L.attn_decode(cfg, p["mix"], h, state, pos, kvcfg=kvcfg,
                          kcfg=kcfg, block_table=block_table, rows=rows)
    x = x + y
    return _mlp_apply(cfg, p, x, None, "", kcfg), st


def apply_layer_verify(cfg: ModelConfig, kind: str, p, x, state, pos, *,
                       kvcfg=None, kcfg=None, block_table=None, rows=None):
    """A drafted window x (B,S,D) at per-slot positions pos..pos+S-1
    through one layer; ``state`` is written in place.  Returns (x, state)."""
    if kind != "attn":
        raise ValueError(
            f"self-speculative decoding supports plain attention layers "
            f"only, got {kind!r} (windowed/latent/recurrent decode states "
            f"mutate destructively and cannot roll back rejected drafts)")
    h = norm(x, p["ln1"])
    y, st = L.attn_verify(cfg, p["mix"], h, state, pos, kvcfg=kvcfg,
                          kcfg=kcfg, block_table=block_table, rows=rows)
    x = x + y
    return _mlp_apply(cfg, p, x, None, "", kcfg), st


def apply_stack_seq(cfg: ModelConfig, run_params, spec, x, *, stats_on=False,
                    want_state=False, max_len=0, kvcfg=None, kcfg=None,
                    pos0: int = 0, prefix_kv=None,
                    compact_state: bool = False):
    """Prefill over all runs.  Returns (x, stats_list, state_list) with
    stats and states stacked over each run's layers.  ``prefix_kv`` (tail
    prefill over a cached prefix of ``pos0`` tokens): per run, (k, v) with
    a leading layer dim; layer i attends to (k[i], v[i])."""
    all_stats, all_states = [], []
    for ri, ((kinds, n), rp) in enumerate(zip(spec, run_params)):
        pk = None if prefix_kv is None else prefix_kv[ri]
        per_layer_stats, per_layer_states = [], []
        for i in range(n):
            up = layer_slice(rp, i)
            kvp = None if pk is None else (pk[0][i], pk[1][i])
            stats = {} if stats_on else None
            states = {}
            for j, kind in enumerate(kinds):
                x, st = apply_layer_seq(cfg, kind, up[f"u{j}"], x, stats,
                                        f"u{j}.", want_state=want_state,
                                        max_len=max_len, kvcfg=kvcfg,
                                        kcfg=kcfg, pos0=pos0, kv_prefix=kvp,
                                        compact_state=compact_state)
                if st is not None:
                    states[f"u{j}"] = st
            per_layer_stats.append(stats)
            per_layer_states.append(states)
        all_stats.append(
            {k: torch.stack([s[k] for s in per_layer_stats])
             for k in per_layer_stats[0]} if stats_on else None)
        all_states.append(
            {u: {k: torch.stack([s[u][k] for s in per_layer_states])
                 for k in per_layer_states[0][u]}
             for u in per_layer_states[0]})
    return x, all_stats, all_states


def apply_stack_decode(cfg: ModelConfig, run_params, spec, run_states, x, pos,
                       *, kvcfg=None, kcfg=None, block_table=None):
    """One decode token over all runs; the stacked caches are updated in
    place (each layer's slice is a view of its run's stack).
    ``block_table`` (B, nblk) addresses a paged cache in every layer; the
    pool rows the token writes are computed once, here, for all of them."""
    rows = None
    if kvcfg is not None and kvcfg.paged:
        rows = L.paged_rows(pos, block_table, cfg.n_kv_heads,
                            kvcfg.block_size)
    for (kinds, n), rp, rs in zip(spec, run_params, run_states):
        for i in range(n):
            up, st = layer_slice(rp, i), layer_slice(rs, i)
            for j, kind in enumerate(kinds):
                x, _ = apply_layer_decode(cfg, kind, up[f"u{j}"], x,
                                          st[f"u{j}"], pos, kvcfg=kvcfg,
                                          kcfg=kcfg, block_table=block_table,
                                          rows=rows)
    return x, run_states


def apply_stack_verify(cfg: ModelConfig, run_params, spec, run_states, x, pos,
                       *, kvcfg=None, kcfg=None, block_table=None):
    """:func:`apply_stack_decode` with a window of S tokens per slot: one
    pass scores every drafted position.  A paged cache's window rows are
    computed once, here, for every layer."""
    rows = None
    if kvcfg is not None and kvcfg.paged:
        rows = L.paged_window_rows(pos, block_table, cfg.n_kv_heads,
                                   kvcfg.block_size, x.shape[1])
    for (kinds, n), rp, rs in zip(spec, run_params, run_states):
        for i in range(n):
            up, st = layer_slice(rp, i), layer_slice(rs, i)
            for j, kind in enumerate(kinds):
                x, _ = apply_layer_verify(cfg, kind, up[f"u{j}"], x,
                                          st[f"u{j}"], pos, kvcfg=kvcfg,
                                          kcfg=kcfg, block_table=block_table,
                                          rows=rows)
    return x, run_states
