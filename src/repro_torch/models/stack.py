"""Layer stack — runs of units of layer kinds: ``attn`` (dense, vlm and
llama4-style MoE decoders), ``mla`` (DeepSeek's latent attention), the
hybrid family's ``rec`` (RG-LRU) and ``lattn`` (local attention over a
window), Mamba2's ``ssd``, and the encoder-decoder's ``enc`` (non-causal
self-attention; the encoder stack, :func:`enc_spec`) and ``xdec``
(self-attention, then cross-attention over the encoder output).  The MLP
of a layer is a GLU, a plain MLP, in the MoE family the experts plus a
shared expert, or none in an ``ssd`` layer (:func:`mlp_kind`).

A stack is a list of runs; a run repeats a unit (a tuple of kinds) n
times.  Parameters keep the reference's stacked layout:
``stack[run]["u<j>"][...]`` holds the j-th layer of every repeat of a
run's unit with a leading repeat dim, e.g. ``stack[0]["u0"]["mix"]["wq"]``
is (n, H·hd, D).  The reference's ``lax.scan`` over repeats is a Python
loop over :func:`layer_slice`.  Stats leaves come back stacked (n, d) under
the same path keys (``u0.mix.wq``); decode states are (n, B, ...).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.ttq import QuantizedTensor, qt_index
from repro_torch.parallel.rules import block_ctx

from . import layers as L
from .common import glu_mlp, init_norm, norm, plain_mlp
from .config import ModelConfig


def mixer_kinds(cfg: ModelConfig) -> set:
    """The mixer kinds of a family's decoder stack: what self-speculative
    decoding and chunked prefill check before refusing a family without
    plain attention."""
    if cfg.family == "hybrid":
        return {"lattn" if k == "attn" else k for k in cfg.hybrid.pattern}
    kind = {"ssm": "ssd", "encdec": "xdec"}.get(cfg.family)
    if kind is None:
        kind = "mla" if cfg.mla is not None else "attn"
    return {kind}


def stack_spec(cfg: ModelConfig):
    """[(unit_kinds, n_repeat)] of the decoder stack: one run of layers of
    the family's kind (``ssd``, ``xdec``, ``mla`` with an MLA config, else
    ``attn``), or for the hybrid family its pattern repeated (``attn`` →
    ``lattn``) and a run of the pattern's head for the layers left over
    (recurrentgemma-9b: 12 × (rec, rec, lattn) and 1 × (rec, rec))."""
    if cfg.family == "hybrid":
        pat = tuple("lattn" if k == "attn" else k for k in cfg.hybrid.pattern)
        n_full, rem = divmod(cfg.n_layers, len(pat))
        runs = [(pat, n_full)] if n_full else []
        if rem:
            runs.append((pat[:rem], 1))
        return runs
    return [(tuple(mixer_kinds(cfg)), cfg.n_layers)]


def enc_spec(cfg: ModelConfig):
    """The encoder stack of the encoder-decoder family: one run of
    ``enc`` layers."""
    return [(("enc",), cfg.encdec.n_enc_layers)]


def mlp_kind(cfg: ModelConfig, kind: str) -> str:
    """A layer's MLP: none in an ``ssd`` layer, ``moe`` in the MoE family
    (but for an encoder layer), else the config's ``glu`` or ``plain``."""
    if kind == "ssd":
        return "none"
    if cfg.moe is not None and kind != "enc":
        return "moe"
    return cfg.mlp


def layer_slice(tree, i):
    """Layer ``i`` of a stacked param/state tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return qt_index(tree, i)
    return tree[i]


def layer_slices(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree at once (views, no copies):
    ``unbind`` on tensors, so that a backward pass stacks the layers'
    gradients in one copy (indexing layer by layer, as
    :func:`layer_slice`, gives each layer's gradient the whole stack's
    shape, summed n times)."""
    if isinstance(tree, dict):
        parts = {k: layer_slices(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, QuantizedTensor):
        return [qt_index(tree, i) for i in range(n)]
    return list(tree.unbind(0))


def init_layer(gen, cfg: ModelConfig, kind: str, n: int, device):
    """``n`` stacked layers of ``kind``: ``ln1`` and the mixer ``mix``; an
    ``xdec`` layer's ``lnx`` and cross-attention ``xattn``; ``ln2`` and
    the ``mlp`` where the layer has one."""
    mix = {"attn": L.init_attn, "lattn": L.init_attn, "enc": L.init_attn,
           "xdec": L.init_attn, "rec": L.init_rec, "mla": L.init_mla,
           "ssd": L.init_ssd}.get(kind)
    if mix is None:
        raise ValueError(kind)
    D, F = cfg.d_model, cfg.d_ff
    nk = "rms" if cfg.norm == "rms" else "layer"
    p = {"ln1": init_norm(D, nk, n, device),
         "mix": mix(gen, cfg, n, device)}
    if kind == "xdec":
        p["lnx"] = init_norm(D, nk, n, device)
        p["xattn"] = L.init_attn(gen, cfg, n, device)
    mk = mlp_kind(cfg, kind)
    if mk == "none":
        return p
    p["ln2"] = init_norm(D, nk, n, device)
    if mk == "moe":
        p["mlp"] = L.init_moe(gen, cfg, n, device)
    elif mk == "glu":
        p["mlp"] = {"wg": L.init_linear(gen, n, F, D, device),
                    "wu": L.init_linear(gen, n, F, D, device),
                    "wd": L.init_linear(gen, n, D, F, device)}
    else:
        p["mlp"] = {"w1": L.init_linear(gen, n, F, D, device),
                    "w2": L.init_linear(gen, n, D, F, device)}
    return p


def init_stack(gen, cfg: ModelConfig, spec, device):
    return [{f"u{j}": init_layer(gen, cfg, kind, n, device)
             for j, kind in enumerate(kinds)} for kinds, n in spec]


def layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                kvcfg=None, num_blocks: int = 0, device="cuda"):
    """One layer's decode state: an ``attn`` cache of max_len rows, an
    ``lattn`` one of min(max_len, window) rows (the rolling window), the
    ``rec`` block's h and conv history, the ``ssd`` block's h and conv
    histories, the ``mla`` latent and rope-key caches, an ``xdec`` layer's
    self-attention cache and its bf16 cross k/v ``xk``/``xv`` (B, Hkv,
    n_frames, hd), computed once from the encoder at prefill.  A paged
    cache holds plain attention layers only (windowed, latent, recurrent
    and cross states stay dense)."""
    if kvcfg is not None and kvcfg.paged and kind != "attn":
        raise ValueError(f"paged KV cache supports plain attention layers "
                         f"only, got {kind!r} (windowed/latent/recurrent "
                         f"states stay dense)")
    if kind == "rec":
        return L.rec_init_state(cfg, batch, device)
    if kind == "ssd":
        return L.ssd_init_state(cfg, batch, device)
    if kind == "mla":
        return L.mla_init_state(cfg, batch, max_len, device)
    if kind == "lattn":
        max_len = min(max_len, cfg.hybrid.window)
    elif kind not in ("attn", "xdec"):
        raise ValueError(kind)
    st = L.attn_init_state(cfg, batch, max_len, kvcfg, device, num_blocks)
    if kind == "xdec":
        shape = (batch, cfg.n_kv_heads, cfg.encdec.n_frames, cfg.hd)
        st["xk"] = torch.zeros(shape, dtype=L.DTYPE, device=device)
        st["xv"] = torch.zeros(shape, dtype=L.DTYPE, device=device)
    return st


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


def _mlp_apply(cfg, kind, p, x, stats, prefix, kcfg=None, pctx=None):
    mk = mlp_kind(cfg, kind)
    if mk == "none":
        return x
    h = norm(x, p["ln2"])
    if mk != "moe":
        mlp = glu_mlp if mk == "glu" else plain_mlp
        return x + mlp(h, p["mlp"], stats, prefix + "mlp", cfg.act, kcfg,
                       pctx=block_ctx(pctx, "mlp"))
    pp = prefix + "mlp."
    ectx = block_ctx(pctx, "experts")
    if ectx is not None and ectx.moe_impl == "a2a":
        y = L.moe_apply_a2a(cfg, p["mlp"], h, stats, pp, pctx=ectx,
                            kcfg=kcfg)
    else:
        y = L.moe_apply_dense(cfg, p["mlp"], h, stats, pp, kcfg=kcfg,
                              pctx=ectx)
    if cfg.moe.n_shared:
        y = y + glu_mlp(h, p["mlp"]["shared"], stats, pp + "shared",
                        cfg.act, kcfg, pctx=block_ctx(pctx, "mlp"))
    return x + y


def apply_layer_seq(cfg: ModelConfig, kind: str, p, x, stats, prefix, *,
                    want_state: bool = False, max_len: int = 0, kvcfg=None,
                    kcfg=None, pos0: int = 0, kv_prefix=None,
                    compact_state: bool = False, enc_out=None,
                    remat: bool = False, pctx=None):
    """Prefill (or a training forward) through one layer.  Returns (x,
    state|None).  ``remat`` runs the mixer and the MLP each under
    ``torch.utils.checkpoint``: backward recomputes their insides, and what
    is kept per layer is the two halves' outputs, two (B,S,D) tensors as
    the reference keeps ``mix_out`` and ``mlp_out``; it takes neither
    stats nor a state; the recomputation reruns a block's forward
    collectives in backward.  ``pctx``: tensor parallelism (each block
    under its layout's context,
    :func:`~repro_torch.parallel.rules.block_ctx`); ``cfg`` is then the
    rank's (``rules.local_cfg``)."""
    if remat:
        if want_state or stats is not None:
            raise ValueError("remat is for training: no stats, no state")
        ckpt = torch.utils.checkpoint.checkpoint
        x = ckpt(lambda x: _mix_seq(cfg, kind, p, x, None, prefix, pos0=pos0,
                                    kv_prefix=kv_prefix, kcfg=kcfg,
                                    enc_out=enc_out, pctx=pctx)[0],
                 x, use_reentrant=False)
        if mlp_kind(cfg, kind) == "none":
            return x, None
        return ckpt(lambda x: _mlp_apply(cfg, kind, p, x, None, prefix, kcfg,
                                         pctx), x, use_reentrant=False), None
    x, st = _mix_seq(cfg, kind, p, x, stats, prefix, want_state=want_state,
                     max_len=max_len, kvcfg=kvcfg, kcfg=kcfg, pos0=pos0,
                     kv_prefix=kv_prefix, compact_state=compact_state,
                     enc_out=enc_out, pctx=pctx)
    return _mlp_apply(cfg, kind, p, x, stats, prefix, kcfg, pctx), st


def _mix_seq(cfg: ModelConfig, kind: str, p, x, stats, prefix, *,
             want_state: bool = False, max_len: int = 0, kvcfg=None,
             kcfg=None, pos0: int = 0, kv_prefix=None,
             compact_state: bool = False, enc_out=None, pctx=None):
    """The mixer half of :func:`apply_layer_seq`: x plus the mixer's output
    (for ``xdec`` plus the cross-attention's too), and the state.  ``kv_prefix``
    (k, v) is cached context in front of this call's tokens, which start at
    ``pos0``.  A paged cache (or ``compact_state``) returns this call's
    k/v rows at the storage dtype instead of a max_len slab; the runner
    writes them into the pool or the slab.  An ``lattn`` layer attends
    over its window and keeps the last min(max_len, window) rows, rolled
    so that position p lies in row p % window once the prompt fills the
    window; a ``rec`` or ``ssd`` layer returns its recurrent state; an
    ``enc`` layer attends without a causal mask; an ``xdec`` layer then
    attends over ``enc_out`` (B,F,D) and keeps its cross k/v."""
    h = norm(x, p["ln1"])
    st = None
    actx = block_ctx(pctx, "attn")
    if kind in ("rec", "ssd"):
        apply = L.rec_apply if kind == "rec" else L.ssd_apply
        kw = dict(kcfg=kcfg, pctx=block_ctx(pctx, kind))
        if want_state:
            y, st = apply(cfg, p["mix"], h, stats, prefix + "mix.",
                          return_state=True, **kw)
        else:
            y = apply(cfg, p["mix"], h, stats, prefix + "mix.", **kw)
        return x + y, st
    if kind == "xdec":
        return _xdec_seq(cfg, p, x, h, stats, prefix, want_state, max_len,
                         pos0, enc_out, kvcfg, kcfg, actx)
    if kind == "mla":
        mctx = block_ctx(pctx, "mla")
        if want_state:
            y, cache = L.mla_apply(cfg, p["mix"], h, stats, prefix + "mix.",
                                   pos0=pos0, return_cache=True, kcfg=kcfg,
                                   pctx=mctx)
            st = L.mla_init_state(cfg, x.shape[0], max_len, x.device)
            for k, c in cache.items():
                st[k][:, :c.shape[1]] = c.to(st[k].dtype)
        else:
            y = L.mla_apply(cfg, p["mix"], h, stats, prefix + "mix.",
                            pos0=pos0, kcfg=kcfg, pctx=mctx)
        return x + y, st
    window = cfg.hybrid.window if kind == "lattn" else 0
    causal = kind != "enc"
    if want_state:
        y, (k, v) = L.attn_apply(cfg, p["mix"], h, stats, prefix + "mix.",
                                 causal=causal, window=window, pos0=pos0,
                                 return_kv=True, kv_prefix=kv_prefix,
                                 kvcfg=kvcfg, kcfg=kcfg, pctx=actx)
        if compact_state or (kvcfg is not None and kvcfg.paged):
            st = L.build_kv_compact(k, v, kvcfg)
        else:
            ml = min(max_len, window) if window else max_len
            S = min(k.shape[2], ml)
            k, v = k[:, :, -S:], v[:, :, -S:]
            if window and S == window:
                shift = (pos0 + x.shape[1]) % window
                k, v = (torch.roll(t, shift, dims=2) for t in (k, v))
            st = L.build_kv_state(cfg, x.shape[0], ml, k, v, kvcfg)
    else:
        y = L.attn_apply(cfg, p["mix"], h, stats, prefix + "mix.",
                         causal=causal, window=window, pos0=pos0,
                         kv_prefix=kv_prefix, kvcfg=kvcfg, kcfg=kcfg,
                         pctx=actx)
    return x + y, st


def _xdec_seq(cfg, p, x, h, stats, prefix, want_state, max_len, pos0,
              enc_out, kvcfg, kcfg, actx=None):
    """An ``xdec`` layer's mixers in sequence mode (``h`` = ln1(x)): causal
    self-attention (its cache a max_len slab), then cross-attention over
    ``enc_out`` from ``lnx``; the caller adds the MLP.  With ``want_state`` the state
    adds the cross k/v in bf16 (the reference's: computed once, never
    quantized).  ``actx``: both attentions head-parallel (the rank's
    self and cross k/v heads; ``enc_out`` is whole on every rank)."""
    st = None
    kw = dict(kcfg=kcfg, pctx=actx)
    if want_state:
        y, (k, v) = L.attn_apply(cfg, p["mix"], h, stats, prefix + "mix.",
                                 pos0=pos0, return_kv=True, kvcfg=kvcfg, **kw)
        st = L.build_kv_state(cfg, x.shape[0], max_len, k, v, kvcfg)
    else:
        y = L.attn_apply(cfg, p["mix"], h, stats, prefix + "mix.", pos0=pos0,
                         **kw)
    x = x + y
    hx = norm(x, p["lnx"])
    if want_state:
        yx, (xk, xv) = L.attn_apply(cfg, p["xattn"], hx, stats,
                                    prefix + "xattn.", x_cross=enc_out,
                                    return_kv=True, **kw)
        st["xk"], st["xv"] = xk.to(L.DTYPE), xv.to(L.DTYPE)
    else:
        yx = L.attn_apply(cfg, p["xattn"], hx, stats, prefix + "xattn.",
                          x_cross=enc_out, **kw)
    return x + yx, st


def apply_layer_decode(cfg: ModelConfig, kind: str, p, x, state, pos, *,
                       kvcfg=None, kcfg=None, block_table=None, rows=None,
                       pctx=None):
    """One token through one layer; ``state`` is updated in place."""
    h = norm(x, p["ln1"])
    actx = block_ctx(pctx, "attn")
    if kind == "rec":
        y, st = L.rec_decode(cfg, p["mix"], h, state, kcfg=kcfg,
                             pctx=block_ctx(pctx, "rec"))
    elif kind == "ssd":
        y, st = L.ssd_decode(cfg, p["mix"], h, state, kcfg=kcfg,
                             pctx=block_ctx(pctx, "ssd"))
    elif kind == "xdec":
        self_kv = {k: v for k, v in state.items() if k not in ("xk", "xv")}
        y, _ = L.attn_decode(cfg, p["mix"], h, self_kv, pos, kvcfg=kvcfg,
                             kcfg=kcfg, pctx=actx)
        x = x + y
        y, st = L.attn_decode(cfg, p["xattn"], norm(x, p["lnx"]), state,
                              pos, cross_kv=(state["xk"], state["xv"]),
                              kcfg=kcfg, pctx=actx)
    elif kind == "mla":
        y, st = L.mla_decode(cfg, p["mix"], h, state, pos, kcfg=kcfg,
                             pctx=block_ctx(pctx, "mla"))
    elif kind == "lattn":
        y, st = L.attn_decode_rolling(cfg, p["mix"], h, state, pos,
                                      cfg.hybrid.window, kvcfg=kvcfg,
                                      kcfg=kcfg, pctx=actx)
    else:
        y, st = L.attn_decode(cfg, p["mix"], h, state, pos, kvcfg=kvcfg,
                              kcfg=kcfg, block_table=block_table, rows=rows,
                              pctx=actx)
    x = x + y
    return _mlp_apply(cfg, kind, p, x, None, "", kcfg, pctx), st


def apply_layer_verify(cfg: ModelConfig, kind: str, p, x, state, pos, *,
                       kvcfg=None, kcfg=None, block_table=None, rows=None,
                       pctx=None):
    """A drafted window x (B,S,D) at per-slot positions pos..pos+S-1
    through one layer; ``state`` is written in place.  Returns (x, state)."""
    if kind != "attn":
        raise ValueError(
            f"self-speculative decoding supports plain attention layers "
            f"only, got {kind!r} (windowed/latent/recurrent decode states "
            f"mutate destructively and cannot roll back rejected drafts)")
    h = norm(x, p["ln1"])
    y, st = L.attn_verify(cfg, p["mix"], h, state, pos, kvcfg=kvcfg,
                          kcfg=kcfg, block_table=block_table, rows=rows,
                          pctx=block_ctx(pctx, "attn"))
    x = x + y
    return _mlp_apply(cfg, kind, p, x, None, "", kcfg, pctx), st


def apply_stack_seq(cfg: ModelConfig, run_params, spec, x, *, stats_on=False,
                    want_state=False, max_len=0, kvcfg=None, kcfg=None,
                    pos0: int = 0, prefix_kv=None,
                    compact_state: bool = False, enc_out=None,
                    remat: bool = False, pctx=None):
    """Prefill (or a training forward) over all runs.  Returns (x,
    stats_list, state_list) with stats and states stacked over each run's
    layers.  ``remat``: every layer as in :func:`apply_layer_seq`.  ``prefix_kv`` (tail
    prefill over a cached prefix of ``pos0`` tokens): per run, (k, v) with
    a leading layer dim; layer i attends to (k[i], v[i]).  ``enc_out``:
    the encoder output every ``xdec`` layer attends over."""
    all_stats, all_states = [], []
    for ri, ((kinds, n), rp) in enumerate(zip(spec, run_params)):
        pk = None if prefix_kv is None else prefix_kv[ri]
        per_layer_stats, per_layer_states = [], []
        layers = layer_slices(rp, n)
        for i in range(n):
            up = layers[i]
            kvp = None if pk is None else (pk[0][i], pk[1][i])
            stats = {} if stats_on else None
            states = {}
            for j, kind in enumerate(kinds):
                x, st = apply_layer_seq(cfg, kind, up[f"u{j}"], x, stats,
                                        f"u{j}.", want_state=want_state,
                                        max_len=max_len, kvcfg=kvcfg,
                                        kcfg=kcfg, pos0=pos0, kv_prefix=kvp,
                                        compact_state=compact_state,
                                        enc_out=enc_out, remat=remat,
                                        pctx=pctx)
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
                       *, kvcfg=None, kcfg=None, block_table=None,
                       pctx=None):
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
                                          rows=rows, pctx=pctx)
    return x, run_states


def apply_stack_verify(cfg: ModelConfig, run_params, spec, run_states, x, pos,
                       *, kvcfg=None, kcfg=None, block_table=None,
                       pctx=None):
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
                                          rows=rows, pctx=pctx)
    return x, run_states
