"""Logical sharding rules — param-path patterns → partition specs — and the
tensor-parallel layout of one model.

The spec logic is the reference's (``repro/parallel/rules.py``), copied
and kept equal: Megatron-style TP on the ``model`` axis, EP for MoE
experts, replication for small tensors; decode-state sharding for
serving.  Rules are matched on the flattened param path (joined with
'.'), first match wins.  :class:`P` stands for ``PartitionSpec``: a tuple
of axis names or None per dimension.

What differs is what a spec becomes.  GSPMD turns a spec into a sharded
global array; here each rank of the model axis holds its local slice
(:func:`shard_params`), and the model code runs on that slice with
explicit collectives.  Two things GSPMD hides must then be decided per
block, once per model, by :func:`bind` (:class:`TPLayout`):

* attention splits whole heads: q heads and KV heads must both divide the
  world, since each rank's q heads read its own KV heads;
* a column slice of a weight must keep whole quantization groups and code
  words (``ParallelCtx.align``), so that each rank's codes are the slice
  of the world-1 codes.

A block that fails its test is replicated and runs unwrapped on every
rank (the reference's ``_tp_gemm_ok``/``_tp_attn_ok`` fallback).  Where
``Hkv`` does not divide the world, the reference shards the KV cache's
sequence instead (``state_sharding``); here that cache is replicated
with its attention block, as the unwrapped call replicates it there.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from .ctx import ParallelCtx


class P(tuple):
    """A partition spec: one axis name (or a tuple of names, or None) per
    dimension."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


# (regex on path, spec maker(model_axis) -> P)
_RULES = [
    # embeddings / head: vocab-parallel
    (r"(^|\.)embed$",        lambda m: P(m, None)),
    (r"(^|\.)lm_head$",      lambda m: P(m, None)),
    (r"(^|\.)pos_embed$",    lambda m: P(None, None)),
    # attention — heads on model
    (r"\.(mix|xattn)\.(wq|wk|wv)$",  lambda m: P(m, None)),
    (r"\.(mix|xattn)\.wo$",          lambda m: P(None, m)),
    (r"\.mix\.(qnorm|knorm)\.",      lambda m: P(None)),
    # MLA
    (r"\.mix\.wkv_a$",       lambda m: P(None, None)),
    (r"\.mix\.wkv_b$",       lambda m: P(m, None)),
    # RG-LRU / SSD — recurrent width on model
    (r"\.mix\.(w_branch|w_in|w_z|w_x)$", lambda m: P(m, None)),
    (r"\.mix\.(w_out)$",     lambda m: P(None, m)),
    (r"\.mix\.w_gate_[ax]$", lambda m: P(m, None, None)),   # block-diag blocks
    (r"\.mix\.conv_[wxBC]$", lambda m: P(None, None)),
    (r"\.mix\.(w_B|w_C|w_dt)$", lambda m: P(None, None)),
    (r"\.mix\.(A_log|Dskip|dt_bias|log_lambda)$", lambda m: P(None)),
    # dense MLP — hidden on model
    (r"\.mlp\.(wg|wu|w1)$",  lambda m: P(m, None)),
    (r"\.mlp\.(wd|w2)$",     lambda m: P(None, m)),
    # MoE — experts on model (EP); shared expert TP'd like dense MLP
    (r"\.mlp\.experts\.(wg|wu|wd)$", lambda m: P(m, None, None)),
    (r"\.mlp\.router$",      lambda m: P(None, None)),
    (r"\.mlp\.shared\.(wg|wu)$", lambda m: P(m, None)),
    (r"\.mlp\.shared\.wd$",  lambda m: P(None, m)),
]


def _path_str(path) -> str:
    return ".".join(str(p) for p in path)


def spec_for_path(path_str: str, leaf_ndim: int, model_axis: str = "model",
                  stacked: bool = True) -> P:
    """Sharding spec for one param. ``stacked``: leading layer-repeat dim."""
    for pat, make in _RULES:
        if re.search(pat, path_str):
            spec = make(model_axis)
            base = len(spec)
            if stacked and leaf_ndim == base + 1:
                return P(None, *spec)
            if leaf_ndim == base:
                return spec
            # pad/trim to rank
            if leaf_ndim > base:
                return P(*([None] * (leaf_ndim - base)), *spec)
            return P(*list(spec)[:leaf_ndim])
    return P(*([None] * leaf_ndim))                     # replicate by default


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, (tuple, list)):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axes]


def divisible_spec(spec: P, shape, mesh) -> P:
    """Drop spec axes that don't divide the corresponding dim (e.g. MQA's
    single KV head can't shard over a 16-way model axis)."""
    out = []
    for i, ax in enumerate(spec):
        n = _axis_size(mesh, ax)
        out.append(ax if (n > 1 and shape[i] % n == 0) or n == 1 else None)
    out += [None] * (len(shape) - len(out))
    return P(*out)


# QuantizedTensor children order: (wint, packed, scale, zero, dinv, B, A)
_QT_FIELDS = ("wint", "packed", "scale", "zero", "dinv", "B", "A")


def _qt_child_specs(base: P, model_axis: str):
    """Per-child specs for a QuantizedTensor from its 2-D weight spec:
    wint/packed/scale/zero share (row, col) (packed/scale cols are d/8,
    d/g slices of the same layout); dinv lives on the input dim (col); B
    on rows, A on cols."""
    row, col = (list(base) + [None, None])[:2]
    return {
        "wint": P(row, col), "packed": P(row, col), "scale": P(row, col),
        "zero": P(row, col), "dinv": P(col), "B": P(row, None), "A": P(None, col),
    }


def qt_specs(path_str: str, shapes, model_axis: str = "model", mesh=None):
    """Per-child specs for a QuantizedTensor at ``path_str``.  ``shapes``:
    dict child-name → shape (None for absent children).  ``mesh`` only
    needs a ``.shape`` mapping, for the divisibility fallback."""
    lead = 1 if ("stack" in path_str) else 0
    ref = shapes.get("wint") or shapes.get("packed")
    extra = len(ref) - 2 - lead              # e.g. expert dim
    base = spec_for_path(path_str, 2, model_axis, stacked=False)
    child = _qt_child_specs(base, model_axis)
    # experts: leading expert dim sharded on model (EP) → override TP
    if extra > 0:
        lead_spec = [None] * lead + [model_axis] + [None] * (extra - 1)
        child = {k: P(*lead_spec, None, None) if k != "dinv"
                 else P(*lead_spec, None) for k in child}
    else:
        lead_spec = [None] * lead
        child = {k: P(*lead_spec, *v) for k, v in child.items()}
    if mesh is not None:
        child = {k: (divisible_spec(v, shapes[k], mesh) if shapes.get(k)
                     else v) for k, v in child.items()}
    return child


# ---------------------------------------------------------------- layout

# families whose mixers are plain attention with a GLU or plain MLP
TP_FAMILIES = ("dense", "vlm")


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which blocks of a model split over the model axis: ``attn`` (whole
    heads: wq/wk/wv rows, wo columns, the KV cache's heads), ``mlp`` (the
    hidden width: wg/wu/w1 rows, wd/w2 columns), ``vocab`` (the embedding's
    and the tied head's rows)."""
    attn: bool = False
    mlp: bool = False
    vocab: bool = False


def _unported(cfg) -> Optional[str]:
    """The ROADMAP item that ports tensor parallelism for ``cfg``'s family,
    or None for a family served tensor-parallel."""
    if cfg.mla is not None:
        return "A10 (b2), MLA"
    if cfg.moe is not None:
        return "A10 (c), expert parallelism (moe_a2a)"
    if cfg.family not in TP_FAMILIES:
        return f"A10 (b2), the {cfg.family} family"
    return None


def check_family(cfg, world: int):
    """Raise NotImplementedError naming the ROADMAP item when ``cfg``'s
    family has no tensor-parallel port and ``world`` > 1."""
    item = _unported(cfg)
    if world > 1 and item is not None:
        raise NotImplementedError(
            f"tensor-parallel serving of {cfg.name} ({cfg.family}) over "
            f"{world} ranks is not ported (ROADMAP {item}); run it with "
            f"world 1")


def tp_layout(cfg, pctx: ParallelCtx) -> TPLayout:
    """The block decisions for ``cfg`` on ``pctx``'s model axis (see the
    module docstring).  Every block splits at world 1, a one-rank slice
    being the whole; a family not served tensor-parallel splits nothing."""
    n = pctx.world
    check_family(cfg, n)
    if _unported(cfg) is not None:
        return TPLayout()
    if n == 1:
        return TPLayout(True, True, True)
    H, Hkv, a = cfg.n_heads, cfg.n_kv_heads, pctx.align
    attn = H % n == 0 and Hkv % n == 0 and (H * cfg.hd // n) % a == 0
    mlp = cfg.d_ff % n == 0 and (cfg.d_ff // n) % a == 0
    return TPLayout(attn, mlp, cfg.vocab % n == 0)


def col_align(*policies) -> int:
    """The input features a column slice must keep for every quantized
    weight of ``policies``: the lcm of their group sizes and codes per
    32-bit word, overrides included (a policy with whole-row groups, group
    size 0, forbids column slices)."""
    a = 1
    for p in policies:
        if p is None or not p.any_enabled:
            continue
        for q in [p.qcfg] + [p._apply(d).qcfg for _, d in p.overrides]:
            if q.group_size <= 0:
                return 1 << 30
            per = 32 // q.bits if 32 % q.bits == 0 else 1
            a = math.lcm(a, q.group_size, per)
    return a


def bind(pctx: Optional[ParallelCtx], cfg,
         align: Optional[int] = None) -> Optional[ParallelCtx]:
    """``pctx`` with its layout for ``cfg`` (and ``align`` when given);
    None stays None, a bound context is returned as it is."""
    if pctx is None or (pctx.layout is not None and align is None):
        return pctx
    if align is not None:
        pctx = dataclasses.replace(pctx, align=align)
    return dataclasses.replace(pctx, layout=tp_layout(cfg, pctx))


def block_ctx(pctx: Optional[ParallelCtx], block: str):
    """``pctx`` where ``block`` ('attn' | 'mlp' | 'vocab') splits, else
    None: the replicated block runs the unwrapped code."""
    if pctx is None or pctx.layout is None:
        return None
    return pctx if getattr(pctx.layout, block) else None


def local_cfg(cfg, pctx: Optional[ParallelCtx]):
    """The config of one rank's slice: q and KV heads per rank where
    attention splits (head_dim pinned), the MLP width per rank where it
    splits."""
    if pctx is None or pctx.layout is None or pctx.world == 1:
        return cfg
    n, lay = pctx.world, pctx.layout
    kw = {}
    if lay.attn:
        kw.update(n_heads=cfg.n_heads // n, n_kv_heads=cfg.n_kv_heads // n,
                  head_dim=cfg.hd)
    if lay.mlp:
        kw.update(d_ff=cfg.d_ff // n)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _block_of(path_str: str) -> Optional[str]:
    if re.search(r"\.(mix|xattn)\.", path_str):
        return "attn"
    if ".mlp." in path_str:
        return "mlp"
    if re.search(r"(^|\.)(embed|lm_head)$", path_str):
        return "vocab"
    return None


def split_of(path_str: str, pctx: Optional[ParallelCtx]) -> Optional[str]:
    """'row' (output features split), 'col' (input features split) or
    None (replicated) for the weight at ``path_str`` under ``pctx``'s
    bound layout."""
    if pctx is None or pctx.layout is None:
        return None
    block = _block_of(path_str)
    if block is None or not getattr(pctx.layout, block):
        return None
    spec = spec_for_path(path_str, 2, pctx.model_axis, stacked=False)
    if len(spec) != 2:
        return None
    return {0: "row", 1: "col"}.get(
        next((i for i, a in enumerate(spec) if a == pctx.model_axis), None))


# ----------------------------------------------------------- placement

def _leaf_spec(ps: str, leaf, pctx: ParallelCtx) -> P:
    in_stack = "stack" in ps
    spec = spec_for_path(ps, leaf.dim(), pctx.model_axis, stacked=in_stack)
    spec = divisible_spec(spec, tuple(leaf.shape), pctx.mesh)
    if pctx.layout is not None and split_of(ps, pctx) is None:
        spec = P(*([None] * leaf.dim()))
    return spec


def qt_sharding(path_str: str, qt, pctx: ParallelCtx):
    """QuantizedTensor of per-child specs (None for absent children) for
    the quantized weight at ``path_str``: what :func:`shard_params` slices
    and :func:`constrain_qt` checks."""
    from repro_torch.core.ttq import QuantizedTensor
    shapes = {n: (tuple(getattr(qt, n).shape) if getattr(qt, n) is not None
                  else None) for n in _QT_FIELDS}
    child = qt_specs(path_str, shapes, pctx.model_axis, pctx.mesh)
    if pctx.layout is not None and split_of(path_str, pctx) is None:
        child = {k: P(*([None] * len(shapes[k]))) if shapes[k] else v
                 for k, v in child.items()}
    vals = [child[n] if shapes[n] is not None else None for n in _QT_FIELDS]
    return QuantizedTensor(*vals, bits=qt.bits, group_size=qt.group_size,
                           out_features=qt.out_features,
                           in_features=qt.in_features)


def constrain_qt(path_str: str, qt, pctx: ParallelCtx, shape):
    """Check that a shard-local requant's output already has its shard's
    shape: ``shape`` is the rank's (d', d) weight slice, and every child
    must be that slice's (codes, S, Z on (d', ·), D⁻¹ on d, B on d', A on
    d).  Never gathers; returns ``qt``."""
    dp, d = shape
    per = 32 // qt.bits if 32 % qt.bits == 0 else 0
    want = {"wint": (dp, d), "packed": (dp, d * qt.bits // 32 if per else 0),
            "scale": (dp, d // qt.group_size), "zero": (dp, d // qt.group_size),
            "dinv": (d,)}
    bad = [f for f, w in want.items() if getattr(qt, f) is not None
           and tuple(getattr(qt, f).shape[-len(w):]) != w]
    if qt.B is not None and qt.B.shape[-2] != dp:
        bad.append("B")
    if qt.A is not None and qt.A.shape[-1] != d:
        bad.append("A")
    if bad or (qt.out_features, qt.in_features) != (dp, d):
        raise ValueError(f"{path_str}: requant output {bad or 'features'} "
                         f"off the rank's ({dp}, {d}) slice")
    return qt


def param_sharding(params, pctx: ParallelCtx):
    """Tree of specs matching ``params`` (layer-stacked leaves get a leading
    replicated dim; QuantizedTensor nodes per-child specs; non-divisible
    dims and, with a bound layout, replicated blocks fall back to
    replication)."""
    from repro_torch.core.ttq import QuantizedTensor

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,)) for i, v in enumerate(tree))
        ps = _path_str(path)
        if isinstance(tree, QuantizedTensor):
            return qt_sharding(ps, tree, pctx)
        if isinstance(tree, torch.Tensor):
            return _leaf_spec(ps, tree, pctx)
        return None
    return walk(params, ())


def shard_tensor(t: torch.Tensor, spec, pctx: ParallelCtx) -> torch.Tensor:
    """This rank's slice of ``t`` along every dimension ``spec`` puts on the
    model axis (a copy, so the whole can be freed; ``t`` itself where the
    slice is the whole)."""
    if t is None or spec is None:
        return t
    n, r, m = pctx.world, pctx.rank, pctx.model_axis
    out = t
    for i, ax in enumerate(spec):
        if ax == m or (isinstance(ax, tuple) and m in ax):
            if n > 1:
                k = t.shape[i] // n
                out = out.narrow(i, r * k, k)
    return out if out is t else out.contiguous().clone()


def shard_params(params, pctx: ParallelCtx):
    """Each rank's local slice of ``params`` along the model axis, per
    :func:`param_sharding` (QuantizedTensor children each per its spec,
    their feature counts the slice's)."""
    from repro_torch.core.ttq import QuantizedTensor
    specs = param_sharding(params, pctx)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, s) for v, s in zip(tree, spec))
        if isinstance(tree, QuantizedTensor):
            kids = {f: shard_tensor(getattr(tree, f), getattr(spec, f), pctx)
                    for f in _QT_FIELDS}
            ref = kids["scale"]
            d = kids["dinv"].shape[-1]
            return dataclasses.replace(tree, **kids,
                                       out_features=ref.shape[-2],
                                       in_features=d)
        if isinstance(tree, torch.Tensor):
            return shard_tensor(tree, spec, pctx)
        return tree
    return walk(params, specs)


def shard_stats(stats, pctx: ParallelCtx):
    """A statistics tree ({'stack': [per-run {key: (L, d)}]}) sliced to the
    rank's inputs: the Σx² of a column-split weight's input is split with
    it; every other leaf is replicated (the full input)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,)) for i, v in enumerate(tree))
        if isinstance(tree, torch.Tensor) and \
                split_of(_path_str(path), pctx) == "col":
            return shard_tensor(tree, P(*([None] * (tree.dim() - 1)),
                                        pctx.model_axis), pctx)
        return tree
    return walk(stats, ())


def shard_lowrank(tree, pctx: ParallelCtx):
    """A low-rank factor tree (a {'B', 'A'} pair at each factored weight)
    sliced per ``_qt_child_specs``: B's rows with a row-split weight, A's
    columns with a column-split one.  The factors are those of the whole
    weight, so each rank's residual W − B·A is the slice of the whole
    residual (the SVD of a slice is not the slice of the SVD)."""
    if tree is None:
        return None
    m = pctx.model_axis

    def walk(t, path):
        if isinstance(t, dict) and set(t) == {"B", "A"}:
            sp = split_of(_path_str(path), pctx)
            B, A = t["B"], t["A"]
            if sp == "row":
                B = shard_tensor(B, P(*([None] * (B.dim() - 2)), m, None),
                                 pctx)
            elif sp == "col":
                A = shard_tensor(A, P(*([None] * (A.dim() - 1)), m), pctx)
            return {"B": B, "A": A}
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (i,)) for i, v in enumerate(t))
        return t
    return walk(tree, ())


def state_sharding(state, pctx: ParallelCtx, batch_axes=None, seq_axis=None,
                   paged: bool = False):
    """Specs of the decode/KV state: batch dim on data axes, head/width
    dims on model.

    Heuristic on rank: (B, Hkv, S, hd)→(dp, m, None|seq, None);
    (B, S, r)→(dp, None|seq, None); (B, dr)→(dp, m); (B, H, p, n)→(dp, m,
    None, None); (B, W, ch)→(dp, None, m); leading run-stacked dims get
    None.  ``paged``: KV leaves are slot-free block pools (NB, Hkv, bs, ·)
    — the KV-head dim only is sharded, never the block-pool dim (the
    allocator's physical block ids are global); the block tables stay
    replicated.  A cache whose Hkv does not divide the model axis (or,
    with a bound layout, whose attention block is replicated) is
    replicated, where the reference shards its sequence dim."""
    mesh, m = pctx.mesh, pctx.model_axis
    dp = pctx.dp if batch_axes is None else batch_axes
    msize = _axis_size(mesh, m)
    attn_ok = pctx.layout is None or pctx.layout.attn

    def per_leaf(ps, leaf):
        nd = leaf.dim()
        lead = 1 if re.match(r"stack\.\d+\.", ps) or ".u" in ps else 0
        core = nd - lead
        if "enc_out" in ps:
            spec = P(dp, None, None)
        elif paged and re.search(r"\.(k|v)(_q|_s)?$", ps) and core == 4:
            spec = P(None, m if attn_ok else None, None, None)
        elif re.search(r"\.(k|v|xk|xv)(_q|_s)?$", ps) and core == 4:
            hkv = leaf.shape[lead + 1]
            if hkv % msize == 0 and attn_ok:
                spec = P(dp, m, seq_axis, None)
            else:
                spec = P(dp, None, seq_axis, None)
        elif re.search(r"\.(latent|k_rope)$", ps) and core == 3:
            spec = P(dp, seq_axis, None)
        elif re.search(r"\.h$", ps) and core == 2:
            spec = P(dp, m)
        elif re.search(r"\.h$", ps) and core == 4:
            spec = P(dp, m, None, None)
        elif re.search(r"\.conv", ps) and core == 3:
            spec = P(dp, None, m)
        else:
            spec = P(*([None] * core))
        if lead:
            spec = P(None, *spec)
        return divisible_spec(spec, tuple(leaf.shape), mesh)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,)) for i, v in enumerate(tree))
        return per_leaf(_path_str(path), tree)
    return walk(state, ())
