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
  world, since each rank's q heads read its own KV heads; MLA splits its q
  heads (wq and wkv_b rows), the RG-LRU its width with its 16 gate blocks,
  SSD its heads, the experts whole experts;
* a column slice of a weight must keep whole quantization groups and code
  words (``ParallelCtx.align``), so that each rank's codes are the slice
  of the world-1 codes.

A block that fails its test is replicated and runs unwrapped on every
rank (the reference's ``_tp_gemm_ok``/``_tp_attn_ok`` fallback).  Where
``Hkv`` does not divide the world, the reference shards the KV cache's
sequence instead (``state_sharding``); here that cache is replicated
with its attention block, as the unwrapped call replicates it there.
The per-channel leaves of a split recurrent or SSD block (conv weights,
decays, the gated norm's gamma), which the reference's rules replicate
and GSPMD slices implicitly, are sliced to the rank's channels here
(:func:`shard_params`).
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

@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which blocks of a model split over the model axis.  ``attn``: plain
    attention's whole heads (wq/wk/wv rows, wo columns, the KV cache's
    heads), the same decision for the encoder's attention and the
    cross-attention (they have the decoder's heads); ``mlp``: the hidden
    width of the dense MLP, or of a MoE layer's shared expert
    (wg/wu/w1 rows, wd/w2 columns); ``vocab``: the embedding's and the tied
    head's rows.  The blocks a family may lack are None where the model has
    none: ``rec`` (the RG-LRU width: w_branch/w_in rows, w_out columns, the
    rank's gate blocks, conv and decay channels, its state's channels),
    ``ssd`` (SSD heads: w_z/w_x rows, w_out columns, the rank's heads of
    the conv, the decays and the gated norm, its state's heads), ``mla``
    (q heads and wkv_b's rows, wo columns) and ``experts`` (whole experts,
    E/n per rank)."""
    attn: bool = False
    mlp: bool = False
    vocab: bool = False
    rec: Optional[bool] = None
    ssd: Optional[bool] = None
    mla: Optional[bool] = None
    experts: Optional[bool] = None


def tp_layout(cfg, pctx: ParallelCtx) -> TPLayout:
    """The block decisions for ``cfg`` on ``pctx``'s model axis (see the
    module docstring).  Every block splits at world 1, a one-rank slice
    being the whole.  Above it a block splits when its heads, channels or
    experts divide the world and each column slice keeps ``align``:
    attention when q and KV heads both divide; the RG-LRU when its width
    and its 16 gate blocks do; SSD when its heads do; MLA when its q heads
    do; the experts when E does."""
    from repro_torch.models.layers import RG_BLOCKS
    n, a = pctx.world, pctx.align
    keeps = lambda width: width > 0 and width % n == 0 \
        and (width // n) % a == 0                          # noqa: E731
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    e = cfg.moe
    lay = dict(
        attn=cfg.mla is None and H > 0 and H % n == 0 and Hkv % n == 0
        and keeps(H * cfg.hd),
        mlp=keeps(e.d_ff_expert * e.n_shared if e is not None else cfg.d_ff),
        vocab=cfg.vocab % n == 0)
    if cfg.hybrid is not None:
        dr = cfg.hybrid.d_rnn or cfg.d_model
        lay["rec"] = RG_BLOCKS % n == 0 and keeps(dr)
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        lay["ssd"] = (di // s.head_dim) % n == 0 and keeps(di)
    if cfg.mla is not None:
        lay["mla"] = H % n == 0 and keeps(H * cfg.mla.v_head_dim)
    if e is not None:
        lay["experts"] = e.n_experts % n == 0
    if n == 1:
        lay = {k: True for k in lay}
    return TPLayout(**lay)


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
    """The config of one rank's slice, where a config field can hold it: q
    and KV heads per rank where attention splits (head_dim pinned), q heads
    where MLA splits, the dense MLP's width and the RG-LRU's ``d_rnn`` per
    rank where they split.  Two local widths no field can hold are read
    from the slices' shapes by the model code instead: SSD's heads (the
    rank's ``A_log``; ``SSMCfg.expand`` is an int) and the rank's experts
    (its expert stack; the router keeps the global ``n_experts`` for its
    top-k)."""
    if pctx is None or pctx.layout is None or pctx.world == 1:
        return cfg
    n, lay = pctx.world, pctx.layout
    kw = {}
    if lay.attn:
        kw.update(n_heads=cfg.n_heads // n, n_kv_heads=cfg.n_kv_heads // n,
                  head_dim=cfg.hd)
    if lay.mla:
        kw.update(n_heads=cfg.n_heads // n)
    if lay.mlp and cfg.moe is None:
        kw.update(d_ff=cfg.d_ff // n)
    if lay.rec:
        h = cfg.hybrid
        kw.update(hybrid=dataclasses.replace(
            h, d_rnn=(h.d_rnn or cfg.d_model) // n))
    return dataclasses.replace(cfg, **kw) if kw else cfg


# (regex on path, the blocks it may belong to, first present one wins):
# weight names, not the ``.mix.`` level, decide, since an RG-LRU's w_in
# and a windowed attention's wq sit at the same level and decide apart
_BLOCKS = [
    (r"\.(mix|xattn)\.(wq|wo)$",                  ("mla", "attn")),
    (r"\.(mix|xattn)\.(wk|wv|qnorm|knorm)(\.|$)", ("attn",)),
    (r"\.mix\.(wkv_a|wkv_b|kv_norm)(\.|$)",        ("mla",)),
    (r"\.mix\.(w_branch|w_in|w_gate_[ax]|conv_w|log_lambda)$", ("rec",)),
    (r"\.mix\.w_out$",                            ("rec", "ssd")),
    (r"\.mix\.(w_z|w_x|w_B|w_C|w_dt|conv_[xBC]|A_log|Dskip|dt_bias|norm)"
     r"(\.|$)",                                    ("ssd",)),
    (r"\.mlp\.experts\.",                         ("experts",)),
    (r"\.mlp\.router$",                           ()),
    (r"\.mlp\.",                                  ("mlp",)),
    (r"(^|\.)(embed|lm_head)$",                    ("vocab",)),
]

# per-channel leaves of a split block that the reference's rules replicate
# (``P(None)``, ``P(None, None)``: GSPMD slices them implicitly where they
# meet the sharded width); here the rank holds its channels explicitly
_CHANNELS = (r"\.mix\.(conv_w|log_lambda|conv_x|A_log|Dskip|dt_bias)$"
             r"|\.mix\.norm\.gamma$")


def _block_of(path_str: str, layout) -> Optional[str]:
    for pat, blocks in _BLOCKS:
        if re.search(pat, path_str):
            return next((b for b in blocks
                         if getattr(layout, b) is not None), None)
    return None


def split_of(path_str: str, pctx: Optional[ParallelCtx]) -> Optional[str]:
    """'row' (output features split), 'col' (input features split),
    'expert' (whole experts split) or None (replicated) for the weight at
    ``path_str`` under ``pctx``'s bound layout."""
    if pctx is None or pctx.layout is None:
        return None
    block = _block_of(path_str, pctx.layout)
    if block is None or not getattr(pctx.layout, block):
        return None
    if block == "experts":
        return "expert"
    spec = spec_for_path(path_str, 2, pctx.model_axis, stacked=False)
    if len(spec) != 2:
        return None
    return {0: "row", 1: "col"}.get(
        next((i for i, a in enumerate(spec) if a == pctx.model_axis), None))


# ----------------------------------------------------------- placement

def _leaf_spec(ps: str, leaf, pctx: ParallelCtx) -> P:
    in_stack = "stack" in ps
    spec = spec_for_path(ps, leaf.dim(), pctx.model_axis, stacked=in_stack)
    lay = pctx.layout
    if lay is not None:
        block = _block_of(ps, lay)
        if block is None or not getattr(lay, block):
            return P(*([None] * leaf.dim()))
        if re.search(_CHANNELS, ps):        # the rank's channels or heads
            spec = P(*([None] * (leaf.dim() - 1)), pctx.model_axis)
    return divisible_spec(spec, tuple(leaf.shape), pctx.mesh)


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


def _names(ax) -> tuple:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def axis_split(ax, pctx: ParallelCtx) -> tuple:
    """(ranks, this rank's index) that a spec entry splits a dimension
    over: the model axis, the data axes, or both (data major, as a
    (data, model) mesh orders its devices); (1, 0) for None."""
    names = _names(ax)
    n, r = 1, 0
    if any(a in pctx.data_axes for a in names):
        n, r = pctx.dp_world, pctx.dp_rank
    if pctx.model_axis in names:
        n, r = n * pctx.world, r * pctx.world + pctx.rank
    return n, r


def rank_slices(spec, shape, pctx: ParallelCtx) -> tuple:
    """This rank's slice of an array of ``shape`` along every dimension
    ``spec`` puts on the model or the data axes, one slice per dimension."""
    out = []
    for i, d in enumerate(shape):
        n, r = axis_split(spec[i] if i < len(spec) else None, pctx)
        out.append(slice(r * (d // n), (r + 1) * (d // n)))
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec, pctx: ParallelCtx) -> torch.Tensor:
    """This rank's slice of ``t`` (:func:`rank_slices`; a copy, so the
    whole can be freed; ``t`` itself where the slice is the whole)."""
    if t is None or spec is None:
        return t
    idx = rank_slices(spec, t.shape, pctx)
    if all(s.stop - s.start == d for s, d in zip(idx, t.shape)):
        return t
    return t[idx].contiguous().clone()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec read on a context: the reference's ``NamedSharding(mesh,
    spec)``, where a rank holds its slice of the global array.
    :meth:`local` cuts the rank's slice from the whole; :meth:`gather`
    rebuilds the whole from every rank's slice (all-gathers over the
    model axis, then the data axis: every rank of the mesh calls it)."""
    pctx: ParallelCtx
    spec: P

    def dims(self, axis: str) -> list:
        """The dimensions split over ``axis`` ('model' or 'data') by more
        than one rank."""
        if axis == "model":
            hit, n = (lambda a: self.pctx.model_axis in _names(a),
                      self.pctx.world)
        else:
            hit, n = (lambda a: any(x in self.pctx.data_axes
                                    for x in _names(a)), self.pctx.dp_world)
        return [i for i, a in enumerate(self.spec) if hit(a)] if n > 1 else []

    def index(self, shape) -> tuple:
        """The rank's slice of an array of the global ``shape``, one slice
        per dimension."""
        return rank_slices(self.spec, shape, self.pctx)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return shard_tensor(t, self.spec, self.pctx)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        from . import comm
        with torch.no_grad():
            for axis in ("model", "data"):
                for i in self.dims(axis):
                    t = comm.all_gather(t, self.pctx, dim=i, axis=axis)
        return t


# the leaves the placement keeps whole inside a split block while each rank
# reads them for its own share only, so that each rank's gradient is a
# partial sum, and the block (regex on path, block): a qk-norm's gammas
# (the rank's heads), SSD's B, C and dt projections and the B and C convs
# (the rank's heads: ``models/layers.py:_ssd_split``), the MoE router (the
# rank's experts, or its chunk of the tokens).  MLA's ``wkv_a`` and
# ``kv_norm`` are whole but not partial: the latent enters through
# ``wkv_b``'s row linear and the rope key enters on its own
# (``models/layers.py:_mla_kv``), so both cotangents are whole on every
# rank before they reach them.
_PARTIAL = [
    (r"\.mix\.(qnorm|knorm)\.", "attn"),
    (r"\.mix\.(w_B|w_C|w_dt|conv_B|conv_C)$", "ssd"),
    (r"\.mlp\.router$", "experts"),
]


def partial_grad(path_str: str, spec, pctx: Optional[ParallelCtx]) -> bool:
    """Whether each model rank's gradient of the leaf at ``path_str`` is a
    partial sum (:data:`_PARTIAL`, where the layout splits its block and
    ``spec`` keeps it whole), which the trainer sums over the model
    axis."""
    if pctx is None or pctx.layout is None or pctx.world == 1 \
            or pctx.model_axis in [a for ax in spec for a in _names(ax)]:
        return False
    return any(re.search(pat, path_str) and bool(getattr(pctx.layout, b))
               for pat, b in _PARTIAL)


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
    it, the per-expert rows (L, E, d) of split experts keep the rank's
    experts; every other leaf is replicated (the full input)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,)) for i, v in enumerate(tree))
        if not isinstance(tree, torch.Tensor):
            return tree
        sp = split_of(_path_str(path), pctx)
        dim = {"col": tree.dim() - 1, "expert": tree.dim() - 2}.get(sp)
        if dim is None:
            return tree
        spec = [None] * tree.dim()
        spec[dim] = pctx.model_axis
        return shard_tensor(tree, P(*spec), pctx)
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
    replicated, where the reference shards its sequence dim.  Two
    differences from the reference's spec: SSD's ``conv_B``/``conv_C``
    histories stay whole (they feed the whole B and C, which every rank
    computes), where the copied (B, W, ch) rule split every ``conv*``; and
    under a bound layout a recurrent state splits only with its block
    (``h`` (B, dr) and ``conv`` with ``rec``, ``h`` (B, H, P, N) and
    ``conv_x`` with ``ssd``)."""
    mesh, m = pctx.mesh, pctx.model_axis
    dp = pctx.dp if batch_axes is None else batch_axes
    msize = _axis_size(mesh, m)
    lay = pctx.layout
    ok = lambda block: lay is None or bool(getattr(lay, block))  # noqa: E731

    def per_leaf(ps, leaf):
        nd = leaf.dim()
        lead = 1 if re.match(r"stack\.\d+\.", ps) or ".u" in ps else 0
        core = nd - lead
        if "enc_out" in ps:
            spec = P(dp, None, None)
        elif paged and re.search(r"\.(k|v)(_q|_s)?$", ps) and core == 4:
            spec = P(None, m if ok("attn") else None, None, None)
        elif re.search(r"\.(k|v|xk|xv)(_q|_s)?$", ps) and core == 4:
            hkv = leaf.shape[lead + 1]
            if hkv % msize == 0 and ok("attn"):
                spec = P(dp, m, seq_axis, None)
            else:
                spec = P(dp, None, seq_axis, None)
        elif re.search(r"\.(latent|k_rope)$", ps) and core == 3:
            spec = P(dp, seq_axis, None)
        elif re.search(r"\.h$", ps) and core == 2:
            spec = P(dp, m if ok("rec") else None)
        elif re.search(r"\.h$", ps) and core == 4:
            spec = P(dp, m if ok("ssd") else None, None, None)
        elif re.search(r"\.conv(_x)?$", ps) and core == 3:
            block = "ssd" if ps.endswith("_x") else "rec"
            spec = P(dp, None, m if ok(block) else None)
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
