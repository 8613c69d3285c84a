"""Whole-model quantization: join parameters ↔ activation statistics by path.

Per parameter path: resolve the effective policy (``overrides``), resolve
its method through the registry, find the statistics leaf (``STAT_ALIAS``
joins projections that share a tapped input), and quantize.

* :func:`quantize_params` — the eager per-leaf path (reference semantics);
* :class:`FusedRequantPlan` — the serving path: leaves grouped into
  families by the reference's key ``(d', d, qcfg, acfg, method, packed,
  has_ba, rank)`` (``api.py:299`` of the JAX package).  With the packed
  policy and ``kernel.use_pallas`` each member's whole layer stack goes
  through ONE ``ttq_quantize`` launch that reads the bf16 stack in place
  and applies D in f32 inside the kernel — the reference's
  ``concatenate(... .astype(float32))`` would need 16.9 GB for gemma-7b's
  wg/wu family alone.  A member with low-rank factors quantizes the f32
  residual W − B·A instead, formed a chunk of layers at a time
  (``RESIDUAL_BYTES``), one launch per chunk.  A MoE expert stack (n, E,
  d′, d) is one member of n·E rows: D per expert row, one launch.  A
  member whose policy has ``rank > 0`` but no factors in the low-rank tree
  (the reference's ``lowrank_tree`` gives a 4-D expert stack none) is a
  family of its own, keyed ``("eager", path)``, quantized per weight with
  an inline SVD, as the reference's eager fallback (``api.py:285-292``
  there).  ``drift``/``gate`` are the reference's delta gate: ``run(only=)``
  requantizes the drifted families.  ``pctx``: each rank quantizes its own
  slice of every weight in place (the reference's shard-local plan,
  ``api.py:227-235,393-395`` there).  The codes, S and Z are per output row
  and per group, so a row slice needs nothing from the other ranks; D is
  per input column but its blend form reads the mean over all columns, so
  a column-split weight's statistics (and, for the gate's drift, its last
  D) are gathered whole, D is computed as world 1 computes it, and the
  rank keeps its slice: every child is bit for bit the slice of world 1's.
  An expert stack split over the ranks (the rank's whole experts) needs
  nothing from the others: D per expert from the rank's experts' rows of
  the statistics, and an eager member's inline SVD is of whole experts.
  A weight split by rows or columns with no factors (``lowrank=None``
  under a mesh) gathers each layer's whole weight once, when the plan is
  built, takes its SVD as world 1 does and keeps the rank's slice of B
  (rows) or A (columns): the SVD of a slice is not the slice of the SVD.
  From then on it is a member with factors, quantized like any other.
* :func:`lowrank_tree` — the data-free SVD factors, computed once per model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch._tree import tree_leaves_with_path as _walk
from repro_torch.core.awq import AWQConfig
from repro_torch.core.lowrank import residual, svd_factors
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qdq import pack_bits, quantize
from repro_torch.core.ttq import QuantizedTensor
from repro_torch.parallel import comm
from repro_torch.parallel.rules import constrain_qt, split_of

# R = W − B·A is formed in f32 at most this many bytes at a time (a chunk of
# one stack's layers) before the kernel quantizes it: gemma-7b's 28-layer
# wg stack alone is 8.5 GB in f32.
RESIDUAL_BYTES = 4 << 30

# the stacked subtrees whose weights are joined to statistics by path
STACKS = ("stack", "enc_stack")

# projections sharing their input with a tapped sibling (one tap per input);
# the cross-attention's wk/wv take wq's statistics although their input is
# the encoder output (the reference's join, kept as it is)
STAT_ALIAS = {"wk": "wq", "wv": "wq", "wkv_a": "wq", "wu": "wg",
              "w_in": "w_branch", "w_z": "w_x", "w_B": "w_x", "w_C": "w_x",
              "w_dt": "w_x"}


def _path_str(path) -> str:
    return ".".join(str(p) for p in path)


def _stats_key(rel_path: tuple) -> str:
    """('u0','mix','wk') → 'u0.mix.wq' (alias on the leaf name)."""
    *head, leaf = rel_path
    return ".".join([*head, STAT_ALIAS.get(leaf, leaf)])


def _replace(tree, results: Dict[str, object], path=()):
    if isinstance(tree, dict):
        return {k: _replace(v, results, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, results, path + (i,))
                          for i, v in enumerate(tree))
    return results.get(_path_str(path), tree)


def _tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _map_paths(fn, tree, path=()):
    """The tree with every leaf replaced by ``fn(path string, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(_path_str(path), tree)


def _stat_key_in(run: dict, rel: tuple) -> Optional[str]:
    """The key of ``rel``'s statistics in one run's stats dict, or None:
    the aliased path, else an expert weight's ``experts.wg`` (wg, wu) or
    ``experts.wd`` (the reference's ``_lookup_stats``)."""
    key = _stats_key(rel)
    if key in run:
        return key
    if rel[-1] in ("wg", "wu", "wd") and "experts" in rel:
        key = ".".join([*rel[:-1], "wg" if rel[-1] in ("wg", "wu") else "wd"])
        if key in run:
            return key
    return None


def _stat_for(stats, parts):
    """The stats leaf (lead..., d) for a parameter path, or None."""
    if parts[0] not in STACKS or not stats or parts[0] not in stats:
        return None
    run = stats[parts[0]][int(parts[1])]
    key = _stat_key_in(run, tuple(parts[2:]))
    return None if key is None else run[key]


def _eligible(base: QuantPolicy, ps: str, leaf) -> Optional[QuantPolicy]:
    if not isinstance(leaf, torch.Tensor) or not 2 <= leaf.dim() <= 4:
        return None
    eff = base.resolve(ps)
    if not eff.quantizes(ps.split(".")[-1]) or not eff.quantizes(ps):
        return None
    return eff


def _factored(eff: QuantPolicy, shape) -> bool:
    """Whether the policy gives a (d′, d) weight low-rank factors."""
    return eff.rank > 0 and min(shape) > eff.rank


def lowrank_tree(params, policy: QuantPolicy):
    """Data-free SVD factors for every quantizable 2/3-D weight whose
    resolved policy has ``rank > 0``: the params' structure with a {'B',
    'A'} pair of stacked factors ((lead..., d', r), (lead..., r, d), in the
    weight's dtype) at each such weight and None elsewhere; None when no
    path resolves to rank > 0.  Computed once per model, one layer's SVD at
    a time; requantization reuses it and never re-runs the SVD."""
    found = False

    def per_leaf(ps, leaf):
        nonlocal found
        eff = policy.resolve(ps)
        if not (isinstance(leaf, torch.Tensor) and leaf.dim() in (2, 3)
                and eff.quantizes(ps.split(".")[-1]) and eff.quantizes(ps)
                and _factored(eff, leaf.shape[-2:])):
            return None
        found = True
        fs = [svd_factors(w, eff.rank)
              for w in leaf.reshape(-1, *leaf.shape[-2:])]
        lead = leaf.shape[:-2]
        return {k: torch.stack([f[i] for f in fs]).reshape(
            *lead, *fs[0][i].shape) for i, k in enumerate(("B", "A"))}

    tree = _map_paths(per_leaf, params)
    return tree if found else None


def _row_qcfg(eff: QuantPolicy):
    q = eff.qcfg
    return q if q.layout == "row" else dataclasses.replace(q, layout="row")


def quantize_params(params, stats, policy: QuantPolicy, *, count=1.0,
                    acfg: Optional[AWQConfig] = None, lowrank_tree=None):
    """Eager per-leaf path: every quantizable stacked weight becomes a
    stacked :class:`QuantizedTensor`; untapped, skipped or disabled leaves
    stay in full precision.  A weight with ``rank > 0`` takes its factors
    from ``lowrank_tree``, or runs the SVD inline when it has none there."""
    base = policy if acfg is None else policy.with_(acfg=acfg)
    results = {}
    for path, leaf in _walk(params):
        ps = _path_str(path)
        eff = _eligible(base, ps, leaf)
        if eff is None:
            continue
        qz = eff.quantizer
        stat = _stat_for(stats, ps.split("."))
        if qz.requires_stats and stat is None:
            continue
        if stat is None:
            if (leaf.dim() < 3) if path[0] in STACKS else leaf.dim() != 2:
                continue        # a stacked (L, d) vector is no weight
            stat = torch.zeros(leaf.shape[:-2] + leaf.shape[-1:],
                               dtype=torch.float32, device=leaf.device)
        lead = leaf.shape[:-2]
        Ws = leaf.reshape(-1, *leaf.shape[-2:])
        Ss = stat.reshape(-1, stat.shape[-1])
        ba = None if lowrank_tree is None else _tree_get(lowrank_tree, path)
        if ba is not None:
            fs = list(zip(*(ba[k].reshape(-1, *ba[k].shape[-2:])
                            for k in ("B", "A"))))
        elif _factored(eff, leaf.shape[-2:]):
            fs = [svd_factors(w, eff.rank) for w in Ws]
        else:
            fs = [(None, None)] * Ws.shape[0]
        qts = [qz.quantize_weight(Ws[i], Ss[i], count, eff, eff.acfg, *fs[i])
               for i in range(Ws.shape[0])]
        results[ps] = _stack_qts(qts, lead)
    return _replace(params, results)


def _stack_qts(qts: List[QuantizedTensor], lead) -> QuantizedTensor:
    def st(f):
        xs = [getattr(q, f) for q in qts]
        if xs[0] is None:
            return None
        return torch.stack(xs).reshape(*lead, *xs[0].shape)
    return dataclasses.replace(qts[0], **{f: st(f) for f in (
        "wint", "packed", "scale", "zero", "dinv", "B", "A")})


@dataclasses.dataclass
class _Member:
    path: tuple
    path_str: str
    lead: tuple
    dp: int
    d: int
    eff: QuantPolicy
    stat_key: Optional[tuple]      # (run index, stats key) or None → zeros
    stat_tree: str = "stack"       # the stats subtree: "stack", "enc_stack"
    split: Optional[str] = None    # 'row' | 'col' under tensor parallelism


class FusedRequantPlan:
    """Whole-model requantization grouped by weight family; built once per
    (params structure, stats structure, policy).  A weight whose policy has
    ``rank > 0`` takes its factors from ``lowrank_tree`` (the same tree is
    passed to :meth:`run`); one that has none there is an eager family
    ``("eager", path)`` that runs the SVD inline at every requant.
    ``pctx``: ``params``, ``stats`` and the factors are the rank's slices
    (see the module docstring); a row- or column-split weight with none
    there takes the rank's slice of its whole weight's factors, computed
    here once, and joins its family as a member with factors."""

    def __init__(self, params, stats, policy: QuantPolicy, *,
                 acfg: Optional[AWQConfig] = None, lowrank_tree=None,
                 pctx=None):
        base = policy if acfg is None else policy.with_(acfg=acfg)
        self.policy = policy
        self.pctx = pctx
        self._tp = pctx is not None and pctx.world > 1
        self.families: Dict[tuple, List[_Member]] = {}
        self._split_ba: Dict[str, dict] = {}   # split members' own factors
        for path, leaf in _walk(params):
            ps = _path_str(path)
            eff = _eligible(base, ps, leaf)
            if eff is None:
                continue
            parts = ps.split(".")
            stat_key = None
            if eff.quantizer.requires_stats:
                if _stat_for(stats, parts) is None:
                    continue
                stat_key = (int(parts[1]), _stat_key_in(
                    stats[parts[0]][int(parts[1])], tuple(parts[2:])))
            elif parts[0] not in STACKS or leaf.dim() < 3:
                continue
            dp, d = leaf.shape[-2:]
            has_ba = (lowrank_tree is not None
                      and _tree_get(lowrank_tree, path) is not None)
            member = _Member(path=tuple(path), path_str=ps,
                             lead=tuple(leaf.shape[:-2]), dp=dp, d=d,
                             eff=eff, stat_key=stat_key, stat_tree=parts[0],
                             split=split_of(ps, pctx))
            n = pctx.world if self._tp else 1      # the whole weight's shape
            whole = {"row": (dp * n, d), "col": (dp, d * n)}.get(
                member.split, (dp, d))
            if not has_ba and _factored(eff, whole):
                if not (self._tp and member.split in ("row", "col")):
                    self.families[("eager", ps)] = [member]
                    continue
                self._split_ba[ps] = self._whole_factors(member, leaf)
                has_ba = True
            key = (dp, d, _row_qcfg(eff), eff.acfg, eff.method, eff.packed,
                   has_ba, eff.rank)
            self.families.setdefault(key, []).append(member)

    @property
    def n_layers(self) -> int:
        return sum(len(ms) for ms in self.families.values())

    def _kernel_ok(self, key) -> bool:
        dp, d, qcfg, _, _, packed_on, _, _ = key
        per = 32 // qcfg.bits if 32 % qcfg.bits == 0 else 0
        return (packed_on and per > 0 and d % per == 0
                and self.policy.kernel.use_pallas and qcfg.bits in (2, 4, 8)
                and not qcfg.symmetric and qcfg.nu == 1.0)

    def _diag(self, m: _Member, stat, count, n: int):
        """D (n, d) of a member's layers: for a column-split weight under
        tensor parallelism from the gathered whole statistics, sliced to the
        rank's columns."""
        qz, d = m.eff.quantizer, m.d
        if not (self._tp and m.split == "col"):
            return qz.diag(stat.reshape(-1, d), count, m.eff.acfg, d)
        full = comm.all_gather(stat.reshape(-1, d), self.pctx, dim=-1)
        D = qz.diag(full, count, m.eff.acfg, full.shape[-1])
        r = self.pctx.rank
        return D[:, r * d:(r + 1) * d].contiguous()

    def _run_member(self, key, m: _Member, W, stat, count, ba=None,
                    into=None):
        """One member's layer stack: D, then quantize the stack — one
        ``ttq_quantize`` launch on the kernel path (one per chunk of layers
        of the residual W − B·A where ``ba`` holds factors).  ``into``: the
        member's leaf of an earlier tree of this plan, overwritten in place
        and returned (the kernel writes its codes, S and Z there; 1/D, and
        on the plain path every field, is copied in; B and A never change
        and stay where they are)."""
        dp, d, qcfg, acfg, method, packed_on, _, _ = key
        qz = m.eff.quantizer
        W = W.reshape(-1, dp, d)                       # a view, no copy
        n = W.shape[0]
        if stat is None:
            stat = torch.zeros((n, d), dtype=torch.float32, device=W.device)
        D = self._diag(m, stat, count, n)                          # (n, d)
        B = A = None
        if ba is not None:
            B, A = (ba[k].reshape(n, *ba[k].shape[-2:]) for k in ("B", "A"))
        per = 32 // qcfg.bits if 32 % qcfg.bits == 0 else 0
        packable = packed_on and per > 0 and d % per == 0
        flat = lambda x: x.reshape(n, *x.shape[len(m.lead):])
        shaped = lambda x: None if x is None else x.reshape(*m.lead,
                                                            *x.shape[1:])
        wint = pk = None
        written = ()
        if self._kernel_ok(key):
            from repro_torch.kernels import ops as kops
            kw = dict(bits=qcfg.bits, group_size=qcfg.group_size)
            out = None
            if into is not None:
                written = ("packed", "scale", "zero")
                out = tuple(flat(getattr(into, f)) for f in written)
            if out is None:
                out = (W.new_empty((n, dp, d // per), dtype=torch.int32),
                       *(W.new_empty((n, dp, d // qcfg.group_size),
                                     dtype=torch.float32) for _ in range(2)))
            step = n if B is None else max(1, RESIDUAL_BYTES // (dp * d * 4))
            for i in range(0, n, step):
                j = slice(i, i + step)
                Wj = W[j] if B is None else residual(W[j], B[j], A[j])
                kops.ttq_quantize(Wj, D[j], out=tuple(o[j] for o in out),
                                  **kw)
            pk, Sc, Z = out
        else:
            Wf = W.float() if B is None else residual(W, B, A)
            Ws = (Wf * D[:, None, :]).reshape(n * dp, d)
            wint, Sc, Z = quantize(Ws, qcfg)
            wint = wint.reshape(n, dp, d)
            Sc, Z = Sc.reshape(n, dp, -1), Z.reshape(n, dp, -1)
            if packable:
                pk, wint = pack_bits(wint, qcfg.bits), None
        fields = dict(wint=wint, packed=pk, scale=Sc, zero=Z,
                      dinv=(1.0 / D).float())
        if into is not None:
            for f, x in fields.items():
                if x is not None and f not in written:
                    getattr(into, f).copy_(shaped(x))
            return into
        factors = dict(B=None, A=None) if ba is None else ba
        qt = QuantizedTensor(
            **{f: shaped(x) for f, x in fields.items()}, B=factors["B"],
            A=factors["A"], bits=qcfg.bits, group_size=qcfg.group_size,
            out_features=dp, in_features=d)
        if self.pctx is not None:
            constrain_qt(m.path_str, qt, self.pctx, (dp, d))
        return qt

    def _whole_factors(self, m: _Member, W) -> dict:
        """The rank's slice of the factors of a row- or column-split
        member's whole weights: each layer's slice gathered over the model
        axis, its SVD taken as world 1 takes it, B's rows (a row split) or
        A's columns (a column split) kept."""
        r, dim = self.pctx.rank, -2 if m.split == "row" else -1
        fs = []
        for w in W.reshape(-1, m.dp, m.d):
            B, A = svd_factors(comm.all_gather(w, self.pctx, dim=dim),
                               m.eff.rank)
            if m.split == "row":
                B = B[r * m.dp:(r + 1) * m.dp]
            else:
                A = A[:, r * m.d:(r + 1) * m.d]
            fs.append((B.contiguous(), A.contiguous()))
        return {k: torch.stack([f[i] for f in fs]).reshape(
            *m.lead, *fs[0][i].shape) for i, k in enumerate(("B", "A"))}

    def _run_eager(self, m: _Member, W, stat, count, into=None):
        """An eager member: each (d′, d) weight of the stack quantized by
        its quantizer with factors from an inline SVD (the reference's
        per-leaf fallback).  ``into``: its fields a requant writes are
        overwritten in place; its B and A, the SVD of the same weights,
        stay as they are."""
        eff = m.eff
        Ws = W.reshape(-1, m.dp, m.d)
        Ss = (torch.zeros((Ws.shape[0], m.d), dtype=torch.float32,
                          device=W.device)
              if stat is None else stat.reshape(-1, m.d))
        qt = _stack_qts([eff.quantizer.quantize_weight(
            Ws[i], Ss[i], count, eff, eff.acfg, *svd_factors(Ws[i], eff.rank))
            for i in range(Ws.shape[0])], m.lead)
        if into is None:
            return qt
        for f in ("wint", "packed", "scale", "zero", "dinv"):
            if getattr(into, f) is not None:
                getattr(into, f).copy_(getattr(qt, f))
        return into

    def _stat(self, stats, m: _Member):
        return None if m.stat_key is None else \
            stats[m.stat_tree][m.stat_key[0]][m.stat_key[1]]

    def run(self, params, stats, count, lowrank_tree=None, *, only=None,
            into=None):
        """The quantized parameter tree (fp leaves shared, not copied).
        ``into``: a tree this plan returned earlier; its quantized leaves
        are overwritten in place and it is returned, so its storage stays
        where a captured decode graph reads it.  ``only`` (a set of family
        keys, the delta gate's): requantize those families alone; the
        others are left as they are in ``into`` (full precision in a new
        tree)."""
        results = {}
        for key, members in self.families.items():
            if only is not None and key not in only:
                continue
            if key[0] == "eager":
                m = members[0]
                results[m.path_str] = self._run_eager(
                    m, _tree_get(params, m.path), self._stat(stats, m), count,
                    None if into is None else _tree_get(into, m.path))
                continue
            has_ba = key[6]
            for m in members:
                ba = (self._split_ba.get(m.path_str)
                      or _tree_get(lowrank_tree, m.path)) if has_ba else None
                results[m.path_str] = self._run_member(
                    key, m, _tree_get(params, m.path), self._stat(stats, m),
                    count, ba,
                    None if into is None else _tree_get(into, m.path))
        return into if into is not None else _replace(params, results)

    # ------------------------------------------------------------ delta gate

    def drift(self, stats, count, last_D: Dict[str, torch.Tensor]
              ) -> Dict[str, float]:
        """Relative-L2 drift of each member's activation diagonal D since
        its snapshot in ``last_D`` ({path: (lead..., d) f32}), the largest
        over the member's layers; members without a snapshot are omitted
        (the gate requantizes them).  Computed on the device, then one
        host transfer of the per-member scalars; under tensor parallelism
        the largest over the ranks (a split expert stack's drift is its
        rank's experts'), so every rank's gate takes the same families."""
        tracked = [m for ms in self.families.values() for m in ms
                   if m.path_str in last_D]
        if not tracked:
            return {}
        vals = []
        for m in tracked:
            Dp = last_D[m.path_str].reshape(-1, m.d)
            s = self._stat(stats, m)
            s = torch.zeros_like(Dp) if s is None else s.reshape(-1, m.d)
            d = m.d
            if self._tp and m.split == "col":   # the whole D, as world 1
                Dp, s = (comm.all_gather(t, self.pctx, dim=-1)
                         for t in (Dp, s))
                d = Dp.shape[-1]
            Dn = m.eff.quantizer.diag(s, count, m.eff.acfg, d)
            num = torch.linalg.vector_norm(Dn - Dp, dim=-1)
            den = torch.linalg.vector_norm(Dp, dim=-1) + 1e-12
            vals.append((num / den).max())
        host = torch.stack(vals).cpu().tolist()        # the one transfer
        if self._tp:            # split experts' drifts are the rank's own
            host = comm.agree(host, self.pctx, "max")
        return {m.path_str: v for m, v in zip(tracked, host)}

    def gate(self, drifts: Dict[str, float], threshold: float,
             have: set) -> tuple:
        """(family keys to requantize, members requantized, members
        skipped): a family requantizes when any member drifted by at least
        ``threshold`` or has no previous QuantizedTensor (``have`` = the
        paths that do)."""
        only = set()
        n_requant = n_skip = 0
        for key, members in self.families.items():
            if any(m.path_str not in have
                   or drifts.get(m.path_str, float("inf")) >= threshold
                   for m in members):
                only.add(key)
                n_requant += len(members)
            else:
                n_skip += len(members)
        return only, n_requant, n_skip
