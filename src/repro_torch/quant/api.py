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
  wg/wu family alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core.awq import AWQConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qdq import pack_bits, quantize
from repro_torch.core.ttq import QuantizedTensor

# projections sharing their input with a tapped sibling (one tap per input)
STAT_ALIAS = {"wk": "wq", "wv": "wq", "wkv_a": "wq", "wu": "wg",
              "w_in": "w_branch", "w_z": "w_x", "w_B": "w_x", "w_C": "w_x",
              "w_dt": "w_x"}


def _path_str(path) -> str:
    return ".".join(str(p) for p in path)


def _stats_key(rel_path: tuple) -> str:
    """('u0','mix','wk') → 'u0.mix.wq' (alias on the leaf name)."""
    *head, leaf = rel_path
    return ".".join([*head, STAT_ALIAS.get(leaf, leaf)])


def _walk(tree, path=()):
    """Yield (path, leaf) for the tensor leaves of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


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


def _stat_for(stats, parts):
    """The stats leaf (lead..., d) for a parameter path, or None."""
    if parts[0] != "stack" or not stats or "stack" not in stats:
        return None
    run = stats["stack"][int(parts[1])]
    return run.get(_stats_key(tuple(parts[2:])))


def _eligible(base: QuantPolicy, ps: str, leaf) -> Optional[QuantPolicy]:
    if not isinstance(leaf, torch.Tensor) or not 2 <= leaf.dim() <= 4:
        return None
    eff = base.resolve(ps)
    if not eff.quantizes(ps.split(".")[-1]) or not eff.quantizes(ps):
        return None
    if eff.rank > 0:
        raise NotImplementedError(
            "low-rank SVD init (rank > 0) is ported in a later slice; a "
            "bridged B/A still runs in ttq_matmul")
    return eff


def _row_qcfg(eff: QuantPolicy):
    q = eff.qcfg
    return q if q.layout == "row" else dataclasses.replace(q, layout="row")


def quantize_params(params, stats, policy: QuantPolicy, *, count=1.0,
                    acfg: Optional[AWQConfig] = None):
    """Eager per-leaf path: every quantizable stacked weight becomes a
    stacked :class:`QuantizedTensor`; untapped, skipped or disabled leaves
    stay in full precision."""
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
            stat = torch.zeros(leaf.shape[:-2] + leaf.shape[-1:],
                               dtype=torch.float32, device=leaf.device)
        lead = leaf.shape[:-2]
        Ws = leaf.reshape(-1, *leaf.shape[-2:])
        Ss = stat.reshape(-1, stat.shape[-1])
        qts = [qz.quantize_weight(Ws[i], Ss[i], count, eff, eff.acfg)
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


class FusedRequantPlan:
    """Whole-model requantization grouped by weight family; built once per
    (params structure, stats structure, policy)."""

    def __init__(self, params, stats, policy: QuantPolicy, *,
                 acfg: Optional[AWQConfig] = None):
        base = policy if acfg is None else policy.with_(acfg=acfg)
        self.policy = policy
        self.families: Dict[tuple, List[_Member]] = {}
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
                stat_key = (int(parts[1]), _stats_key(tuple(parts[2:])))
            elif parts[0] != "stack" or leaf.dim() < 3:
                continue
            dp, d = leaf.shape[-2:]
            key = (dp, d, _row_qcfg(eff), eff.acfg, eff.method, eff.packed,
                   False, eff.rank)
            self.families.setdefault(key, []).append(_Member(
                path=tuple(path), path_str=ps, lead=tuple(leaf.shape[:-2]),
                dp=dp, d=d, eff=eff, stat_key=stat_key))

    @property
    def n_layers(self) -> int:
        return sum(len(ms) for ms in self.families.values())

    def _kernel_ok(self, key) -> bool:
        dp, d, qcfg, _, _, packed_on, _, _ = key
        per = 32 // qcfg.bits if 32 % qcfg.bits == 0 else 0
        return (packed_on and per > 0 and d % per == 0
                and self.policy.kernel.use_pallas and qcfg.bits in (2, 4, 8)
                and not qcfg.symmetric and qcfg.nu == 1.0)

    def _run_member(self, key, m: _Member, W, stat, count, into=None):
        """One member's layer stack: D, then quantize the stack — one
        ``ttq_quantize`` launch on the kernel path.  ``into``: the member's
        leaf of an earlier tree of this plan, overwritten in place and
        returned (the kernel writes its codes, S and Z there; 1/D, and on
        the plain path every field, is copied in)."""
        dp, d, qcfg, acfg, method, packed_on, _, _ = key
        qz = m.eff.quantizer
        W = W.reshape(-1, dp, d)                       # a view, no copy
        n = W.shape[0]
        if stat is None:
            stat = torch.zeros((n, d), dtype=torch.float32, device=W.device)
        D = qz.diag(stat.reshape(-1, d), count, acfg, d)          # (n, d)
        per = 32 // qcfg.bits if 32 % qcfg.bits == 0 else 0
        packable = packed_on and per > 0 and d % per == 0
        flat = lambda x: x.reshape(n, *x.shape[len(m.lead):])
        shaped = lambda x: None if x is None else x.reshape(*m.lead,
                                                            *x.shape[1:])
        wint = pk = None
        written = ()
        if self._kernel_ok(key):
            from repro_torch.kernels import ops as kops
            out = None
            if into is not None:
                written = ("packed", "scale", "zero")
                out = tuple(flat(getattr(into, f)) for f in written)
            pk, Sc, Z = kops.ttq_quantize(W, D, bits=qcfg.bits,
                                          group_size=qcfg.group_size, out=out)
        else:
            Ws = (W.float() * D[:, None, :]).reshape(n * dp, d)
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
        return QuantizedTensor(
            **{f: shaped(x) for f, x in fields.items()}, B=None, A=None,
            bits=qcfg.bits, group_size=qcfg.group_size, out_features=dp,
            in_features=d)

    def run(self, params, stats, count, into=None):
        """The quantized parameter tree (fp leaves shared, not copied).
        ``into``: a tree this plan returned earlier; its quantized leaves
        are overwritten in place and it is returned, so its storage stays
        where a captured decode graph reads it."""
        results = {}
        for key, members in self.families.items():
            for m in members:
                stat = None
                if m.stat_key is not None:
                    stat = stats["stack"][m.stat_key[0]][m.stat_key[1]]
                results[m.path_str] = self._run_member(
                    key, m, _tree_get(params, m.path), stat, count,
                    None if into is None else _tree_get(into, m.path))
        return into if into is not None else _replace(params, results)
