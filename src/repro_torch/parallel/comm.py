"""The collectives of tensor-parallel serving, over the model axis's group.

``all_reduce`` (a sum, in place) closes every column-parallel linear, the
vocab-parallel embedding lookup, the SSD gated norm's Σy² and the
expert-parallel MoE's partial sums; ``all_gather`` rebuilds the
vocab-parallel head's logits, the all-to-all MoE's token chunks and, in
the requant, the full statistics and diagonals of column-split weights;
``all_to_all`` carries the all-to-all MoE's tokens to the ranks that own
their experts and the results back; ``agree`` reduces a few host scalars
so that every rank takes the same decision (the delta gate, the guards,
the double buffer's swap).

Under NCCL a collective takes the device's tensors and may be captured in
a CUDA graph.  gloo takes CPU tensors: a CUDA tensor goes through a pinned
host buffer (:func:`_staged`), the one place this happens; such a
collective syncs the host and cannot be captured, so a runner over gloo
runs its blocks eagerly (``serving/runner.py``).

``COUNTS`` counts the collectives each rank runs, one per call: a
decode graph records its counts at capture and adds them per replay, as
it does the kernel launches.  ``STAGED_S`` sums the host seconds of the
staged collectives (each waits for the device, copies, reduces over
gloo and copies back, so its host time is its whole cost).
"""
from __future__ import annotations

from typing import Iterable, List

import time

import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}
STAGED_S = {"all_reduce": 0.0, "all_gather": 0.0, "all_to_all": 0.0}


def _staged(t: torch.Tensor, op, kind: str):
    """Run ``op`` on a pinned host copy of the CUDA tensor ``t`` and return
    the host result (gloo takes no CUDA tensors)."""
    t0 = time.perf_counter()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    out = op(h)
    STAGED_S[kind] += time.perf_counter() - t0
    return out


def all_reduce(t: torch.Tensor, pctx) -> torch.Tensor:
    """Σ over the model axis, in place in ``t`` (returned)."""
    COUNTS["all_reduce"] += 1
    m = pctx.mesh
    if m.stage and t.is_cuda:
        def op(h):
            dist.all_reduce(h, group=m.group)
            return h
        t.copy_(_staged(t, op, "all_reduce"))
        return t
    dist.all_reduce(t, group=m.group)
    return t


def all_gather(t: torch.Tensor, pctx, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, rank order (a new
    contiguous tensor)."""
    COUNTS["all_gather"] += 1
    m, n = pctx.mesh, pctx.world
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    if m.backend == "nccl":
        out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, src, group=m.group)
    else:
        def op(h):
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=m.group)
            return torch.cat(parts)
        out = _staged(src, op, "all_gather") if src.is_cuda else op(src)
        out = out.to(t.device)
    return out.movedim(0, dim).contiguous()   # reductions over it then
                                              # run as over a local tensor


def all_to_all(t: torch.Tensor, pctx) -> torch.Tensor:
    """``t`` (n, ...) exchanged on its leading dim: block r of the result on
    rank j is block j of rank r's ``t`` (the reference's untiled
    ``lax.all_to_all`` with split and concat axis 0); a new tensor."""
    COUNTS["all_to_all"] += 1
    m = pctx.mesh
    src = t.contiguous()
    if m.backend == "nccl" or not src.is_cuda:
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=m.group)
        return out

    def op(h):
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=m.group)
        return out
    return _staged(src, op, "all_to_all").to(t.device)


def agree(values: Iterable[float], pctx, op: str = "sum") -> List[float]:
    """Host scalars reduced over the model axis (``op``: sum, min or max):
    one small collective, then one host read."""
    vals = [float(v) for v in values]
    if pctx is None or pctx.mesh is None or pctx.mesh.group is None:
        return vals
    t = torch.tensor(vals, dtype=torch.float64)
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    if pctx.mesh.backend == "nccl":
        t = t.to(pctx.mesh.device)
    dist.all_reduce(t, op=red, group=pctx.mesh.group)
    return t.cpu().tolist()


def warm(pctx):
    """One eager collective on the group: NCCL creates its communicator on
    first use, which a CUDA-graph capture cannot do."""
    if pctx is not None and pctx.mesh is not None \
            and pctx.mesh.group is not None:
        t = torch.zeros((1,), device=pctx.mesh.device)
        dist.all_reduce(t, group=pctx.mesh.group)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
