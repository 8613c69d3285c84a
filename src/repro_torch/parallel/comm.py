"""The collectives of tensor- and data-parallel runs, over one axis's group.

Every collective runs over the model axis's group unless ``axis="data"``
names the data axis (the trainer's).  On the model axis ``all_reduce`` (a
sum, in place) closes every column-parallel linear, the vocab-parallel
embedding lookup, the SSD gated norm's Σy² and the expert-parallel MoE's
partial sums; ``all_gather`` rebuilds the vocab-parallel head's logits,
the all-to-all MoE's token chunks and, in the requant, the full
statistics and diagonals of column-split weights; ``all_to_all`` carries
the all-to-all MoE's tokens to the ranks that own their experts and the
results back; ``agree`` reduces a few host scalars so that every rank
takes the same decision (the delta gate, the guards, the double buffer's
swap).  On the data axis the trainer sums the gradients (``all_reduce``,
or ``reduce_scatter`` onto a ZeRO-1 slice), gathers the updated masters'
slices (``all_gather``), and the compressed step agrees its scale
(``all_reduce(op="max")``).  A collective over an axis of one rank is the
identity.

Training differentiates through the model's collectives.  A tensor that
requires grad (with grad mode on) goes through an autograd function, with
these backward rules (Megatron's f and g, and their kin):

* ``all_reduce`` (g: its sum feeds computation every rank replicates, so
  each rank's cotangent is already the whole one): the identity;
* ``enter`` (f, the identity forward at every entry of a replicated
  tensor into a split block: a row-parallel linear, the vocab-parallel
  head): the all-reduce of the cotangent, in f32, each rank holding the
  partial cotangent of its slice;
* ``all_gather``: the rank's slice of the cotangent (whatever reads the
  gathered tensor is replicated);
* ``all_to_all``: the all-to-all of the cotangent (its own inverse).

Any other tensor takes the inference path, unchanged: so a CUDA-graph
capture and ``COUNTS`` are as they were.

Under NCCL a collective takes the device's tensors and may be captured in
a CUDA graph.  gloo takes CPU tensors: a CUDA tensor goes through a pinned
host buffer (:func:`_staged`), the one place this happens; such a
collective syncs the host and cannot be captured, so a runner over gloo
runs its blocks eagerly (``serving/runner.py``).

``COUNTS`` counts the collectives each rank runs, one per call (a
backward's collective too): a decode graph records its counts at capture
and adds them per replay, as it does the kernel launches.  ``STAGED_S``
sums the host seconds of the staged collectives (each waits for the
device, copies, reduces over gloo and copies back, so its host time is
its whole cost).
"""
from __future__ import annotations

from typing import Iterable, List

import time

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")
COUNTS = {k: 0 for k in KINDS}
STAGED_S = {k: 0.0 for k in KINDS}
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
# reduce_scatter_tensor is renamed reduce_scatter_single in torch 2.13
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _staged(t: torch.Tensor, op, kind: str):
    """Run ``op`` on a pinned host copy of the CUDA tensor ``t`` and return
    the host result (gloo takes no CUDA tensors), which ``op`` writes into
    pinned memory too, so both copies run at the pinned rate (torch's host
    allocator keeps freed pinned blocks for the next call)."""
    t0 = time.perf_counter()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    out = op(h)
    STAGED_S[kind] += time.perf_counter() - t0
    return out


def _axis(pctx, axis: str):
    """(group, ranks, this rank) of ``pctx``'s ``axis``."""
    if axis == "data":
        return pctx.mesh.dp_group, pctx.dp_world, pctx.dp_rank
    if axis != "model":
        raise ValueError(f"axis {axis!r}: 'model' or 'data'")
    return pctx.mesh.group, pctx.world, pctx.rank


# ------------------------------------------------ the collectives themselves

def _reduce(t, pctx, axis, op="sum"):
    group, n, _ = _axis(pctx, axis)
    if n == 1 and axis == "data":
        return t
    COUNTS["all_reduce"] += 1
    m, red = pctx.mesh, _OPS[op]
    if m.stage and t.is_cuda:
        def run(h):
            dist.all_reduce(h, op=red, group=group)
            return h
        t.copy_(_staged(t, run, "all_reduce"))
        return t
    dist.all_reduce(t, op=red, group=group)
    return t


def _gather(t, pctx, dim, axis):
    group, n, _ = _axis(pctx, axis)
    if n == 1 and axis == "data":
        return t.contiguous().clone()
    COUNTS["all_gather"] += 1
    m = pctx.mesh
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    if m.backend == "nccl":
        out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        def run(h):
            out = torch.empty((n * h.shape[0], *h.shape[1:]), dtype=h.dtype,
                              pin_memory=h.is_pinned())
            dist.all_gather(list(out.chunk(n)), h, group=group)
            return out
        out = _staged(src, run, "all_gather") if src.is_cuda else run(src)
        out = out.to(t.device)
    return out.movedim(0, dim).contiguous()   # reductions over it then
                                              # run as over a local tensor


def _scatter(t, pctx, dim, axis):
    group, n, r = _axis(pctx, axis)
    if n == 1 and axis == "data":
        return t
    COUNTS["reduce_scatter"] += 1
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    k = src.shape[0] // n

    def run(h):
        if pctx.mesh.backend == "nccl":
            out = torch.empty((k, *h.shape[1:]), dtype=h.dtype,
                              device=h.device)
            _reduce_scatter(out, h, group=group)
            return out
        # gloo's reduce-scatter moves more than its all-reduce (1.4 s
        # against 1.0 s per GB between two ranks on the card's host)
        dist.all_reduce(h, group=group)
        return h[r * k:(r + 1) * k]
    if pctx.mesh.stage and src.is_cuda:
        out = _staged(src, run, "reduce_scatter").to(t.device)
    elif pctx.mesh.backend == "nccl":
        out = run(src)
    else:                               # gloo sums in place: not into t
        out = run(src.clone()).clone()
    return out.movedim(0, dim).contiguous()


def _exchange(t, pctx):
    COUNTS["all_to_all"] += 1
    m = pctx.mesh
    src = t.contiguous()
    if m.backend == "nccl" or not src.is_cuda:
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=m.group)
        return out

    def run(h):
        out = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
        dist.all_to_all_single(out, h, group=m.group)
        return out
    return _staged(src, run, "all_to_all").to(t.device)


# --------------------------------------------------- their backward rules

def _tracked(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllReduce(torch.autograd.Function):
    """g: the sum forward, the identity backward."""

    @staticmethod
    def forward(ctx, t, pctx, axis):
        return _reduce(t.clone(), pctx, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """f: the identity forward, the f32 sum of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, pctx):
        ctx.pctx = pctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
        return _reduce(s, ctx.pctx, "model").to(g.dtype), None


class _AllGather(torch.autograd.Function):
    """The gather forward, the rank's slice of the cotangent backward."""

    @staticmethod
    def forward(ctx, t, pctx, dim, axis):
        ctx.dim = dim % t.dim()
        ctx.k = t.shape[ctx.dim]
        ctx.r = _axis(pctx, axis)[2]
        return _gather(t, pctx, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.k, ctx.k), None, None, None


class _AllToAll(torch.autograd.Function):
    """The exchange forward and backward (it is its own inverse)."""

    @staticmethod
    def forward(ctx, t, pctx):
        ctx.pctx = pctx
        return _exchange(t, pctx)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.pctx), None


# ------------------------------------------------------------ the entries

def all_reduce(t: torch.Tensor, pctx, *, axis: str = "model",
               op: str = "sum") -> torch.Tensor:
    """Σ (or ``op``: min, max) over ``axis``, in place in ``t`` (returned);
    a new tensor when ``t`` requires grad (backward: the identity)."""
    if _tracked(t):
        if op != "sum":
            raise ValueError(f"a differentiable all-reduce sums, not {op!r}")
        return _AllReduce.apply(t, pctx, axis)
    return _reduce(t, pctx, axis, op)


def enter(x: torch.Tensor, pctx) -> torch.Tensor:
    """A replicated ``x`` entering a block split over the model axis: ``x``
    itself, whose cotangent is all-reduced over the model axis in
    backward (Megatron's f).  An ``x`` that already entered on ``pctx``
    is returned as it is, so the row linears that share one input (q, k,
    v; the gate and up projections) share one backward all-reduce."""
    if pctx is None or pctx.mesh is None or not _tracked(x) \
            or getattr(x, "_entered_on", None) is pctx:
        return x
    y = _Enter.apply(x, pctx)
    y._entered_on = pctx
    return y


def all_gather(t: torch.Tensor, pctx, dim: int = -1, *,
               axis: str = "model") -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, rank order (a new
    contiguous tensor; backward: the rank's slice)."""
    if _tracked(t):
        return _AllGather.apply(t, pctx, dim, axis)
    return _gather(t, pctx, dim, axis)


def reduce_scatter(t: torch.Tensor, pctx, dim: int = 0, *,
                   axis: str = "data") -> torch.Tensor:
    """Σ over ``axis`` of ``t``, of which the rank keeps its slice along
    ``dim`` (rank order; a new contiguous tensor).  Not differentiable:
    the trainer runs it on gradients."""
    return _scatter(t, pctx, dim, axis)


def all_to_all(t: torch.Tensor, pctx) -> torch.Tensor:
    """``t`` (n, ...) exchanged on its leading dim over the model axis:
    block r of the result on rank j is block j of rank r's ``t`` (the
    reference's untiled ``lax.all_to_all`` with split and concat axis 0);
    a new tensor (backward: the same exchange)."""
    if _tracked(t):
        return _AllToAll.apply(t, pctx)
    return _exchange(t, pctx)


def barrier(pctx):
    """Wait for every rank of the mesh (both axes)."""
    if pctx is None or pctx.mesh is None:
        return
    for group, n, _ in (_axis(pctx, "model"), _axis(pctx, "data")):
        if n > 1:
            dist.barrier(group=group)


def agree(values: Iterable[float], pctx, op: str = "sum") -> List[float]:
    """Host scalars reduced over the model axis (``op``: sum, min or max):
    one small collective, then one host read."""
    vals = [float(v) for v in values]
    if pctx is None or pctx.mesh is None or pctx.mesh.group is None:
        return vals
    t = torch.tensor(vals, dtype=torch.float64)
    if pctx.mesh.backend == "nccl":
        t = t.to(pctx.mesh.device)
    dist.all_reduce(t, op=_OPS[op], group=pctx.mesh.group)
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
