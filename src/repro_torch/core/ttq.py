"""TTQ core: the quantized weight type and the linear that consumes it.

    y = deq(W_int) · (x / D) [+ B(Ax)]

``QuantizedTensor`` holds the same seven tensor fields as the reference
(``wint``/``packed``/``scale``/``zero``/``dinv``/``B``/``A``) plus the
static ``bits``/``group_size``/``out_features``/``in_features``.  A stacked
weight (leading layer dim) is one ``QuantizedTensor`` whose tensors carry
that dim; :func:`qt_index` slices one layer out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .awq import AWQConfig, awq_quantize, diag_from_stats
from .policy import QuantPolicy
from .qdq import QuantConfig, dequantize, pack_bits, unpack_bits


@dataclasses.dataclass
class QuantizedTensor:
    wint: Optional[torch.Tensor]      # (d', d) uint8 | None
    packed: Optional[torch.Tensor]    # (d', d*bits//32) int32 | None
    scale: torch.Tensor               # (d', d//g) f32
    zero: torch.Tensor                # (d', d//g) f32
    dinv: torch.Tensor                # (d,) f32 — activation prescale 1/D
    B: Optional[torch.Tensor]         # (d', r) | None
    A: Optional[torch.Tensor]         # (r, d) | None
    bits: int = 4
    group_size: int = 32
    out_features: int = 0
    in_features: int = 0

    @property
    def qcfg(self) -> QuantConfig:
        return QuantConfig(bits=self.bits, group_size=self.group_size,
                           layout="row")


_QT_TENSORS = ("wint", "packed", "scale", "zero", "dinv", "B", "A")


def qt_index(qt: QuantizedTensor, i) -> QuantizedTensor:
    """One layer (or any leading-dim index) of a stacked QuantizedTensor."""
    return dataclasses.replace(qt, **{
        f: (None if getattr(qt, f) is None else getattr(qt, f)[i])
        for f in _QT_TENSORS})


def calibrate(stats: Any, counts: Any, acfg: AWQConfig) -> Any:
    """Map an accumulated Σ|x|^p stats tree → the D tree of the same
    structure; ``counts`` has that structure too (dicts, lists and tuples
    are walked in step; None leaves stay None).  As in the reference, each
    leaf is one statistic: the blend form's mean runs over all of a
    stacked leaf's entries, not per layer row as in the fused plan."""
    if stats is None:
        return None
    if isinstance(stats, dict):
        return {k: calibrate(v, counts[k], acfg) for k, v in stats.items()}
    if isinstance(stats, (list, tuple)):
        return type(stats)(calibrate(s, n, acfg)
                           for s, n in zip(stats, counts, strict=True))
    return diag_from_stats(stats.reshape(1, -1), counts,
                           acfg).reshape(stats.shape)


def quantize_weight(W: torch.Tensor, D: torch.Tensor, policy: QuantPolicy,
                    B: Optional[torch.Tensor] = None,
                    A: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize one (d', d) weight given its activation diagonal D."""
    qcfg = policy.qcfg
    if qcfg.layout != "row":
        qcfg = dataclasses.replace(qcfg, layout="row")
    Wf = W.float()
    if B is not None and A is not None and policy.rank > 0:
        Wf = Wf - B.float() @ A.float()
    else:
        B = A = None
    wint, S, Z = awq_quantize(Wf, D, qcfg)
    dinv = (1.0 / D).float()
    packed = wint_out = None
    if (policy.packed and 32 % qcfg.bits == 0
            and W.shape[1] % (32 // qcfg.bits) == 0):
        packed = pack_bits(wint, qcfg.bits)
    else:
        wint_out = wint
    return QuantizedTensor(
        wint=wint_out, packed=packed, scale=S, zero=Z, dinv=dinv, B=B, A=A,
        bits=qcfg.bits, group_size=qcfg.group_size,
        out_features=W.shape[0], in_features=W.shape[1])


def dequant(qt: QuantizedTensor) -> torch.Tensor:
    """Effective fp weight Ŵ = deq(Wint)∘D⁻¹ [+ BA] (f32)."""
    wint = qt.wint
    if wint is None:
        wint = unpack_bits(qt.packed, qt.in_features, qt.bits)
    W = dequantize(wint, qt.scale, qt.zero, qt.qcfg) * qt.dinv[None, :]
    if qt.B is not None:
        W = W + qt.B.float() @ qt.A.float()
    return W


def ttq_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
               kcfg=None, pctx=None, tp=None) -> torch.Tensor:
    """y = x @ Ŵᵀ for x (..., d).  With ``kcfg.use_pallas`` a packed weight
    goes through the ``ttq_gemm`` kernel, the D⁻¹ prescale fused into its
    prologue; otherwise the plain path prescales x∘D⁻¹ in f32 and multiplies
    the dequantized f32 weight.  The low-rank branch runs on the unscaled x
    either way.  A weight with a leading expert axis (scale (E, d', d/g))
    is :func:`ttq_matmul_experts`.

    ``pctx``/``tp`` ('row'|'col'): the rank's slice under tensor
    parallelism (``kernels/ops.py:ttq_gemm_tp``).  A column slice's
    products are partial sums, all-reduced over the model axis: the GEMM's
    after it, the low-rank branch's rank-r product x·Aᵀ before it meets the
    replicated B."""
    if qt.scale.dim() == 3:
        return ttq_matmul_experts(x, qt, kcfg=kcfg)
    col = tp == "col" and pctx is not None and pctx.mesh is not None
    if col:
        from repro_torch.parallel import comm
    if kcfg is not None and kcfg.use_pallas and qt.packed is not None:
        from repro_torch.kernels import ops as kops
        y = kops.ttq_gemm_tp(x, qt.packed, qt.scale, qt.zero, qt.dinv,
                             bits=qt.bits, group_size=qt.group_size,
                             pctx=pctx, tp=tp)
    else:
        lead = x.shape[:-1]
        xs = x.reshape(-1, x.shape[-1]).float() * qt.dinv
        wint = qt.wint
        if wint is None:
            wint = unpack_bits(qt.packed, qt.in_features, qt.bits)
        Wd = dequantize(wint, qt.scale, qt.zero, qt.qcfg)
        from repro_torch.kernels.ref import row_matmul
        y = row_matmul(xs, Wd.T).reshape(*lead, -1)
        if col:                 # f32 partial sums, rounded once after
            y = comm.all_reduce(y, pctx)
        y = y.to(x.dtype)
    if qt.B is not None:
        if col and pctx.world > 1:
            xa = comm.all_reduce(x.float() @ qt.A.float().T, pctx).to(x.dtype)
        else:
            xa = x @ qt.A.to(x.dtype).T
            if col:
                xa = comm.all_reduce(xa, pctx)
        y = y + xa @ qt.B.to(x.dtype).T
    return y


def ttq_matmul_experts(x: torch.Tensor, qt: QuantizedTensor, *,
                       kcfg=None) -> torch.Tensor:
    """E expert weights at once, the reference's ``jax.vmap(ttq_matmul)``
    over the expert axis (``models/layers.py:_expert_mm`` there): x (E, C,
    d), or (C, d) shared by every expert; ``qt`` with (E, ...) fields →
    y (E, C, d') in x's dtype.  The kernel path is one ``ttq_gemm_experts``
    launch; the plain path prescales and dequantizes expert by expert, as
    :func:`ttq_matmul`'s plain path does for one weight; the low-rank
    branch B(Ax) is one batched product per factor on the unscaled x."""
    E = qt.scale.shape[0]
    if kcfg is not None and kcfg.use_pallas and qt.packed is not None:
        from repro_torch.kernels import ops as kops
        y = kops.ttq_gemm_experts(x, qt.packed, qt.scale, qt.zero, qt.dinv,
                                  bits=qt.bits, group_size=qt.group_size)
    else:
        one = dataclasses.replace(qt, B=None, A=None)
        y = torch.stack([ttq_matmul(x if x.dim() == 2 else x[e],
                                    qt_index(one, e))
                         for e in range(E)])
    if qt.B is not None:
        xe = x.expand(E, *x.shape) if x.dim() == 2 else x
        y = y + torch.bmm(torch.bmm(xe, qt.A.to(x.dtype).transpose(1, 2)),
                          qt.B.to(x.dtype).transpose(1, 2))
    return y


def init_lowrank_tree(params: Any, policy: QuantPolicy, is_weight) -> Any:
    """Offline, data-free: top-r SVD factors per quantizable 2-D weight
    (the reference's ``core/ttq.py:init_lowrank_tree``).  ``is_weight(path,
    leaf) → bool`` decides eligibility, ``path`` a tuple of keys.  Returns
    the params' nesting with a {'B', 'A'} dict at each eligible 2-D weight
    and None elsewhere.  (The serving path's stacked factors come from
    ``quant/api.py:lowrank_tree``.)"""
    from .lowrank import svd_factors

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,)) for i, v in enumerate(tree))
        if (policy.rank > 0 and isinstance(tree, torch.Tensor)
                and tree.dim() == 2 and is_weight(path, tree)):
            B, A = svd_factors(tree, policy.rank)
            return {"B": B, "A": A}
        return None
    return walk(params, ())


def quantize_params(params, stats, policy: QuantPolicy, **kw):
    """Whole-model eager quantization, kept here under the reference's
    historical import (``repro.core.quantize_params``); it lives in
    :func:`repro_torch.quant.api.quantize_params`."""
    from repro_torch.quant.api import quantize_params as _qp
    return _qp(params, stats, policy, **kw)


def ttq_linear(x: torch.Tensor, w, **kw) -> torch.Tensor:
    """fp weight (d', d) → plain matmul; QuantizedTensor → ttq path."""
    if isinstance(w, QuantizedTensor):
        return ttq_matmul(x, w, **kw)
    return x @ w.T
