"""Low-rank decomposition for TTQ — paper §2 "TTQ with Low-Rank
Decomposition" / App. E.

Ŵ = W_q + B·A with static, data-free factors B = U_r Λ_r^{1/2}, A =
Λ_r^{1/2} V_rᵀ from the exact top-r SVD of W (``torch.linalg.svd`` in f32,
not a randomized SVD).  Only the residual W − B·A is quantized, online per
prompt: W_q = Q[(W − BA)∘D]∘D⁻¹.  The factors are computed once per model
(``quant/api.py:lowrank_tree``); the alternating refinement (eq. 34-35) is
the paper's ablation.
"""
from __future__ import annotations

import dataclasses

import torch

from .awq import awq_qdq, awq_quantize
from .qdq import QuantConfig, qdq


def svd_top(W: torch.Tensor, r: int):
    """f32 factors of W (d', d)'s top-r SVD: B (d', r), A (r, d).  Eq. 31-33.
    On the card through cuSOLVER's ``gesvd`` (QR iteration): the default
    Jacobi method (``gesvdj``) left the top singular values of
    gemma-7b-shaped random weights 2.0-3.4e-4 off a float64 SVD, ``gesvd``
    1.5-5.1e-5 (``tools/svd_drivers.py``, PERF.md)."""
    U, s, Vh = torch.linalg.svd(W.float(), full_matrices=False,
                                driver="gesvd" if W.is_cuda else None)
    sr = s[:r].sqrt()
    return U[:, :r] * sr[None, :], sr[:, None] * Vh[:r, :]


def svd_factors(W: torch.Tensor, r: int):
    """:func:`svd_top`'s factors in W's dtype."""
    B, A = svd_top(W, r)
    return B.to(W.dtype), A.to(W.dtype)


def residual(W, B, A) -> torch.Tensor:
    """R = W − B·A in f32 (batched over leading dims), formed as the
    reference forms it: the f32 product subtracted from the f32 weight."""
    R = W.to(torch.float32, copy=True)
    R -= B.float() @ A.float()
    return R


def ttq_lowrank_qdq(W, B, A, D, qcfg: QuantConfig) -> torch.Tensor:
    """Fake-quant TTQ+LR: Ŵ = Q[(W−BA)∘D]∘D⁻¹ + BA, in W's dtype."""
    BA = B.float() @ A.float()
    return (awq_qdq(residual(W, B, A), D, qcfg) + BA).to(W.dtype)


def ttq_lowrank_quantize(W, B, A, D, qcfg: QuantConfig):
    """Real-quant path: (W_int, S, Z) of the scaled residual; B, A stay in
    full precision.  Serving computes y = deq(W_int)(x/D) + B(Ax)."""
    return awq_quantize(residual(W, B, A), D, qcfg)


def alternating_refine(W, D, qcfg: QuantConfig, r: int, iters: int = 3):
    """Quantization-aware alternating factorization (eq. 34-35); the
    paper's ablation."""
    Wf = W.float()
    B, A = svd_factors(Wf, r)
    for _ in range(iters):
        Wq = awq_qdq(Wf - B @ A, D, qcfg)
        B, A = svd_factors(Wf - Wq, r)
    return B, A


def quantize_factors(B, A, qcfg: QuantConfig, which: str = "A"):
    """Appendix-E extension: fake-quantize the factors themselves ('A',
    'B' or 'both'), in flat groups."""
    fcfg = dataclasses.replace(qcfg, layout="flat")
    qB, qA = B, A
    if which in ("A", "both"):
        qA = qdq(A, fcfg)
    if which in ("B", "both"):
        qB = qdq(B, fcfg)
    return qB, qA
