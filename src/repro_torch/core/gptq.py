"""GPTQ baseline (Frantar et al., 2022): optimal-brain-surgeon greedy
quantization, column by column, for the method-comparison benchmarks.

The reference's algorithm exactly: H = 2XᵀX + λI, its inverse's upper
Cholesky factor U (``cholesky(inv(H), upper=True)``), then for each column
j: the group's scale and zero from the current weights at a group start,
the column's round-to-nearest, and its error (divided by U[j, j]) carried
into the later columns along row j of U.  O(d³); it is off the serving
path (the registry's ``gptq`` uses the diagonal closed form there).  On
the card it is a loop of d column steps, a few launches each.
"""
from __future__ import annotations

import torch

from .qdq import QuantConfig


def _hessian(X: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """H = 2 XᵀX + λI with λ = damp · mean(diag(H)) + 1e-6; X (..., d)
    token-major."""
    Xf = X.float().reshape(-1, X.shape[-1])
    H = 2.0 * (Xf.T @ Xf)
    damp = damp_frac * torch.diagonal(H).mean() + 1e-6
    return H + damp * torch.eye(H.shape[0], dtype=torch.float32,
                                device=H.device)


def gptq_qdq(W: torch.Tensor, X: torch.Tensor,
             qcfg: QuantConfig) -> torch.Tensor:
    """Fake-quantized Ŵ of W (d', d) against activations X (T, d), in W's
    dtype."""
    d = W.shape[1]
    g, qmax = qcfg.group_size, float(qcfg.qmax)
    U = torch.linalg.cholesky(torch.linalg.inv(_hessian(X)), upper=True)
    Wc = W.float().clone()
    Q = torch.zeros_like(Wc)
    S = Z = None
    for j in range(d):
        col = Wc[:, j]
        if j % g == 0:                  # group start: scale from Wc now
            blk = Wc[:, j:j + g]
            wmin = blk.amin(dim=1)
            S = torch.clamp((blk.amax(dim=1) - wmin) / qmax, min=1e-12)
            Z = wmin
        qcol = torch.clamp(torch.round((col - Z) / S), 0.0, qmax) * S + Z
        err = (col - qcol) / U[j, j]
        Wc[:, j + 1:] -= err[:, None] * U[j, j + 1:][None, :]
        Q[:, j] = qcol
    return Q.to(W.dtype)
