"""Activation-aware diagonal statistics + AWQ closed form — paper §2 / App. C.

* ``raw``   — D = (‖X_i‖_p + λ)^α (the paper's pseudo-code);
* ``blend`` — D = ((1-λ)·m_i + λ·mean(m))^{α/2}, m_i = Σx²/T (eq. 13).

Statistics are additive (Σ_t |x_{t,i}|^p), so accumulation over prefill
batches is exact.
"""
from __future__ import annotations

import dataclasses

import torch

from .qdq import QuantConfig, qdq, quantize

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class AWQConfig:
    p: float = 2.0
    alpha: float = 0.5
    lam: float = 0.4
    form: str = "blend"  # 'raw' | 'blend'


def accumulate_stats(X: torch.Tensor, p: float = 2.0):
    """Sufficient statistic over tokens: X (..., T, d) → (Σ|x|^p per
    feature (d,) f32, token count as an f32 scalar tensor); leading axes
    fold into the token axis."""
    Xf = X.float().reshape(-1, X.shape[-1])
    if p == 2.0:
        s = (Xf * Xf).sum(dim=0)
    elif p == 1.0:
        s = Xf.abs().sum(dim=0)
    else:
        s = (Xf.abs() ** p).sum(dim=0)
    return s, torch.tensor(float(Xf.shape[0]), dtype=torch.float32,
                           device=X.device)


def diag_from_stats(stat: torch.Tensor, count, cfg: AWQConfig) -> torch.Tensor:
    """Σ|x|^p (..., d) → scaling vector D (..., d); leading dims are rows
    (the fused requant passes a (n, d) stack)."""
    stat = stat.float()
    if cfg.form == "raw":
        norm = stat ** (1.0 / cfg.p)
        D = (norm + cfg.lam) ** cfg.alpha
    elif cfg.form == "blend":
        cnt = torch.as_tensor(count, dtype=torch.float32, device=stat.device)
        m = stat / torch.clamp(cnt, min=1.0)
        eta = m.mean(dim=-1, keepdim=True)
        Dsq = (1.0 - cfg.lam) * m + cfg.lam * eta
        D = torch.clamp(Dsq, min=_EPS) ** (cfg.alpha / 2.0)
    else:
        raise ValueError(f"unknown AWQ form {cfg.form!r}")
    return torch.clamp(D, min=_EPS)


def activation_diag(X: torch.Tensor, cfg: AWQConfig = AWQConfig()
                    ) -> torch.Tensor:
    """One-shot D (d,) from raw activations X (..., T, d)."""
    s, n = accumulate_stats(X, cfg.p)
    return diag_from_stats(s, n, cfg)


def awq_qdq(W: torch.Tensor, D: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """Fake-quant closed form Ŵ = Q[W∘D]∘D⁻¹ (paper eq. 20); W (d', d), D
    (d,)."""
    Dn = D[None, :].float()
    return (qdq(W.float() * Dn, qcfg) / Dn).to(W.dtype)


def awq_quantize(W: torch.Tensor, D: torch.Tensor, qcfg: QuantConfig):
    """Real-quant path: quantize W∘D (D kept separate, applied as x/D)."""
    Ws = W.float() * D[None, :].float()
    return quantize(Ws, qcfg)


def awq_loss(W: torch.Tensor, What: torch.Tensor,
             C_diag: torch.Tensor) -> torch.Tensor:
    """Diagnostic: the activation-aware loss ‖(W − Ŵ) diag(c)^½‖² with
    c = E[x_i²], in f32."""
    E = (W - What).float()
    return (E * E * C_diag[None, :].float()).sum()
