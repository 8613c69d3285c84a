"""Robustness guards for the TTQ lifecycle.

Online calibration makes the shared statistics the engine's most dangerous
mutable state: one degenerate prompt (NaN/Inf activations, an extreme
outlier) folded into the session would be baked by the next requant into
the weights every later request is served with.  This module holds the two
validation points that stop that, and the knobs of the serving side's
isolation machinery:

* :func:`stats_summary`: ``(all_finite, mean_abs)`` of a statistics tree;
  :class:`~repro_torch.quant.session.CalibrationSession` calls it on every
  incoming update (and on the running tree for the outlier gate);
* :func:`qt_health`: validates a candidate quantized tree before it can
  be swapped in: every scale / zero / D⁻¹ leaf finite and, optionally, the
  relative drift of D⁻¹ against the last-good tree bounded;
* :class:`GuardConfig`: the frozen knobs ``EngineConfig.guard_cfg`` carries
  to the scheduler (retries, admission-attempt cap), the engine (the
  degradation ladder) and the quantized model.

Each validator is a plain PyTorch reduction followed by one host read of
its two scalars, as the reference's jitted reductions are.  They run per
admission and per requant, never inside a decode block.  The reference
counts its two jitted programs in ``compiled_programs``; here they run
eagerly and hold no graph, so they count none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Knobs of the robustness layer, frozen so that it can ride the frozen
    ``EngineConfig`` and be shared between components."""
    calib_outlier_factor: float = 100.0   # reject updates whose per-token
                                          # mean |stat| exceeds factor × the
                                          # running per-token mean
    calib_warmup_updates: int = 1         # accepted updates before the
                                          # outlier gate arms
    snapshot_ring: int = 4                # last-good pre-update snapshots
                                          # kept for rollback
    quarantine_max: int = 16              # rejected-update records retained
    requant_max_drift: float = -1.0       # max relative L2 drift of D⁻¹ per
                                          # swap (<0: finiteness check only)
    max_retries: int = 1                  # per-request decode-fault retries
                                          # before the request errors out
    max_admission_attempts: int = 8       # MemoryError→preempt retries per
                                          # request per planning round
                                          # (lifted to at least max_slots+1)
    degrade_pressure: float = 0.95        # pool pressure that climbs the
                                          # degradation ladder one rung
    recover_pressure: float = 0.5         # pressure that steps back down


def stats_summary(tree: Any) -> Tuple[bool, float]:
    """``(all_finite, mean |leaf|)`` of a statistics tree, on the host.
    One host read of two scalars."""
    from .api import _walk
    leaves = [t for _, t in _walk(tree)]
    if not leaves:
        return True, 0.0
    finite = torch.stack([torch.isfinite(x).all() for x in leaves]).all()
    total = torch.stack([x.abs().float().sum() for x in leaves]).sum()
    n = sum(x.numel() for x in leaves)
    out = torch.stack([finite.float(), total / max(n, 1)]).cpu()
    return bool(out[0] > 0), float(out[1])


def qt_health(tree: Any, prev_dinv: Dict[str, torch.Tensor],
              max_drift: float) -> Tuple[bool, float]:
    """Validate a candidate quantized tree before it can be swapped in:
    every ``QuantizedTensor`` scale / zero / D⁻¹ finite and, when
    ``max_drift >= 0``, the relative L2 drift of each D⁻¹ against the
    last-good tree's (``prev_dinv``: path → previous dinv) bounded.
    Returns ``(healthy, max drift observed)``; one host read."""
    from repro_torch.core.ttq import QuantizedTensor

    from .api import _path_str, _walk

    arrs, pairs = [], []
    for path, leaf in _walk(tree):
        if not isinstance(leaf, QuantizedTensor):
            continue
        arrs += [a for a in (leaf.scale, leaf.zero, leaf.dinv)
                 if a is not None]
        prev = prev_dinv.get(_path_str(path))
        if prev is not None and leaf.dinv is not None \
                and prev.shape == leaf.dinv.shape:
            pairs.append((leaf.dinv, prev))
    if not arrs:
        return True, 0.0
    finite = torch.stack([torch.isfinite(a).all() for a in arrs]).all()
    drift = torch.zeros((), dtype=torch.float32, device=arrs[0].device)
    for new, prev in pairs:
        num = torch.linalg.vector_norm((new - prev).float().ravel())
        den = torch.clamp(torch.linalg.vector_norm(prev.float().ravel()),
                          min=1e-12)
        drift = torch.maximum(drift, num / den)
    out = torch.stack([finite.float(), drift]).cpu()
    d = float(out[1])
    ok = bool(out[0] > 0) and (max_drift < 0 or d <= float(max_drift))
    return ok, d


def token_count_ok(tokens: float) -> bool:
    """Token-count sanity for a calibration update: finite and positive."""
    try:
        t = float(tokens)
    except (TypeError, ValueError):
        return False
    return math.isfinite(t) and t > 0
