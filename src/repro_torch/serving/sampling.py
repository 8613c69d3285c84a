"""Token sampling — public re-export.

The implementation lives in :mod:`repro_torch.models.common`
(``sample_logits``), where the fused decode loop (``lm.decode_many``)
samples on the device without a models → serving import cycle.
"""
from __future__ import annotations

from repro_torch.models.common import sample_logits as sample

__all__ = ["sample"]
