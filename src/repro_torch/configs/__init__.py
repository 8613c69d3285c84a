"""Architecture configs of this slice of the port.

``get(name, smoke=False)`` resolves ``<name>.config()`` (the published
shape) or ``<name>.smoke()`` (a reduced same-family config for CPU tests).
Only ``gemma_7b`` is ported so far; other families come in later slices.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["gemma_7b"]


def get(name: str, smoke: bool = False):
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (slice 1 ports {ARCH_IDS}); "
            f"other families come with their layers in a later slice")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.config()
