"""Architecture configs of this slice of the port.

``get(name, smoke=False)`` resolves ``<name>.config()`` (the published
shape) or ``<name>.smoke()`` (a reduced same-family config for CPU tests).
Every family of the reference is ported: ``ARCH_IDS`` lists its ten
configs in the reference's order.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "recurrentgemma_9b", "minitron_4b", "starcoder2_15b", "gemma_7b",
    "granite_34b", "whisper_medium", "deepseek_v2_lite_16b",
    "llama4_scout_17b_a16e", "chameleon_34b", "mamba2_1p3b",
]


def get(name: str, smoke: bool = False):
    if name not in ARCH_IDS:
        raise ValueError(f"unknown config {name!r} (known: {ARCH_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.config()
