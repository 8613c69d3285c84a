"""Architecture configs of this slice of the port.

``get(name, smoke=False)`` resolves ``<name>.config()`` (the published
shape) or ``<name>.smoke()`` (a reduced same-family config for CPU tests).
The dense, vlm, hybrid and MoE families are ported (``ARCH_IDS``); SSM
and encoder-decoder come in later slices.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["gemma_7b", "minitron_4b", "starcoder2_15b", "granite_34b",
            "chameleon_34b", "recurrentgemma_9b", "llama4_scout_17b_a16e",
            "deepseek_v2_lite_16b"]


def get(name: str, smoke: bool = False):
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ported: {ARCH_IDS}); "
            f"other families come with their layers in a later slice")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.config()
