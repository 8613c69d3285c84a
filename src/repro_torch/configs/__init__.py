"""Architecture configs and input shapes (``repro.configs``).

``get(name, smoke=False)`` resolves ``<name>.config()`` (the published
shape) or ``<name>.smoke()`` (a reduced same-family config for CPU tests).
Every family of the reference is ported: ``ARCH_IDS`` lists its ten
configs in the reference's order.  ``SHAPES`` is the reference's per-arch
input-shape set, and ``cells()`` its (arch, shape) cells with the skip
rule (long_500k needs sub-quadratic attention), which the napkin roofline
(``launch/napkin.py``) reads.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "recurrentgemma_9b", "minitron_4b", "starcoder2_15b", "gemma_7b",
    "granite_34b", "whisper_medium", "deepseek_v2_lite_16b",
    "llama4_scout_17b_a16e", "chameleon_34b", "mamba2_1p3b",
]

# shape_name: (seq_len, global_batch, step_kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get(name: str, smoke: bool = False):
    if name not in ARCH_IDS:
        raise ValueError(f"unknown config {name!r} (known: {ARCH_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.config()


def skip_reason(cfg, shape_name: str):
    if shape_name == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch — long_500k needs sub-quadratic attention"
    return None


def cells(include_skipped: bool = False):
    """All (arch_id, shape_name) dry-run cells, with skip annotations."""
    out = []
    for a in ARCH_IDS:
        cfg = get(a)
        for s in SHAPES:
            r = skip_reason(cfg, s)
            if r is None or include_skipped:
                out.append((a, s, r))
    return out
