"""AdamW and the LR schedules.  The int8 gradient compression of the
reference (``compress.py``) needs a process group and waits for tensor
parallelism (ROADMAP A10 (d))."""
from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup"]
