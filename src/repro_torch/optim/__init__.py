"""AdamW, the LR schedules, and the int8 gradient compression with error
feedback of the compressed data-parallel step (``compress.py``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule, linear_warmup
from .compress import compress_state_init, compressed_psum

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup", "compress_state_init",
           "compressed_psum"]
