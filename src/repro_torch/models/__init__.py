"""Models: config, shared blocks, attention layer, layer stack, LM entry points."""
from .config import ModelConfig

__all__ = ["ModelConfig"]
