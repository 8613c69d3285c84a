"""Models: config, shared blocks, attention layer, layer stack, LM entry points."""
from . import lm
from .config import EncDecCfg, HybridCfg, MLACfg, ModelConfig, MoECfg, SSMCfg

__all__ = ["lm", "ModelConfig", "MoECfg", "MLACfg", "HybridCfg", "SSMCfg",
           "EncDecCfg"]
