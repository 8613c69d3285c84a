"""Serving: scheduler (host policy), runner (device), engine (facade)."""
from .engine import EngineConfig, TTQEngine
from .scheduler import GenResult, pick_decode_chunk

__all__ = ["EngineConfig", "GenResult", "TTQEngine", "pick_decode_chunk"]
