"""Serving: scheduler (host policy), runner (device), engine (facade),
fault injection and the asyncio streaming server."""
from .engine import EngineConfig, TTQEngine
from .faults import Fault, FaultInjector, VirtualClock, demo_injector
from .scheduler import (ChunkPlan, GenResult, QueueFull, Request, Scheduler,
                        pick_decode_chunk)
from .server import RequestFailed, TTQServer

__all__ = ["ChunkPlan", "EngineConfig", "Fault", "FaultInjector", "GenResult",
           "QueueFull", "Request", "RequestFailed", "Scheduler", "TTQEngine",
           "TTQServer", "VirtualClock", "demo_injector", "pick_decode_chunk"]
