from .ft import FailureInjector, StepMonitor

__all__ = ["FailureInjector", "StepMonitor"]
