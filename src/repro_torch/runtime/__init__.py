from .ft import ElasticController, FailureInjector, StepMonitor

__all__ = ["ElasticController", "FailureInjector", "StepMonitor"]
