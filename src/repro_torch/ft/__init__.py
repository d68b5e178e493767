"""Fault tolerance: failure injection, checkpoint/restart supervision and
elastic batch plans, as the JAX package's ``ft/``."""
from .failures import FailureInjector, run_with_restarts
from .elastic import ElasticBatchPlan

__all__ = ["FailureInjector", "run_with_restarts", "ElasticBatchPlan"]
