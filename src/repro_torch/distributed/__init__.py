"""Fault tolerance of the training loop (port of ``repro.distributed``)."""
from .fault_tolerance import (
    FailureInjector,
    StragglerPolicy,
    TrainController,
    WorkerFailure,
)

__all__ = [
    "FailureInjector",
    "StragglerPolicy",
    "TrainController",
    "WorkerFailure",
]
