"""``gluon.contrib.estimator``: the high-level fit loop and its event
handlers."""
from .estimator import Estimator
from .event_handler import (BatchBegin, BatchEnd, CheckpointHandler,
                            EarlyStoppingHandler, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler,
                            StoppingHandler, TrainBegin, TrainEnd,
                            ValidationHandler)

__all__ = [
    "Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
    "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
    "ValidationHandler", "LoggingHandler", "CheckpointHandler",
    "EarlyStoppingHandler",
]
