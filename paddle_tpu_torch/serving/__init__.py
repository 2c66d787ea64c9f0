"""Batched online inference: InferenceEngine over a saved model, a
coalescing Batcher, and ServingMetrics."""
from .batcher import (Batcher, DeadlineExceededError, QueueFullError,  # noqa: F401
                      RequestFuture, RequestTooLargeError,
                      ServingClosedError, ServingError)
from .engine import InferenceEngine, InvalidRequestError, ResultSlice  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
