"""Online inference: InferenceEngine over a saved model (bucketed
scoring, weight-dtype serving), DecodeEngine (slot-resident continuous
decode), the coalescing Batcher and DecodeBatcher, their metrics, and the
HTTP ModelServer."""
from .batcher import (  # noqa: F401
    Batcher, DeadlineExceededError, DecodeBatcher, DecodeStream,
    QueueFullError, RequestFuture, RequestTooLargeError, ServingClosedError,
    ServingError)
from .engine import (DecodeEngine, InferenceEngine,  # noqa: F401
                     InvalidRequestError, ResultSlice)
from .metrics import (DecodeMetrics, ServingMetrics,  # noqa: F401
                      render_prometheus_all)
from .server import ModelServer  # noqa: F401
