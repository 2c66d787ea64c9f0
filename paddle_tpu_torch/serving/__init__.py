"""Online inference: InferenceEngine over a saved model (bucketed
scoring, weight-dtype serving, tensor-parallel engines with `tp=`),
DecodeEngine (slot-resident continuous decode), the coalescing Batcher
and DecodeBatcher, their metrics, the HTTP ModelServer, and the layers
above one engine: ReplicaPool (N replicas behind one submit surface:
health-gated routing, failover, hedging, admission, zero-downtime
reload, canary promotion through CanaryController), DecodePool,
PoolAutoscaler and ModelFleet (N models with priority brownout).
Parity: the JAX package's serving/ and its exported names."""
from .autoscaler import PoolAutoscaler
from .batcher import (Batcher, DeadlineExceededError, DecodeBatcher,
                      DecodeStream, QueueFullError, RequestFuture,
                      RequestTooLargeError, ServingClosedError, ServingError)
from .canary import CanaryController, CanaryFuture
from .engine import (DecodeEngine, InferenceEngine, InvalidRequestError,
                     ResultSlice)
from .fleet import BrownoutError, ModelFleet
from .metrics import DecodeMetrics, ServingMetrics, render_prometheus_all
from .pool import (AttemptTimeoutError, DecodePool, PoisonedOutputError,
                   PoolFuture, PoolMetrics, PoolResult, ReplicaPool)
from .server import ModelServer

__all__ = [
    "InferenceEngine", "ModelServer", "Batcher", "ServingMetrics",
    "RequestFuture", "ResultSlice", "ServingError", "QueueFullError",
    "DeadlineExceededError", "ServingClosedError", "RequestTooLargeError",
    "InvalidRequestError",
    "ReplicaPool", "PoolFuture", "PoolResult", "PoolMetrics",
    "AttemptTimeoutError", "PoisonedOutputError",
    "PoolAutoscaler", "CanaryController", "CanaryFuture",
    "ModelFleet", "BrownoutError",
    "DecodeEngine", "DecodeBatcher", "DecodeStream", "DecodeMetrics",
    "DecodePool", "render_prometheus_all",
]
