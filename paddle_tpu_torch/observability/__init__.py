"""paddle_tpu_torch.observability: tracing and one metrics registry.

Parity: the JAX package's observability package.

  * `trace`: span-based tracing into an always-on bounded flight-recorder
    ring, with a Chrome trace-event exporter and a text timeline.
  * `registry`: one counter/gauge/histogram registry fronting the
    runtime's metric surfaces (in-flight windows, batcher queues, decode
    step loops, the trace ring), rendered as Prometheus text: appended to
    serving `/metrics`, served standalone by `serve_metrics()`, dumped by
    `write_textfile()`; `watch_cluster()` adds a cluster directory's
    heartbeat gauges.
"""
from . import trace
from . import registry
from .registry import (REGISTRY, MetricsServer, serve_metrics,
                       unwatch_cluster, watch_cluster, write_textfile)

__all__ = ["trace", "registry", "REGISTRY", "MetricsServer",
           "serve_metrics", "watch_cluster", "unwatch_cluster",
           "write_textfile"]
