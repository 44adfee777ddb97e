"""Engine observability of the port: span tracing + metrics registry."""
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.trace import (ENGINE_TID, NullTracer,  # noqa: F401
                                   Tracer, as_tracer, graphs_captured,
                                   request_tid)
