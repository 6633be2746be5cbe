"""Observability: the telemetry counter-stream contract, the Chrome-trace
`Tracer` (`NULL_TRACER` is the no-op default), the `Metrics` registry
with its JSONL sink and `BlockMonitor`, and `python -m
repro_torch.obs.report`, which renders a run's JSONL and trace."""
from repro_torch.obs import counters  # noqa: F401
from repro_torch.obs.metrics import BlockMonitor, Metrics  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Tracer,
    validate_trace,
)
