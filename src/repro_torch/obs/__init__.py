"""Observability: the telemetry counter-stream contract."""
from repro_torch.obs import counters  # noqa: F401
