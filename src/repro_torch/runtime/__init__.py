"""Runtime fault tolerance: heartbeats, straggler detection, restart policy."""
from repro_torch.runtime.fault import (  # noqa: F401
    HeartbeatMonitor, StepMonitor, run_with_restarts,
)
