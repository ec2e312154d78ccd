# Runtime policy: fault tolerance (heartbeats, stragglers, restarts, elastic
# mesh shapes), plain Python.
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    HeartbeatMonitor,
    RestartPolicy,
    StragglerDetector,
    elastic_mesh_shape,
)
