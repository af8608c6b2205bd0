# Fault tolerance (the checkpoint/restart loop, the step watchdog) and the
# serving runtime (the continuous batcher over the model's decode step).
from .fault_tolerance import FaultTolerantLoop, StepWatchdog
from .serving import ContinuousBatcher, Request

__all__ = ["FaultTolerantLoop", "StepWatchdog", "ContinuousBatcher",
           "Request"]
