"""Runtime: heartbeats, failure injection, straggler monitoring."""

from repro_torch.runtime.failures import FailureInjector, SimulatedFailure
from repro_torch.runtime.monitor import Heartbeat, StepMonitor

__all__ = ["StepMonitor", "Heartbeat", "FailureInjector", "SimulatedFailure"]
