"""Runtime substrate of the port: two-level checkpointing, failure
handling, stragglers (the JAX package's ``repro.runtime``; ``failure`` and
``straggler`` are copies of the originals)."""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.failure import FailureInjector, Heartbeat, SimulatedFailure
from repro_torch.runtime.straggler import StepTimeMonitor

__all__ = [
    "CheckpointManager",
    "FailureInjector",
    "Heartbeat",
    "SimulatedFailure",
    "StepTimeMonitor",
]
