"""Checkpoint/restart supervision of the sharded engines."""
from repro_torch.runtime.fault_tolerance import (FailureSchedule, Heartbeat,
                                                 SimulatedFailure, Stage,
                                                 StagedState, StageSchedule,
                                                 Supervisor, SupervisorResult,
                                                 run_staged, staged_from_host,
                                                 staged_to_host)

__all__ = ["FailureSchedule", "Heartbeat", "SimulatedFailure", "Stage",
           "StagedState", "StageSchedule", "Supervisor", "SupervisorResult",
           "run_staged", "staged_from_host", "staged_to_host"]
