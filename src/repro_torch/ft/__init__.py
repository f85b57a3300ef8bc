"""Fault-tolerant training substrate (port of ``repro/ft``): the paper's
NVM persistence machinery as a first-class training feature."""
from repro_torch.ft.checkpoint import NVMCheckpointManager, CheckpointConfig  # noqa: F401
from repro_torch.ft.period import optimal_period, PersistencePeriodTuner  # noqa: F401
from repro_torch.ft.recovery import TrainingRecovery, inject_host_failure  # noqa: F401
from repro_torch.ft.straggler import StragglerMonitor, StragglerAdvice  # noqa: F401
