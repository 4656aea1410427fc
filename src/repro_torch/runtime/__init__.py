"""The fault-tolerant train loop."""
from repro_torch.runtime.fault_tolerance import TrainLoopRunner, StragglerMonitor  # noqa: F401
