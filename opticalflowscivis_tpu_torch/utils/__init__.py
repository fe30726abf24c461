"""Utility subsystems: profiling/tracing, timers, debug helpers."""

from opticalflowscivis_tpu_torch.utils.profiling import StepTimer, check_tensor, trace

__all__ = ["StepTimer", "check_tensor", "trace"]
