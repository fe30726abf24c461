"""Utility subsystems: profiling/tracing with the port's spans, debug helpers."""

from opticalflowscivis_tpu_torch.utils.profiling import check_tensor, span, spans, trace

__all__ = ["check_tensor", "span", "spans", "trace"]
