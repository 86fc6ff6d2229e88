"""Tracing, counters and device selection."""

from hybridsearch_tpu_torch.utils.tracing import (  # noqa: F401
    QueryTracer,
    StageTimer,
    trace_span,
)
