"""Tracing and per-stage query-path metrics.

  - StageTimer: lock-protected rolling latency/rate statistics per named
    stage (search_batch, encode, hybrid_sparse, ladder.rung, ...; inside
    encode a decoder encoder's encoder.tokenize and encoder.forward, and
    moe.route and moe.experts once an MoE layer) over the window of time
    their last samples cover, surfaced through stats;
  - Counters: named monotonic counters (e.g. the ladders' certified rows;
    encoder_texts, encoder_tokens, encoder_tokens_padded and
    moe_tokens_routed, each known on the host at tokenization);
  - trace_span: context manager recording into a StageTimer and labelling
    the stage on a torch.profiler timeline (record_function) when a
    profiling session is active;
  - QueryTracer: a one-call profile (torch.profiler, CPU and CUDA activity)
    written as a trace file under a directory.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np


class StageTimer:
    """Rolling per-stage latency stats over the last ``window`` samples of
    each stage. ``_samples[stage]`` holds their seconds, ``_ends[stage]``
    their end times on ``time.perf_counter``."""

    def __init__(self, window: int = 1024) -> None:
        self.window = window
        self._samples: Dict[str, deque] = {}
        self._ends: Dict[str, deque] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, stage: str, seconds: float) -> None:
        end = time.perf_counter()
        with self._lock:
            self._samples.setdefault(stage, deque(maxlen=self.window)).append(seconds)
            self._ends.setdefault(stage, deque(maxlen=self.window)).append(end)
            self._counts[stage] = self._counts.get(stage, 0) + 1

    def reset(self) -> None:
        """Forget every sample and count."""
        with self._lock:
            self._samples.clear()
            self._ends.clear()
            self._counts.clear()

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per stage: ``count`` (every sample since construction or
        ``reset``), and over the kept samples: ``samples``, ``window_s``
        (from the start of the oldest to this call, so idle time since the
        newest counts), the percentiles, the mean and ``rate_per_s``
        (samples / window_s)."""
        now = time.perf_counter()
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for stage, dq in self._samples.items():
                arr = np.asarray(dq, dtype=np.float64) * 1e3
                window_s = max(now - (self._ends[stage][0] - dq[0]), 1e-9)
                out[stage] = {
                    "count": self._counts[stage],
                    "samples": len(dq),
                    "window_s": window_s,
                    "p50_ms": float(np.percentile(arr, 50)),
                    "p95_ms": float(np.percentile(arr, 95)),
                    "p99_ms": float(np.percentile(arr, 99)),
                    "mean_ms": float(arr.mean()),
                    "rate_per_s": len(dq) / window_s,
                }
            return out


GLOBAL_TIMER = StageTimer()


class Counters:
    """Named monotonic counters surfaced through /metrics (e.g. the
    exact->approximate semantic-arm downgrade counter)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, by: int = 1) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by
            return self._counts[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def all(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


GLOBAL_COUNTERS = Counters()


@contextlib.contextmanager
def trace_span(stage: str, timer: Optional[StageTimer] = None) -> Iterator[None]:
    """Time a stage (host clock; device work queued inside the span is not
    waited for) and label it on a torch.profiler trace (record_function)."""
    import torch

    timer = timer or GLOBAL_TIMER
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(stage):
            yield
    finally:
        timer.record(stage, time.perf_counter() - t0)


class QueryTracer:
    """One-call profiling into ``log_dir`` (by default ``hst_trace`` under
    the temporary directory): ``profile()`` records host activity, and the
    card's kernels too when CUDA is available, and on exit writes one
    ``*.pt.trace.json`` file (Chrome trace format, which TensorBoard's
    profiler plugin reads) there."""

    def __init__(self, log_dir: Optional[str] = None) -> None:
        self.log_dir = log_dir or os.path.join(tempfile.gettempdir(), "hst_trace")

    @contextlib.contextmanager
    def profile(self) -> Iterator[str]:
        """Profile the body; yields the directory the trace goes to."""
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(self.log_dir)):
            yield self.log_dir
