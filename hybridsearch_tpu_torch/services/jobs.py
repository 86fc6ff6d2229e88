"""Async job queue: thread pool, states, retries, webhooks, progress.

Counterpart of ``hybridsearch_tpu/services/jobs.py``, host code copied
with the port's imports.

Parity with the reference job system (reference jobs.py:21-392): 3 worker
threads, PENDING -> PROCESSING -> COMPLETED/FAILED/CANCELLED lifecycle,
progress percentage, retries with exponential backoff delay = base *
2^(retry-1) (reference jobs.py:310), webhook POST on terminal states
(reference jobs.py:333-362), cancellation via threading.Event, and a
pluggable backend (in-memory or the sqlite DocStore jobs table for
persistence across restarts — an upgrade over the reference's
memory-only default)."""

from __future__ import annotations

import enum
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class JobState(str, enum.Enum):
    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


TERMINAL_STATES = {JobState.COMPLETED, JobState.FAILED, JobState.CANCELLED}


@dataclass
class Job:
    job_id: str
    job_type: str
    state: JobState = JobState.PENDING
    progress: float = 0.0
    payload: Optional[dict] = None
    result: Any = None
    error: Optional[str] = None
    retries: int = 0
    max_retries: int = 3
    webhook_url: Optional[str] = None
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    cancel_event: threading.Event = field(default_factory=threading.Event)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "job_type": self.job_type,
            "state": self.state.value,
            "progress": round(self.progress, 2),
            "result": self.result,
            "error": self.error,
            "retries": self.retries,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }


class InMemoryJobBackend:
    """Dict-backed job store (reference jobs.py:83-142)."""

    def __init__(self) -> None:
        self._jobs: Dict[str, Job] = {}
        self._lock = threading.Lock()

    def put(self, job: Job) -> None:
        with self._lock:
            self._jobs[job.job_id] = job

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def list(self, limit: int = 100) -> List[Job]:
        with self._lock:
            jobs = sorted(self._jobs.values(), key=lambda j: -j.created_at)
            return jobs[:limit]


class JobQueue:
    """Thread-pool job queue (reference jobs.py:145-392)."""

    def __init__(
        self,
        n_workers: int = 3,  # reference jobs.py:152
        backend: Optional[InMemoryJobBackend] = None,
        retry_base_delay: float = 1.0,
        docstore=None,  # optional sqlite persistence
    ) -> None:
        self.backend = backend or InMemoryJobBackend()
        self.docstore = docstore
        self.retry_base_delay = retry_base_delay
        self._handlers: Dict[str, Callable] = {}
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._workers: List[threading.Thread] = []
        self._shutdown = threading.Event()
        for i in range(n_workers):
            t = threading.Thread(target=self._worker, name=f"job-worker-{i}",
                                 daemon=True)
            t.start()
            self._workers.append(t)

    # -- registration / submission ------------------------------------------------

    def register_handler(self, job_type: str, fn: Callable) -> None:
        """fn(payload, progress_cb, cancel_event) -> result."""
        self._handlers[job_type] = fn

    def enqueue(
        self,
        job_type: str,
        payload: Optional[dict] = None,
        max_retries: int = 3,
        webhook_url: Optional[str] = None,
    ) -> str:
        """Submit a job; returns its id (reference jobs.py:175-207)."""
        if job_type not in self._handlers:
            raise ValueError(f"no handler registered for job type {job_type!r}")
        job = Job(job_id=uuid.uuid4().hex, job_type=job_type, payload=payload,
                  max_retries=max_retries, webhook_url=webhook_url)
        self.backend.put(job)
        self._persist(job)
        self._q.put(job.job_id)
        return job.job_id

    def get(self, job_id: str) -> Optional[Job]:
        return self.backend.get(job_id)

    def list(self, limit: int = 100) -> List[Job]:
        return self.backend.list(limit)

    def cancel(self, job_id: str) -> bool:
        """Cancel a pending/processing job (reference jobs.py:214-242)."""
        job = self.backend.get(job_id)
        if job is None or job.state in TERMINAL_STATES:
            return False
        job.cancel_event.set()
        if job.state == JobState.PENDING:
            self._transition(job, JobState.CANCELLED)
        return True

    def shutdown(self, wait: bool = True) -> None:
        self._shutdown.set()
        for _ in self._workers:
            self._q.put(None)
        if wait:
            for t in self._workers:
                t.join(timeout=5)

    # -- internals ---------------------------------------------------------------------

    def _persist(self, job: Job) -> None:
        if self.docstore is not None:
            self.docstore.upsert_job({
                "job_id": job.job_id, "job_type": job.job_type,
                "state": job.state.value, "progress": job.progress,
                "payload": job.payload,
                "result": job.result if isinstance(job.result, (dict, list)) else None,
                "error": job.error, "retries": job.retries,
            })

    def _transition(self, job: Job, state: JobState) -> None:
        job.state = state
        job.updated_at = time.time()
        self.backend.put(job)
        self._persist(job)
        if state in TERMINAL_STATES:
            self._notify_webhook(job)

    def _notify_webhook(self, job: Job) -> None:
        """POST terminal state to the webhook (reference jobs.py:333-362)."""
        if not job.webhook_url:
            return
        try:
            import requests

            requests.post(job.webhook_url, json=job.to_dict(), timeout=10)
        except Exception:
            pass  # webhook failures never affect job state

    def _worker(self) -> None:
        while not self._shutdown.is_set():
            job_id = self._q.get()
            if job_id is None:
                return
            job = self.backend.get(job_id)
            if job is None or job.state != JobState.PENDING:
                continue
            if job.cancel_event.is_set():
                self._transition(job, JobState.CANCELLED)
                continue
            self._process(job)

    def _process(self, job: Job) -> None:
        """Run with retries + exponential backoff (reference jobs.py:258-331)."""
        handler = self._handlers[job.job_type]
        self._transition(job, JobState.PROCESSING)

        def progress_cb(pct: float) -> None:
            job.progress = max(0.0, min(100.0, float(pct)))
            job.updated_at = time.time()
            self.backend.put(job)

        while True:
            try:
                result = handler(job.payload, progress_cb, job.cancel_event)
                if job.cancel_event.is_set():
                    self._transition(job, JobState.CANCELLED)
                    return
                job.result = result
                job.progress = 100.0
                self._transition(job, JobState.COMPLETED)
                return
            except Exception as e:
                if job.cancel_event.is_set():
                    self._transition(job, JobState.CANCELLED)
                    return
                job.retries += 1
                if job.retries > job.max_retries:
                    job.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                    self._transition(job, JobState.FAILED)
                    return
                # delay = base * 2^(retry-1) (reference jobs.py:310)
                delay = self.retry_base_delay * (2 ** (job.retries - 1))
                if job.cancel_event.wait(timeout=delay):
                    self._transition(job, JobState.CANCELLED)
                    return
