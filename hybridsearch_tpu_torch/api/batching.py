"""Cross-request dynamic batching for /search (continuous batching; the
port of ``hybridsearch_tpu/api/batching.py``, the same policy).

The reference serves one request at a time (reference api.py:272 runs a
single search per call). On the card one [B]-query ``search_batch`` costs
barely more than one query (the kernels' launches and the host's work a
batch are paid once), so the serving layer coalesces concurrent requests
into one batched dispatch.

Policy — continuous batching, no artificial wait:
  * engine idle  -> a lone request dispatches immediately (adds ~0
    latency at low load);
  * engine busy  -> arrivals accumulate; when the in-flight dispatch
    returns, everything queued (up to `max_batch`) forms the next batch.
Requests are grouped by fusion-weight signature (different weights fuse
different scores); top_k is served at the group max and trimmed per
request. The query list is padded up to a power-of-two bucket (with the
last query) so the card sees a handful of batch shapes instead of one per
concurrency level.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple


class BatchTimeout(Exception):
    """The request sat in the queue longer than queue_timeout_s."""


class _Pending:
    __slots__ = ("query", "top_k", "sw", "lw", "done", "results",
                 "query_id", "error", "t_enq")

    def __init__(self, query: str, top_k: int, sw: float, lw: float):
        self.query = query
        self.top_k = top_k
        self.sw = sw
        self.lw = lw
        self.done = threading.Event()
        self.results: Optional[list] = None
        self.query_id: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.t_enq = time.perf_counter()


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class SearchBatcher:
    """Coalesces concurrent search requests into batched device dispatches.

    One dispatcher thread owns every device call made through `submit`,
    which also serializes those searches on the card's stream."""

    def __init__(self, searcher, query_memory=None, max_batch: int = 64,
                 queue_timeout_s: float = 30.0):
        self.searcher = searcher
        self.query_memory = query_memory
        self.max_batch = max(1, int(max_batch))
        self.queue_timeout_s = float(queue_timeout_s)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # observability (surfaced via /metrics)
        self.dispatches = 0
        self.batched_requests = 0
        self.max_seen_batch = 0

    # -- lifecycle ---------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            with self._cv:
                if self._thread is None or not self._thread.is_alive():
                    self._stop = False
                    self._thread = threading.Thread(
                        target=self._loop, name="search-batcher",
                        daemon=True)
                    self._thread.start()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # fail anything still queued rather than strand its waiter
        while self._queue:
            p = self._queue.popleft()
            p.error = RuntimeError("batcher shut down")
            p.done.set()

    # -- request side ------------------------------------------------------

    def submit(self, query: str, top_k: int, sw: float, lw: float
               ) -> Tuple[list, Optional[int]]:
        """Blocks until the batched dispatch covering this request
        completes; returns (results, query_id). Raises BatchTimeout when
        the engine cannot drain the queue in time."""
        self._ensure_started()
        p = _Pending(query, top_k, sw, lw)
        with self._cv:
            self._queue.append(p)
            self._cv.notify()
        if not p.done.wait(self.queue_timeout_s + 60.0):
            p.error = BatchTimeout(
                f"search queue stuck > {self.queue_timeout_s + 60.0:.0f}s")
        if p.error is not None:
            raise p.error
        return p.results or [], p.query_id

    # -- dispatcher --------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=1.0)
                if self._stop:
                    return
                batch: List[_Pending] = []
                while self._queue and len(batch) < self.max_batch:
                    batch.append(self._queue.popleft())
            self._dispatch(batch)

    def _dispatch(self, batch: List[_Pending]) -> None:
        now = time.perf_counter()
        live: List[_Pending] = []
        for p in batch:
            if now - p.t_enq > self.queue_timeout_s:
                p.error = BatchTimeout(
                    f"search queued > {self.queue_timeout_s:.0f}s")
                p.done.set()
            else:
                live.append(p)
        # group by fusion-weight signature: different weights produce
        # different fused scores and cannot share one program's output
        groups: dict = {}
        for p in live:
            groups.setdefault((p.sw, p.lw), []).append(p)
        for (sw, lw), grp in groups.items():
            queries = [p.query for p in grp]
            k = max(p.top_k for p in grp)
            n_pad = _bucket(len(queries), self.max_batch)
            padded = queries + [queries[-1]] * (n_pad - len(queries))
            try:
                rows = self.searcher.search_batch(
                    padded, top_k=k, semantic_weight=sw,
                    lexical_weight=lw, log=False)
            except BaseException as e:  # noqa: BLE001 — deliver to waiters
                for p in grp:
                    p.error = e
                    p.done.set()
                continue
            self.dispatches += 1
            self.batched_requests += len(grp)
            self.max_seen_batch = max(self.max_seen_batch, len(grp))
            for p, row in zip(grp, rows):
                p.results = row[:p.top_k]
                if self.query_memory is not None:
                    try:
                        p.query_id = self.query_memory.log_query(
                            p.query, sw, lw,
                            top_score=p.results[0][0] if p.results
                            else None,
                            n_results=len(p.results))
                    except Exception:  # noqa: BLE001 — logging is best-effort
                        p.query_id = None
                p.done.set()
