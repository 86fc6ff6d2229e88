"""Retrieval evaluation metrics (a copy of
``hybridsearch_tpu/evaluation/metrics.py``).

Parity with the reference evaluator (reference evaluation.py:80-129):
P/R/F1@k, MRR, binary NDCG@k (including its slightly non-standard ideal
ranking, see ndcg_at_k), latency percentiles p50/p95/p99
(reference evaluation.py:221-223).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np


def precision_at_k(retrieved: Sequence[int], relevant: Sequence[int], k: int) -> float:
    if k <= 0:
        return 0.0
    top = list(retrieved)[:k]
    if not top:
        return 0.0
    rel = set(relevant)
    return sum(1 for d in top if d in rel) / len(top)


def recall_at_k(retrieved: Sequence[int], relevant: Sequence[int], k: int) -> float:
    rel = set(relevant)
    if not rel:
        return 0.0
    top = list(retrieved)[:k]
    return sum(1 for d in top if d in rel) / len(rel)


def f1_at_k(retrieved: Sequence[int], relevant: Sequence[int], k: int) -> float:
    p = precision_at_k(retrieved, relevant, k)
    r = recall_at_k(retrieved, relevant, k)
    return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


def mrr(retrieved: Sequence[int], relevant: Sequence[int]) -> float:
    rel = set(relevant)
    for rank, d in enumerate(retrieved, start=1):
        if d in rel:
            return 1.0 / rank
    return 0.0


def ndcg_at_k(retrieved: Sequence[int], relevant: Sequence[int], k: int) -> float:
    """Binary NDCG@k with the reference's ideal ranking: IDCG assumes the
    first min(|relevant|, k) positions are all relevant
    (reference evaluation.py:111-129)."""
    rel = set(relevant)
    top = list(retrieved)[:k]
    dcg = sum(
        (1.0 / math.log2(rank + 1)) for rank, d in enumerate(top, start=1) if d in rel
    )
    ideal_hits = min(len(rel), k)
    idcg = sum(1.0 / math.log2(rank + 1) for rank in range(1, ideal_hits + 1))
    return dcg / idcg if idcg > 0 else 0.0


def latency_percentiles(latencies_s: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 in milliseconds (reference evaluation.py:221-223)."""
    if not latencies_s:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    arr = np.asarray(latencies_s, dtype=np.float64) * 1e3
    return {
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
    }


def host_array(x) -> np.ndarray:
    """A float32 host array of a model's output (a tensor on any device, or
    anything numpy takes)."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.array(x, np.float32)
