"""Query logging, feedback, and learned fusion weights.

Parity with the reference QueryMemory (reference core.py:20-109): every
query is logged with its weights; positive feedback accumulates; once >= 10
positively-rated samples exist, the optimal weights are the average over
those queries' weights (reference core.py:55-78)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from hybridsearch_tpu_torch.store.docstore import DocStore


class QueryMemory:
    MIN_SAMPLES = 10  # reference core.py:73

    def __init__(self, store: DocStore) -> None:
        self.store = store

    def log_query(
        self,
        query: str,
        semantic_weight: float,
        lexical_weight: float,
        top_score: Optional[float] = None,
        n_results: int = 0,
        latency_ms: Optional[float] = None,
    ) -> int:
        return self.store.log_query(
            query, semantic_weight, lexical_weight, top_score, n_results, latency_ms
        )

    def log_feedback(self, query: str, doc_id: int, rating: int,
                     query_id: Optional[int] = None) -> int:
        return self.store.log_feedback(query, doc_id, rating, query_id)

    def get_optimal_weights(self) -> Optional[Tuple[float, float]]:
        return self.store.optimal_weights(min_samples=self.MIN_SAMPLES)

    def get_query_stats(self) -> Dict[str, Any]:
        return self.store.query_stats()
