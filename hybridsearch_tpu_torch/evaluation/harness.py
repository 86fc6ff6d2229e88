"""Search quality evaluation harness (the port of
``hybridsearch_tpu/evaluation/harness.py``).

Parity with the reference evaluator (reference evaluation.py:64-297):
evaluate_query / evaluate over {"query", "relevant_doc_ids"} test sets with
P/R/F1@k, MRR, NDCG@k and latency p50/p95/p99; multi-config comparison
(compare_configs); test-set synthesis from positive feedback.

Plus the recall-parity harness required by BASELINE.json: Jaccard overlap
of the engine's top-k ids against the NumPy flat+BM25 oracle at equal
inputs (>= 0.99 target).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from hybridsearch_tpu_torch.evaluation import oracle
from hybridsearch_tpu_torch.evaluation.metrics import (
    f1_at_k,
    host_array,
    latency_percentiles,
    mrr,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
)


class SearchEvaluator:
    """Evaluate a searcher against ground-truth test sets."""

    def __init__(self, searcher, k: int = 10) -> None:
        self.searcher = searcher
        self.k = k

    def evaluate_query(self, query: str, relevant_doc_ids: Sequence[int],
                       **search_kwargs) -> Dict[str, Any]:
        """Single-query metrics (reference evaluation.py:131-179)."""
        t0 = time.perf_counter()
        results = self.searcher.search(query, top_k=self.k, log=False,
                                       **search_kwargs)
        latency = time.perf_counter() - t0
        retrieved = [doc_id for _s, _c, doc_id in results]
        return {
            "query": query,
            "precision": precision_at_k(retrieved, relevant_doc_ids, self.k),
            "recall": recall_at_k(retrieved, relevant_doc_ids, self.k),
            "f1": f1_at_k(retrieved, relevant_doc_ids, self.k),
            "mrr": mrr(retrieved, relevant_doc_ids),
            "ndcg": ndcg_at_k(retrieved, relevant_doc_ids, self.k),
            "latency_s": latency,
            "retrieved": retrieved,
        }

    def evaluate(self, test_set: Sequence[Dict[str, Any]],
                 **search_kwargs) -> Dict[str, Any]:
        """Aggregate metrics over a test set (reference evaluation.py:181-225)."""
        rows = [
            self.evaluate_query(t["query"], t["relevant_doc_ids"],
                                **search_kwargs)
            for t in test_set
        ]
        if not rows:
            return {"queries": 0}
        agg = {
            "queries": len(rows),
            "precision": float(np.mean([r["precision"] for r in rows])),
            "recall": float(np.mean([r["recall"] for r in rows])),
            "f1": float(np.mean([r["f1"] for r in rows])),
            "mrr": float(np.mean([r["mrr"] for r in rows])),
            "ndcg": float(np.mean([r["ndcg"] for r in rows])),
            **latency_percentiles([r["latency_s"] for r in rows]),
            "per_query": rows,
        }
        return agg

    def compare_configs(
        self,
        test_set: Sequence[Dict[str, Any]],
        configs: Dict[str, Dict[str, Any]],
    ) -> Dict[str, Dict[str, Any]]:
        """A/B comparison of search kwargs (reference evaluation.py:240-266)."""
        out = {}
        for name, kwargs in configs.items():
            result = self.evaluate(test_set, **kwargs)
            result.pop("per_query", None)
            out[name] = result
        return out

    def create_test_set_from_feedback(self, min_rating: int = 1
                                      ) -> List[Dict[str, Any]]:
        """Ground truth from positive click feedback (reference
        evaluation.py:269-297)."""
        return self.searcher.indexer.store.feedback_test_set(min_rating)


def recall_parity(
    searcher,
    queries: Sequence[str],
    k: int = 10,
    semantic_weight: float = 0.7,
    lexical_weight: float = 0.3,
) -> Dict[str, float]:
    """BASELINE.json parity metric: Jaccard overlap of the engine's top-k
    doc ids vs a NumPy oracle computing the same flat-cosine + BM25 hybrid
    on the same embeddings. Target >= 0.99."""
    ix = searcher.indexer
    n = ix.dense.n_docs
    doc_vecs = ix.dense.get_vectors(list(range(n)))
    from hybridsearch_tpu_torch.text.extractor import extract_tokens

    bm_oracle = oracle.BM25Oracle(
        k1=ix.bm25.k1, b=ix.bm25.b,
        variant=ix.bm25.variant, delta=ix.bm25.delta,
    ).fit([extract_tokens(c) for c in ix.contents])

    jaccards = []
    for q in queries:
        got = [i for _s, _c, i in searcher.search(q, top_k=k, log=False,
                                                  semantic_weight=semantic_weight,
                                                  lexical_weight=lexical_weight)]
        q_vec = host_array(ix.encoder.encode([q]))
        sem = oracle.cosine_scores(q_vec, doc_vecs)[0]
        lex = bm_oracle.score_all(extract_tokens(q))
        hybrid = oracle.hybrid_fusion(sem[None, :], lex[None, :],
                                      semantic_weight, lexical_weight)[0]
        want = np.argsort(-hybrid, kind="stable")[:k].tolist()
        jaccards.append(oracle.recall_jaccard(got, want))
    return {
        "mean_jaccard": float(np.mean(jaccards)),
        "min_jaccard": float(np.min(jaccards)),
        "queries": len(queries),
        "k": k,
    }
