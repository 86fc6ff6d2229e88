"""NumPy reference oracle for kernel parity tests (a copy of
``hybridsearch_tpu/evaluation/oracle.py``, not an import of it).

Implements flat cosine top-k, BM25 scoring, min-max normalization, weighted
fusion, and MMR with semantics matching the reference implementation
(reference utils.py:5-106, bm25.py:45-179, core.py:178-285,
pipelines.py:531-569). Kernels are tested against this oracle; the oracle
itself is tested against hand-computed values. Pure NumPy.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np


def l2_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.sqrt((x.astype(np.float64) ** 2).sum(axis=-1, keepdims=True))
    return x / np.maximum(n, eps)


def cosine_scores(queries: np.ndarray, docs: np.ndarray) -> np.ndarray:
    """[B, N] cosine matrix (reference utils.py:28 batch_cosine_sim)."""
    q = l2_normalize(queries.astype(np.float64))
    d = l2_normalize(docs.astype(np.float64))
    return (q @ d.T).astype(np.float32)


def dense_topk(
    queries: np.ndarray, docs: np.ndarray, k: int, normalized: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k by inner product (== FAISS IndexFlatIP after normalize,
    reference indexer.py:40-58)."""
    if normalized:
        s = (queries.astype(np.float64) @ docs.astype(np.float64).T).astype(np.float32)
    else:
        s = cosine_scores(queries, docs)
    k = min(k, docs.shape[0])
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(s, idx, axis=1)
    return vals, idx.astype(np.int32)


def minmax_normalize(scores: np.ndarray) -> np.ndarray:
    """Reference utils.py:57-71 semantics: constant scores -> all ones."""
    s = scores.astype(np.float32)
    mn, mx = s.min(axis=-1, keepdims=True), s.max(axis=-1, keepdims=True)
    rng = mx - mn
    out = np.where(rng > 1e-12, (s - mn) / np.where(rng > 1e-12, rng, 1.0), 1.0)
    return out.astype(np.float32)


class BM25Oracle:
    """Dict-based BM25 matching the reference's formulas exactly
    (fit: bm25.py:45-81, score: bm25.py:83-112, BM25+: bm25.py:160-179)."""

    def __init__(self, k1: float = 1.5, b: float = 0.75, variant: str = "bm25",
                 delta: float = 1.0):
        self.k1, self.b, self.variant, self.delta = k1, b, variant, delta
        self.doc_tfs: List[Counter] = []
        self.doc_lens: List[int] = []
        self.idf: Dict[str, float] = {}
        self.avg_len = 0.0
        self.n_docs = 0

    def fit(self, tokenized_docs: Sequence[Sequence[str]]) -> "BM25Oracle":
        self.doc_tfs = [Counter(toks) for toks in tokenized_docs]
        self.doc_lens = [len(toks) for toks in tokenized_docs]
        self.n_docs = len(tokenized_docs)
        self.avg_len = (sum(self.doc_lens) / self.n_docs) if self.n_docs else 0.0
        df: Counter = Counter()
        for tf in self.doc_tfs:
            df.update(tf.keys())
        self.idf = {
            t: math.log((self.n_docs - n + 0.5) / (n + 0.5) + 1.0)
            for t, n in df.items()
        }
        return self

    def score(self, query_tokens: Sequence[str], doc_idx: int) -> float:
        tf = self.doc_tfs[doc_idx]
        dl = self.doc_lens[doc_idx]
        avg = max(self.avg_len, 1e-9)
        s = 0.0
        for t in query_tokens:
            if t not in tf:
                continue
            f = tf[t]
            comp = f * (self.k1 + 1.0) / (
                f + self.k1 * (1.0 - self.b + self.b * dl / avg)
            )
            if self.variant == "bm25plus":
                comp += self.delta
            s += self.idf.get(t, 0.0) * comp
        return s

    def score_all(self, query_tokens: Sequence[str]) -> np.ndarray:
        return np.array(
            [self.score(query_tokens, i) for i in range(self.n_docs)],
            dtype=np.float32,
        )


def hybrid_fusion(
    semantic: np.ndarray, lexical: np.ndarray, w_sem: float = 0.7, w_lex: float = 0.3
) -> np.ndarray:
    """Reference core.py:264-268: min-max normalize both, weighted sum."""
    return minmax_normalize(semantic) * w_sem + minmax_normalize(lexical) * w_lex


def mmr(
    relevance: np.ndarray, embeddings: np.ndarray, k: int, lam: float = 0.5
) -> List[int]:
    """Greedy MMR (reference pipelines.py:531-569)."""
    emb = l2_normalize(embeddings.astype(np.float64))
    sim = emb @ emb.T
    C = len(relevance)
    selected: List[int] = []
    remaining = set(range(C))
    max_sim = np.zeros(C)
    for _ in range(min(k, C)):
        best, best_score = -1, -np.inf
        for i in sorted(remaining):
            score = lam * relevance[i] - (1 - lam) * max_sim[i]
            if score > best_score:
                best, best_score = i, score
        selected.append(best)
        remaining.discard(best)
        max_sim = np.maximum(max_sim, sim[:, best])
    return selected


def recall_jaccard(ids_a: Sequence[int], ids_b: Sequence[int]) -> float:
    """Jaccard overlap of two retrieved id sets (BASELINE.json parity metric)."""
    a, b = set(ids_a), set(ids_b)
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)
