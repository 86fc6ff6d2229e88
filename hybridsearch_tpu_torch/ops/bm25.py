"""BM25 sparse scoring: eager CSR postings and bucketed run scoring.

Counterpart of ``hybridsearch_tpu/ops/bm25.py``, limited to what the hybrid
search path uses. At index build time the full BM25 contribution of every
(term, doc) pair is precomputed (BM25S-style):

    w(t, d) = idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * len_d / avg_len))
    idf(t) = log((N - df + 0.5) / (df + 0.5) + 1)

and stored in term-major, doc-sorted CSR on the device. A query batch is
encoded on the host into (start, length) posting-run pieces bucketed by
width, and scored by one gather + one scatter-add per bucket into [B, n].
``cand_scores_bisect`` scores given candidates by bisection over the full
runs (the impact hybrid's margin correction, ops/hybrid.py). The hot-term
tables, the other candidate scorers and mesh sharding of the JAX module
serve paths the port does not take yet.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class BM25Postings(NamedTuple):
    """Device-resident eager-scored postings (term-major CSR)."""

    indptr: torch.Tensor  # [V+1] int64 — start offset of each term's run
    doc_ids: torch.Tensor  # [nnz + P_max] int32 — padded tail = n_docs
    weights: torch.Tensor  # [nnz + P_max] float32 — padded tail = 0
    n_docs: int
    max_postings: int  # longest posting run (slice width cap)
    vocab_size: int
    starts_host: np.ndarray  # [V] int64 host run starts
    lengths_host: np.ndarray  # [V] int64 host run lengths


def build_postings_arrays(
    term_ids: np.ndarray,
    doc_ids: np.ndarray,
    weights: np.ndarray,
    n_docs: int,
    vocab_size: int,
    device: torch.device,
    presorted: bool = False,
) -> BM25Postings:
    """Host-side CSR build from COO (term, doc, weight) triples, padded by
    max_postings so a run slice of any bucket width never reads out of
    bounds. presorted=True asserts (term asc, doc asc) order."""
    if presorted:
        t = term_ids.astype(np.int64)
        d = doc_ids.astype(np.int32)
        w = weights.astype(np.float32)
    else:
        order = np.lexsort((doc_ids, term_ids))
        t = term_ids[order].astype(np.int64)
        d = doc_ids[order].astype(np.int32)
        w = weights[order].astype(np.float32)
    indptr = np.zeros(vocab_size + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(t, minlength=vocab_size)[:vocab_size])
    lengths = indptr[1:] - indptr[:-1]
    max_post = max(int(lengths.max()) if len(t) else 1, 1)
    d_pad = np.concatenate([d, np.full(max_post, n_docs, dtype=np.int32)])
    w_pad = np.concatenate([w, np.zeros(max_post, dtype=np.float32)])
    return BM25Postings(
        indptr=torch.from_numpy(indptr).to(device),
        doc_ids=torch.from_numpy(d_pad).to(device),
        weights=torch.from_numpy(w_pad).to(device),
        n_docs=n_docs,
        max_postings=max_post,
        vocab_size=vocab_size,
        starts_host=indptr[:-1].astype(np.int64),
        lengths_host=lengths.astype(np.int64),
    )


# Posting-run length buckets: a query term is scored with slices as wide as
# its bucket, not the corpus-wide max run; runs longer than the top bucket
# are split into pieces at encode time. Term counts pad to TERM_LADDER and
# each width caps its pieces per query at T_CAPS (extra pieces form further
# groups), bounding the [B, T, W] gather staging.
LENGTH_BUCKETS = (128, 1024, 8192, 65536)
TERM_LADDER = (8, 32, 128, 256)
T_CAPS = {128: 256, 1024: 64, 8192: 16, 65536: 8}


def bucket_width(run_len: int, cap: int) -> int:
    for w in LENGTH_BUCKETS:
        if run_len <= w:
            return min(w, cap)
    return LENGTH_BUCKETS[-1]


def _ladder(n: int, cap: int) -> int:
    for t in TERM_LADDER:
        if t >= n:
            return min(t, cap)
    return cap


def encode_run_pieces(
    starts_host: np.ndarray,
    lengths_host: np.ndarray,
    query_term_ids: Sequence[Sequence[int]],
    cap: int,
) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Host-side query encoding: term ids -> per-bucket (width,
    starts [B, T], lengths [B, T]) run pieces (int32 numpy)."""
    B = len(query_term_ids)
    buckets: dict = {}
    for qi, ids in enumerate(query_term_ids):
        for tid in ids:
            start = int(starts_host[tid])
            remaining = int(lengths_host[tid])
            off = 0
            while remaining > 0:
                piece = min(remaining, LENGTH_BUCKETS[-1])
                w = bucket_width(piece, cap)
                buckets.setdefault(w, [[] for _ in range(B)])[qi].append(
                    (start + off, piece))
                off += piece
                remaining -= piece
    out: List[Tuple[int, np.ndarray, np.ndarray]] = []
    for w in sorted(buckets):
        lists = buckets[w]
        longest = max((len(x) for x in lists), default=0)
        t_cap = T_CAPS.get(w, TERM_LADDER[-1])
        for chunk_start in range(0, longest, t_cap):
            chunk = [x[chunk_start:chunk_start + t_cap] for x in lists]
            c_longest = max((len(x) for x in chunk), default=0)
            if c_longest == 0:
                continue
            T = _ladder(c_longest, t_cap)
            s_arr = np.zeros((B, T), dtype=np.int32)
            l_arr = np.zeros((B, T), dtype=np.int32)
            for qi, pieces in enumerate(chunk):
                for j, (st, ln) in enumerate(pieces[:T]):
                    s_arr[qi, j] = st
                    l_arr[qi, j] = ln
            out.append((w, s_arr, l_arr))
    return out


def bm25_scores_runs(
    doc_ids: torch.Tensor,
    weights: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    n_docs: int,
    width: int,
) -> torch.Tensor:
    """[B, n_docs] scores from (start, length) posting-run pieces: one
    gather of [B, T, width] slices, one scatter-add (masked slots land in
    a dropped column)."""
    B = starts.shape[0]
    iota = torch.arange(width, device=doc_ids.device)
    pos = starts.long()[:, :, None] + iota  # [B, T, W]
    valid = iota < lengths.long()[:, :, None]
    ids = torch.where(valid, doc_ids[pos].long(), n_docs)
    ws = torch.where(valid, weights[pos], 0.0)
    out = torch.zeros((B, n_docs + 1), dtype=torch.float32, device=doc_ids.device)
    out.scatter_add_(1, ids.reshape(B, -1), ws.reshape(B, -1))
    return out[:, :n_docs]


def local_bucketed_scores(doc_ids: torch.Tensor, weights: torch.Tensor,
                          groups: Sequence[Tuple[int, np.ndarray, np.ndarray]],
                          n: int, batch: int) -> torch.Tensor:
    """Sum of the bucketed run-piece scores of every group: [batch, n]."""
    dev = doc_ids.device
    total = torch.zeros((batch, n), dtype=torch.float32, device=dev)
    for width, starts, lengths in groups:
        total += bm25_scores_runs(doc_ids, weights,
                                  torch.from_numpy(starts).to(dev),
                                  torch.from_numpy(lengths).to(dev), n, width)
    return total


def cand_scores_bisect(
    doc_ids: torch.Tensor,  # [nnz_pad] int32, doc-sorted within each run
    weights: torch.Tensor,  # [nnz_pad] float32
    starts: torch.Tensor,  # [B, H] run starts (0 = pad with len 0)
    lengths: torch.Tensor,  # [B, H] run lengths (0 = pad)
    candidates: torch.Tensor,  # [B, C] doc ids (out-of-range = no hit)
    n_iters: int = 26,
) -> torch.Tensor:
    """[B, C] summed weights of candidates across the given runs by
    lower-bound bisection in place over the device-resident CSR (no run is
    ever sliced out). 2^26 covers runs to 67M postings; the runs are added
    in order h = 0 .. H-1."""
    st = starts.long()[:, :, None]  # [B, H, 1]
    ln = lengths.long()[:, :, None]
    cand = candidates.long()[:, None, :]  # [B, 1, C]
    B, H = starts.shape
    C = candidates.shape[1]
    lo = torch.zeros((B, H, C), dtype=torch.long, device=doc_ids.device)
    hi = ln.expand(B, H, C).clone()
    last = (ln - 1).clamp_min(0)
    for _ in range(n_iters):
        mid = (lo + hi) // 2
        v = doc_ids[st + torch.minimum(mid, last)].long()
        upd = lo < hi
        go_right = upd & (v < cand)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(upd & ~go_right, mid, hi)
    pos = st + torch.minimum(lo, last)
    hit = (lo < ln) & (doc_ids[pos].long() == cand)
    w = torch.where(hit, weights[pos], 0.0)
    acc = torch.zeros((B, C), dtype=torch.float32, device=doc_ids.device)
    for h in range(H):
        acc = acc + w[:, h]
    return acc


def compute_eager_weights(
    tf_term_ids: np.ndarray,
    tf_doc_ids: np.ndarray,
    tf_counts: np.ndarray,
    doc_lens: np.ndarray,
    n_docs: int,
    vocab_size: int,
    k1: float = 1.5,
    b: float = 0.75,
    variant: str = "bm25",
    delta: float = 1.0,
    df: Optional[np.ndarray] = None,
    avg_len: Optional[float] = None,
) -> np.ndarray:
    """Host-side eager weights from COO tf triples (float64 math, float32
    out). BM25+ adds ``delta`` inside the per-term sum."""
    if df is None:
        df = np.bincount(tf_term_ids, minlength=vocab_size).astype(np.int64)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
    if avg_len is None:
        avg_len = float(doc_lens.mean()) if n_docs else 1.0
    avg_len = max(avg_len, 1e-9)
    tf = tf_counts.astype(np.float64)
    len_norm = k1 * (1.0 - b + b * doc_lens[tf_doc_ids] / avg_len)
    comp = tf * (k1 + 1.0) / (tf + len_norm)
    if variant == "bm25plus":
        comp = comp + delta
    return (idf[tf_term_ids] * comp).astype(np.float32)
