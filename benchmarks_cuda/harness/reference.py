"""The plain reference: exact hybrid search worked out again from the text.

From the corpus and the query texts alone, with the frozen text rules of
``textops.py`` and plain PyTorch:

- embeddings: the configuration's encoder kind's reference embedder
  (``encoders/<kind>.py`` ``Embedder``, built from the weights the
  benchmark drew and handed to the program too), L2-normalized; the dense
  score is the cosine, the product of query and document embeddings;
- BM25: Okapi weights of every (term, document) pair,
  ``idf * tf (k1 + 1) / (tf + k1 (1 - b + b len / avg_len))`` with
  ``idf = log((N - df + 0.5) / (df + 0.5) + 1)``, summed over the query's
  tokens (a repeated token counts again);
- fusion: each arm min-max normalized over every document (an arm with no
  spread is all ones), ``w_s * dense + w_l * lexical``, and the top k.

``precision="tf32"`` computes the dense products with TF32 inputs (the
card's TF32 matmul; on the CPU the inputs rounded to TF32's 10-bit
mantissa): the control, the nearest precision below the float32 the
configuration states. The reference imports nothing of the program.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from harness import textops


@contextmanager
def _matmul_precision(tf32: bool):
    """TF32 on or off for the card's float32 matmuls inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Params(NamedTuple):
    k1: float
    b: float
    w_s: float
    w_l: float


class Reference:
    """Exact fused scores of query texts over one corpus. ``embedder`` has
    ``embed(texts)``: [n, dim] float32, L2-normalized."""

    def __init__(self, texts: Sequence[str], embedder, params: Params,
                 precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.p, self.precision, self.embedder = params, precision, embedder
        self.n = len(texts)
        self.docs = embedder.embed(texts)
        self.device = self.docs.device
        self._fit_bm25(textops.hash_texts(texts))

    def _fit_bm25(self, hashed: textops.Hashed) -> None:
        p, dev = self.p, self.device
        self.vocab, term = np.unique(hashed.hashes, return_inverse=True)
        term = term.reshape(-1).astype(np.int64)
        V = max(len(self.vocab), 1)
        doc = np.repeat(np.arange(self.n, dtype=np.int64), hashed.counts)
        key, tf = np.unique(term * self.n + doc, return_counts=True)  # term-major
        t, d = key // self.n, key % self.n
        df = np.bincount(t, minlength=V).astype(np.float64)
        doc_len = hashed.counts.astype(np.float64)
        avg_len = max(float(doc_len.mean()) if self.n else 1.0, 1e-9)
        idf = np.log((self.n - df + 0.5) / (df + 0.5) + 1.0)
        tf = tf.astype(np.float64)
        w = idf[t] * tf * (p.k1 + 1.0) / (tf + p.k1 * (1.0 - p.b + p.b * doc_len[d] / avg_len))
        indptr = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(np.bincount(t, minlength=V), out=indptr[1:])
        self.indptr = torch.from_numpy(indptr).to(dev)
        self.post_doc = torch.from_numpy(d).to(dev)
        self.post_w = torch.from_numpy(w.astype(np.float32)).to(dev)

    def dense(self, queries: Sequence[str]) -> torch.Tensor:
        """[B, n] cosines."""
        q, docs = self.embedder.embed(queries), self.docs
        if self.precision == "tf32" and self.device.type != "cuda":
            q, docs = round_tf32(q), round_tf32(docs)
        with _matmul_precision(self.precision == "tf32"):
            return q @ docs.T

    def lexical(self, queries: Sequence[str]) -> torch.Tensor:
        """[B, n] BM25 scores."""
        hq = textops.hash_texts(queries)
        B, n, dev = len(queries), self.n, self.device
        row = np.repeat(np.arange(B, dtype=np.int64), hq.counts)
        at = np.minimum(np.searchsorted(self.vocab, hq.hashes), max(len(self.vocab) - 1, 0))
        known = (self.vocab[at] == hq.hashes) if len(self.vocab) else np.zeros(len(at), bool)
        row, term = row[known], at[known]
        out = torch.zeros(B * n, dtype=torch.float32, device=dev)
        if len(term):
            term_t = torch.from_numpy(term).to(dev)
            lo, hi = self.indptr[term_t], self.indptr[term_t + 1]
            lens = hi - lo
            owner = torch.repeat_interleave(torch.arange(len(term), device=dev), lens)
            first = torch.cumsum(lens, 0) - lens
            src = lo[owner] + torch.arange(owner.numel(), device=dev) - first[owner]
            flat = torch.from_numpy(row).to(dev)[owner] * n + self.post_doc[src]
            out.index_add_(0, flat, self.post_w[src])
        return out.view(B, n)

    def arms(self, queries: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, n] dense and lexical arms, each min-max normalized over every
        document (an arm with no spread is all ones)."""
        def norm(x):
            mn = x.amin(dim=1, keepdim=True)
            rng = x.amax(dim=1, keepdim=True) - mn
            return torch.where(rng > 1e-12, (x - mn) / rng.clamp_min(1e-12),
                               torch.ones_like(x))

        return norm(self.dense(queries)), norm(self.lexical(queries))

    def fused(self, queries: Sequence[str]) -> torch.Tensor:
        """[B, n] fused scores."""
        dense, lexical = self.arms(queries)
        return self.p.w_s * dense + self.p.w_l * lexical

    def topk_rows(self, queries: Sequence[str], k: int, texts: Sequence[str]) -> List[list]:
        """Rows as ``search_batch`` gives them: (score, text, document)."""
        vals, idx = torch.topk(self.fused(queries), k, dim=1)
        return [[(v, texts[i], i) for v, i in zip(vr, ir)]
                for vr, ir in zip(vals.double().cpu().tolist(), idx.cpu().tolist())]


class Served(NamedTuple):
    """A batch's served rows in plain arrays."""

    values: np.ndarray  # [B, k] float64, nan past a row's results
    docs: np.ndarray  # [B, k] int64 corpus index of each result, -1 past / unknown
    short: np.ndarray  # [B] bool: missing, or fewer than k results
    unknown: np.ndarray  # [B] bool: a result's text is no document of the corpus
    malformed: np.ndarray  # [B] bool: a document twice, or scores not descending


def served_arrays(rows: List[list], batch: int, k: int, index_of: Dict[str, int]) -> Served:
    """``search_batch``'s rows ([(score, content, id)] each) as arrays; a
    missing row counts as short. Texts map to corpus indices (a text that
    two documents share maps to the first: both score alike); repeats are
    found by the program's own ids."""
    rows = list(rows[:batch]) + [[]] * max(0, batch - len(rows))
    lens = np.fromiter((min(len(r), k) for r in rows), np.int64, batch)
    flat = [t for r in rows for t in r[:k]]
    values = np.full((batch, k), np.nan)
    docs = np.full((batch, k), -1, dtype=np.int64)
    ids = np.full((batch, k), -1, dtype=np.int64)
    at = (np.repeat(np.arange(batch), lens), np.arange(len(flat)) - np.repeat(
        np.cumsum(lens) - lens, lens))
    values[at] = np.fromiter((t[0] for t in flat), np.float64, len(flat))
    docs[at] = np.fromiter((index_of.get(t[1], -1) for t in flat), np.int64, len(flat))
    ids[at] = np.fromiter((t[2] for t in flat), np.int64, len(flat))
    unknown = np.zeros(batch, dtype=bool)
    np.logical_or.at(unknown, at[0], docs[at] < 0)
    s = np.sort(ids, axis=1)
    twice = ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(axis=1)
    rising = (np.diff(values, axis=1) > 0).any(axis=1)
    return Served(values, docs, lens != k, unknown, twice | rising)


class Judged(NamedTuple):
    score_gap: np.ndarray  # [B] widest |served value - reference score of that doc|
    rank_gap: np.ndarray  # [B] widest reference j-th score less that of the served j-th doc
    band_gap: np.ndarray  # [B] widest distance of a served value outside its band
    bad: np.ndarray  # [B] bool: short, citing an unknown text, or malformed


def judge(ref: Reference, queries: Sequence[str], served: Served, k: int) -> Judged:
    """Each row's gaps against the reference (0 for a bad row, which is
    judged by ``bad`` alone). The band of a served document holds on any
    row, certified or not: its dense part ``w_s * dense`` is exact (the
    dense arm's min and max come from a sweep of every document), and its
    lexical part, normalized by whatever maximum the program found, lies
    in [0, w_l]."""
    dense, lexical = ref.arms(queries)
    fused = ref.p.w_s * dense + ref.p.w_l * lexical
    top = torch.topk(fused, k, dim=1).values.double().cpu().numpy()
    docs = torch.from_numpy(np.maximum(served.docs, 0)).to(fused.device)
    of_served = torch.gather(fused, 1, docs).double().cpu().numpy()
    lo = ref.p.w_s * torch.gather(dense, 1, docs).double().cpu().numpy()
    bad = served.short | served.unknown | served.malformed
    ok = ~bad
    v = np.nan_to_num(served.values)
    score_gap = np.where(ok, np.abs(v - of_served).max(axis=1), 0.0)
    rank_gap = np.where(ok, (top - of_served).max(axis=1), 0.0)
    band = np.maximum(np.maximum(lo - v, v - (lo + ref.p.w_l)), 0.0)
    band_gap = np.where(ok, band.max(axis=1), 0.0)
    return Judged(score_gap, rank_gap, band_gap, bad)
