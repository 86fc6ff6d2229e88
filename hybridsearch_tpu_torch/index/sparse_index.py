"""BM25 sparse (lexical) index.

Counterpart of ``hybridsearch_tpu/index/sparse_index.py``, limited to what
the hybrid search path uses: every (term, doc) contribution is eager-scored
at fit time into device-resident term-major CSR postings (ops/bm25.py);
queries are encoded on the host into bucketed run pieces (the < 200k-doc
fused path), supertile slots (the supertile ladder, ops/supertile.py) or
impact-run descriptors (the impact ladder, ops/impact.py).

The fitted state is published atomically, so a reader never pairs a vocab
from one fit with postings from another; the structures derived from a
state (supertile, impact tier) are cached against it. Incremental adds
(delta segments), deletes, persistence and mesh sharding of the JAX module
are still to port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from hybridsearch_tpu_torch.ops import bm25 as bm25_ops
from hybridsearch_tpu_torch.text.extractor import (
    HashVocabulary,
    Vocabulary,
    extract_tokens,
    token_hashes_docs,
)
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device


class _BM25State(NamedTuple):
    vocab: Vocabulary
    postings: Optional[bm25_ops.BM25Postings]
    n_docs: int


class BM25:
    """Okapi BM25 with the reference's smoothed IDF."""

    variant = "bm25"

    def __init__(self, k1: float = 1.5, b: float = 0.75, delta: float = 1.0,
                 device: DeviceLike = None) -> None:
        self.k1 = k1
        self.b = b
        self.delta = delta
        self.device = resolve_device(device)
        self._state = _BM25State(Vocabulary(), None, 0)
        self._super_cache = None  # (state, SuperPostings)
        self._impact_cache = None  # (state, p_max, ImpactPostings)

    @property
    def vocab(self) -> Vocabulary:
        return self._state.vocab

    @property
    def postings(self) -> Optional[bm25_ops.BM25Postings]:
        return self._state.postings

    @property
    def n_docs(self) -> int:
        return self._state.n_docs

    # -- fit -------------------------------------------------------------

    def fit(self, corpus: Sequence[str]) -> "BM25":
        """Tokenize the corpus and publish eager-scored postings."""
        return self.fit_tokens([extract_tokens(t) for t in corpus])

    def fit_tokens(self, tokenized: Sequence[Sequence[str]]) -> "BM25":
        """Fit from token lists; term ids in first-seen order."""
        vocab = Vocabulary()
        n_new = len(tokenized)
        doc_lens = np.array([len(t) for t in tokenized], dtype=np.float64)
        add = vocab.add
        flat_ids = np.fromiter((add(t) for toks in tokenized for t in toks),
                               dtype=np.int64, count=int(doc_lens.sum()))
        doc_of = np.repeat(np.arange(n_new, dtype=np.int64),
                           doc_lens.astype(np.int64))
        V = max(len(vocab), 1)
        uniq, c_arr = np.unique(doc_of * V + flat_ids, return_counts=True)
        self._publish_from_coo(vocab, uniq % V, uniq // V,
                               c_arr.astype(np.float64), doc_lens)
        return self

    def fit_hashes(self, texts: Sequence[str]) -> "BM25":
        """Bulk fit with term identity = the stable 64-bit token hash
        (HashVocabulary, ids in hash order): the state the JAX package's
        native bulk-index path builds."""
        hashes, counts = token_hashes_docs(texts)
        return self.fit_coo_from_hashes(hashes, counts)

    def fit_coo_from_hashes(self, hashes: np.ndarray,
                            counts: np.ndarray) -> "BM25":
        """Publish a fitted state from per-doc token hashes (contiguous
        ``hashes``, per-doc ``counts``)."""
        doc_lens = counts.astype(np.float64)
        doc_of = np.repeat(np.arange(len(counts), dtype=np.int64),
                           counts.astype(np.int64))
        uniq_hashes, term_of = np.unique(hashes, return_inverse=True)
        vocab = HashVocabulary.from_hashes(uniq_hashes)
        V = max(len(vocab), 1)
        uniq, c_arr = np.unique(doc_of * V + term_of.reshape(-1),
                                return_counts=True)
        self._publish_from_coo(vocab, uniq % V, uniq // V,
                               c_arr.astype(np.float64), doc_lens)
        return self

    def _publish_from_coo(self, vocab, t_arr, d_arr, c_arr, doc_lens) -> None:
        """Eager weights over the (term asc, doc asc)-sorted COO, CSR build,
        atomic publish."""
        n_docs = len(doc_lens)
        if len(t_arr):
            order = np.lexsort((d_arr, t_arr))
            t_arr, d_arr, c_arr = t_arr[order], d_arr[order], c_arr[order]
        V = len(vocab)
        df = np.bincount(t_arr, minlength=V).astype(np.int64)[:V]
        avg_len = max(float(doc_lens.sum()) / n_docs if n_docs else 1.0, 1e-9)
        weights = bm25_ops.compute_eager_weights(
            t_arr, d_arr, c_arr, doc_lens, n_docs, V, k1=self.k1, b=self.b,
            variant=self.variant, delta=self.delta, df=df, avg_len=avg_len)
        postings = bm25_ops.build_postings_arrays(
            t_arr, d_arr.astype(np.int32), weights, n_docs, V, self.device,
            presorted=True)
        self.set_state(vocab, postings, n_docs)

    def set_state(self, vocab, postings: bm25_ops.BM25Postings,
                  n_docs: int) -> None:
        """Atomically publish a fitted state (also used by convert.py)."""
        self._state = _BM25State(vocab, postings, n_docs)

    # -- query encoding ----------------------------------------------------

    def encode_queries_bucketed(self, queries: Sequence[str],
                                state: Optional[_BM25State] = None):
        """Per-bucket (width, starts, lengths) run pieces for the fused
        < 200k-doc path."""
        state = state or self._state
        if state.postings is None:
            return []
        po = state.postings
        term_id_lists = [state.vocab.encode(extract_tokens(q)) for q in queries]
        return bm25_ops.encode_run_pieces(po.starts_host, po.lengths_host,
                                          term_id_lists, po.max_postings)

    def super_postings(self, state: Optional[_BM25State] = None,
                       super_tiles: int = 128):
        """Supertile structures for the fitted state (built once per state
        and cached)."""
        state = state or self._state
        if state.postings is None:
            return None
        cached = self._super_cache
        if cached is not None and cached[0] is state:
            return cached[1]
        from hybridsearch_tpu_torch.ops.supertile import build_super_postings

        po = state.postings
        nnz = int(po.starts_host[-1] + po.lengths_host[-1]) if po.vocab_size else 0
        sp = build_super_postings(
            self._coo_term_ids(po), po.doc_ids[:nnz].cpu().numpy(),
            po.weights[:nnz].cpu().numpy(), po.n_docs, po.vocab_size,
            self.device, super_tiles=super_tiles)
        self._super_cache = (state, sp)  # atomic publish
        return sp

    def _coo_term_ids(self, po: bm25_ops.BM25Postings) -> np.ndarray:
        """[nnz] term id of every CSR entry."""
        return np.repeat(np.arange(po.vocab_size, dtype=np.int64),
                         po.lengths_host)

    def impact_postings(self, p_max: int = 4096,
                        state: Optional[_BM25State] = None):
        """The impact-ordered pruned tier of a fitted state (ops/impact.py),
        built at first use and cached per state (a deeper cached tier
        serves a shallower request)."""
        state = state or self._state
        if state.postings is None:
            return None
        cached = self._impact_cache
        if cached is not None and cached[0] is state and cached[1] >= p_max:
            return cached[2]
        from hybridsearch_tpu_torch.ops.impact import build_impact_postings

        po = state.postings
        nnz = int(po.starts_host[-1] + po.lengths_host[-1]) if po.vocab_size else 0
        imp = build_impact_postings(
            self._coo_term_ids(po), po.doc_ids[:nnz].cpu().numpy(),
            po.weights[:nnz].cpu().numpy(), po.n_docs, po.vocab_size,
            p_max=p_max, device=self.device)
        self._impact_cache = (state, p_max, imp)  # atomic publish
        return imp

    def encode_queries_impact(self, queries: Sequence[str], p_depth: int,
                              p_max: int = 4096):
        """(ImpactPostings, ImpactQueryEnc) for hybrid_impact_topk. The vocab,
        the tier, the hot descriptors and the full CSR arrays they index
        into (``enc.full_postings``) all come from ONE state snapshot."""
        from hybridsearch_tpu_torch.ops.impact import encode_impact_queries

        state = self._state
        imp = self.impact_postings(p_max=p_max, state=state)
        if imp is None:
            return None, None
        po = state.postings
        term_id_lists = [state.vocab.encode(extract_tokens(q)) for q in queries]
        enc = encode_impact_queries(imp, term_id_lists, p_depth=p_depth,
                                    full_starts=po.starts_host,
                                    full_lengths=po.lengths_host)
        return imp, enc._replace(full_postings=(po.doc_ids, po.weights))

    def encode_queries_super(self, queries: Sequence[str]):
        """(SuperPostings, SuperQueryEnc) from one state snapshot."""
        from hybridsearch_tpu_torch.ops.supertile import encode_super_queries

        state = self._state
        sp = self.super_postings(state=state)
        if sp is None:
            return None, None
        term_id_lists = [state.vocab.encode(extract_tokens(q)) for q in queries]
        return sp, encode_super_queries(sp, term_id_lists)


class BM25Plus(BM25):
    """BM25+ — adds delta inside the per-term sum for matching docs."""

    variant = "bm25plus"
