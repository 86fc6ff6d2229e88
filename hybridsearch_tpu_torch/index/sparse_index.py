"""BM25 sparse (lexical) index.

Counterpart of ``hybridsearch_tpu/index/sparse_index.py`` on one device:
every (term, doc) contribution is eager-scored at fit time into
device-resident term-major CSR postings (ops/bm25.py); queries are encoded
on the host into bucketed run pieces (the < 200k-doc fused path and
``batch_scores``), supertile slots (the supertile ladder, ops/supertile.py)
or impact-run descriptors (the impact ladder, ops/impact.py).

The fitted state is published atomically, so a reader never pairs a vocab
from one fit with postings from another; the structures derived from a
state (supertile, impact tier) are cached against it. Incremental adds land
in a delta segment scored beside the main postings under the stats frozen
at the last full publish (the epoch); ``compact`` folds it in with a full
recompute, and every at-scale builder and ``save`` compact first. Deletes
are tombstones that ``search`` honours; a fit clears them. ``save`` /
``load`` read and write the JAX package's ``.npz`` layout. Mesh sharding
and the hot-term tables of the JAX module are still to port.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.ops import bm25 as bm25_ops
from hybridsearch_tpu_torch.text.extractor import (
    HashVocabulary,
    Vocabulary,
    extract_tokens,
    stable_token_hash,
    token_hashes_docs,
)
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

# query widths of the term-id encoding (``_encode_queries``)
_QUERY_WIDTHS = (8, 16, 32, 64, 128)


class _DeltaSeg(NamedTuple):
    """Docs added since the epoch. ``tf`` is their own (term asc, doc
    asc)-sorted COO with global doc ids; ``postings`` a CSR over just these
    docs (n_docs = the corpus total) weighted under the epoch's frozen
    stats. A doc lives in exactly one segment, so main + delta is its
    score."""

    tf: tuple  # (t, d, c, doc_lens)
    postings: bm25_ops.BM25Postings


class _BM25State(NamedTuple):
    vocab: Vocabulary
    postings: Optional[bm25_ops.BM25Postings]
    n_docs: int
    term_runs: Optional[np.ndarray] = None  # [V+1] host run lengths
    # host COO (t, d, c, doc_lens), (term asc, doc asc)-sorted, of the
    # epoch corpus: incremental adds merge into it, never re-tokenizing
    tf_cache: Optional[tuple] = None
    # (df [V] int64, avg_len, len_sum) of the last full publish: the delta
    # is weighted under these
    frozen: Optional[tuple] = None
    delta_seg: Optional[_DeltaSeg] = None


class BM25:
    """Okapi BM25 with the reference's smoothed IDF."""

    variant = "bm25"

    # The frozen stats serve until the delta holds more than 1% of the
    # epoch corpus (or 64 docs for tiny corpora) or avg_len drifts 1%;
    # then the add folds everything into a full recompute.
    DELTA_MAX_FRAC = 0.01
    DELTA_MIN_DOCS = 64
    AVG_LEN_DRIFT = 0.01

    def __init__(self, k1: float = 1.5, b: float = 0.75, delta: float = 1.0,
                 device: DeviceLike = None) -> None:
        self.k1 = k1
        self.b = b
        self.delta = delta
        self.device = resolve_device(device)
        self._state = _BM25State(Vocabulary(), None, 0)
        self._super_cache = None  # (state, SuperPostings)
        self._impact_cache = None  # (state, p_max, ImpactPostings)
        # deleted doc ids, masked out of search() until the next fit
        self._tombstones: set = set()

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
        self._publish_from_coo(vocab, *self._encode_coo(tokenized, vocab, 0))
        self._tombstones = set()  # a refit defines a fresh corpus
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
        self._tombstones = set()
        return self

    @staticmethod
    def _coo_of_ids(flat_ids: np.ndarray, doc_lens: np.ndarray, V: int,
                    doc_base: int):
        """(term, doc, count) COO, (doc, term)-sorted, of a doc-major term
        id stream; docs numbered from ``doc_base``."""
        doc_of = np.repeat(np.arange(doc_base, doc_base + len(doc_lens),
                                     dtype=np.int64), doc_lens.astype(np.int64))
        V = max(V, 1)
        uniq, c_arr = np.unique(doc_of * V + flat_ids, return_counts=True)
        return uniq % V, uniq // V, c_arr.astype(np.float64), doc_lens

    @classmethod
    def _encode_coo(cls, tokenized, vocab, doc_base: int):
        """(term, doc, count) COO and float64 doc lengths of token lists,
        new terms added to ``vocab`` in first-seen order. A hash vocabulary
        hashes each distinct token once and adds the stream in bulk (the
        ids ``vocab.add`` gives token by token)."""
        doc_lens = np.array([len(t) for t in tokenized], dtype=np.float64)
        if isinstance(vocab, HashVocabulary):
            table: dict = {}
            flat = np.fromiter((table.setdefault(t, len(table))
                                for toks in tokenized for t in toks),
                               dtype=np.int64, count=int(doc_lens.sum()))
            h_tok = np.fromiter((stable_token_hash(t) for t in table),
                                dtype=np.uint64, count=len(table))
            flat_ids = vocab.add_hashes(h_tok[flat])
        else:
            add = vocab.add
            flat_ids = np.fromiter((add(t) for toks in tokenized for t in toks),
                                   dtype=np.int64, count=int(doc_lens.sum()))
        return cls._coo_of_ids(flat_ids, doc_lens, len(vocab), doc_base)

    def _publish_from_coo(self, vocab, t_arr, d_arr, c_arr, doc_lens,
                          presorted: bool = False) -> None:
        """Eager weights over the (term asc, doc asc)-sorted COO, CSR build,
        atomic publish. The sorted COO is kept as the tf cache and the
        stats as the frozen epoch stats."""
        n_docs = len(doc_lens)
        if not presorted and len(t_arr):
            order = np.lexsort((d_arr, t_arr))
            t_arr, d_arr, c_arr = t_arr[order], d_arr[order], c_arr[order]
        V = len(vocab)
        df = np.bincount(t_arr, minlength=V).astype(np.int64)[:V]
        len_sum = float(doc_lens.sum())
        avg_len = max(len_sum / n_docs if n_docs else 1.0, 1e-9)
        weights = bm25_ops.compute_eager_weights(
            t_arr, d_arr, c_arr, doc_lens, n_docs, V, k1=self.k1, b=self.b,
            variant=self.variant, delta=self.delta, df=df, avg_len=avg_len)
        postings = bm25_ops.build_postings_arrays(
            t_arr, d_arr.astype(np.int32), weights, n_docs, V, self.device,
            presorted=True)
        self._state = _BM25State(  # atomic publish
            vocab, postings, n_docs, np.bincount(t_arr, minlength=V + 1),
            tf_cache=(t_arr, d_arr, c_arr, doc_lens),
            frozen=(df, avg_len, len_sum))

    def set_state(self, vocab, postings: bm25_ops.BM25Postings, n_docs: int,
                  tf_cache: Optional[tuple] = None, frozen: Optional[tuple] = None,
                  delta_seg: Optional[_DeltaSeg] = None) -> None:
        """Atomically publish a fitted state (convert.py carries the JAX
        package's through this). Without ``tf_cache`` the next add refits."""
        self._state = _BM25State(vocab, postings, n_docs, None, tf_cache,
                                 frozen, delta_seg)

    # -- incremental adds ---------------------------------------------------

    def _addable(self) -> _BM25State:
        state = self._state
        if state.tf_cache is None:
            raise ValueError("add_tokens needs the COO cache of a fit (a state "
                             "restored by load() must refit to add)")
        return state

    def add_tokens(self, tokenized: Sequence[Sequence[str]]) -> "BM25":
        """Incremental add of token lists: O(new tokens) host work. The new
        docs join the delta segment, weighted under the epoch's frozen
        stats, unless a drift bound trips: then the pending delta and the
        new docs merge into the cached COO and every weight is recomputed.
        Needs a fitted state with a tf cache; raises otherwise."""
        state = self._addable()
        # copy-on-write vocab: readers of the old snapshot never see term
        # ids past their postings' vocab_size
        vocab = state.vocab.copy()
        return self._add_coo(state, vocab,
                             *self._encode_coo(tokenized, vocab, state.n_docs))

    def add_hashes(self, hashes: np.ndarray, counts: np.ndarray) -> "BM25":
        """``add_tokens`` for a hash vocabulary from the docs' token hashes
        (``token_hashes_docs``): the same ids and state, no per-token
        Python."""
        state = self._addable()
        if not isinstance(state.vocab, HashVocabulary):
            raise ValueError("add_hashes needs a hash vocabulary; use add_tokens")
        vocab = state.vocab.copy()
        flat_ids = vocab.add_hashes(hashes)
        return self._add_coo(state, vocab, *self._coo_of_ids(
            flat_ids, counts.astype(np.float64), len(vocab), state.n_docs))

    def _add_coo(self, state: _BM25State, vocab, t1, d1, c1, l1) -> "BM25":
        order = np.lexsort((d1, t1))
        t1, d1, c1 = t1[order], d1[order], c1[order]
        if state.postings is not None and state.frozen is not None:
            if self._publish_delta(state, vocab, t1, d1, c1, l1):
                return self
        # Full path: the cached COO is (term, doc)-sorted and every new doc
        # id exceeds every old one, so inserting the sorted new triples at
        # their term runs' ends keeps the order: no corpus-wide sort.
        t0, d0, c0, l0 = state.tf_cache
        if state.delta_seg is not None:
            dt, dd, dc, dl = state.delta_seg.tf
            t1, d1 = np.concatenate([dt, t1]), np.concatenate([dd, d1])
            c1, l1 = np.concatenate([dc, c1]), np.concatenate([dl, l1])
            order = np.lexsort((d1, t1))
            t1, d1, c1 = t1[order], d1[order], c1[order]
        pos = np.searchsorted(t0, t1, side="right")
        self._publish_from_coo(vocab, np.insert(t0, pos, t1), np.insert(d0, pos, d1),
                               np.insert(c0, pos, c1), np.concatenate([l0, l1]),
                               presorted=True)
        return self

    def _publish_delta(self, state: _BM25State, vocab, t1, d1, c1, l1) -> bool:
        """The O(delta) add: merge the sorted new triples into the pending
        delta, weight them under the frozen stats (a term born in the delta
        takes the delta's own df) and publish. False when a drift bound
        trips."""
        df_e, avg_e, len_sum_e = state.frozen
        n_epoch = state.postings.n_docs
        if state.delta_seg is not None:
            dt, dd, dc, dl = state.delta_seg.tf
            pos = np.searchsorted(dt, t1, side="right")
            dt, dd = np.insert(dt, pos, t1), np.insert(dd, pos, d1)
            dc, dl = np.insert(dc, pos, c1), np.concatenate([dl, l1])
        else:
            dt, dd, dc, dl = t1, d1, c1, l1
        n_delta = len(dl)
        avg_now = (len_sum_e + float(dl.sum())) / max(n_epoch + n_delta, 1)
        if (n_delta > max(self.DELTA_MIN_DOCS, int(n_epoch * self.DELTA_MAX_FRAC))
                or abs(avg_now - avg_e) > self.AVG_LEN_DRIFT * max(avg_e, 1e-9)):
            return False
        v_new = len(vocab)
        df_eff = np.zeros(v_new, dtype=np.int64)
        df_eff[:len(df_e)] = df_e
        if v_new > len(df_e):
            np.add.at(df_eff, dt[dt >= len(df_e)], 1)
        w = bm25_ops.compute_eager_weights(
            dt, dd - n_epoch, dc, dl, n_epoch, v_new, k1=self.k1, b=self.b,
            variant=self.variant, delta=self.delta, df=df_eff, avg_len=avg_e)
        total = n_epoch + n_delta
        po_d = bm25_ops.build_postings_arrays(dt, dd.astype(np.int32), w, total,
                                              v_new, self.device, presorted=True)
        self._state = _BM25State(  # atomic publish
            vocab, state.postings, total, state.term_runs,
            tf_cache=state.tf_cache, frozen=state.frozen,
            delta_seg=_DeltaSeg(tf=(dt, dd, dc, dl), postings=po_d))
        return True

    def compact(self) -> "BM25":
        """Fold the pending delta into the main postings with a full stats
        recompute (at-scale builders, ``save`` and the hybrid searcher call
        this on entry, so their structures cover the whole corpus exactly)."""
        state = self._state
        if state.delta_seg is None:
            return self
        t0, d0, c0, l0 = state.tf_cache
        dt, dd, dc, dl = state.delta_seg.tf
        pos = np.searchsorted(t0, dt, side="right")
        self._publish_from_coo(state.vocab, np.insert(t0, pos, dt),
                               np.insert(d0, pos, dd), np.insert(c0, pos, dc),
                               np.concatenate([l0, dl]), presorted=True)
        return self

    def _compacted_state(self, state: Optional[_BM25State] = None) -> _BM25State:
        """A snapshot with no pending delta (compacting first if needed)."""
        state = state if state is not None else self._state
        if state.delta_seg is not None:
            self.compact()
            state = self._state
        return state

    # -- deletion ------------------------------------------------------------

    def delete(self, doc_ids: Sequence[int]) -> None:
        """Tombstone docs: they stop surfacing from ``search``. Postings and
        stats are untouched until the next fit."""
        tombs = set(self._tombstones)
        tombs.update(int(i) for i in doc_ids)
        self._tombstones = tombs  # atomic publish (replace, never mutate)

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the compacted postings and vocab as the JAX package's
        ``.npz`` (``vocab_hashes`` for a hash vocabulary, else ``vocab``)."""
        state = self._compacted_state()
        if state.postings is None:
            raise ValueError("an unfitted BM25 cannot be saved")
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        po = state.postings
        if isinstance(state.vocab, HashVocabulary):
            vocab_field = {"vocab_hashes": np.asarray(state.vocab.id_to_hash,
                                                      dtype=np.uint64)}
        else:  # a unicode array: readable by both packages, no pickle
            vocab_field = {"vocab": np.asarray(state.vocab.id_to_token, dtype=str)}
        indptr = po.indptr.cpu().numpy()
        if int(indptr[-1]) < 2**31:
            indptr = indptr.astype(np.int32)  # the JAX package's dtype
        np.savez_compressed(
            path, indptr=indptr, doc_ids=po.doc_ids.cpu().numpy(),
            weights=po.weights.cpu().numpy(), n_docs=po.n_docs,
            max_postings=po.max_postings,
            params=np.asarray([self.k1, self.b, self.delta]),
            variant=self.variant, **vocab_field)

    def load(self, path: str) -> "BM25":
        """Adopt a state saved by either package. A loaded state has no tf
        cache: the next add refits."""
        with np.load(path) as probe:
            # the JAX package writes a string vocab as an object array
            strings = "vocab" in probe.files
        with np.load(path, allow_pickle=strings) as data:
            if "vocab_hashes" in data.files:
                vocab = HashVocabulary.from_hashes(data["vocab_hashes"].tolist())
            else:
                vocab = Vocabulary()
                for tok in data["vocab"].tolist():
                    vocab.add(str(tok))
            postings = bm25_ops.postings_from_csr(
                data["indptr"], data["doc_ids"], data["weights"], int(data["n_docs"]),
                len(vocab), self.device)
            self.k1, self.b, self.delta = [float(x) for x in data["params"]]
        self.set_state(vocab, postings, postings.n_docs)
        return self

    # -- query encoding ----------------------------------------------------

    def _term_lists(self, queries: Sequence[str], state: _BM25State):
        return [state.vocab.encode(extract_tokens(q)) for q in queries]

    def encode_queries_bucketed(self, queries: Sequence[str],
                                state: Optional[_BM25State] = None):
        """Per-bucket (width, starts, lengths) run pieces against the main
        postings (terms born in a pending delta have no run there)."""
        state = state or self._state
        if state.postings is None:
            return []
        po = state.postings
        lists = self._term_lists(queries, state)
        if state.delta_seg is not None:
            lists = [[t for t in ids if t < po.vocab_size] for ids in lists]
        return bm25_ops.encode_run_pieces(po.starts_host, po.lengths_host, lists,
                                          po.max_postings)

    def _delta_groups(self, queries: Sequence[str], state: _BM25State):
        """Run-piece groups against the delta segment's postings."""
        po = state.delta_seg.postings
        return bm25_ops.encode_run_pieces(po.starts_host, po.lengths_host,
                                          self._term_lists(queries, state),
                                          po.max_postings)

    def _encode_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """[B, width] term ids padded with vocab_size (an empty run) to the
        smallest of ``_QUERY_WIDTHS`` that holds the longest query (longer
        queries are cut to the widest)."""
        lists = [self.vocab.encode(extract_tokens(q)) for q in queries]
        longest = max((len(x) for x in lists), default=1)
        width = next((w for w in _QUERY_WIDTHS if w >= longest), _QUERY_WIDTHS[-1])
        out = np.full((len(queries), width), len(self.vocab), dtype=np.int64)
        for i, ids in enumerate(lists):
            ids = ids[:width]
            out[i, :len(ids)] = ids
        return torch.from_numpy(out).to(self.device)

    def super_postings(self, state: Optional[_BM25State] = None,
                       super_tiles: int = 128):
        """Supertile structures of the (compacted) state, built once per
        state and cached."""
        state = self._compacted_state(state)
        if state.postings is None:
            return None
        cached = self._super_cache
        if cached is not None and cached[0] is state:
            return cached[1]
        from hybridsearch_tpu_torch.ops.supertile import build_super_postings

        po = state.postings
        nnz = int(po.starts_host[-1] + po.lengths_host[-1]) if po.vocab_size else 0
        sp = build_super_postings(
            self._coo_term_ids(state), po.doc_ids[:nnz].cpu().numpy(),
            po.weights[:nnz].cpu().numpy(), po.n_docs, po.vocab_size,
            self.device, super_tiles=super_tiles)
        self._super_cache = (state, sp)  # atomic publish
        return sp

    @staticmethod
    def _coo_term_ids(state: _BM25State) -> np.ndarray:
        """[nnz] term id of every CSR entry of the state's main postings."""
        po = state.postings
        runs = (state.term_runs[:po.vocab_size] if state.term_runs is not None
                else po.lengths_host)
        return np.repeat(np.arange(po.vocab_size, dtype=np.int64), runs)

    def impact_postings(self, p_max: int = 4096,
                        state: Optional[_BM25State] = None):
        """The impact-ordered pruned tier of the (compacted) state
        (ops/impact.py), built at first use and cached per state (a deeper
        cached tier serves a shallower request)."""
        state = self._compacted_state(state)
        if state.postings is None:
            return None
        cached = self._impact_cache
        if cached is not None and cached[0] is state and cached[1] >= p_max:
            return cached[2]
        from hybridsearch_tpu_torch.ops.impact import build_impact_postings

        po = state.postings
        nnz = int(po.starts_host[-1] + po.lengths_host[-1]) if po.vocab_size else 0
        imp = build_impact_postings(
            self._coo_term_ids(state), po.doc_ids[:nnz].cpu().numpy(),
            po.weights[:nnz].cpu().numpy(), po.n_docs, po.vocab_size,
            p_max=p_max, device=self.device)
        self._impact_cache = (state, p_max, imp)  # atomic publish
        return imp

    def encode_queries_impact(self, queries: Sequence[str], p_depth: int,
                              p_max: int = 4096):
        """(ImpactPostings, ImpactQueryEnc) for hybrid_impact_topk. The vocab,
        the tier, the hot descriptors and the full CSR arrays they index
        into (``enc.full_postings``) all come from ONE compacted state."""
        from hybridsearch_tpu_torch.ops.impact import encode_impact_queries

        state = self._compacted_state()
        imp = self.impact_postings(p_max=p_max, state=state)
        if imp is None:
            return None, None
        po = state.postings
        enc = encode_impact_queries(imp, self._term_lists(queries, state),
                                    p_depth=p_depth, full_starts=po.starts_host,
                                    full_lengths=po.lengths_host)
        return imp, enc._replace(full_postings=(po.doc_ids, po.weights))

    def encode_queries_super(self, queries: Sequence[str]):
        """(SuperPostings, SuperQueryEnc) from one compacted state."""
        from hybridsearch_tpu_torch.ops.supertile import encode_super_queries

        state = self._compacted_state()
        sp = self.super_postings(state=state)
        if sp is None:
            return None, None
        return sp, encode_super_queries(sp, self._term_lists(queries, state))

    # -- scoring -------------------------------------------------------------

    def batch_scores(self, queries: Sequence[str]) -> torch.Tensor:
        """[B, n_docs] float32 scores on the BM25's device. With a pending
        delta, main and delta postings are scored apart and summed (a doc
        lives in one of them)."""
        state = self._state
        B = len(queries)
        if state.n_docs == 0 or state.postings is None:
            return torch.zeros((B, 0), dtype=torch.float32, device=self.device)
        groups = self.encode_queries_bucketed(list(queries), state)
        out = torch.zeros((B, state.n_docs), dtype=torch.float32,
                          device=self.device)
        if groups:
            main = bm25_ops.bm25_scores_bucketed(state.postings, groups, B)
            out[:, :main.shape[1]] = main[:, :state.n_docs]
        seg = state.delta_seg
        if seg is not None:
            groups_d = self._delta_groups(queries, state)
            if groups_d:
                out += bm25_ops.bm25_scores_bucketed(seg.postings, groups_d,
                                                     B)[:, :state.n_docs]
        return out

    def score_all(self, query: str) -> np.ndarray:
        """Dense [n_docs] score vector of one query (numpy)."""
        if self.n_docs == 0 or self.postings is None:
            return np.zeros((0,), dtype=np.float32)
        return self.batch_scores([query])[0].cpu().numpy()

    def score(self, query: str, doc_idx: int) -> float:
        """One (query, doc) score."""
        return float(self.score_all(query)[doc_idx])

    def score_batch(self, query: str, doc_indices: Sequence[int]) -> List[float]:
        """Scores of one query at a subset of docs."""
        full = self.score_all(query)
        return [float(full[i]) for i in doc_indices]

    def candidate_scores(self, query: str, candidates: np.ndarray) -> np.ndarray:
        """[C] scores at candidate doc ids (-1 ids score 0), by binary
        search in the query's runs of the main and delta postings: equal to
        full scoring, without it."""
        if self.n_docs == 0:
            return np.zeros(len(candidates), dtype=np.float32)
        state = self._state
        cand = torch.from_numpy(np.asarray(candidates, np.int64)[None, :])
        out = np.zeros(len(candidates), dtype=np.float32)
        groups = self.encode_queries_bucketed([query], state)
        if groups:
            out = out + bm25_ops.bm25_candidate_scores_runs(
                state.postings, groups, cand)[0].cpu().numpy()
        if state.delta_seg is not None:
            groups_d = self._delta_groups([query], state)
            if groups_d:
                out = out + bm25_ops.bm25_candidate_scores_runs(
                    state.delta_seg.postings, groups_d, cand)[0].cpu().numpy()
        return out.astype(np.float32)

    def search(self, query: str, top_k: int = 10) -> List[Tuple[int, float]]:
        """Top-k (doc, score) with a positive score, tombstoned docs left
        out."""
        if self.n_docs == 0:
            return []
        tombs = self._tombstones
        k = min(top_k + len(tombs), self.n_docs)
        scores = self.score_all(query)
        if scores.size == 0:
            return []
        idx = np.argsort(-scores, kind="stable")[:k]
        return [(int(i), float(scores[i])) for i in idx
                if scores[i] > 0.0 and int(i) not in tombs][:top_k]


class BM25Plus(BM25):
    """BM25+ — adds delta inside the per-term sum for matching docs."""

    variant = "bm25plus"
