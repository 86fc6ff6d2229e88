"""Hybrid searcher — the hot query path.

Counterpart of ``hybridsearch_tpu/retrieval/searcher.py`` on one device:

  encode(query) -> semantic scores -> lexical scores -> alive-masked min-max
  normalize -> weighted fusion -> top-k -> (score, content, doc_id) tuples

Two regimes, as in the JAX package:

  * below ``SPARSE_HYBRID_MIN_DOCS`` docs: full [B, n] semantic and BM25
    scores, fused and ranked exactly (``_hybrid_one_program``);
  * at scale (``_sparse_hybrid``), with no [B, n] array:
      - on a ``layout="clustered"`` index, the supertile ladder
        (``supertile_ladder``): one rung-invariant prefix, then probe-budget
        rungs that re-run only the uncertified queries;
      - on any other layout (the default ``"source"``), the impact ladder:
        ``hybrid_impact_topk`` (ops/hybrid.py) at escalating (k_dense,
        c_per_term, p_depth) rungs (``_IMPACT_LADDER``), each re-encoding
        and re-running only the uncertified queries.

The JAX package's clustered tile hybrid (``hybrid_tile_topk``, reached there
only with ``HST_SUPER_HYBRID=0``), the lexical "fuzzy" and semantic
"scatter" modes and the mesh branches are not part of the port yet.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.builder import Indexer
from hybridsearch_tpu_torch.ops.bm25 import local_bucketed_scores
from hybridsearch_tpu_torch.ops.dense import (
    l2_normalize,
    stable_topk,
    tiled_dense_topk,
    tiled_matrix_topk,
)
from hybridsearch_tpu_torch.ops.fusion import validate_weights
from hybridsearch_tpu_torch.retrieval.query_memory import QueryMemory
from hybridsearch_tpu_torch.utils.device import DeviceLike
from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS, trace_span

SearchResult = Tuple[float, str, int]

# Above this corpus size the fused path switches from full [B, n] fusion to
# a certified ladder (same semantics, no [B, n] arrays).
SPARSE_HYBRID_MIN_DOCS = 200_000
# (k_dense, c_per_term, p_depth) escalation ladder of the impact-pruned
# hybrid; depths come from ops/impact.py IMPACT_P_LADDER
_IMPACT_LADDER = ((512, 64, 256), (1024, 128, 1024), (2048, 256, 4096))
# supertile probe-budget ladder, in 16384-doc supertiles: 2 rungs cover a
# straddling topic, deeper rungs chase uncertified queries
_SUPER_LADDER = (2, 4, 8, 16)
# smallest padded batch for compacted escalation rungs (_pow2_bucket)
_MIN_ESCALATION_BUCKET = 32


def _pow2_bucket(n: int, lo: Optional[int] = None) -> int:
    b = lo if lo is not None else _MIN_ESCALATION_BUCKET
    while b < n:
        b <<= 1
    return b


def _subset_batch_rows(obj, fi_pad: np.ndarray, batch: int):
    """Rows ``fi_pad`` of every per-query field of a NamedTuple: fields
    whose leading dim equals ``batch`` are gathered (tensors on their
    device, numpy on the host); corpus-side fields, tuples and scalars pass
    through. Pad rows repeat a real failed query, so the subset is a valid
    batch (their outputs are dropped at merge)."""
    idx = None
    out = []
    for v in obj:
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == batch:
            if idx is None:
                idx = torch.from_numpy(np.asarray(fi_pad, np.int64)).to(v.device)
            out.append(v.index_select(0, idx))
        elif isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == batch:
            out.append(np.take(v, fi_pad, axis=0))
        else:
            out.append(v)
    return type(obj)(*out)


class _LadderState:
    """Merged full-batch results across compacted escalation rungs."""

    def __init__(self, batch: int):
        self.batch = batch
        self.values: Optional[np.ndarray] = None
        self.indices: Optional[np.ndarray] = None
        self.exact: Optional[np.ndarray] = None
        self.rows: Optional[np.ndarray] = None  # rows the last rung ran

    def merge(self, values, indices, exact) -> None:
        rv = values.cpu().numpy()
        ri = indices.cpu().numpy()
        re_ = exact.cpu().numpy()
        if self.rows is None:
            self.values, self.indices, self.exact = rv.copy(), ri.copy(), re_.copy()
        else:
            m = len(self.rows)
            self.values[self.rows] = rv[:m]
            self.indices[self.rows] = ri[:m]
            self.exact[self.rows] = re_[:m]

    def next_rows(self) -> Optional[np.ndarray]:
        """Uncertified rows to escalate, or None to re-run the full batch
        (compaction pays only when the padded bucket is smaller)."""
        fi = np.where(~self.exact)[0]
        if len(fi) and _pow2_bucket(len(fi)) < self.batch:
            self.rows = fi
            return fi
        self.rows = None
        return None

    def padded(self, fi: np.ndarray) -> np.ndarray:
        b = _pow2_bucket(len(fi))
        return np.concatenate([fi, np.full(b - len(fi), fi[-1], dtype=fi.dtype)])


def supertile_ladder(
    q: torch.Tensor,
    docs: torch.Tensor,
    sp,
    enc_s,
    k: int,
    sw: float,
    lw: float,
    bias: Optional[torch.Tensor] = None,
    n_alive: Optional[int] = None,
    valid_n: Optional[int] = None,
    ladder: Optional[Tuple[int, ...]] = None,
    uncertified_tol: float = 0.005,
    scores_dedup: bool = False,
    place_fused: bool = False,
) -> Tuple[_LadderState, int]:
    """The supertile serving ladder: one prefix (stats sweep + bound
    selection), then probe-budget rungs that escalate only the uncertified
    tail, compacted to a pow2 bucket. ``scores_dedup`` and ``place_fused``
    (``EngineConfig.perf``) pick the rungs' K4 / K5 routes. Returns the
    merged _LadderState (full-batch coordinates) and the number of rungs
    run."""
    from hybridsearch_tpu_torch.ops.supertile import (
        hybrid_supertile_topk_rung,
        super_prefix,
    )

    ladder = _SUPER_LADDER if ladder is None else ladder
    B = q.shape[0]
    n = docs.shape[0] if valid_n is None else valid_n
    n_alive = n if n_alive is None else n_alive
    certifiable = enc_s.complete & (enc_s.full_touched < n_alive)
    st = _LadderState(B)
    pfx = super_prefix(q, docs, sp, enc_s, bias=bias, w_s=sw, w_l=lw,
                       s_max=ladder[-1])
    cur_q, cur_enc, cur_pfx = q, enc_s, pfx
    prev_fails = None
    rungs = 0
    for s_probe in ladder:
        res = hybrid_supertile_topk_rung(
            cur_q, docs, sp, cur_enc, cur_pfx, k, sw, lw, bias=bias,
            s_probe=s_probe, n_alive=n_alive, scores_dedup=scores_dedup,
            place_fused=place_fused)
        rungs += 1
        st.merge(res.values, res.indices, res.exact)
        fails = int((~st.exact).sum())
        if fails == 0:
            break
        # serving contract: stop once the uncertified tail is within tol;
        # those queries are served best-effort like a ladder exhaustion
        if fails <= uncertified_tol * B:
            break
        # term-complete AND lexical-min-provably-0 rows are the only ones a
        # deeper probe can certify
        if not np.logical_and(~st.exact, certifiable).any():
            break
        if s_probe * sp.super_docs >= n:
            break  # this rung already probed every supertile
        if prev_fails is not None and fails >= prev_fails:
            break  # no progress: the bounds are not tightening
        prev_fails = fails
        fi = st.next_rows()
        if fi is not None:
            fp = st.padded(fi)
            cur_q = q.index_select(0, torch.from_numpy(fp).to(q.device))
            cur_enc = _subset_batch_rows(enc_s, fp, B)
            cur_pfx = _subset_batch_rows(pfx, fp, B)
        else:
            cur_q, cur_enc, cur_pfx = q, enc_s, pfx
    return st, rungs


def _fuse_and_topk(sem: torch.Tensor, lex: torch.Tensor, w_s: float, w_l: float,
                   bias: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-max normalize both arms over ALIVE docs (bias == 0), weighted
    sum, add the tombstone bias, top-k: tombstoned rows neither surface nor
    skew the normalization statistics."""
    alive = (bias >= 0.0)[None, :]
    big = 3.4e38

    def norm(x):
        mn = torch.where(alive, x, big).amin(dim=-1, keepdim=True)
        mx = torch.where(alive, x, -big).amax(dim=-1, keepdim=True)
        rng = mx - mn
        return torch.where(rng > 1e-12, (x - mn) / rng.clamp_min(1e-12),
                           torch.ones_like(x))

    hybrid = norm(sem) * w_s + norm(lex) * w_l + bias[None, :]
    if hybrid.shape[1] > 65536:
        return tiled_matrix_topk(hybrid, k)
    return stable_topk(hybrid, k)


def _hybrid_one_program(q, docs, postings, groups, w_s, w_l, bias, k, n):
    """The whole below-threshold hybrid query: semantic matmul + bucketed
    BM25 + alive-masked min-max fusion + exact top-k."""
    qn = l2_normalize(q.float())
    sem = qn @ docs.T
    if groups:
        lex = local_bucketed_scores(postings.doc_ids, postings.weights, groups,
                                    n, q.shape[0])
    else:
        lex = torch.zeros_like(sem)
    return _fuse_and_topk(sem, lex, w_s, w_l, bias, k)


class Searcher:
    def __init__(
        self,
        indexer: Optional[Indexer] = None,
        db_path: str = ":memory:",
        encoder=None,
        use_query_memory: bool = True,
        config: Optional[EngineConfig] = None,
        device: DeviceLike = None,
    ) -> None:
        self.config = config or EngineConfig()
        self.indexer = indexer or Indexer(db_path=db_path, encoder=encoder,
                                          config=self.config, device=device)
        self.device = self.indexer.device
        self.query_memory = (QueryMemory(self.indexer.store)
                             if use_query_memory else None)
        self.last_query_id: Optional[int] = None
        self.default_weights = (self.config.fusion.semantic_weight,
                                self.config.fusion.lexical_weight)

    def resolve_weights(self, semantic_weight: Optional[float],
                        lexical_weight: Optional[float],
                        use_learned_weights: bool = False) -> Tuple[float, float]:
        """Feedback-learned weights only on explicit opt-in; otherwise the
        explicit weights, else the configured defaults."""
        if use_learned_weights and self.query_memory is not None and (
                learned := self.query_memory.get_optimal_weights()):
            sw, lw = learned
        elif semantic_weight is not None or lexical_weight is not None:
            sw = semantic_weight if semantic_weight is not None else (
                1.0 - (lexical_weight or 0.0))
            lw = lexical_weight if lexical_weight is not None else 1.0 - sw
        else:
            sw, lw = self.default_weights
        validate_weights(sw, lw)
        return sw, lw

    def search(self, query: str, top_k: int = 5,
               semantic_weight: Optional[float] = None,
               lexical_weight: Optional[float] = None,
               use_learned_weights: bool = False,
               log: bool = True) -> List[SearchResult]:
        return self.search_batch([query], top_k, semantic_weight, lexical_weight,
                                 use_learned_weights=use_learned_weights,
                                 log=log)[0]

    def search_batch(
        self,
        queries: Sequence[str],
        top_k: int = 5,
        semantic_weight: Optional[float] = None,
        lexical_weight: Optional[float] = None,
        use_learned_weights: bool = False,
        log: bool = True,
    ) -> List[List[SearchResult]]:
        """Batched hybrid search over one consistent index snapshot."""
        t0 = time.perf_counter()
        sw, lw = self.resolve_weights(semantic_weight, lexical_weight,
                                      use_learned_weights)
        snap = self.indexer.dense._snap
        bm25 = self.indexer.bm25
        bm25_state = bm25._state
        n = snap.n
        if n == 0:
            return [[] for _ in queries]
        k = min(top_k, n)
        with trace_span("encode"):
            q_vecs = self.indexer.encoder.encode(list(queries)).to(self.device)
        fitted = bm25_state.postings is not None and bm25_state.n_docs == n
        if fitted and n >= SPARSE_HYBRID_MIN_DOCS:
            with trace_span("hybrid_sparse"):
                vals, idxs = self._sparse_hybrid(queries, q_vecs, snap, bm25,
                                                 k, sw, lw)
        elif fitted:
            with trace_span("hybrid_fused"):
                groups = bm25.encode_queries_bucketed(list(queries), bm25_state)
                vals, idxs = _hybrid_one_program(
                    q_vecs, snap.docs[:n], bm25_state.postings, groups, sw, lw,
                    snap.bias[:n], k, n)
        else:
            # no BM25 state for this index generation: the lexical arm is
            # zeros (min-max of a constant arm is all-ones)
            with trace_span("fuse_topk"):
                sem = l2_normalize(q_vecs.float()) @ snap.docs[:n].T
                vals, idxs = _fuse_and_topk(sem, torch.zeros_like(sem), sw, lw,
                                            snap.bias[:n], k)
        vals_np = np.asarray(vals.cpu().numpy() if torch.is_tensor(vals) else vals)
        idxs_np = np.asarray(idxs.cpu().numpy() if torch.is_tensor(idxs) else idxs)
        latency_ms = (time.perf_counter() - t0) * 1e3
        results: List[List[SearchResult]] = []
        contents = self.indexer.contents
        for b, query in enumerate(queries):
            row = [
                (float(vals_np[b, j]), contents[int(idxs_np[b, j])],
                 int(idxs_np[b, j]))
                for j in range(k)
                if 0 <= int(idxs_np[b, j]) < len(contents)
                # top_k > alive count surfaces tombstoned rows at -inf
                and np.isfinite(vals_np[b, j])
            ]
            results.append(row)
            if log and self.query_memory is not None:
                self.last_query_id = self.query_memory.log_query(
                    query, sw, lw, top_score=row[0][0] if row else None,
                    n_results=len(row), latency_ms=latency_ms)
        return results

    def _sparse_hybrid(self, queries, q_vecs, snap, bm25, k, sw, lw):
        """At-scale hybrid: the supertile ladder on a clustered index, the
        impact ladder otherwise. An uncertified result is served
        best-effort (near-exact) with a one-time warning and a counter."""
        q = l2_normalize(q_vecs.float())
        n_alive = snap.n - self.indexer.dense.deleted_count
        if self.indexer.config.index.layout == "clustered":
            sp, enc_s = bm25.encode_queries_super(list(queries))
            perf = self.config.perf
            st, _rungs = supertile_ladder(
                q, snap.docs, sp, enc_s, k, sw, lw, bias=snap.bias,
                n_alive=n_alive, valid_n=snap.n,
                uncertified_tol=self.indexer.config.serving.uncertified_tol,
                scores_dedup=bool(perf.scores_dedup),
                place_fused=bool(perf.place_fused))
            if not st.exact.all():
                _warn_uncertified("supertile hybrid certificate did not close "
                                  "after probe escalation; serving the "
                                  "best-effort top-k")
            return st.values, st.indices
        st, rungs = impact_ladder(q, queries, snap, bm25, k, sw, lw, n_alive)
        if not rungs:  # no impact tier (no postings): dense-only scores
            return tiled_dense_topk(q, snap.docs, min(k, snap.n), bias=snap.bias)
        if not st.exact.all():
            _warn_uncertified("sparse hybrid certificate did not close after "
                              "escalation; serving the best-effort top-k "
                              "(pruned-lexical bounds were too loose for this "
                              "query/corpus)")
        return st.values, st.indices


def impact_ladder(q: torch.Tensor, queries: Sequence[str], snap, bm25, k: int,
                  sw: float, lw: float, n_alive: int) -> Tuple[_LadderState, int]:
    """The impact serving ladder: ``hybrid_impact_topk`` at each (k_dense,
    c_per_term, p_depth) rung, the queries re-encoded at the rung's depth;
    deeper rungs re-run only the uncertified queries (compacted to a pow2
    bucket) while some failure can still certify. Returns the merged
    _LadderState (full-batch coordinates) and the number of rungs run."""
    from hybridsearch_tpu_torch.ops.hybrid import hybrid_impact_topk

    B = q.shape[0]
    st = _LadderState(B)
    cur_queries, cur_q = list(queries), q
    rungs = 0
    prev_fails = None
    for kd, cp, pd in _IMPACT_LADDER:
        imp, enc = bm25.encode_queries_impact(cur_queries, p_depth=pd)
        if imp is None:
            break
        # enc.full_postings comes from the same snapshot as imp and enc
        res = hybrid_impact_topk(cur_q, snap.docs, imp, enc, k, sw, lw,
                                 bias=snap.bias, k_dense=kd, c_per_term=cp,
                                 p_depth=pd, n_alive=n_alive)
        rungs += 1
        st.merge(res.values, res.indices, res.exact)
        if st.exact.all():
            break
        # escalation helps queries whose terms a deeper prune depth can fully
        # cover, and margin-certifiable ones (every truncated term bisected:
        # deeper rungs shrink the tail slack). The rung's enc covers its own
        # (possibly compacted) rows: scatter to full-batch coordinates.
        ci = enc.certifiable_deeper
        if enc.corrected_complete is not None:
            ci = ci | enc.corrected_complete
        can_improve = np.zeros(B, bool)
        if st.rows is None:
            can_improve[:] = np.asarray(ci)[:B]
        else:
            can_improve[st.rows] = np.asarray(ci)[:len(st.rows)]
        if not np.logical_and(~st.exact, can_improve).any():
            break
        fails = int((~st.exact).sum())
        if prev_fails is not None and fails >= prev_fails:
            break  # no progress: deeper rungs are not certifying more
        prev_fails = fails
        fi = st.next_rows()  # compacted escalation
        if fi is not None:
            fp = st.padded(fi)
            cur_queries = [queries[i] for i in fp]
            cur_q = q.index_select(0, torch.from_numpy(fp).to(q.device))
        else:
            cur_queries, cur_q = list(queries), q
    return st, rungs


def _warn_uncertified(message: str) -> None:
    """Count an uncertified batch; warn the first time."""
    if GLOBAL_COUNTERS.inc("hybrid_sparse_uncertified") == 1:
        import warnings

        warnings.warn(message, RuntimeWarning)
