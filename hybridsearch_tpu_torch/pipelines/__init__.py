"""The eight pre-built pipelines + factory.

Counterpart of ``hybridsearch_tpu/pipelines/__init__.py`` (parity with the
reference pipeline layer, reference pipelines.py:24-646): the same names,
composition semantics and factory kwargs, over the port's Indexer and
Searcher on ``device`` (the card unless the caller asks for the CPU).
Quirks kept deliberately, as in the JAX package:

  - ChunkedPipeline fetches top_k*2 chunks when return_parent and dedups
    parents (reference pipelines.py:157-183); its chunk map is persisted in
    the store and ``reload`` restores it;
  - HybridBM25Pipeline normalizes by max (not min-max) and fuses over ALL
    docs (reference pipelines.py:315-343); above ``HYBRID_BM25_SPARSE_MIN``
    docs it runs the impact hybrid with ``norm="max"`` instead;
  - BM25Pipeline.index embeds nothing;
  - MultiStagePipeline's 100 -> 20 -> 5 funnel: dense stage 1, BM25 on the
    candidates only, cross-encoder last (reference pipelines.py:470-511);
    ``search`` drops -1 and -inf stage-1 hits before stage 2;
  - DiversityPipeline's MMR with lambda 0.5 (reference pipelines.py:514-569)
    runs as ``ops/mmr.py``.

No Pallas kernel backs this layer. Its device work goes through the port's
kernels underneath: ``DenseIndex.search`` (K1 and K4 at tile grain), the
impact hybrid (K1, K4, K6, K7) and ``Searcher.search_batch``.

``mesh`` (every rank building the same pipeline) reaches the Indexer, so
the pipelines serve through the mesh's collective programs;
HybridBM25Pipeline's divide-by-max fusion runs there rank by rank, its two
arm maxima in one all-reduce.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.builder import Indexer
from hybridsearch_tpu_torch.ops.fusion import max_normalize
from hybridsearch_tpu_torch.ops.mmr import mmr_select, mmr_select_batch
from hybridsearch_tpu_torch.retrieval.highlighter import Highlighter, get_highlighter
from hybridsearch_tpu_torch.retrieval.searcher import Searcher
from hybridsearch_tpu_torch.text.chunker import Chunk, get_chunker
from hybridsearch_tpu_torch.utils.device import DeviceLike

SearchResult = Tuple[float, str, int]

# HybridBM25Pipeline switches to the impact hybrid above this corpus size
# (full [1, n] score arrays below it, for exact reference parity including
# the normalize-over-everything quirk).
HYBRID_BM25_SPARSE_MIN = 65536
# (k_dense, c_per_term, p_depth) rungs of HybridBM25Pipeline's impact path
_HYBRID_BM25_RUNGS = ((512, 64, 256), (1024, 128, 4096))


@dataclasses.dataclass
class PipelineResult:
    """Universal pipeline output (reference pipelines.py:24-30)."""

    results: List[SearchResult]
    query: str
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    highlighted: Optional[List[str]] = None
    answer: Optional[str] = None  # RAG pipelines only


class BasePipeline:
    """index(documents) / search(query, top_k) (reference pipelines.py:33-59)."""

    name = "base"

    def __init__(
        self,
        encoder=None,
        db_path: str = ":memory:",
        config: Optional[EngineConfig] = None,
        highlight: bool = False,
        highlight_style: str = "markdown",
        device: DeviceLike = None,
        mesh=None,
        **kwargs,
    ) -> None:
        self.config = config or EngineConfig()
        self.indexer = Indexer(db_path=db_path, encoder=encoder,
                               config=self.config, device=device, mesh=mesh)
        self.searcher = Searcher(indexer=self.indexer, config=self.config)
        self.highlighter: Optional[Highlighter] = (
            get_highlighter(highlight_style) if highlight else None
        )

    @property
    def device(self) -> torch.device:
        return self.indexer.device

    def index(self, documents: Sequence[str]) -> Dict[str, Any]:
        return self.indexer.index_documents(list(documents))

    def _finish(self, results: List[SearchResult], query: str,
                metadata: Dict[str, Any]) -> PipelineResult:
        highlighted = (
            self.highlighter.highlight_results(results, query)
            if self.highlighter
            else None
        )
        return PipelineResult(results=results, query=query, metadata=metadata,
                              highlighted=highlighted)

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        raise NotImplementedError


def _cross_encoder(reranker, device: torch.device):
    """The given reranker, else a lazy ``CrossEncoderReranker`` on the
    pipeline's device."""
    if reranker is not None:
        return reranker
    from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker

    return CrossEncoderReranker(device=device)


class BasicPipeline(BasePipeline):
    """Plain hybrid search (reference pipelines.py:62-103)."""

    name = "basic"

    def __init__(self, semantic_weight: float = 0.7, lexical_weight: float = 0.3,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.semantic_weight = semantic_weight
        self.lexical_weight = lexical_weight

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        results = self.searcher.search(
            query, top_k=top_k,
            semantic_weight=self.semantic_weight,
            lexical_weight=self.lexical_weight,
        )
        return self._finish(results, query, {"pipeline": self.name})


class ChunkedPipeline(BasePipeline):
    """Chunk documents, search chunks, optionally map back to parents
    (reference pipelines.py:106-193)."""

    name = "chunked"

    def __init__(self, chunk_strategy: str = "sentence", return_parent: bool = True,
                 chunker_kwargs: Optional[dict] = None, **kwargs) -> None:
        super().__init__(**kwargs)
        self.chunker = get_chunker(chunk_strategy, **(chunker_kwargs or {}))
        self.return_parent = return_parent
        self.parents: List[str] = []
        self.chunk_to_parent: List[int] = []  # chunk row -> parent doc id

    def index(self, documents: Sequence[str]) -> Dict[str, Any]:
        self.parents = list(documents)
        chunks: List[str] = []
        rows = []
        self.chunk_to_parent = []
        for doc_id, doc in enumerate(documents):
            pieces = self.chunker.chunk(doc, doc_id=doc_id) or [
                Chunk(content=doc, doc_id=doc_id)]
            for c in pieces:
                rows.append((len(chunks), doc_id, c.chunk_index,
                             c.start_char, c.end_char))
                chunks.append(c.content)
                self.chunk_to_parent.append(doc_id)
        stats = self.indexer.index_documents(chunks)
        # persist the chunk -> parent registry (survives restarts; the
        # reference keeps it only in memory, pipelines.py:125-144)
        self.indexer.store.save_chunk_map(self.parents, rows)
        stats["parents"] = len(documents)
        stats["chunks"] = len(chunks)
        return stats

    def reload(self) -> int:
        """Restore the chunk registry and the chunk index from the store."""
        self.parents, self.chunk_to_parent = self.indexer.store.load_chunk_map()
        return self.indexer.reload()

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        fetch_k = top_k * 2 if self.return_parent else top_k  # pipelines.py:157
        hits = self.searcher.search(query, top_k=fetch_k)
        if not self.return_parent:
            return self._finish(hits, query, {"pipeline": self.name})
        seen = set()
        results: List[SearchResult] = []
        for score, _chunk_text, chunk_id in hits:
            parent = self.chunk_to_parent[chunk_id]
            if parent in seen:
                continue  # parent dedup (pipelines.py:157-183)
            seen.add(parent)
            results.append((score, self.parents[parent], parent))
            if len(results) >= top_k:
                break
        return self._finish(results, query,
                            {"pipeline": self.name, "chunks_searched": fetch_k})


class RerankedPipeline(BasePipeline):
    """Retrieve a wider candidate set, cross-encoder rerank
    (reference pipelines.py:196-250)."""

    name = "reranked"

    def __init__(self, reranker=None, rerank_multiplier: int = 3,
                 use_fusion: bool = False, **kwargs) -> None:
        super().__init__(**kwargs)
        self.reranker = _cross_encoder(reranker, self.device)
        self.rerank_multiplier = rerank_multiplier
        self.use_fusion = use_fusion

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        candidates = self.searcher.search(query, top_k=top_k * self.rerank_multiplier)
        if self.use_fusion:
            results = self.reranker.rerank_with_fusion(query, candidates, top_k)
        else:
            results = self.reranker.rerank(query, candidates, top_k)
        return self._finish(results, query,
                            {"pipeline": self.name, "candidates": len(candidates)})


class BM25Pipeline(BasePipeline):
    """Pure lexical BM25 (reference pipelines.py:253-280)."""

    name = "bm25"

    def __init__(self, k1: float = 1.5, b: float = 0.75, **kwargs) -> None:
        kwargs.setdefault("config", EngineConfig())
        kwargs["config"].bm25.k1 = k1
        kwargs["config"].bm25.b = b
        super().__init__(**kwargs)

    def index(self, documents: Sequence[str]) -> Dict[str, Any]:
        # lexical-only: no dense embed at all
        from hybridsearch_tpu_torch.text.extractor import preprocess_text

        docs = [preprocess_text(d) for d in documents]
        self.indexer.store.replace_documents(docs)
        self.indexer.contents = docs
        self.indexer.doc_ids = list(range(len(docs)))
        self.indexer.bm25.fit(docs)
        return {"indexed": len(docs)}

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        hits = self.indexer.bm25.search(query, top_k=top_k)
        results = [
            (score, self.indexer.contents[i], i) for i, score in hits
        ]
        return self._finish(results, query, {"pipeline": self.name})


class HybridBM25Pipeline(BasePipeline):
    """Dense + BM25 with max-normalization over all docs
    (reference pipelines.py:283-357; fusion at :334-343)."""

    name = "hybrid_bm25"

    def __init__(self, semantic_weight: float = 0.5, bm25_weight: float = 0.5,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.semantic_weight = semantic_weight
        self.bm25_weight = bm25_weight

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        ix = self.indexer
        snap = ix.dense._snap
        n = snap.n
        if n == 0:
            return self._finish([], query, {"pipeline": self.name})
        q_vec = ix.encoder.encode([query]).to(ix.device)
        if ix.mesh is not None:
            return self._mesh_search(query, q_vec, snap, top_k)
        bm25_state = ix.bm25._state
        if (n > HYBRID_BM25_SPARSE_MIN and bm25_state.postings is not None
                and bm25_state.n_docs == n):
            out = self._impact_search(query, q_vec, snap, top_k)
            if out is not None:
                return out
        sem = self.searcher._semantic_scores(q_vec, n, snap)  # full scores
        lex = ix.bm25.batch_scores([query])
        # the reference normalizes by max only, over ALL docs (top_k =
        # len(docs)); the tombstone bias keeps deleted docs out of this path
        fused = (
            max_normalize(sem) * self.semantic_weight
            + max_normalize(lex) * self.bm25_weight
        ) + snap.bias[:n][None, :]
        fused_np = fused[0].cpu().numpy()
        order = np.argsort(-fused_np, kind="stable")[:top_k]
        results = [
            (float(fused_np[i]), ix.contents[int(i)], int(i))
            for i in order if np.isfinite(fused_np[i])
        ]
        return self._finish(results, query, {"pipeline": self.name})

    def _mesh_search(self, query: str, q_vec: torch.Tensor, snap,
                     top_k: int) -> PipelineResult:
        """The full divide-by-max fusion on a mesh (the sharded BM25 has no
        impact tier, as in the JAX package): each rank scores its own rows
        (the cosine arm over its dense part, ``BM25.shard_scores``), one
        all-reduce MAX of both arms' maxima over the real rows (< n, dead
        ones included, as the single device's max) normalizes them, the
        tombstone bias is added after the fusion, and the rank-local top-k
        merge by (value desc, doc id asc): ``np.argsort(-fused,
        kind="stable")``'s order. Every rank returns the same rows."""
        from hybridsearch_tpu_torch.ops.dense import l2_normalize, stable_topk
        from hybridsearch_tpu_torch.parallel.collectives import all_reduce, merge_topk

        ix = self.indexer
        n = snap.n
        lo, per = ix.dense._rows(snap.capacity)
        sem = l2_normalize(q_vec.float()) @ snap.docs.T  # [1, per]
        lex = ix.bm25.shard_scores([query], per)
        pad = (torch.arange(per, device=sem.device) + lo) >= n
        mx = all_reduce(torch.stack([sem.masked_fill(pad, float("-inf")).amax(),
                                     lex.masked_fill(pad, float("-inf")).amax()]),
                        "max", ix.mesh)
        fused = (max_normalize(sem, mx=mx[0]) * self.semantic_weight
                 + max_normalize(lex, mx=mx[1]) * self.bm25_weight) + snap.bias[None, :]
        k = min(top_k, n)
        vals, idx = stable_topk(fused, min(k, per))
        vals, ids = merge_topk(vals, torch.where(torch.isfinite(vals), idx + lo, -1),
                               k, ix.mesh)
        results = [(float(v), ix.contents[int(i)], int(i))
                   for v, i in zip(vals[0].cpu().numpy(), ids[0].cpu().numpy())
                   if np.isfinite(v)]
        return self._finish(results, query, {"pipeline": self.name})

    def _impact_search(self, query: str, q_vec: torch.Tensor, snap,
                       top_k: int) -> Optional[PipelineResult]:
        """The same divide-by-max fusion through the impact hybrid, with no
        [1, n] score array: one rung, then the deeper one while the row is
        not exact and can be certified deeper. Arm maxima are taken over
        alive docs only (the full path keeps the reference's
        include-everything max). None when there is no impact tier."""
        from hybridsearch_tpu_torch.ops.dense import l2_normalize
        from hybridsearch_tpu_torch.ops.hybrid import hybrid_impact_topk

        ix = self.indexer
        n = snap.n
        q = l2_normalize(q_vec.float())
        n_alive = n - ix.dense.deleted_count
        res = None
        exact = False
        for kd, cp, pd in _HYBRID_BM25_RUNGS:
            imp, enc = ix.bm25.encode_queries_impact([query], p_depth=pd)
            if imp is None:
                break
            res = hybrid_impact_topk(
                q, snap.docs, imp, enc, min(top_k, n), self.semantic_weight,
                self.bm25_weight, bias=snap.bias, k_dense=kd, c_per_term=cp,
                p_depth=pd, norm="max", n_alive=n_alive,
            )
            exact = bool(res.exact[0])
            if exact or not enc.certifiable_deeper[0]:
                break
        if res is None:
            return None
        vals = res.values[0].cpu().numpy()
        idx = res.indices[0].cpu().numpy()
        results = [
            (float(v), ix.contents[int(i)], int(i))
            for v, i in zip(vals, idx)
            if 0 <= i < len(ix.contents) and np.isfinite(v)
        ]
        return self._finish(results, query, {"pipeline": self.name, "exact": exact})


class RAGPipeline(BasePipeline):
    """Retrieval + LLM answering (reference pipelines.py:360-432)."""

    name = "rag"

    def __init__(self, provider: str = "local", llm_fn=None, **kwargs) -> None:
        super().__init__(**kwargs)
        from hybridsearch_tpu_torch.retrieval.rag import RAGAnswerer

        self.answerer = RAGAnswerer(self.searcher, provider=provider, llm_fn=llm_fn)

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        resp = self.answerer.ask(query, top_k=top_k)
        results = [
            (s["score"], s["preview"], s["doc_id"]) for s in resp.sources
        ]
        pr = self._finish(results, query,
                          {"pipeline": self.name, "provider": resp.provider,
                           "tokens_used": resp.tokens_used})
        pr.answer = resp.answer
        return pr


class MultiStagePipeline(BasePipeline):
    """stage 1 dense (semantic only) -> stage 2 BM25 on the candidates ->
    stage 3 cross-encoder (reference pipelines.py:435-511). Stages 1-2 run
    on the device; only the stage-2 contents go to the cross-encoder."""

    name = "multi_stage"

    def __init__(self, stage1_k: int = 100, stage2_k: int = 20, final_k: int = 5,
                 reranker=None, **kwargs) -> None:
        super().__init__(**kwargs)
        self.stage1_k = stage1_k
        self.stage2_k = stage2_k
        self.final_k = final_k
        self.reranker = _cross_encoder(reranker, self.device)

    def search(self, query: str, top_k: Optional[int] = None) -> PipelineResult:
        ix = self.indexer
        final_k = top_k or self.final_k
        n = ix.dense.n_docs
        if n == 0:
            return self._finish([], query, {"pipeline": self.name})
        # Stage 1: dense retrieval (pure semantic, pipelines.py:474-481)
        q_vec = ix.encoder.encode([query])
        k1 = min(self.stage1_k, n)
        vals1, idxs = ix.dense.search(q_vec, k1)
        # drop -1 padding ids (k1 > alive docs) and tombstoned (-inf) hits:
        # Python's -1 indexing would otherwise smuggle the LAST doc into
        # stage 2 with a made-up score (the batched path guards them too)
        keep = (idxs[0] >= 0) & np.isfinite(vals1[0])
        candidates = idxs[0][keep]
        if candidates.size == 0:
            return self._finish([], query, {"pipeline": self.name})
        # Stage 2: BM25 scores gathered at the candidates (pipelines.py:484-487)
        cand_scores = ix.bm25.candidate_scores(query, candidates)
        k2 = min(self.stage2_k, len(candidates))
        order = np.argsort(-cand_scores, kind="stable")[:k2]
        stage2_ids = [int(candidates[i]) for i in order]
        stage2 = [
            (float(cand_scores[i]), ix.contents[int(candidates[i])],
             int(candidates[i]))
            for i in order
        ]
        # Stage 3: cross-encoder (pipelines.py:492-496)
        results = self.reranker.rerank(query, stage2, top_k=final_k)
        return self._finish(
            results, query,
            {"pipeline": self.name, "stage1_k": k1, "stage2_k": k2,
             "stage2_ids": stage2_ids},
        )

    def search_batch(self, queries: Sequence[str],
                     top_k: Optional[int] = None) -> List[PipelineResult]:
        """Batched funnel: every stage runs once for the whole query batch
        (one dense top-k, one batched candidate-BM25 call, ONE cross-encoder
        pass over all (query, doc) pairs)."""
        final_k = top_k or self.final_k
        rows, meta = run_funnel_batch(
            self.indexer, self.reranker, queries,
            stage1_k=self.stage1_k, stage2_k=self.stage2_k, final_k=final_k,
        )
        return [
            self._finish(r, q, {"pipeline": self.name, **meta,
                                "batched": True})
            for q, r in zip(queries, rows)
        ]


def run_funnel_batch(
    indexer: Indexer,
    reranker,
    queries: Sequence[str],
    stage1_k: int = 100,
    stage2_k: int = 20,
    final_k: int = 5,
) -> Tuple[List[List[SearchResult]], Dict[str, Any]]:
    """The batched 100 -> 20 -> 5 funnel core (reference pipelines.py:470-511
    semantics, one device pass a stage): one encode and one
    ``DenseIndex.search`` over the whole batch, candidate-only BM25 by one
    ``BM25.candidate_scores_batch`` over [B, k1], then one cross-encoder
    ``predict`` over all B*k2 pairs in chunks of ``HST_CE_BATCH`` pairs
    (the reranker's model takes ``stats=``, as ``MiniLMCrossEncoder.predict``
    does). The meta holds each stage's seconds (the encode synchronised
    before its clock stops) and the cross-encoder's stats."""

    ix = indexer
    n = ix.dense.n_docs
    if n == 0 or not queries:
        return [[] for _ in queries], {"stage1_k": 0, "stage2_k": 0}
    t0 = time.perf_counter()
    q_vecs = ix.encoder.encode(list(queries))
    if q_vecs.device.type == "cuda":
        torch.cuda.synchronize(q_vecs.device)
    t_enc = time.perf_counter()
    k1 = min(stage1_k, n)
    vals1, idxs = ix.dense.search(q_vecs, k1)  # [B, k1] on the host
    # mark padding (-1) and tombstoned (-inf) hits invalid so the stage-3
    # id guard drops them
    idxs = np.where((idxs >= 0) & np.isfinite(vals1), idxs, -1)
    t_dense = time.perf_counter()
    # Stage 2: batched candidate BM25
    cand_scores = ix.bm25.candidate_scores_batch(list(queries), idxs)
    k2 = min(stage2_k, k1)
    order = np.argsort(-cand_scores, axis=1, kind="stable")[:, :k2]
    stage2_ids = np.take_along_axis(idxs, order, axis=1)  # [B, k2]
    t_bm25 = time.perf_counter()
    # Stage 3: one cross-encoder pass over all B*k2 pairs
    pairs, owners = [], []
    for b, q in enumerate(queries):
        for j in range(k2):
            did = int(stage2_ids[b, j])
            if 0 <= did < len(ix.contents):
                pairs.append((q, ix.contents[did]))
                owners.append((b, did))
    ce_bs = int(os.environ.get("HST_CE_BATCH", "128"))
    ce_stats: Dict[str, Any] = {}
    if not pairs:
        ce = np.zeros(0, np.float32)
    else:
        ce = reranker.model.predict(pairs, batch_size=ce_bs, stats=ce_stats)
        ce = torch.as_tensor(ce).cpu().numpy()
    t_ce = time.perf_counter()
    per_query: List[List[SearchResult]] = [[] for _ in queries]
    for (b, did), score in zip(owners, ce):
        per_query[b].append((float(score), ix.contents[did], did))
    rows = [sorted(r, key=lambda t: -t[0])[:final_k] for r in per_query]
    return rows, {"stage1_k": k1, "stage2_k": k2,
                  "t_encode_s": t_enc - t0,
                  "t_dense_s": t_dense - t_enc,
                  "t_bm25_s": t_bm25 - t_dense,
                  "t_ce_s": t_ce - t_bm25,
                  **{f"ce_{k_}": v_ for k_, v_ in ce_stats.items()}}


class DiversityPipeline(BasePipeline):
    """MMR diversity selection (reference pipelines.py:514-614); the MMR
    rounds are ``ops/mmr.py`` on the pipeline's device."""

    name = "diversity"

    def __init__(self, lambda_param: float = 0.5, candidate_multiplier: int = 3,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self.lambda_param = lambda_param
        self.candidate_multiplier = candidate_multiplier

    def search(self, query: str, top_k: int = 5) -> PipelineResult:
        fetch_k = top_k * self.candidate_multiplier
        candidates = self.searcher.search(query, top_k=fetch_k)
        if len(candidates) <= top_k:
            return self._finish(candidates, query, {"pipeline": self.name})
        rel = torch.tensor([s for s, _c, _i in candidates], dtype=torch.float32,
                           device=self.device)
        ids = [i for _s, _c, i in candidates]
        emb = torch.from_numpy(self.indexer.dense.get_vectors(ids)).to(self.device)
        order, _scores = mmr_select(rel, emb, top_k, self.lambda_param)
        results = [candidates[int(j)] for j in order.cpu().numpy()]
        return self._finish(results, query,
                            {"pipeline": self.name, "lambda": self.lambda_param})

    def search_batch(self, queries: Sequence[str],
                     top_k: int = 5) -> List[PipelineResult]:
        """Batched diversity: ONE hybrid batch for the candidates, one
        ``get_vectors`` (moved to the device once), and ONE [B, C, C]
        similarity product + masked-argmax rounds for all queries' MMR
        (``mmr_select_batch``)."""
        fetch_k = top_k * self.candidate_multiplier
        rows = self.searcher.search_batch(list(queries), top_k=fetch_k)
        meta = {"pipeline": self.name, "lambda": self.lambda_param,
                "batched": True}
        # Rows with <= top_k candidates skip MMR (reference behavior);
        # the rest pad to one common C and run as a single program.
        todo = [b for b, r in enumerate(rows) if len(r) > top_k]
        out: List[Optional[PipelineResult]] = [None] * len(rows)
        for b, r in enumerate(rows):
            if len(r) <= top_k:
                out[b] = self._finish(r, queries[b], dict(meta))
        if todo:
            C = max(len(rows[b]) for b in todo)
            B = len(todo)
            rel = np.zeros((B, C), dtype=np.float32)
            ids = np.zeros((B, C), dtype=np.int64)
            valid = np.zeros((B, C), dtype=bool)
            for j, b in enumerate(todo):
                r = rows[b]
                rel[j, : len(r)] = [s for s, _c, _i in r]
                ids[j, : len(r)] = [i for _s, _c, i in r]
                valid[j, : len(r)] = True
            dev = self.device
            emb = torch.from_numpy(self.indexer.dense.get_vectors(ids.reshape(-1)))
            order, _scores = mmr_select_batch(
                torch.from_numpy(rel).to(dev), emb.to(dev).reshape(B, C, -1),
                top_k, self.lambda_param, valid=torch.from_numpy(valid).to(dev),
            )
            order = order.cpu().numpy()
            for j, b in enumerate(todo):
                picked = [rows[b][int(p)] for p in order[j]
                          if p < len(rows[b])]
                out[b] = self._finish(picked, queries[b], dict(meta))
        return out  # type: ignore[return-value]


_PIPELINES = {
    "basic": BasicPipeline,
    "chunked": ChunkedPipeline,
    "reranked": RerankedPipeline,
    "bm25": BM25Pipeline,
    "hybrid_bm25": HybridBM25Pipeline,
    "rag": RAGPipeline,
    "multi_stage": MultiStagePipeline,
    "diversity": DiversityPipeline,
}


def create_pipeline(pipeline_type: str = "basic", **kwargs) -> BasePipeline:
    """Factory (reference pipelines.py:617-646)."""
    if pipeline_type not in _PIPELINES:
        raise ValueError(
            f"unknown pipeline type {pipeline_type!r}; "
            f"choose from {sorted(_PIPELINES)}"
        )
    return _PIPELINES[pipeline_type](**kwargs)
