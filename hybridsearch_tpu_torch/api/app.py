"""REST API: framework-agnostic router + engine state (the port of
``hybridsearch_tpu/api/app.py``, with the same 32 routes and handlers).

Route-table parity with the reference FastAPI app (reference api.py, ~28
endpoints; inventory at SURVEY §1.2). The router is plain Python —
(method, path) -> handler returning (status, json) — served by either the
stdlib adapter (api/httpd.py, zero dependencies) or the FastAPI adapter
(api/fastapi_app.py) when fastapi is installed.

``EngineState(device=)`` places the index, the encoder, the semantic
cache and the rerankers: the card unless the caller asks for the CPU.
Handlers return Python ints and floats only, so every payload is JSON.

Deliberate fixes over the reference:
  - the semantic cache IS consulted by /search (the reference instantiates
    it but never wires it into the query path, api.py:117 vs :272);
  - auth + rate limiting are enforced when enabled (the reference defines
    auth.py but never mounts it);
  - /search/batch is a true batched device call (the reference loops,
    api.py:420-447);
  - index mutations go through the Indexer's atomic snapshot swap instead
    of mutating process globals without a lock (reference api.py:232-238).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.api.batching import BatchTimeout
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.builder import Indexer
from hybridsearch_tpu_torch.retrieval.searcher import Searcher
from hybridsearch_tpu_torch.retrieval.highlighter import get_highlighter
from hybridsearch_tpu_torch.services.auth import AuthContext
from hybridsearch_tpu_torch.services.autocomplete import AutocompleteEngine
from hybridsearch_tpu_torch.services.dedup import DeduplicationEngine
from hybridsearch_tpu_torch.services.jobs import JobQueue
from hybridsearch_tpu_torch.services.language import LanguageDetector
from hybridsearch_tpu_torch.services.metadata_filter import (
    FilterParseError,
    MetadataFilterEngine,
)
from hybridsearch_tpu_torch.services.semantic_cache import SemanticCache
from hybridsearch_tpu_torch.services.watcher import FileWatcher
from hybridsearch_tpu_torch.utils.device import DeviceLike

JSON = Dict[str, Any]
Handler = Callable[["EngineState", Dict[str, str], JSON, Dict[str, str]],
                   Tuple[int, JSON]]


class EngineState:
    """Process-wide engine state (the reference's SearchEngineState,
    api.py:78-146) — built once at startup, mutated only through locked
    component APIs."""

    def __init__(
        self,
        db_path: str = ":memory:",
        encoder=None,
        mesh=None,
        config: Optional[EngineConfig] = None,
        auth_enabled: bool = False,
        use_semantic_cache: bool = True,
        device: DeviceLike = None,
    ) -> None:
        self.config = config or EngineConfig()
        self.indexer = Indexer(db_path=db_path, encoder=encoder, mesh=mesh,
                               config=self.config, device=device)
        self.device = self.indexer.device
        self.searcher = Searcher(indexer=self.indexer, config=self.config)
        self.autocomplete = AutocompleteEngine()
        self.semantic_cache: Optional[SemanticCache] = (
            SemanticCache(
                similarity_threshold=self.config.cache.similarity_threshold,
                ttl_seconds=self.config.cache.ttl_seconds,
                n_tables=self.config.cache.lsh_tables,
                n_bits=self.config.cache.lsh_bits,
                dim=self.config.index.dim,
                max_entries=self.config.cache.max_entries,
                device=self.device,
            )
            if use_semantic_cache
            else None
        )
        self.metadata = MetadataFilterEngine(store=self.indexer.store)
        self.dedup = DeduplicationEngine(threshold=self.config.dedup_threshold)
        self.language = LanguageDetector()
        self.jobs = JobQueue(n_workers=3, docstore=self.indexer.store)
        self.jobs.register_handler("index", self._index_job)
        self.watcher: Optional[FileWatcher] = None
        self.auth = AuthContext(enabled=auth_enabled)
        self.batcher = None
        if self.config.serving.dynamic_batching:
            from hybridsearch_tpu_torch.api.batching import SearchBatcher

            self.batcher = SearchBatcher(
                self.searcher,
                query_memory=self.searcher.query_memory,
                max_batch=self.config.serving.max_batch,
                queue_timeout_s=self.config.serving.queue_timeout_s,
            )
        self.started_at = time.time()
        self._mutate_lock = threading.Lock()
        self._warm_autocomplete()

    def _warm_autocomplete(self, limit: int = 5000) -> None:
        """Rebuild the suggestion trie from persisted query history so
        autocomplete survives restarts (history lives in sqlite; the
        reference's trie is memory-only)."""
        try:
            rows = self.indexer.store._conn.execute(
                "SELECT query, COUNT(*) c FROM query_history "
                "GROUP BY query ORDER BY c DESC LIMIT ?", (limit,)
            ).fetchall()
            for r in rows:
                self.autocomplete.history.insert(r["query"], weight=int(r["c"]))
        except Exception:
            pass

    def warmup(self, sample_queries: Optional[List[str]] = None,
               top_k: int = 10) -> int:
        """Serve one search_batch per batcher pad bucket (1, 2, 4, ...,
        max_batch) BEFORE traffic, cycling representative queries, so the
        first batch of each bucket shape (the kernels' first builds and
        launches, the allocator's first blocks at that shape) is not paid
        inside live traffic. Returns the number of warm dispatches run.

        Queries default to terms sampled from the indexed corpus so the
        term-shape buckets and ladder rungs taken here match live
        traffic's. No query logging and no cache pollution.
        """
        if self.indexer.dense.n_docs == 0:
            return 0
        if not sample_queries:
            sample_queries = []
            try:
                contents = self.indexer.contents
                step = max(1, len(contents) // 13)
                for c in contents[::step][:13]:
                    toks = c.split()[:4]
                    if toks:
                        sample_queries.append(" ".join(toks))
            except Exception:  # noqa: BLE001 — warmup is best-effort
                pass
        if not sample_queries:
            return 0
        max_b = (self.batcher.max_batch if self.batcher is not None
                 else self.config.serving.max_batch)
        n = 0
        b = 1
        while b <= max(1, max_b):
            qs = [sample_queries[i % len(sample_queries)] for i in range(b)]
            try:
                self.searcher.search_batch(qs, top_k=top_k, log=False)
                n += 1
            except Exception:  # noqa: BLE001 — warmup is best-effort
                pass
            b <<= 1
        return n

    # -- mutation discipline ------------------------------------------------------

    def invalidate_query_caches(self) -> None:
        """Every index mutation must call this: cached /search responses
        reference doc ids that a mutation may repoint or remove."""
        if self.semantic_cache is not None:
            self.semantic_cache.invalidate()

    # -- jobs ------------------------------------------------------------------

    def _index_job(self, payload, progress_cb, cancel_event):
        """Async index handler. Idempotent under JobQueue retries: committed
        progress is tracked in the payload (the same dict across retries), so
        a retry resumes after the last committed batch instead of re-adding
        every batch (which would duplicate docs up to max_retries+1 times)."""
        docs = payload.get("documents", [])
        # each add_documents commit rebuilds device postings and recomputes
        # all eager weights (global BM25 stats change); scale the batch so a
        # job pays at most ~20 rebuild rounds while keeping progress/cancel
        # granularity for small jobs
        batch = max(32, -(-len(docs) // 20))
        added: List[int] = payload.setdefault("_added_ids", [])
        start = int(payload.get("_committed", 0))
        for i in range(start, len(docs), batch):
            if cancel_event.is_set():
                raise RuntimeError("cancelled")
            with self._mutate_lock:
                ids = self.indexer.add_documents(docs[i : i + batch])
                added.extend(int(x) for x in ids)
                payload["_committed"] = i + batch
            self.invalidate_query_caches()
            progress_cb(100.0 * min(1.0, (i + batch) / max(len(docs), 1)))
        return {"added": len(added), "doc_ids": list(added)}

    def close(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        if self.batcher is not None:
            self.batcher.close()
        self.jobs.shutdown(wait=False)
        self.indexer.close()


# -- router ---------------------------------------------------------------------------


class Router:
    def __init__(self, state: EngineState) -> None:
        self.state = state
        self._routes: List[Tuple[str, re.Pattern, List[str], Handler, str]] = []

    def add(self, method: str, path: str, handler: Handler,
            scope: str = "read") -> None:
        names = re.findall(r"\{(\w+)\}", path)
        pattern = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path) + "$"
        )
        self._routes.append((method.upper(), pattern, names, handler, scope))

    def dispatch(
        self,
        method: str,
        path: str,
        body: Optional[JSON] = None,
        query: Optional[Dict[str, str]] = None,
        api_key: Optional[str] = None,
        client_ip: str = "local",
    ) -> Tuple[int, JSON, Dict[str, str]]:
        """Returns (status, json_body, extra_headers)."""
        for m, pattern, _names, handler, scope in self._routes:
            if m != method.upper():
                continue
            match = pattern.match(path)
            if match is None:
                continue
            allowed, status, headers = self.state.auth.authorize(
                api_key, client_ip, scope=scope
            )
            if not allowed:
                return status, {"detail": _AUTH_ERRORS.get(status, "forbidden")}, headers
            try:
                code, payload = handler(self.state, match.groupdict(),
                                        body or {}, query or {})
                return code, payload, headers
            except FilterParseError as e:
                return 400, {"detail": str(e)}, headers
            except ValueError as e:
                return 400, {"detail": str(e)}, headers
            except BatchTimeout as e:
                # the engine cannot drain the search queue: shed load
                # with an honest 503 instead of stacking more work
                return 503, {"detail": str(e)}, headers
            except Exception as e:  # mirrors reference's try/except -> 500
                return 500, {"detail": f"{type(e).__name__}: {e}"}, headers
        return 404, {"detail": f"no route: {method} {path}"}, {}

    def routes(self) -> List[str]:
        return [f"{m} {p.pattern}" for m, p, _n, _h, _s in self._routes]


_AUTH_ERRORS = {401: "invalid or missing API key", 403: "insufficient scope",
                429: "rate limit exceeded"}


# -- handlers ---------------------------------------------------------------------------


def _result_rows(results) -> List[JSON]:
    return [
        {"score": float(s), "content": c, "doc_id": int(i)}
        for s, c, i in results
    ]


def _validated_weights(body: JSON) -> Tuple[Optional[float], Optional[float]]:
    sw = body.get("semantic_weight")
    lw = body.get("lexical_weight")
    return sw, lw


def h_health(state, params, body, query):
    """GET /health (reference api.py:161-168)."""
    return 200, {
        "status": "healthy",
        "documents": len(state.indexer.contents),
        "uptime_s": round(time.time() - state.started_at, 1),
    }


def h_search(state, params, body, query):
    """POST /search — semantic-cache consulted, then the fused device path
    (reference api.py:250-301 + the cache wiring it lacks)."""
    q = body.get("query", "")
    if not q:
        return 400, {"detail": "query is required"}
    top_k = int(body.get("top_k", 5))
    sw, lw = _validated_weights(body)
    use_learned = bool(body.get("use_learned_weights", False))
    # resolve up front so the cache key and the reported weights_used both
    # reflect what the kernel actually fused (reference api.py:287-296
    # echoes weights_used in every response)
    rsw, rlw = state.searcher.resolve_weights(sw, lw, use_learned)
    cache_key_vec = None
    if state.semantic_cache is not None:
        cache_key_vec = state.indexer.encoder.encode([q])[0]
        hit = state.semantic_cache.get(cache_key_vec)
        if hit is not None and hit.get("top_k", -1) >= top_k and (
            hit.get("weights") == [rsw, rlw]
        ):
            state.autocomplete.record_query(q)
            return 200, {**hit["response"], "cached": True}
    t0 = time.perf_counter()
    if state.batcher is not None:
        # continuous batching: concurrent requests coalesce into one
        # batched device dispatch (api/batching.py) — the reference
        # serves one request at a time (api.py:272)
        results, query_id = state.batcher.submit(q, top_k, rsw, rlw)
    else:
        results = state.searcher.search(q, top_k=top_k, semantic_weight=rsw,
                                        lexical_weight=rlw)
        query_id = state.searcher.last_query_id
    latency_ms = (time.perf_counter() - t0) * 1e3
    state.autocomplete.record_query(q)
    resp = {
        "query": q,
        "query_id": query_id,
        "results": _result_rows(results),
        "weights_used": {"semantic": rsw, "lexical": rlw,
                         "learned": use_learned},
        "latency_ms": round(latency_ms, 3),
        "cached": False,
    }
    if state.semantic_cache is not None and cache_key_vec is not None:
        state.semantic_cache.set(
            cache_key_vec,
            {"response": resp, "top_k": top_k, "weights": [rsw, rlw]},
        )
    return 200, resp


def h_search_batch(state, params, body, query):
    """POST /search/batch — one batched device program (the reference loops
    per query, api.py:420-447)."""
    queries = body.get("queries", [])
    if not queries:
        return 400, {"detail": "queries is required"}
    top_k = int(body.get("top_k", 5))
    sw, lw = _validated_weights(body)
    batch = state.searcher.search_batch(queries, top_k=top_k,
                                        semantic_weight=sw, lexical_weight=lw)
    return 200, {
        "results": [
            {"query": q, "results": _result_rows(r)}
            for q, r in zip(queries, batch)
        ]
    }


def h_search_funnel(state, params, body, query):
    """POST /search/funnel — the batched multi-stage retrieval funnel
    (dense stage1_k -> candidate BM25 stage2_k -> cross-encoder top_k,
    reference pipelines.py:470-511 semantics) over a whole query batch:
    one device pass per stage and a single length-bucketed cross-encoder
    pass for all B*stage2_k pairs. The reference exposes no funnel route
    at all (its /search/batch is a per-query Python loop, api.py:420-447)."""
    queries = body.get("queries") or ([body["query"]] if body.get("query")
                                      else [])
    if not queries:
        return 400, {"detail": "queries is required"}
    from hybridsearch_tpu_torch.pipelines import run_funnel_batch

    if getattr(state, "_funnel_reranker", None) is None:
        from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker

        state._funnel_reranker = CrossEncoderReranker(device=state.device)
    rows, meta = run_funnel_batch(
        state.indexer, state._funnel_reranker, queries,
        stage1_k=int(body.get("stage1_k", 100)),
        stage2_k=int(body.get("stage2_k", 20)),
        final_k=int(body.get("top_k", 5)),
    )
    return 200, {
        **meta,
        "results": [
            {"query": q, "results": _result_rows(r)}
            for q, r in zip(queries, rows)
        ],
    }


def h_search_highlighted(state, params, body, query):
    """POST /search/highlighted (reference api.py:449-485): inherits the
    SearchRequest fields plus `highlight` and `snippet_length`."""
    q = body.get("query", "")
    if not q:
        return 400, {"detail": "query is required"}
    style = body.get("style", "html")
    top_k = int(body.get("top_k", 5))
    sw, lw = _validated_weights(body)
    snippet_length = int(body.get("snippet_length", 150))
    do_highlight = bool(body.get("highlight", True))
    results = state.searcher.search(q, top_k=top_k, semantic_weight=sw,
                                    lexical_weight=lw)
    hl = get_highlighter(style)
    rows = []
    for s, c, i in results:
        row = {"score": float(s), "doc_id": int(i), "content": c}
        if do_highlight:
            row["highlighted"] = hl.highlight_text(c, q)
        # the reference's snippet_length is the full window around a
        # match (api.py:410, highlighter.py:68-145); ours is a half-width
        row["snippets"] = hl.extract_snippets(
            c, q, window=max(1, snippet_length // 2),
            highlight=do_highlight)
        rows.append(row)
    return 200, {"query": q, "results": rows}


def h_search_filtered(state, params, body, query):
    """POST /search/filtered — metadata PRE-filter inside the kernel via the
    bias mask (the reference post-filters retrieved results,
    api.py:759-791)."""
    q = body.get("query", "")
    filter_text = body.get("filter", "")
    if not q or not filter_text:
        return 400, {"detail": "query and filter are required"}
    top_k = int(body.get("top_k", 5))
    n = state.indexer.dense.n_docs
    bias = state.metadata.bias_for(filter_text, n)
    q_vec = state.indexer.encoder.encode([q])
    vals, idxs = state.indexer.dense.search(
        q_vec, top_k, extra_bias=torch.from_numpy(
            np.asarray(bias, np.float32)).to(state.indexer.dense.device))
    contents = state.indexer.contents
    results = [
        (float(vals[0, j]), contents[int(idxs[0, j])], int(idxs[0, j]))
        for j in range(vals.shape[1])
        if 0 <= int(idxs[0, j]) < len(contents) and np.isfinite(vals[0, j])
    ]
    return 200, {"query": q, "filter": filter_text,
                 "results": _result_rows(results)}


def h_ask(state, params, body, query):
    """POST /ask — RAG (reference api.py /ask route)."""
    q = body.get("question") or body.get("query", "")
    if not q:
        return 400, {"detail": "question is required"}
    from hybridsearch_tpu_torch.retrieval.rag import RAGAnswerer

    # the reference's field is llm_provider with a model override
    # (api.py:413-418); `provider` is kept as an alias
    provider = body.get("llm_provider") or body.get("provider", "local")
    kw = {}
    if body.get("model"):
        kw["model"] = body["model"]
    answerer = RAGAnswerer(state.searcher, provider=provider, **kw)
    resp = answerer.ask(q, top_k=int(body.get("top_k", 5)))
    return 200, {"question": q, "answer": resp.answer, "sources": resp.sources,
                 "provider": resp.provider, "tokens_used": resp.tokens_used}


def h_rerank(state, params, body, query):
    """POST /rerank (reference api.py:521-555): the reference takes
    query params `query`, repeated `doc_ids` (resolved from the store)
    and `top_k`; raw `documents` in the body is kept as an extension."""
    q = body.get("query") or query.get("query", "")
    if not q:
        return 400, {"detail": "query is required"}
    from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker

    documents = body.get("documents", [])
    doc_ids = body.get("doc_ids", query.get("doc_ids", []))
    if isinstance(doc_ids, str):
        doc_ids = [x for x in doc_ids.split(",") if x]
    elif not isinstance(doc_ids, list):
        doc_ids = [doc_ids]
    if documents:
        results = [(0.0, d, i) for i, d in enumerate(documents)]
    elif doc_ids:
        contents = state.indexer.contents
        results = []
        for did in doc_ids:
            did = int(did)
            if 0 <= did < len(contents):
                results.append((0.0, contents[did], did))
        if not results:
            return 404, {"detail": "No matching documents found"}
    else:
        return 400, {"detail": "doc_ids or documents is required"}
    top_k = int(body.get("top_k", query.get("top_k", len(results))))
    rr = CrossEncoderReranker(device=state.device)
    ranked = rr.rerank(q, results, top_k=top_k)
    return 200, {"query": q, "results": _result_rows(ranked)}


def _normalize_documents(docs):
    """Accept the reference's two request shapes for a document
    (reference api.py:26-32 `Document`): a plain string, or an object
    with required `content` and optional `source_path`. An optional
    `metadata` object per document is an extension: the reference only
    takes metadata through its separate metadata route, which leaves
    /search/filtered useless until a second call — here one /index call
    fully arms the device pre-filter. Returns (texts, paths, metas);
    raises ValueError on anything else so the caller can surface a 400
    instead of a 500."""
    texts, paths, metas = [], [], []
    for d in docs:
        if isinstance(d, str):
            texts.append(d)
            paths.append(None)
            metas.append(None)
        elif isinstance(d, dict) and isinstance(d.get("content"), str):
            texts.append(d["content"])
            sp = d.get("source_path")
            paths.append(sp if isinstance(sp, str) else None)
            md = d.get("metadata")
            metas.append(md if isinstance(md, dict) else None)
        else:
            raise ValueError(
                "each document must be a string or an object with a "
                "string 'content' field")
    return texts, paths, metas


def h_index(state, params, body, query):
    """POST /index — destructive full reindex (reference api.py:171-196)."""
    raw = body.get("documents", [])
    if not raw:
        return 400, {"detail": "documents is required"}
    try:
        docs, paths, metas = _normalize_documents(raw)
    except ValueError as e:
        return 400, {"detail": str(e)}
    with state._mutate_lock:
        stats = state.indexer.index_documents(docs, paths=paths, metas=metas)
        state.autocomplete.index_content(docs)
        for i, d in enumerate(docs):
            state.dedup.add_document(str(i), d)
    if state.semantic_cache is not None:
        state.semantic_cache.invalidate()
    return 200, {"indexed": stats["indexed"]}


def h_index_directory(state, params, body, query):
    """POST /index/directory (reference api.py:199-227)."""
    directory = body.get("directory", "")
    if not directory:
        return 400, {"detail": "directory is required"}
    from hybridsearch_tpu_torch.text.extractor import discover_documents

    found = discover_documents(directory)
    if not found:
        return 200, {"indexed": 0, "files": []}
    with state._mutate_lock:
        stats = state.indexer.index_documents(
            [c for _p, c in found], [p for p, _c in found]
        )
    if state.semantic_cache is not None:
        state.semantic_cache.invalidate()
    return 200, {"indexed": stats["indexed"], "files": [p for p, _ in found]}


def h_index_add(state, params, body, query):
    """POST /index/add — incremental, consistent across BOTH indexes
    (reference api.py:230-247 merges into globals without refitting)."""
    raw = body.get("documents", [])
    if not raw:
        return 400, {"detail": "documents is required"}
    try:
        docs, _, metas = _normalize_documents(raw)
    except ValueError as e:
        return 400, {"detail": str(e)}
    dedup_action = body.get("dedup", None)
    skipped = []
    to_add = []
    to_add_metas = []
    for d, m in zip(docs, metas):
        if dedup_action:
            existing = state.dedup.find_duplicates(d)
            if existing and dedup_action == "skip":
                skipped.append({"content": d[:80],
                                "duplicate_of": existing[0][0]})
                continue
        to_add.append(d)
        to_add_metas.append(m)
    with state._mutate_lock:
        ids = state.indexer.add_documents(
            to_add, metas=to_add_metas) if to_add else []
        for did, d in zip(ids, to_add):
            state.dedup.add_document(str(did), d)
        state.autocomplete.index_content(to_add)
    if state.semantic_cache is not None:
        state.semantic_cache.invalidate()
    return 200, {"added": len(ids), "doc_ids": [int(x) for x in ids],
                 "skipped": skipped}


def h_delete_document(state, params, body, query):
    """DELETE /documents/{id} — tombstone the doc in the dense index, the
    BM25 postings AND the host store (it stops surfacing from every path
    immediately; compaction reclaims space). Beyond the reference's surface,
    enabled by the tombstone bias machinery."""
    doc_id = int(params["doc_id"])
    if doc_id < 0 or doc_id >= state.indexer.dense.n_docs:
        return 404, {"detail": f"doc {doc_id} not found"}
    with state._mutate_lock:
        state.indexer.delete_documents([doc_id])
    state.invalidate_query_caches()
    return 200, {"status": "deleted", "doc_id": doc_id,
                 "tombstoned": state.indexer.dense.deleted_count}


def h_feedback(state, params, body, query):
    """POST /feedback — accepts the reference's FeedbackRequest form
    (query_id/relevance_score/clicked, reference api.py:48-53, 304-320)
    and the query-string form."""
    doc_id = body.get("doc_id")
    if doc_id is None:
        return 400, {"detail": "doc_id is required"}
    if "query_id" in body:
        try:
            state.searcher.record_feedback(
                int(body["query_id"]), int(doc_id),
                relevance_score=int(body.get("relevance_score", 0)),
                clicked=bool(body.get("clicked", False)),
            )
        except KeyError as e:
            return 404, {"detail": str(e)}
        return 200, {"status": "success", "message": "Feedback recorded"}
    q = body.get("query", "")
    rating = body.get("rating", body.get("relevance_score"))
    if not q or rating is None:
        return 400, {"detail": "query_id or (query, rating) is required"}
    state.searcher.log_feedback(q, int(doc_id), int(rating))
    return 200, {"status": "recorded"}


def h_stats(state, params, body, query):
    """GET /stats (reference api.py:323-338)."""
    return 200, state.searcher.get_stats()


def h_metrics(state, params, body, query):
    """GET /metrics — Prometheus text exposition (the reference lists
    Prometheus as roadmap-only, README.md:397)."""
    lines = [
        "# HELP hst_documents_total Indexed documents",
        "# TYPE hst_documents_total gauge",
        f"hst_documents_total {len(state.indexer.contents)}",
    ]
    stats = state.searcher.get_stats()
    lines += [
        "# HELP hst_queries_total Queries served",
        "# TYPE hst_queries_total counter",
        f"hst_queries_total {stats.get('total_queries', 0)}",
        "# HELP hst_feedback_total Feedback events",
        "# TYPE hst_feedback_total counter",
        f"hst_feedback_total {stats.get('total_feedback', 0)}",
    ]
    for stage, s in stats.get("stages", {}).items():
        lines += [
            f'hst_stage_latency_ms{{stage="{stage}",quantile="0.5"}} '
            f"{s['p50_ms']:.4f}",
            f'hst_stage_latency_ms{{stage="{stage}",quantile="0.99"}} '
            f"{s['p99_ms']:.4f}",
            f'hst_stage_calls_total{{stage="{stage}"}} {s["count"]}',
        ]
    if state.semantic_cache is not None:
        cs = state.semantic_cache.stats()
        lines += [
            f"hst_cache_hits_total {cs['hits']}",
            f"hst_cache_misses_total {cs['misses']}",
            f"hst_cache_entries {cs['entries']}",
        ]
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

    for name, v in sorted(GLOBAL_COUNTERS.all().items()):
        lines.append(f"hst_{name}_total {v}")
    if state.batcher is not None:
        b = state.batcher
        lines += [
            "# HELP hst_batch_dispatches_total Coalesced device dispatches",
            "# TYPE hst_batch_dispatches_total counter",
            f"hst_batch_dispatches_total {b.dispatches}",
            f"hst_batch_requests_total {b.batched_requests}",
            f"hst_batch_max_size {b.max_seen_batch}",
        ]
    return 200, {"_text": "\n".join(lines) + "\n"}


def h_documents(state, params, body, query):
    """GET /documents (reference api.py /documents)."""
    limit = int(query.get("limit", 100))
    offset = int(query.get("offset", 0))
    docs = state.indexer.store.get_all_documents()
    page = docs[offset : offset + limit]
    return 200, {"total": len(docs), "documents": page}


def h_watcher_start(state, params, body, query):
    """POST /watcher/start (reference api.py:341-367: `directory` is a
    query param defaulting to "data"; a JSON body key works too)."""
    directory = body.get("directory") or query.get("directory") or "data"
    if state.watcher is not None and state.watcher.is_running:
        return 400, {"detail": "watcher already running"}
    from hybridsearch_tpu_torch.text.extractor import discover_documents

    def _reindex(_event: str, _path: str) -> None:
        # same mutation discipline as the handlers: take the lock, then
        # invalidate the semantic cache (a destructive full reindex repoints
        # every doc_id — stale cached /search responses must not survive it)
        docs = discover_documents(directory)
        if docs:
            with state._mutate_lock:
                state.indexer.index_documents(
                    [c for _p, c in docs], [p for p, _c in docs]
                )
            state.invalidate_query_caches()

    state.watcher = FileWatcher(directory, _reindex)
    state.watcher.start()
    return 200, {"status": "watching", "directory": directory}


def h_watcher_stop(state, params, body, query):
    if state.watcher is None or not state.watcher.is_running:
        return 400, {"detail": "watcher not running"}
    state.watcher.stop()
    return 200, {"status": "stopped"}


def h_autocomplete(state, params, body, query):
    """GET /autocomplete?prefix=... (extension) and the reference's POST
    form with partial_query/limit returning a bare list of
    {text, score, source, frequency} (reference api.py:567-596)."""
    if body.get("partial_query"):
        prefix = body["partial_query"]
        limit = int(body.get("limit", 10))
        return 200, [
            {"text": s["suggestion"], "score": s["score"],
             "source": s["source"], "frequency": s["frequency"]}
            for s in state.autocomplete.suggest(prefix, limit)
        ]
    prefix = query.get("prefix") or query.get("q", "")
    limit = int(query.get("limit", 10))
    return 200, {"prefix": prefix,
                 "suggestions": state.autocomplete.suggest(prefix, limit)}


def h_autocomplete_record(state, params, body, query):
    """POST /autocomplete/record — the reference passes partial_query and
    selected as query params (api.py:598-609); body keys work too."""
    selected = (query.get("selected") or body.get("selected")
                or body.get("suggestion") or body.get("query", ""))
    partial = query.get("partial_query") or body.get("partial_query", "")
    if not selected:
        return 400, {"detail": "selected (or suggestion) is required"}
    state.autocomplete.record_selection(partial or selected, selected)
    return 200, {"status": "recorded"}


def h_cache_stats(state, params, body, query):
    """GET /cache/stats (reference api.py:613-626)."""
    if state.semantic_cache is None:
        return 200, {"enabled": False}
    return 200, {"enabled": True, **state.semantic_cache.stats()}


def h_cache_invalidate(state, params, body, query):
    if state.semantic_cache is None:
        return 200, {"invalidated": 0}
    return 200, {"invalidated": state.semantic_cache.invalidate()}


def h_duplicates(state, params, body, query):
    """GET /documents/duplicates (reference api.py duplicates route)."""
    docs = {str(i): c for i, c in enumerate(state.indexer.contents)}
    return 200, {"groups": state.dedup.find_all_duplicates(docs)}


def h_mark_duplicate(state, params, body, query):
    doc_id = int(params["doc_id"])
    duplicate_of = body.get("duplicate_of")
    if duplicate_of is None:
        return 400, {"detail": "duplicate_of is required"}
    state.indexer.store.mark_duplicate(doc_id, int(duplicate_of))
    return 200, {"status": "marked", "doc_id": doc_id,
                 "duplicate_of": int(duplicate_of)}


def h_get_metadata(state, params, body, query):
    doc_id = int(params["doc_id"])
    meta = state.metadata.get_metadata(doc_id)
    if meta is None:
        return 404, {"detail": f"no metadata for doc {doc_id}"}
    return 200, {"doc_id": doc_id, "metadata": meta}


def h_set_metadata(state, params, body, query):
    doc_id = int(params["doc_id"])
    metadata = body.get("metadata", body)
    state.metadata.set_metadata(doc_id, metadata)
    return 200, {"status": "set", "doc_id": doc_id}


def h_language_detect(state, params, body, query):
    """POST /language/detect (reference api.py language route)."""
    text = body.get("text", "")
    if not text:
        return 400, {"detail": "text is required"}
    r = state.language.detect(text)
    return 200, {"language": r.language, "confidence": round(r.confidence, 4),
                 "script": r.script}


def h_jobs_index(state, params, body, query):
    """POST /jobs/index — async indexing job (reference api.py:822-864)."""
    raw = body.get("documents", [])
    if not raw:
        return 400, {"detail": "documents is required"}
    try:
        docs, _, _metas = _normalize_documents(raw)
    except ValueError as e:
        return 400, {"detail": str(e)}
    job_id = state.jobs.enqueue("index", {"documents": docs},
                                webhook_url=body.get("webhook_url"))
    return 202, {"job_id": job_id, "state": "pending"}


def h_job_get(state, params, body, query):
    job = state.jobs.get(params["job_id"])
    if job is None:
        return 404, {"detail": "job not found"}
    return 200, job.to_dict()


def h_job_cancel(state, params, body, query):
    ok = state.jobs.cancel(params["job_id"])
    if not ok:
        return 400, {"detail": "job not cancellable"}
    return 200, {"status": "cancelling"}


def h_jobs_list(state, params, body, query):
    limit = int(query.get("limit", 100))
    return 200, {"jobs": [j.to_dict() for j in state.jobs.list(limit)]}


def build_router(state: EngineState) -> Router:
    """The full route table (SURVEY §1.2 inventory)."""
    r = Router(state)
    r.add("GET", "/health", h_health)
    r.add("POST", "/search", h_search)
    r.add("POST", "/search/batch", h_search_batch)
    r.add("POST", "/search/funnel", h_search_funnel)
    r.add("POST", "/search/highlighted", h_search_highlighted)
    r.add("POST", "/search/filtered", h_search_filtered)
    r.add("POST", "/ask", h_ask)
    r.add("POST", "/rerank", h_rerank)
    r.add("POST", "/index", h_index, scope="write")
    r.add("POST", "/index/directory", h_index_directory, scope="write")
    r.add("POST", "/index/add", h_index_add, scope="write")
    r.add("POST", "/feedback", h_feedback)
    r.add("GET", "/stats", h_stats)
    r.add("GET", "/metrics", h_metrics)
    r.add("GET", "/documents", h_documents)
    r.add("POST", "/watcher/start", h_watcher_start, scope="write")
    r.add("POST", "/watcher/stop", h_watcher_stop, scope="write")
    r.add("GET", "/autocomplete", h_autocomplete)
    r.add("POST", "/autocomplete", h_autocomplete)
    r.add("POST", "/autocomplete/record", h_autocomplete_record)
    r.add("GET", "/cache/stats", h_cache_stats)
    r.add("POST", "/cache/invalidate", h_cache_invalidate, scope="write")
    r.add("GET", "/documents/duplicates", h_duplicates)
    r.add("POST", "/documents/{doc_id}/mark-duplicate", h_mark_duplicate,
          scope="write")
    r.add("DELETE", "/documents/{doc_id}", h_delete_document, scope="write")
    r.add("GET", "/documents/{doc_id}/metadata", h_get_metadata)
    r.add("POST", "/documents/{doc_id}/metadata", h_set_metadata, scope="write")
    r.add("POST", "/language/detect", h_language_detect)
    r.add("POST", "/jobs/index", h_jobs_index, scope="write")
    r.add("GET", "/jobs/{job_id}", h_job_get)
    r.add("DELETE", "/jobs/{job_id}", h_job_cancel, scope="write")
    r.add("GET", "/jobs", h_jobs_list)
    return r
