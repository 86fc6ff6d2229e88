"""Host-side document/metadata/feedback store (sqlite3).

Plays the role DuckDB plays in the reference (reference indexer.py:112-201:
5 tables + 2 sequences for docs, query history, feedback, metadata). The
store holds only host data — document text, metadata JSON, query logs,
feedback, job records; embeddings live in the device DenseIndex and persist
via its shard manifest (index/dense_index.py), never here.

sqlite3 is stdlib, transactional, and safe across the API's worker threads
(single connection + lock; WAL mode for concurrent readers).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    doc_id INTEGER PRIMARY KEY,
    content TEXT NOT NULL,
    path TEXT,
    token_count INTEGER NOT NULL DEFAULT 0,
    char_count INTEGER NOT NULL DEFAULT 0,
    lang TEXT,
    is_duplicate_of INTEGER,
    deleted INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS query_history (
    query_id INTEGER PRIMARY KEY AUTOINCREMENT,
    query TEXT NOT NULL,
    semantic_weight REAL NOT NULL,
    lexical_weight REAL NOT NULL,
    top_score REAL,
    n_results INTEGER,
    latency_ms REAL,
    ts REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS feedback (
    feedback_id INTEGER PRIMARY KEY AUTOINCREMENT,
    query_id INTEGER,
    query TEXT NOT NULL,
    doc_id INTEGER NOT NULL,
    rating INTEGER NOT NULL,
    ts REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS doc_metadata (
    doc_id INTEGER PRIMARY KEY,
    meta_json TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    job_type TEXT NOT NULL,
    state TEXT NOT NULL,
    progress REAL NOT NULL DEFAULT 0,
    payload_json TEXT,
    result_json TEXT,
    error TEXT,
    retries INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS chunks (
    chunk_row INTEGER PRIMARY KEY,
    parent_doc_id INTEGER NOT NULL,
    chunk_index INTEGER NOT NULL,
    start_char INTEGER NOT NULL DEFAULT 0,
    end_char INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS parents (
    parent_doc_id INTEGER PRIMARY KEY,
    content TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_feedback_query ON feedback(query);
CREATE INDEX IF NOT EXISTS idx_history_ts ON query_history(ts);
CREATE INDEX IF NOT EXISTS idx_chunks_parent ON chunks(parent_doc_id);
"""


class DocStore:
    def __init__(self, path: str = ":memory:") -> None:
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            if path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.executescript(_SCHEMA)
            # migrate pre-existing stores created before the deleted column
            cols = [r["name"] for r in self._conn.execute(
                "PRAGMA table_info(documents)").fetchall()]
            if "deleted" not in cols:
                self._conn.execute(
                    "ALTER TABLE documents ADD COLUMN deleted INTEGER "
                    "NOT NULL DEFAULT 0")
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def __enter__(self) -> "DocStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- documents -----------------------------------------------------------

    def replace_documents(
        self, docs: Sequence[str], paths: Optional[Sequence[Optional[str]]] = None,
        token_counts: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Destructive full reindex (reference indexer.py:268 DELETE FROM)."""
        with self._lock:
            self._conn.execute("DELETE FROM documents")
            self._conn.execute("DELETE FROM doc_metadata")
            self._conn.commit()
        return self.add_documents(docs, paths, token_counts, start_id=0)

    def add_documents(
        self,
        docs: Sequence[str],
        paths: Optional[Sequence[Optional[str]]] = None,
        token_counts: Optional[Sequence[int]] = None,
        start_id: Optional[int] = None,
    ) -> List[int]:
        """Append documents with contiguous ids = MAX(doc_id)+1..
        (reference indexer.py:336-337)."""
        now = time.time()
        paths = paths or [None] * len(docs)
        tc = token_counts or [len(d.split()) for d in docs]
        with self._lock:
            if start_id is None:
                row = self._conn.execute(
                    "SELECT COALESCE(MAX(doc_id)+1, 0) AS nxt FROM documents"
                ).fetchone()
                start_id = int(row["nxt"])
            ids = list(range(start_id, start_id + len(docs)))
            self._conn.executemany(
                "INSERT OR REPLACE INTO documents "
                "(doc_id, content, path, token_count, char_count, created_at) "
                "VALUES (?,?,?,?,?,?)",
                [
                    (i, d, p, t, len(d), now)
                    for i, d, p, t in zip(ids, docs, paths, tc)
                ],
            )
            self._conn.commit()
        return ids

    def get_document(self, doc_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM documents WHERE doc_id=?", (doc_id,)
            ).fetchone()
        return dict(row) if row else None

    def get_all_documents(self, include_deleted: bool = False) -> List[Dict[str, Any]]:
        """Ordered by doc_id (reference indexer.py:362-373); tombstoned docs
        are excluded from listings unless asked for."""
        where = "" if include_deleted else "WHERE deleted=0 "
        with self._lock:
            rows = self._conn.execute(
                f"SELECT * FROM documents {where}ORDER BY doc_id"
            ).fetchall()
        return [dict(r) for r in rows]

    def delete_documents(self, doc_ids: Sequence[int]) -> None:
        """Soft-delete: rows stay (positional doc_id alignment with the
        device indexes must survive reloads) but leave listings."""
        with self._lock:
            self._conn.executemany(
                "UPDATE documents SET deleted=1 WHERE doc_id=?",
                [(int(i),) for i in doc_ids],
            )
            self._conn.commit()

    def deleted_ids(self) -> List[int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT doc_id FROM documents WHERE deleted=1 ORDER BY doc_id"
            ).fetchall()
        return [r["doc_id"] for r in rows]

    def get_contents(self) -> Tuple[List[int], List[str]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT doc_id, content FROM documents ORDER BY doc_id"
            ).fetchall()
        return [r["doc_id"] for r in rows], [r["content"] for r in rows]

    def count_documents(self) -> int:
        with self._lock:
            return int(
                self._conn.execute("SELECT COUNT(*) c FROM documents").fetchone()["c"]
            )

    def mark_duplicate(self, doc_id: int, duplicate_of: int) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE documents SET is_duplicate_of=? WHERE doc_id=?",
                (duplicate_of, doc_id),
            )
            self._conn.commit()

    # -- metadata --------------------------------------------------------------

    def set_metadata(self, doc_id: int, metadata: Dict[str, Any]) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO doc_metadata (doc_id, meta_json) VALUES (?,?)",
                (doc_id, json.dumps(metadata)),
            )
            self._conn.commit()

    def get_metadata(self, doc_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT meta_json FROM doc_metadata WHERE doc_id=?", (doc_id,)
            ).fetchone()
        return json.loads(row["meta_json"]) if row else None

    def all_metadata(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute("SELECT doc_id, meta_json FROM doc_metadata")
            return {r["doc_id"]: json.loads(r["meta_json"]) for r in rows.fetchall()}

    # -- query history / feedback (reference core.py:20-109) -------------------

    def log_query(
        self,
        query: str,
        semantic_weight: float,
        lexical_weight: float,
        top_score: Optional[float] = None,
        n_results: int = 0,
        latency_ms: Optional[float] = None,
    ) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO query_history "
                "(query, semantic_weight, lexical_weight, top_score, n_results, "
                " latency_ms, ts) VALUES (?,?,?,?,?,?,?)",
                (query, semantic_weight, lexical_weight, top_score, n_results,
                 latency_ms, time.time()),
            )
            self._conn.commit()
            return int(cur.lastrowid)

    def log_feedback(self, query: str, doc_id: int, rating: int,
                     query_id: Optional[int] = None) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO feedback (query_id, query, doc_id, rating, ts) "
                "VALUES (?,?,?,?,?)",
                (query_id, query, doc_id, rating, time.time()),
            )
            self._conn.commit()
            return int(cur.lastrowid)

    def get_query_by_id(self, query_id: int) -> Optional[Dict[str, Any]]:
        """Look up one query_history row by its id (the reference's
        /feedback takes a query_id from the search response,
        reference api.py:48-53, 304-320)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT query_id, query, semantic_weight, lexical_weight "
                "FROM query_history WHERE query_id = ?", (int(query_id),)
            ).fetchone()
        return dict(row) if row is not None else None

    def optimal_weights(self, min_samples: int = 10) -> Optional[Tuple[float, float]]:
        """Average weights over positively-rated queries once >= min_samples
        exist (reference core.py:55-78 requires >= 10 positive rows)."""
        with self._lock:
            row = self._conn.execute(
                """
                SELECT AVG(qh.semantic_weight) sw, AVG(qh.lexical_weight) lw,
                       COUNT(*) c
                FROM feedback f JOIN query_history qh ON f.query = qh.query
                WHERE f.rating > 0
                """
            ).fetchone()
        if row is None or row["c"] is None or row["c"] < min_samples:
            return None
        return float(row["sw"]), float(row["lw"])

    def query_stats(self) -> Dict[str, Any]:
        """Aggregate stats (reference core.py:80-109, api.py:323-338)."""
        with self._lock:
            qh = self._conn.execute(
                "SELECT COUNT(*) c, COUNT(DISTINCT query) u, "
                "AVG(semantic_weight) avg_sw FROM query_history"
            ).fetchone()
            fb = self._conn.execute(
                "SELECT COUNT(*) c, AVG(rating) avg_r, "
                "SUM(CASE WHEN rating > 0 THEN 1 ELSE 0 END) pos "
                "FROM feedback"
            ).fetchone()
            top = self._conn.execute(
                "SELECT query, COUNT(*) c FROM query_history "
                "GROUP BY query ORDER BY c DESC LIMIT 10"
            ).fetchall()
        return {
            "total_queries": int(qh["c"]),
            "unique_queries": int(qh["u"]),
            "avg_semantic_weight": (
                float(qh["avg_sw"]) if qh["avg_sw"] is not None else None),
            "total_feedback": int(fb["c"]),
            # our schema folds clicks into rating>0 (see
            # Searcher.record_feedback), so positives stand in for the
            # reference's clicked count
            "total_clicks": int(fb["pos"] or 0),
            "avg_relevance": float(fb["avg_r"]) if fb["avg_r"] is not None else None,
            "top_queries": [(r["query"], r["c"]) for r in top],
        }

    def feedback_test_set(self, min_rating: int = 1) -> List[Dict[str, Any]]:
        """Synthesize an evaluation test set from positive feedback
        (reference evaluation.py:269-297)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT query, doc_id FROM feedback WHERE rating >= ? "
                "ORDER BY query", (min_rating,),
            ).fetchall()
        by_query: Dict[str, List[int]] = {}
        for r in rows:
            by_query.setdefault(r["query"], []).append(int(r["doc_id"]))
        return [
            {"query": q, "relevant_doc_ids": sorted(set(ids))}
            for q, ids in by_query.items()
        ]

    # -- chunk registry (chunk row -> parent doc mapping, persisted so
    # chunked pipelines reload without re-chunking; the reference keeps this
    # only in memory, pipelines.py:125-144) -----------------------------------

    def save_chunk_map(self, parents: Sequence[str],
                       chunk_rows: Sequence[Tuple[int, int, int, int, int]]
                       ) -> None:
        """chunk_rows: (chunk_row, parent_doc_id, chunk_index, start, end)."""
        with self._lock:
            self._conn.execute("DELETE FROM chunks")
            self._conn.execute("DELETE FROM parents")
            self._conn.executemany(
                "INSERT INTO parents (parent_doc_id, content) VALUES (?,?)",
                list(enumerate(parents)),
            )
            self._conn.executemany(
                "INSERT INTO chunks (chunk_row, parent_doc_id, chunk_index, "
                "start_char, end_char) VALUES (?,?,?,?,?)",
                list(chunk_rows),
            )
            self._conn.commit()

    def load_chunk_map(self) -> Tuple[List[str], List[int]]:
        """Returns (parents ordered by id, chunk_row -> parent mapping)."""
        with self._lock:
            parents = [
                r["content"] for r in self._conn.execute(
                    "SELECT content FROM parents ORDER BY parent_doc_id"
                ).fetchall()
            ]
            mapping = [
                r["parent_doc_id"] for r in self._conn.execute(
                    "SELECT parent_doc_id FROM chunks ORDER BY chunk_row"
                ).fetchall()
            ]
        return parents, mapping

    # -- jobs -------------------------------------------------------------------

    def upsert_job(self, job: Dict[str, Any]) -> None:
        now = time.time()
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO jobs "
                "(job_id, job_type, state, progress, payload_json, result_json, "
                " error, retries, created_at, updated_at) "
                "VALUES (?,?,?,?,?,?,?,?,COALESCE((SELECT created_at FROM jobs "
                " WHERE job_id=?),?),?)",
                (
                    job["job_id"], job.get("job_type", ""), job["state"],
                    job.get("progress", 0.0),
                    json.dumps(job.get("payload")) if job.get("payload") else None,
                    json.dumps(job.get("result")) if job.get("result") else None,
                    job.get("error"), job.get("retries", 0),
                    job["job_id"], now, now,
                ),
            )
            self._conn.commit()

    def get_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM jobs WHERE job_id=?", (job_id,)
            ).fetchone()
        return dict(row) if row else None

    def list_jobs(self, limit: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM jobs ORDER BY created_at DESC LIMIT ?", (limit,)
            ).fetchall()
        return [dict(r) for r in rows]
