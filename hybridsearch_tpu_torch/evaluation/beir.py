"""BEIR-format dataset loading (the port of
``hybridsearch_tpu/evaluation/beir.py``).

BASELINE.json configs 2-4 reference BEIR SciFact / NFCorpus and MS MARCO
dev. Nothing is downloaded, so datasets must be present on disk; this
loader consumes the standard BEIR layout:

    <root>/corpus.jsonl   {"_id", "title", "text"}
    <root>/queries.jsonl  {"_id", "text"}
    <root>/qrels/<split>.tsv  query-id \t corpus-id \t score

and produces (docs, doc_key_to_row, test_set) ready for the Indexer and
SearchEvaluator. `evaluate_beir` wires it to a searcher end-to-end.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple


def load_beir(
    root: str, split: str = "test", max_docs: Optional[int] = None
) -> Tuple[List[str], Dict[str, int], List[dict]]:
    """Returns (doc texts in row order, corpus-id -> row, test_set where
    relevant_doc_ids are row numbers)."""
    docs: List[str] = []
    key_to_row: Dict[str, int] = {}
    with open(os.path.join(root, "corpus.jsonl"), encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if max_docs is not None and len(docs) >= max_docs:
                break
            key_to_row[str(rec["_id"])] = len(docs)
            title = rec.get("title") or ""
            docs.append((title + " " + rec.get("text", "")).strip())

    queries: Dict[str, str] = {}
    with open(os.path.join(root, "queries.jsonl"), encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            queries[str(rec["_id"])] = rec.get("text", "")

    qrels_path = os.path.join(root, "qrels", f"{split}.tsv")
    rels: Dict[str, List[int]] = {}
    with open(qrels_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            if i == 0 and parts and parts[0].lower() in ("query-id", "qid"):
                continue  # header
            if len(parts) < 3:
                continue
            qid, did, score = parts[0], parts[1], parts[2]
            try:
                if float(score) <= 0:
                    continue
            except ValueError:
                continue
            row = key_to_row.get(did)
            if row is not None and qid in queries:
                rels.setdefault(qid, []).append(row)

    test_set = [
        {"query": queries[qid], "relevant_doc_ids": sorted(set(rows))}
        for qid, rows in rels.items()
    ]
    return docs, key_to_row, test_set


def evaluate_beir(
    searcher,
    root: str,
    split: str = "test",
    k: int = 10,
    max_docs: Optional[int] = None,
    max_queries: Optional[int] = None,
    **search_kwargs,
) -> dict:
    """Index a BEIR dataset and evaluate the searcher on its qrels."""
    from hybridsearch_tpu_torch.evaluation.harness import SearchEvaluator

    docs, _keys, test_set = load_beir(root, split, max_docs=max_docs)
    searcher.indexer.index_documents(docs)
    if max_queries is not None:
        test_set = test_set[:max_queries]
    agg = SearchEvaluator(searcher, k=k).evaluate(test_set, **search_kwargs)
    agg.pop("per_query", None)
    agg["dataset"] = os.path.basename(os.path.abspath(root))
    agg["docs"] = len(docs)
    return agg
