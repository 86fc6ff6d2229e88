"""Deterministic synthetic BEIR-format dataset generator (a copy of
``hybridsearch_tpu/evaluation/synth_beir.py``).

Nothing is downloaded, so the real BEIR corpora (SciFact / NFCorpus /
MS MARCO dev — BASELINE.json configs 2-4) are not on disk. This module makes the quality harness a TESTED path anyway: it
writes a corpus with planted graded relevance in the exact BEIR disk
layout consumed by evaluation/beir.py (corpus.jsonl / queries.jsonl /
qrels/<split>.tsv), so the full chain

    disk -> load_beir -> Indexer -> Searcher -> SearchEvaluator

runs end-to-end and its metrics can be pinned (tests/test_evaluation.py).
The moment real datasets land on disk, the same chain runs on them with
zero code changes (evaluate_beir(root=...)).

Relevance model (mirrors what makes BEIR corpora non-trivial):
  - `n_topics` topics, each owning a vocabulary block;
  - relevant docs draw most tokens from their query's topic (grade 2 =
    strongly on-topic, grade 1 = partially on-topic), with qrels storing
    the grade;
  - distractor docs draw from OTHER topics plus a shared background
    vocabulary (including stopword-grade terms) so lexical scoring sees
    realistic df skew;
  - queries are short (3-6 tokens) topic-term samples, like real queries.

Everything derives from `seed`; two runs write byte-identical datasets.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def generate_synth_beir(
    root: str,
    n_docs: int = 2000,
    n_queries: int = 50,
    n_topics: int = 40,
    terms_per_topic: int = 30,
    bg_vocab: int = 500,
    doc_len: int = 40,
    split: str = "test",
    seed: int = 0,
) -> str:
    """Write a synthetic BEIR dataset under `root` and return `root`.

    Layout and field names match the official BEIR release format
    (corpus.jsonl: _id/title/text; queries.jsonl: _id/text;
    qrels/<split>.tsv: query-id \\t corpus-id \\t score with header).
    """
    rng = np.random.default_rng(seed)
    topic_terms = [
        [f"t{z}w{j}" for j in range(terms_per_topic)]
        for z in range(n_topics)
    ]
    bg_terms = [f"bg{j}" for j in range(bg_vocab)]
    # Zipf-ish background sampling: low ranks appear stopword-often
    bg_p = 1.0 / np.arange(1, bg_vocab + 1)
    bg_p /= bg_p.sum()

    os.makedirs(os.path.join(root, "qrels"), exist_ok=True)
    doc_topic = rng.integers(0, n_topics, n_docs)
    # per-doc on-topic fraction: some docs are strongly on-topic (grade-2
    # material), some only partially (grade-1), the rest background-heavy
    on_frac = rng.choice([0.7, 0.4, 0.1], size=n_docs, p=[0.25, 0.25, 0.5])
    with open(os.path.join(root, "corpus.jsonl"), "w", encoding="utf-8") as f:
        for i in range(n_docs):
            z = int(doc_topic[i])
            n_on = int(round(doc_len * float(on_frac[i])))
            toks = list(rng.choice(topic_terms[z], size=n_on)) + list(
                rng.choice(bg_terms, size=doc_len - n_on, p=bg_p)
            )
            rng.shuffle(toks)
            f.write(json.dumps({
                "_id": f"d{i}",
                "title": f"doc {i} topic {z}",
                "text": " ".join(toks),
            }) + "\n")

    q_topic = rng.integers(0, n_topics, n_queries)
    with open(os.path.join(root, "queries.jsonl"), "w", encoding="utf-8") as f:
        for qi in range(n_queries):
            z = int(q_topic[qi])
            k = int(rng.integers(3, 7))
            toks = rng.choice(topic_terms[z], size=k, replace=False)
            f.write(json.dumps({"_id": f"q{qi}",
                                "text": " ".join(toks)}) + "\n")

    with open(os.path.join(root, "qrels", f"{split}.tsv"), "w",
              encoding="utf-8") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for qi in range(n_queries):
            z = int(q_topic[qi])
            for i in np.flatnonzero(doc_topic == z):
                grade = 2 if on_frac[i] >= 0.7 else (
                    1 if on_frac[i] >= 0.4 else 0
                )
                if grade > 0:
                    f.write(f"q{qi}\td{i}\t{grade}\n")
    return root


def ensure_synth_beir(root: Optional[str] = None, **kwargs) -> str:
    """Generate once per interpreter/tmp lifetime; reuse if present."""
    root = root or "/tmp/hst_synth_beir"
    if not os.path.exists(os.path.join(root, "corpus.jsonl")):
        generate_synth_beir(root, **kwargs)
    return root
