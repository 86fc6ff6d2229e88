"""Query kind ``paraphrase``: another question of a uniformly drawn
cluster, of ``words_mean`` words (``min_words`` plus a negative binomial of
dispersion ``length_dispersion``, cut at ``max_words``), keeping each core
word with probability ``keep`` and a share ``head_share`` of common words;
the cluster's documents are its relevant ones (BEIR Quora's test queries)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from harness.corpus import Corpus, QueryBatch, lengths, questions, texts_of


def draw(corpus: Corpus, spec: Dict, rng: np.random.Generator, B: int) -> QueryBatch:
    cl = rng.integers(0, len(corpus.cluster_size), B)
    lens = lengths(rng, B, spec["words_mean"], spec["min_words"], spec["max_words"],
                   spec["length_dispersion"])
    ids = questions(rng, corpus.voc, corpus.core[cl], lens, spec["head_share"], spec["keep"])
    return QueryBatch(texts_of(corpus.voc, ids, lens), cl)
