"""The corpus generator, and the stream of query batches over a corpus.

A corpus comes from a configuration's ``corpus`` block; query batches from
a traffic mix's ``queries`` block, whose ``kind`` names the file that draws
one batch: ``queries/<kind>.py`` with ``draw(corpus, spec, rng, B)``
returning a ``QueryBatch`` (``harness/kinds.py`` finds it). Both are drawn
from the configuration's fixed seed; the run's seed orders the batches.

A corpus is a set of questions grouped into duplicate clusters (the shape
of BEIR Quora, where a query's relevant documents are the questions it
duplicates). Each cluster has a topic and an ordered core of content
words; a question of the cluster keeps each core word with probability
``keep`` (else draws another content word) and fills the rest of its
length with common words:

- lengths: ``min_words`` plus a negative binomial of dispersion
  ``length_dispersion``, so the mean is ``words_mean``, cut at
  ``max_words``;
- content words: Zipf(``content_zipf``) over ``content_vocab`` words, or,
  with probability ``topic_share``, uniform over the cluster topic's
  ``topic_words`` words; topics are Zipf(``topic_zipf``)-popular;
- common words: Zipf(``head_zipf``) over the ``head_words`` list (English
  question and function words, stopwords among them), a share
  ``head_share`` of a question's words on average, placed among the
  content words, which keep their core order;
- cluster sizes: drawn from ``cluster_sizes`` ({size: share}), so the mean
  is the number of relevant documents a query has;
- the documents are shuffled, so a cluster's questions do not sit side by
  side in the input order.

A query kind draws with ``lengths``, ``questions`` and ``texts_of`` as the
corpus does, or with its own code.

Every run serves the same work in another order: the corpus (in one input
order), the query pool (``pool_batches`` batches of the mix, each batch's
queries fixed) and the warm-up queries are drawn from the configuration's
own ``corpus.seed``; the run's seed shuffles the order in which the pool's
batches are served, never which queries share a batch. (A corpus drawn
from the run's seed, or only put in another input order by it, changed the
work from seed to seed far more than two runs of one seed differ: the
clustered layout's k-means follows the input order. Queries shuffled into
new batches by the seed moved ``exact_share`` too: a ladder's stop rules
act on a whole batch.)

Each draw comes from ``numpy.random.default_rng([seed, stream])`` with a
fixed stream a purpose.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, NamedTuple, Sequence

import numpy as np

from harness.textops import STOPWORDS

_STREAM_CORPUS = 1
_STREAM_WARMUP = 2
_STREAM_POOL = 3
_STREAM_QUERY_ORDER = 7
_CHUNK = 65536  # documents drawn at a time (bounds the draw's memory)
_CONSONANTS = "bcdfgklmnprstvz"
_VOWELS = "aeiou"


def content_vocabulary(n: int, forbidden: Sequence[str]) -> List[str]:
    """``n`` distinct pseudo-words of two, then three, consonant-vowel
    syllables, none of them in ``forbidden``; the same list for every
    seed."""
    syll = [c + v for c in _CONSONANTS for v in _VOWELS]
    bad = set(forbidden) | STOPWORDS
    out: List[str] = []
    for parts in range(2, 5):
        out.extend(w for w in map("".join, itertools.product(syll, repeat=parts))
                   if w not in bad)
        if len(out) >= n:
            return out[:n]
    raise ValueError(f"content_vocab {n} is more than the syllables make")


def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    c = np.cumsum(w)
    return c / c[-1]


def _draw(rng: np.random.Generator, cdf: np.ndarray, size) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, rng.random(size), side="right"),
                      len(cdf) - 1).astype(np.int64)


def lengths(rng: np.random.Generator, count: int, mean: float, lo: int, hi: int,
            dispersion: float) -> np.ndarray:
    """``lo`` plus a negative binomial of mean ``mean - lo``, cut at ``hi``."""
    m = mean - lo
    p = dispersion / (dispersion + m)
    return np.minimum(lo + rng.negative_binomial(dispersion, p, count), hi).astype(np.int64)


class Vocabulary(NamedTuple):
    words: np.ndarray  # [H + V] object: head words, then content words
    n_head: int
    head_cdf: np.ndarray
    content_cdf: np.ndarray
    word_chars: np.ndarray  # [H + V] int64 characters a word


def vocabulary(spec: Dict) -> Vocabulary:
    head = list(spec["head_words"])
    content = content_vocabulary(int(spec["content_vocab"]), head)
    words = np.array(head + content, dtype=object)
    return Vocabulary(words, len(head), _zipf_cdf(len(head), spec["head_zipf"]),
                      _zipf_cdf(len(content), spec["content_zipf"]),
                      np.array([len(w) for w in words], dtype=np.int64))


def texts_of(voc: Vocabulary, ids: np.ndarray, lens: np.ndarray) -> List[str]:
    """Row i's first ``lens[i]`` word ids of ``ids`` joined by spaces."""
    flat = ids[np.arange(ids.shape[1])[None, :] < lens[:, None]]
    if not len(flat):
        return [""] * len(lens)
    big = " ".join(voc.words[flat].tolist())
    step = voc.word_chars[flat] + 1
    word_start = np.cumsum(step) - step
    first = np.cumsum(lens) - lens
    starts = word_start[np.minimum(first, len(flat) - 1)]
    ends = np.append(starts[1:] - 1, len(big))
    return [big[s:e] if n else "" for s, e, n in
            zip(starts.tolist(), ends.tolist(), lens.tolist())]


def questions(rng: np.random.Generator, voc: Vocabulary, core: np.ndarray,
              lens: np.ndarray, head_share: float, keep: float) -> np.ndarray:
    """[count, max(lens)] word ids: per row the first n of its ``core``
    row (each kept with probability ``keep``, else another content word)
    in core order, with common words placed among them (-1 past the row's
    length)."""
    count = len(lens)
    width = int(lens.max()) if count else 1
    n_core = core.shape[1]
    n_content = np.clip(rng.binomial(lens, 1.0 - head_share), 1,
                        np.minimum(lens, n_core))
    col = np.arange(width)[None, :]
    is_content = col < n_content[:, None]
    is_head = (col < lens[:, None]) & ~is_content
    words = np.full((count, width), -1, dtype=np.int64)
    key = np.full((count, width), 2.0)
    ci = np.nonzero(is_content)
    picked = core[ci[0], ci[1]]
    swap = rng.random(len(picked)) >= keep
    picked[swap] = _draw(rng, voc.content_cdf, int(swap.sum()))
    words[ci] = voc.n_head + picked
    # content words keep their order; common words fall at random among them
    key[ci] = (ci[1] + 0.5) / n_content[ci[0]]
    hi = np.nonzero(is_head)
    words[hi] = _draw(rng, voc.head_cdf, len(hi[0]))
    key[hi] = rng.random(len(hi[0]))
    return np.take_along_axis(words, np.argsort(key, axis=1, kind="stable"), axis=1)


class Corpus(NamedTuple):
    texts: List[str]
    doc_cluster: np.ndarray  # [n_docs] cluster of each document
    cluster_size: np.ndarray  # [n_clusters] documents of each cluster
    cluster_topic: np.ndarray  # [n_clusters]
    core: np.ndarray  # [n_clusters, core_words] content ranks
    topic_vocab: np.ndarray  # [n_topics, topic_words] content ranks
    voc: Vocabulary
    seed: int  # the configuration's own seed, which drew it


def make_corpus(spec: Dict) -> Corpus:
    """The corpus of a configuration's ``corpus`` block."""
    rng = np.random.default_rng([spec["seed"], _STREAM_CORPUS])
    voc = vocabulary(spec)
    n_docs = int(spec["n_docs"])
    sizes = np.array([int(k) for k in spec["cluster_sizes"]], dtype=np.int64)
    shares = np.array(list(spec["cluster_sizes"].values()), dtype=np.float64)
    shares /= shares.sum()
    mean_size = float((sizes * shares).sum())
    cs = rng.choice(sizes, size=int(n_docs / mean_size * 1.05) + 16, p=shares)
    cut = int(np.searchsorted(np.cumsum(cs), n_docs))
    cs = cs[:cut + 1].copy()
    cs[-1] -= int(cs.sum()) - n_docs  # the last cluster ends at n_docs
    n_clusters = len(cs)
    V = len(voc.content_cdf)
    n_topics = int(spec["n_topics"])
    topic_vocab = rng.integers(0, V, (n_topics, int(spec["topic_words"])))
    topic = _draw(rng, _zipf_cdf(n_topics, spec["topic_zipf"]), n_clusters)
    k_core = int(spec["core_words"])
    from_topic = rng.random((n_clusters, k_core)) < spec["topic_share"]
    core = np.where(
        from_topic,
        topic_vocab[topic[:, None], rng.integers(0, topic_vocab.shape[1],
                                                 (n_clusters, k_core))],
        _draw(rng, voc.content_cdf, (n_clusters, k_core)))
    doc_cluster = np.repeat(np.arange(n_clusters), cs)
    lens = lengths(rng, n_docs, spec["words_mean"], spec["min_words"],
                   spec["max_words"], spec["length_dispersion"])
    texts: List[str] = []
    for lo in range(0, n_docs, _CHUNK):
        hi = min(lo + _CHUNK, n_docs)
        ids = questions(rng, voc, core[doc_cluster[lo:hi]], lens[lo:hi],
                        spec["head_share"], spec["keep"])
        texts.extend(texts_of(voc, ids, lens[lo:hi]))
    order = rng.permutation(n_docs)
    return Corpus([texts[i] for i in order.tolist()], doc_cluster[order], cs, topic,
                  core, topic_vocab, voc, int(spec["seed"]))


class QueryBatch(NamedTuple):
    texts: List[str]
    cluster: np.ndarray  # [B] cluster each query was drawn from (its relevant documents)


class QueryStream:
    """Batches of a traffic mix's queries over one corpus: ``warmup()``
    draws from its own stream; ``batch(i)`` is the window's i-th batch, one
    of the pool's ``pool_batches`` fixed batches, served in the order the
    run's seed shuffles them (shuffled again each time the pool runs out).
    ``draw`` is the query kind's (``queries/<kind>.py``), one batch."""

    def __init__(self, corpus: Corpus, spec: Dict, batch: int, seed: int,
                 pool_batches: int, draw: Callable[..., QueryBatch]):
        self.corpus, self.spec, self.size = corpus, spec, batch
        self._kind_draw = draw
        self._warm = np.random.default_rng([corpus.seed, _STREAM_WARMUP])
        pool_rng = np.random.default_rng([corpus.seed, _STREAM_POOL])
        self._pool = [self._draw(pool_rng, batch) for _ in range(pool_batches)]
        self._order_rng = np.random.default_rng([seed, _STREAM_QUERY_ORDER])
        self._order = np.zeros(0, dtype=np.int64)

    def warmup(self) -> QueryBatch:
        return self._draw(self._warm, self.size)

    def batch(self, i: int) -> QueryBatch:
        while len(self._order) <= i:
            self._order = np.concatenate(
                [self._order, self._order_rng.permutation(len(self._pool))])
        return self._pool[int(self._order[i])]

    def _draw(self, rng: np.random.Generator, B: int) -> QueryBatch:
        return self._kind_draw(self.corpus, self.spec, rng, B)
