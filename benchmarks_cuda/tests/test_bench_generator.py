"""The generator against BEIR Quora's published figures (Thakur et al.,
arXiv:2104.08663, Table 1): 11.44 words a document, 9.53 words a query,
1.6 relevant documents a query. Tolerances: 2% of each mean, from a draw of
65,536 documents and 20,480 queries (the sampling error of each mean is
under 0.5%)."""

import json
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]

N_DOCS = 65536
N_BATCHES = 80


def _query_draw(tr):
    """The draw of the traffic mix's query kind, from ``queries/``."""
    from harness import kinds

    return kinds.load(BENCH / "queries", tr["queries"]["kind"]).draw


@pytest.fixture(scope="module")
def drawn():
    from harness.corpus import QueryStream, make_corpus

    cfg = json.loads((BENCH / "configs" / "beir-quora.clustered.json").read_text())
    spec = dict(cfg["corpus"], n_docs=N_DOCS)
    corpus = make_corpus(spec)
    tr = json.loads((BENCH / "traffic" / "dup.json").read_text())
    stream = QueryStream(corpus, tr["queries"], 256, 2**31 + 5, N_BATCHES,
                         _query_draw(tr))
    return cfg, corpus, [stream.batch(i) for i in range(N_BATCHES)]


def test_corpus_means_match_beir_quora(drawn):
    cfg, corpus, _ = drawn
    pub = cfg["published"]
    words = np.array([len(t.split()) for t in corpus.texts])
    assert len(corpus.texts) == N_DOCS
    assert abs(words.mean() / pub["doc_words_mean"] - 1) < 0.02
    assert words.min() >= cfg["corpus"]["min_words"]
    assert words.max() <= cfg["corpus"]["max_words"]


def test_paraphrase_queries_match_beir_quora(drawn):
    cfg, corpus, batches = drawn
    pub = cfg["published"]
    words = np.array([len(t.split()) for b in batches for t in b.texts])
    assert abs(words.mean() / pub["query_words_mean"] - 1) < 0.02
    rel = corpus.cluster_size[np.concatenate([b.cluster for b in batches])]
    assert abs(rel.mean() / pub["relevant_docs_per_query"] - 1) < 0.02


def test_paraphrases_share_most_words_with_their_cluster(drawn):
    """The overlap coefficient (shared words over the shorter text's) of a
    query and its closest relevant document is over a half on average."""
    _cfg, corpus, batches = drawn
    members = {}
    for d, c in enumerate(corpus.doc_cluster.tolist()):
        members.setdefault(c, []).append(d)
    shared = []
    for b in batches[:4]:
        for text, c in zip(b.texts, b.cluster.tolist()):
            q = set(text.split())
            shared.append(max(len(q & set(corpus.texts[d].split()))
                              / min(len(q), len(set(corpus.texts[d].split())))
                              for d in members[c]))
    assert np.mean(shared) > 0.5


def test_every_seed_serves_the_same_batches_in_another_order():
    from harness.corpus import QueryStream, make_corpus

    cfg = json.loads((BENCH / "configs" / "beir-quora.clustered.json").read_text())
    spec = dict(cfg["corpus"], n_docs=3000)
    tr = json.loads((BENCH / "traffic" / "dup.json").read_text())
    seed = 2**33 + 1  # more than 32 bits
    a, b = make_corpus(spec), make_corpus(spec)
    assert a.texts == b.texts
    draw = _query_draw(tr)
    qa = QueryStream(a, tr["queries"], 64, seed, 4, draw)
    qb = QueryStream(b, tr["queries"], 64, seed, 4, draw)
    qc = QueryStream(a, tr["queries"], 64, seed + 1, 4, draw)
    qa.warmup()  # warm-up draws do not move the window's batches
    assert qa.batch(3).texts == qb.batch(3).texts
    pool = sorted(tuple(qa.batch(i).texts) for i in range(4))
    assert len(set(pool)) == 4
    # each batch keeps its queries whatever the seed; the seed orders them
    assert sorted(tuple(qc.batch(i).texts) for i in range(4)) == pool
    assert [qa.batch(i).texts for i in range(4)] != [qc.batch(i).texts for i in range(4)]
    # past the pool, the same batches again in a new order
    assert sorted(tuple(qa.batch(i).texts) for i in range(4, 8)) == pool
