"""The port's eight pipelines, the 100 -> 20 -> 5 funnel, the highlighter
and RAG / HyDE / agentic search against the JAX package's, on the CPU, on
the same inputs: the hashing encoder's table and a tiny random
cross-encoder's weights carried across (``convert.hashing_encoder``,
``convert.bert_state``), the same documents and queries (the mirror of
``tests/test_pipelines.py``).

Tolerances:

- fused and BM25 scores rtol 1e-4 / atol 1e-5 (float32 sums in another
  order); cross-encoder logits (float32 activations) atol 1e-4;
- ids exact, except where two slots' scores lie within eps_num = 1e-4 of
  each other (a near-tie the summation order may swap);
- host code (highlighting, RAG prompts, chunk maps, metadata): equal.

HybridBM25Pipeline's impact path (above ``HYBRID_BM25_SPARSE_MIN`` docs) is
reached on a small corpus by lowering the threshold on the port's module
only: its rows marked ``exact`` must then equal the JAX package's full
divide-by-max fusion.
"""

import sys
import types

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import hybridsearch_tpu_torch
from hybridsearch_tpu import pipelines as jpl
from hybridsearch_tpu.models.bert import BertConfig as JBertConfig
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.models.minilm import MiniLMCrossEncoder as JCE
from hybridsearch_tpu.retrieval import highlighter as jhl
from hybridsearch_tpu.retrieval import rag as jrag
from hybridsearch_tpu.retrieval.reranker import CrossEncoderReranker as JRR
from hybridsearch_tpu.retrieval.searcher import Searcher as JSearcher
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch import pipelines as tpl
from hybridsearch_tpu_torch.models.bert import BertConfig as TBertConfig
from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder as TCE
from hybridsearch_tpu_torch.retrieval import highlighter as thl
from hybridsearch_tpu_torch.retrieval import rag as trag
from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker as TRR
from hybridsearch_tpu_torch.retrieval.searcher import Searcher as TSearcher

CPU = torch.device("cpu")
EPS = 1e-4
CE_ATOL = 1e-4
QUERIES = ["machine learning", "cooking pasta with salt", "neural networks brains",
           "weather sunny breeze", "stock market quarter", "python data science",
           "what is machine learning", "zebra okapi"]
PIPELINES = ["basic", "chunked", "reranked", "bm25", "hybrid_bm25", "rag",
             "multi_stage", "diversity"]


def fake_llm(prompt):
    return ("The answer is machine learning.", 42)


def _same_rows(got, want, atol=1e-5):
    """Two result lists (score, content, id): scores within tolerance, ids
    equal outside near-ties, contents of equal ids equal."""
    assert len(got) == len(want)
    gv = np.array([v for v, _c, _i in got], np.float64)
    wv = np.array([v for v, _c, _i in want], np.float64)
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=atol)
    for j, ((_gv, gc, gi), (_wv, wc, wi)) in enumerate(zip(got, want)):
        if gi != wi:
            assert (np.abs(wv - wv[j]) <= EPS).sum() > 1, f"slot {j}: ids differ outside a tie"
        else:
            assert gc == wc


def _flat(params) -> dict:
    params = flax.core.meta.unbox(params)
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


@pytest.fixture(scope="module")
def encoders():
    jenc = JEnc(dim=128)
    return jenc, convert.hashing_encoder(np.asarray(jenc.table), device=CPU)


@pytest.fixture(scope="module")
def cross_encoders():
    """A tiny random cross-encoder in float32, its weights carried across."""
    spec = dict(vocab_size=2000, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128)
    jce = JCE(cfg=JBertConfig(dtype=jnp.float32, **spec), dim=64, max_seq_len=64)
    tce = TCE(cfg=TBertConfig(dtype=torch.float32, **spec), dim=64, max_seq_len=64,
              device=CPU)
    tce.model.load_state_dict(convert.bert_state(_flat(jce.params)), strict=True)
    return jce, tce


def _pair(name, encoders, cross_encoders=None, **kw):
    """The JAX pipeline and the port's, built alike."""
    jenc, tenc = encoders
    jkw, tkw = dict(kw, encoder=jenc), dict(kw, encoder=tenc, device=CPU)
    if name in ("reranked", "multi_stage"):
        jce, tce = cross_encoders
        jkw["reranker"], tkw["reranker"] = JRR(model=jce), TRR(model=tce)
    if name == "rag":
        jkw["llm_fn"] = tkw["llm_fn"] = fake_llm
    if name == "bm25":  # its config is changed in place: one each
        jkw["config"], tkw["config"] = jpl.EngineConfig(), tpl.EngineConfig()
    return jpl.create_pipeline(name, **jkw), tpl.create_pipeline(name, **tkw)


def _topic_corpus(n=1600, seed=0, n_bg=400):
    """Docs of 6 words of one of 40 topics and 10 background words; queries
    of topic words, topic and background words, and background words. With
    a small background (n_bg) its words hold more postings than the impact
    path's first rung slices."""
    rng = np.random.default_rng(seed)
    topics = [[f"z{z}t{j}" for j in range(10)] for z in range(40)]
    bg = [f"w{i}" for i in range(n_bg)]
    texts = [" ".join(list(rng.choice(topics[i % 40], 6)) + list(rng.choice(bg, 10)))
             for i in range(n)]
    queries = ([" ".join(rng.choice(topics[z], 2)) for z in range(0, 40, 3)]
               + [f"{rng.choice(topics[z])} {bg[z % n_bg]}" for z in range(1, 40, 5)]
               + [f"{bg[i]} {bg[i + 7]}" for i in range(4)] + ["nothing matches"])
    return texts, queries


# -- the factory and all eight pipelines -------------------------------------------


def test_factory_unknown_type_and_package_export():
    with pytest.raises(ValueError, match="unknown pipeline type"):
        tpl.create_pipeline("bogus")
    assert hybridsearch_tpu_torch.create_pipeline is tpl.create_pipeline
    assert tpl.HYBRID_BM25_SPARSE_MIN == jpl.HYBRID_BM25_SPARSE_MIN == 65536
    assert sorted(tpl._PIPELINES) == sorted(jpl._PIPELINES) == sorted(PIPELINES)


@pytest.mark.parametrize("name", PIPELINES)
def test_every_pipeline_matches_jax(name, encoders, cross_encoders, demo_docs):
    jp, tp = _pair(name, encoders, cross_encoders)
    assert type(tp).__name__ == type(jp).__name__ and tp.name == name
    jstats, tstats = jp.index(demo_docs), tp.index(demo_docs)
    assert {k: v for k, v in tstats.items() if k != "timings_s"} == \
        {k: v for k, v in jstats.items() if k != "timings_s"}
    atol = CE_ATOL if name in ("reranked", "multi_stage") else 1e-5
    for q in QUERIES:
        got, want = tp.search(q, top_k=3), jp.search(q, top_k=3)
        assert isinstance(got, tpl.PipelineResult) and got.query == q
        _same_rows(got.results, want.results, atol=atol)
        assert got.metadata == want.metadata
        assert got.answer == want.answer and got.highlighted is None
    assert tp.search("machine learning", top_k=3).results


def test_highlighted_pipeline_matches_jax(encoders, demo_docs):
    for style in ("markdown", "html", "terminal", "plain"):
        jp, tp = _pair("basic", encoders, highlight=True, highlight_style=style)
        jp.index(demo_docs)
        tp.index(demo_docs)
        for q in QUERIES[:4]:
            assert tp.search(q, top_k=3).highlighted == jp.search(q, top_k=3).highlighted


# -- BM25 -----------------------------------------------------------------------------


def test_bm25_pipeline_matches_bm25_search_and_embeds_nothing(encoders, demo_docs):
    _jp, tp = _pair("bm25", encoders, k1=1.2, b=0.5)
    calls = []
    enc = tp.indexer.encoder
    tp.indexer._encoder = types.SimpleNamespace(
        dim=enc.dim, encode=lambda texts: calls.append(texts) or enc.encode(texts))
    assert tp.index(demo_docs) == {"indexed": len(demo_docs)}
    assert not calls and tp.indexer.dense.n_docs == 0
    assert (tp.indexer.bm25.k1, tp.indexer.bm25.b) == (1.2, 0.5)
    for q in QUERIES:
        out = tp.search(q, top_k=3)
        want = tp.indexer.bm25.search(q, top_k=3)
        assert [(r[2], r[0]) for r in out.results] == [(i, s) for i, s in want]


# -- HybridBM25: both regimes ---------------------------------------------------------


def _plain_max_fusion(pipe, query, top_k):
    """Divide-by-max fusion over the alive docs, the impact path's contract
    (ids, values), computed in full from the port's own arms."""
    ix = pipe.indexer
    snap = ix.dense._snap
    n = snap.n
    q = ix.encoder.encode([query]).float()
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    sem = (q @ snap.docs[:n].T)[0]
    lex = ix.bm25.batch_scores([query])[0]
    alive = snap.bias[:n] == 0

    def norm(x):
        mx = x[alive].max()
        return x / mx if mx > 1e-12 else x

    fused = norm(sem) * pipe.semantic_weight + norm(lex) * pipe.bm25_weight
    fused = torch.where(alive, fused, float("-inf")).numpy()
    order = np.argsort(-fused, kind="stable")[:top_k]
    return [(float(fused[i]), ix.contents[int(i)], int(i)) for i in order]


def test_hybrid_bm25_at_scale_matches_jax_full_fusion(encoders, monkeypatch):
    texts, queries = _topic_corpus(n_bg=30)
    jp, tp = _pair("hybrid_bm25", encoders, semantic_weight=0.6, bm25_weight=0.4)
    jp.index(texts)
    tp.index(texts)
    monkeypatch.setattr(tpl, "HYBRID_BM25_SPARSE_MIN", 1000)
    from hybridsearch_tpu_torch.ops import hybrid as thyb

    calls = []
    real = thyb.hybrid_impact_topk
    monkeypatch.setattr(thyb, "hybrid_impact_topk",
                        lambda *a, **k: calls.append(k["p_depth"]) or real(*a, **k))
    n_exact, rungs = 0, []
    for q in queries:
        calls.clear()
        got, want = tp.search(q, top_k=5), jp.search(q, top_k=5)
        assert set(got.metadata) == {"pipeline", "exact"}
        # one rung, then the deeper one while the row can still certify
        assert calls in ([256], [256, 4096])
        rungs.append(len(calls))
        if got.metadata["exact"]:
            n_exact += 1
            _same_rows(got.results, want.results)
            _same_rows(got.results, _plain_max_fusion(tp, q, 5))
    assert n_exact >= len(queries) // 2
    assert 1 in rungs and 2 in rungs


def test_hybrid_bm25_at_scale_with_tombstones_uses_alive_maxima(encoders, monkeypatch):
    texts, queries = _topic_corpus(seed=1)
    _jp, tp = _pair("hybrid_bm25", encoders)
    tp.index(texts)
    monkeypatch.setattr(tpl, "HYBRID_BM25_SPARSE_MIN", 1000)
    first = [tp.search(q, top_k=3).results for q in queries[:6]]
    dead = sorted({i for row in first for _v, _c, i in row[:1]})
    tp.indexer.delete_documents(dead)
    for q in queries:
        got = tp.search(q, top_k=5)
        assert not {i for _v, _c, i in got.results} & set(dead)
        if got.metadata["exact"]:
            _same_rows(got.results, _plain_max_fusion(tp, q, 5))


def test_hybrid_bm25_without_an_impact_tier_takes_the_full_path(encoders, monkeypatch):
    texts, queries = _topic_corpus(n=1200, seed=2)
    jp, tp = _pair("hybrid_bm25", encoders)
    jp.index(texts)
    tp.index(texts)
    monkeypatch.setattr(tpl, "HYBRID_BM25_SPARSE_MIN", 1000)
    monkeypatch.setattr(tp.indexer.bm25, "encode_queries_impact",
                        lambda *a, **k: (None, None))
    for q in queries:
        got, want = tp.search(q, top_k=5), jp.search(q, top_k=5)
        assert got.metadata == want.metadata == {"pipeline": "hybrid_bm25"}
        _same_rows(got.results, want.results)


def test_hybrid_bm25_keeps_max_normalization(encoders, demo_docs):
    _jp, tp = _pair("hybrid_bm25", encoders, semantic_weight=0.6, bm25_weight=0.4)
    tp.index(demo_docs)
    out = tp.search("machine learning", top_k=5)
    # max-normalized fusion keeps scores in [0, 1] for non-negative arms
    assert all(r[0] <= 1.0 + 1e-5 for r in out.results)
    assert out.results[0][2] in {1, 3, 6, 8, 10}


# -- the funnel ----------------------------------------------------------------------


def _funnel_pair(encoders, cross_encoders, docs, **kw):
    kw = {"stage1_k": 8, "stage2_k": 4, "final_k": 2, **kw}
    jp, tp = _pair("multi_stage", encoders, cross_encoders, **kw)
    jp.index(docs)
    tp.index(docs)
    return jp, tp


def test_funnel_batched_matches_single_and_jax(encoders, cross_encoders):
    texts, queries = _topic_corpus(n=600, seed=3)
    jp, tp = _funnel_pair(encoders, cross_encoders, texts, stage1_k=30, stage2_k=10,
                          final_k=5)
    batched = tp.search_batch(queries)
    j_batched = jp.search_batch(queries)
    for q, b, jb in zip(queries, batched, j_batched):
        single = tp.search(q)
        assert [r[2] for r in b.results] == [r[2] for r in single.results]
        np.testing.assert_allclose([r[0] for r in b.results],
                                   [r[0] for r in single.results], rtol=0, atol=1e-5)
        assert b.metadata["batched"] is True
        assert {"t_encode_s", "t_dense_s", "t_bm25_s", "t_ce_s", "ce_pairs",
                "ce_dispatches"} <= set(b.metadata)
        assert set(b.metadata) == set(jb.metadata)
        _same_rows(b.results, jb.results, atol=CE_ATOL)
        jsingle = jp.search(q)
        assert single.metadata == jsingle.metadata
        _same_rows(single.results, jsingle.results, atol=CE_ATOL)


def test_funnel_stages(encoders, cross_encoders, demo_docs):
    _jp, tp = _funnel_pair(encoders, cross_encoders, demo_docs)
    out = tp.search("machine learning")
    assert len(out.results) == 2
    assert out.metadata["stage1_k"] == 8 and out.metadata["stage2_k"] == 4
    assert set(out.metadata["stage2_ids"]) >= {r[2] for r in out.results}
    # stage 2 ranks stage 1's candidates by BM25.candidate_scores
    vals, idxs = tp.indexer.dense.search(tp.indexer.encoder.encode(["machine learning"]), 8)
    cand = idxs[0]
    scores = tp.indexer.bm25.candidate_scores("machine learning", cand)
    assert out.metadata["stage2_ids"] == cand[np.argsort(-scores, kind="stable")[:4]].tolist()
    # stage 3 sorts them by the cross-encoder
    ce = tp.reranker.model.predict([("machine learning", tp.indexer.contents[i])
                                    for i in out.metadata["stage2_ids"]]).numpy()
    assert [r[0] for r in out.results] == sorted(ce.tolist(), reverse=True)[:2]


def test_funnel_drops_padding_and_tombstoned_hits(encoders, cross_encoders, demo_docs):
    jp, tp = _funnel_pair(encoders, cross_encoders, demo_docs, stage1_k=100,
                          stage2_k=20, final_k=20)
    dead = [1, 3, 8]
    tp.indexer.delete_documents(dead)
    jp.indexer.delete_documents(dead)
    for q in QUERIES:
        single = tp.search(q)
        assert not set(single.metadata["stage2_ids"]) & set(dead)
        assert single.metadata["stage2_k"] == len(demo_docs) - len(dead)
        assert single.metadata == jp.search(q).metadata
        batched = tp.search_batch([q])[0]
        assert not {r[2] for r in batched.results} & set(dead)
        assert sorted(r[2] for r in batched.results) == sorted(r[2] for r in single.results)


def test_funnel_batch_scores_a_pending_delta(encoders, cross_encoders):
    """With a BM25 delta pending, the batched funnel scores stage 2 as
    ``BM25.candidate_scores`` does (main + delta postings), so it equals the
    per-query funnel. (The JAX batched funnel scores the main postings only,
    so delta docs drop out of its stage 2: a reference fault the port does
    not copy.)"""
    texts, _q = _topic_corpus(n=800, seed=4)
    _jp, tp = _funnel_pair(encoders, cross_encoders, texts, stage1_k=30, stage2_k=10,
                           final_k=5)
    tp.indexer.add_documents(["z0t1 z0t2 newterm w1", "z3t4 newterm z3t5 w2"])
    assert tp.indexer.bm25._state.delta_seg is not None
    queries = ["z0t1 z0t2 newterm", "z3t4 newterm", "z0t1 w1", "newterm"]
    for q, b in zip(queries, tp.search_batch(queries)):
        single = tp.search(q)
        assert [r[2] for r in b.results] == [r[2] for r in single.results]
    assert tp.indexer.bm25._state.delta_seg is not None  # the funnel compacts nothing


def test_funnel_on_an_empty_index(encoders, cross_encoders):
    _jp, tp = _pair("multi_stage", encoders, cross_encoders)
    assert tp.search("x").results == []
    rows, meta = tpl.run_funnel_batch(tp.indexer, tp.reranker, ["x", "y"])
    assert rows == [[], []] and meta == {"stage1_k": 0, "stage2_k": 0}


# -- diversity ------------------------------------------------------------------------

DIVERSE_DOCS = [
    "machine learning models learn from data",
    "machine learning models learn from training data",
    "machine learning systems learn patterns from data",
    "learning machines model data patterns",
    "gardens bloom with colorful spring flowers",
    "the stock market rallied this quarter",
    "neural networks power modern vision systems",
    "flowers and gardens in springtime bloom",
]


def test_diversity_batched_matches_single_and_jax(encoders):
    texts, queries = _topic_corpus(n=500, seed=5)
    for docs, qs in ((DIVERSE_DOCS, ["machine learning data", "spring flowers garden",
                                     "zebra"]), (texts, queries)):
        jp, tp = _pair("diversity", encoders, lambda_param=0.3, candidate_multiplier=2)
        jp.index(docs)
        tp.index(docs)
        batch = tp.search_batch(qs, top_k=3)
        j_batch = jp.search_batch(qs, top_k=3)
        for q, res, jres in zip(qs, batch, j_batch):
            single = tp.search(q, top_k=3)
            assert [r[2] for r in res.results] == [r[2] for r in single.results]
            assert res.metadata == jres.metadata and res.metadata["batched"] is True
            _same_rows(res.results, jres.results)
            _same_rows(single.results, jp.search(q, top_k=3).results)


def test_diversity_pipeline_diversifies(encoders):
    plain = tpl.create_pipeline("basic", encoder=encoders[1], device=CPU)
    plain.index(DIVERSE_DOCS[:6])
    div = tpl.create_pipeline("diversity", encoder=encoders[1], device=CPU,
                              lambda_param=0.3, candidate_multiplier=2)
    div.index(DIVERSE_DOCS[:6])
    p_ids = [r[2] for r in plain.search("machine learning data", top_k=3).results]
    d_ids = [r[2] for r in div.search("machine learning data", top_k=3).results]
    assert set(p_ids) <= {0, 1, 2, 3}  # plain returns only the near-duplicates
    assert d_ids[0] == p_ids[0]  # the first MMR pick is the most relevant
    assert d_ids != p_ids  # diversification changed the tail


def test_diversity_batch_short_rows(encoders):
    """Queries with <= top_k candidates skip MMR but still return."""
    jp, tp = _pair("diversity", encoders)
    for p in (jp, tp):
        p.index(["only one document here", "and a second one", "a third document"])
    got = tp.search_batch(["document", "second one", "zzz"], top_k=2)
    want = jp.search_batch(["document", "second one", "zzz"], top_k=2)
    for g, w in zip(got, want):
        _same_rows(g.results, w.results)
    single = tp.search_batch(["document"], top_k=5)
    assert len(single) == 1 and len(single[0].results) == 3


# -- chunked ----------------------------------------------------------------------------

CHUNK_DOCS = [
    "Python is great. Python has packages. Python powers data science. "
    "Many people write Python daily.",
    "Cooking pasta is easy. Boil water with salt. Add the pasta for ten "
    "minutes. Drain and serve with sauce.",
    "Gardens bloom in spring. Tulips need water. Flowers need sun. "
    "The garden is colorful in May.",
]


def test_chunked_pipeline_parent_mapping(encoders):
    jp, tp = _pair("chunked", encoders, chunker_kwargs={"max_chars": 60})
    stats = tp.index(CHUNK_DOCS)
    assert stats["chunks"] > stats["parents"] == 3
    assert {k: v for k, v in stats.items() if k != "timings_s"} == \
        {k: v for k, v in jp.index(CHUNK_DOCS).items() if k != "timings_s"}
    assert tp.chunk_to_parent == jp.chunk_to_parent
    out = tp.search("python data science", top_k=1)
    assert out.results[0][2] == 0 and out.results[0][1] == CHUNK_DOCS[0]
    for q in ("python data science", "pasta water", "garden flowers", "water"):
        got, want = tp.search(q, top_k=3), jp.search(q, top_k=3)
        ids = [r[2] for r in got.results]
        assert len(ids) == len(set(ids))  # parents deduped
        assert got.metadata == want.metadata == {"pipeline": "chunked",
                                                 "chunks_searched": 6}
        _same_rows(got.results, want.results)


def test_chunked_pipeline_return_chunks(encoders):
    docs = ["One sentence. Another sentence entirely about gardens."]
    _jp, tp = _pair("chunked", encoders, return_parent=False,
                    chunker_kwargs={"max_chars": 25})
    tp.index(docs)
    out = tp.search("gardens", top_k=1)
    assert "garden" in out.results[0][1].lower()


def test_chunked_pipeline_reload_restores_the_chunk_map(encoders, tmp_path):
    db = str(tmp_path / "chunks.db")
    _jp, tp = _pair("chunked", encoders, db_path=db, chunker_kwargs={"max_chars": 60})
    tp.index(CHUNK_DOCS)
    want = [tp.search(q, top_k=3).results for q in QUERIES]
    fresh = tpl.create_pipeline("chunked", encoder=encoders[1], device=CPU, db_path=db,
                                chunker_kwargs={"max_chars": 60})
    assert fresh.parents == [] and fresh.chunk_to_parent == []
    assert fresh.reload() == len(tp.chunk_to_parent)
    assert fresh.parents == tp.parents and fresh.chunk_to_parent == tp.chunk_to_parent
    for q, w in zip(QUERIES, want):
        _same_rows(fresh.search(q, top_k=3).results, w)
    tp.indexer.close()
    fresh.indexer.close()


# -- RAG, HyDE, agentic ----------------------------------------------------------------


def test_rag_pipeline_sources_are_the_searchers_rows(encoders, demo_docs):
    jp, tp = _pair("rag", encoders)
    jp.index(demo_docs)
    tp.index(demo_docs)
    for q in QUERIES:
        out = tp.search(q, top_k=3)
        assert out.answer == "The answer is machine learning."
        assert out.metadata == {"pipeline": "rag", "provider": "local", "tokens_used": 42}
        rows = tp.searcher.search(q, top_k=3)
        assert [(s, c[:200], i) for s, c, i in rows] == out.results
        assert all(len(r[1]) <= 200 for r in out.results)  # 200-char previews
        _same_rows(out.results, jp.search(q, top_k=3).results)


def test_build_context_and_prompt_match_jax():
    cases = [[(1.0, "x" * 3000, 0), (0.9, "y" * 3000, 1), (0.8, "z", 2)],
             [(0.5, f"doc {i} " * 40, i) for i in range(8)], []]
    for results in cases:
        ctx = trag.build_context(results)
        assert ctx == jrag.build_context(results) and len(ctx) <= 4100
    assert "[Document 1]" in trag.build_context(cases[0])
    assert trag.build_prompt("why?", "because") == jrag.build_prompt("why?", "because")


class _FakeResponse:
    def __init__(self, payload):
        self.payload = payload

    def raise_for_status(self):
        pass

    def json(self):
        return self.payload


def test_providers_parse_as_jax_without_the_network(monkeypatch):
    """A stand-in ``requests`` module answers each provider's POST; both
    packages send the same request and parse the same answer."""
    answers = {
        "https://api.openai.com/v1/chat/completions": {
            "choices": [{"message": {"content": "oa"}}], "usage": {"total_tokens": 7}},
        "https://api.anthropic.com/v1/messages": {
            "content": [{"text": "an"}], "usage": {"input_tokens": 3, "output_tokens": 4}},
        "http://localhost:11434/api/generate": {"response": "lo"},
    }
    sent = []

    def post(url, **kw):
        sent.append((url, kw))
        return _FakeResponse(answers[url])

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(post=post))
    monkeypatch.setenv("OPENAI_API_KEY", "k1")
    monkeypatch.setenv("ANTHROPIC_API_KEY", "k2")
    for provider, want in (("openai", ("oa", 7)), ("anthropic", ("an", 7)),
                           ("local", ("lo", None))):
        got = trag.provider_fn(provider)("hello")
        n = len(sent)
        assert got == jrag.provider_fn(provider)("hello") == want
        assert sent[n - 1] == sent[n]  # the port's request equals the JAX one's
    monkeypatch.delenv("OPENAI_API_KEY")
    with pytest.raises(RuntimeError, match="OPENAI_API_KEY"):
        trag.call_openai("x")
    with pytest.raises(ValueError):
        trag.provider_fn("bogus")


def _searchers(encoders, docs):
    jenc, tenc = encoders
    js = JSearcher(encoder=jenc)
    js.indexer.index_documents(docs)
    ts = TSearcher(encoder=tenc, device=CPU)
    ts.indexer.index_documents(docs)
    return js, ts


def test_hyde_searcher_matches_jax(encoders, demo_docs):
    js, ts = _searchers(encoders, demo_docs)
    llm = lambda p: ("neural networks learn patterns", 1)  # noqa: E731
    got = trag.HyDESearcher(ts, llm_fn=llm).search("what do brains inspire?", top_k=3)
    want = jrag.HyDESearcher(js, llm_fn=llm).search("what do brains inspire?", top_k=3)
    assert len(got) == 3 and {r[2] for r in got} & {1, 3, 8, 10}
    _same_rows(got, want)


def test_agentic_search_follows_directives_as_jax(encoders, demo_docs):
    js, ts = _searchers(encoders, demo_docs)
    outs = []
    for mod, s in ((trag, ts), (jrag, js)):
        calls = {"n": 0}

        def llm(prompt, calls=calls):
            calls["n"] += 1
            return ("SEARCH: neural networks", 1) if calls["n"] == 1 else ("DONE", 1)

        res = mod.AgenticSearcher(s, llm_fn=llm).search("ai stuff", top_k=4)
        assert calls["n"] == 2 and len(res) <= 4
        ids = [r[2] for r in res]
        assert len(ids) == len(set(ids))  # deduped
        outs.append(res)
    _same_rows(*outs)


def test_agentic_search_caps_iterations(encoders, demo_docs):
    _js, ts = _searchers(encoders, demo_docs)
    calls = {"n": 0}

    def llm(prompt):
        calls["n"] += 1
        return (f"SEARCH: query {calls['n']}", 1)

    trag.AgenticSearcher(ts, llm_fn=llm).search("x", top_k=2)
    assert calls["n"] == trag.MAX_AGENT_ITERS == 3


# -- highlighter -----------------------------------------------------------------------

HL_TEXTS = ["The learner is learning fast", "Machine Learning", "find me",
            ("padding words " * 20) + "the key term appears here" + (" trailing" * 20),
            "café au lait, résumé! Café.", "learning learning; LEARNING (learning)"]
HL_QUERIES = ["learning", "machine", "find", "key term", "café résumé", "", "the"]


@pytest.mark.parametrize("style", ["markdown", "html", "terminal", "plain"])
def test_highlighter_styles_match_jax(style):
    th, jh = thl.get_highlighter(style), jhl.get_highlighter(style)
    assert (th.open_tag, th.close_tag) == (jh.open_tag, jh.close_tag)
    for text in HL_TEXTS:
        for q in HL_QUERIES:
            assert th.highlight_text(text, q) == jh.highlight_text(text, q)
            for window, n in ((40, 3), (80, 1), (10, 5)):
                assert th.extract_snippets(text, q, window=window, max_snippets=n) == \
                    jh.extract_snippets(text, q, window=window, max_snippets=n)
            assert th.extract_snippets(text, q, highlight=False) == \
                jh.extract_snippets(text, q, highlight=False)
    rows = [(1.0, t, i) for i, t in enumerate(HL_TEXTS)]
    assert th.highlight_results(rows, "learning key") == jh.highlight_results(rows,
                                                                              "learning key")


def test_highlighter_rules():
    h = thl.MarkdownHighlighter()
    out = h.highlight_text("The learner is learning fast", "learning")
    assert "**learning**" in out and "**learner**" not in out  # word boundaries
    assert thl.HTMLHighlighter().highlight_text("Machine Learning", "machine") == \
        "<mark>Machine</mark> Learning"
    snips = h.extract_snippets(HL_TEXTS[3], "key term", window=40)
    assert "**key**" in snips[0] and snips[0].startswith("...")
    term = thl.TerminalHighlighter().highlight_text("find me", "find")
    assert "\033[1;33m" in term and "\033[0m" in term
    assert thl.Highlighter(open_tag="[", close_tag="]").highlight_text("a find", "find") \
        == "a [find]"
    with pytest.raises(ValueError):
        thl.get_highlighter("nope")
