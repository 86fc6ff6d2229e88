"""The port's evaluation package (hybridsearch_tpu_torch/evaluation/:
metrics, oracle, harness, beir, synth_beir, multilingual, ood_english)
against the JAX package's, on the CPU.

Every case of tests/test_evaluation.py, tests/test_metrics.py and
tests/test_multilingual.py runs through both packages: searchers built
alike (the hashing encoder's table carried across), the same test sets,
and the same metrics must come back (precision, recall, F1, MRR, NDCG and
the recall-parity Jaccards exactly; latencies are clock readings and are
not compared). The synthetic-BEIR generator writes byte-identical files,
``load_beir`` reads them back alike, and the chain reproduces the pinned
metrics. (The train-state checkpoint case of tests/test_evaluation.py is
the port's tests/test_torch_training.py.)
"""

import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from hybridsearch_tpu.evaluation import beir as jbeir
from hybridsearch_tpu.evaluation import harness as jharness
from hybridsearch_tpu.evaluation import metrics as jm
from hybridsearch_tpu.evaluation import multilingual as jml
from hybridsearch_tpu.evaluation import ood_english as jood
from hybridsearch_tpu.evaluation import oracle as joracle
from hybridsearch_tpu.evaluation import synth_beir as jsynth
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.retrieval.searcher import Searcher as JSearcher
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.evaluation import beir as tbeir
from hybridsearch_tpu_torch.evaluation import harness as tharness
from hybridsearch_tpu_torch.evaluation import metrics as tm
from hybridsearch_tpu_torch.evaluation import multilingual as tml
from hybridsearch_tpu_torch.evaluation import ood_english as tood
from hybridsearch_tpu_torch.evaluation import oracle as toracle
from hybridsearch_tpu_torch.evaluation import synth_beir as tsynth
from hybridsearch_tpu_torch.retrieval.searcher import Searcher as TSearcher

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENCY = {"latency_s", "p50_ms", "p95_ms", "p99_ms"}

TEST_SET = [
    {"query": "machine learning data", "relevant_doc_ids": [1, 3]},
    {"query": "cooking pasta salt", "relevant_doc_ids": [5]},
    {"query": "neural networks brains", "relevant_doc_ids": [8, 3]},
]

_ENC = {}


def searchers(dim: int = 128, **kw):
    """(the JAX searcher, the port's) with the same hashing encoder."""
    if dim not in _ENC:
        jenc = JEnc(dim=dim)
        _ENC[dim] = (jenc, convert.hashing_encoder(np.asarray(jenc.table), device=CPU))
    jenc, tenc = _ENC[dim]
    return JSearcher(encoder=jenc, **kw), TSearcher(encoder=tenc, device=CPU, **kw)


@pytest.fixture()
def pair(demo_docs):
    out = searchers()
    for s in out:
        s.indexer.index_documents(demo_docs)
    return out


def same_metrics(j, t):
    """Two metric dicts (or lists of them) equal outside clock readings."""
    if isinstance(j, dict):
        assert set(j) == set(t)
        for k in j:
            if k not in LATENCY:
                same_metrics(j[k], t[k])
    elif isinstance(j, list):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            same_metrics(a, b)
    elif isinstance(j, float):
        assert t == pytest.approx(j, rel=1e-6, abs=1e-9)
    else:
        assert j == t


# -- metrics and the oracle -------------------------------------------------------------


@pytest.mark.parametrize("m", [jm, tm], ids=["jax", "torch"])
def test_precision_recall_f1(m):
    retrieved, relevant = [1, 2, 3, 4, 5], [2, 5, 9]
    assert m.precision_at_k(retrieved, relevant, 5) == pytest.approx(2 / 5)
    assert m.recall_at_k(retrieved, relevant, 5) == pytest.approx(2 / 3)
    p, r = 2 / 5, 2 / 3
    assert m.f1_at_k(retrieved, relevant, 5) == pytest.approx(2 * p * r / (p + r))


@pytest.mark.parametrize("m", [jm, tm], ids=["jax", "torch"])
def test_mrr_ndcg_latency(m):
    assert m.mrr([9, 7, 3], [3]) == pytest.approx(1 / 3)
    assert m.mrr([3, 7], [3]) == 1.0 and m.mrr([1, 2], [5]) == 0.0
    assert m.ndcg_at_k([1, 2], [1, 2], 2) == pytest.approx(1.0)
    assert m.ndcg_at_k([9, 1], [1], 2) == pytest.approx(1 / math.log2(3))
    assert m.ndcg_at_k([1], [], 5) == 0.0
    assert m.latency_percentiles([0.001, 0.002, 0.003])["p50_ms"] == pytest.approx(2.0)
    assert m.latency_percentiles([]) == {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}


def test_metrics_equal_the_jax_metrics():
    rng = np.random.default_rng(0)
    for _ in range(50):
        retrieved = rng.permutation(30)[:10].tolist()
        relevant = rng.permutation(30)[:int(rng.integers(0, 6))].tolist()
        for k in (1, 5, 10):
            for name in ("precision_at_k", "recall_at_k", "f1_at_k", "ndcg_at_k"):
                assert getattr(tm, name)(retrieved, relevant, k) == getattr(jm, name)(
                    retrieved, relevant, k)
        assert tm.mrr(retrieved, relevant) == jm.mrr(retrieved, relevant)
    lat = rng.random(37).tolist()
    assert tm.latency_percentiles(lat) == jm.latency_percentiles(lat)


def test_oracle_equals_the_jax_oracle(demo_docs):
    """The port's copy of the fp64 oracle computes what the JAX one does."""
    from hybridsearch_tpu_torch.text.extractor import extract_tokens

    rng = np.random.default_rng(1)
    q, d = rng.normal(size=(3, 16)), rng.normal(size=(40, 16))
    np.testing.assert_array_equal(toracle.cosine_scores(q, d), joracle.cosine_scores(q, d))
    sem, lex = rng.random((3, 40)), rng.random((3, 40)) * 5
    np.testing.assert_array_equal(toracle.hybrid_fusion(sem, lex, 0.7, 0.3),
                                  joracle.hybrid_fusion(sem, lex, 0.7, 0.3))
    toks = [extract_tokens(x) for x in demo_docs]
    for variant in ("bm25", "bm25plus"):
        jb = joracle.BM25Oracle(variant=variant).fit(toks)
        tb = toracle.BM25Oracle(variant=variant).fit(toks)
        np.testing.assert_array_equal(tb.score_all(["machine", "learning"]),
                                      jb.score_all(["machine", "learning"]))
    assert toracle.recall_jaccard([1, 2, 3], [2, 3, 4]) == joracle.recall_jaccard(
        [1, 2, 3], [2, 3, 4])


# -- the harness ---------------------------------------------------------------------------


def test_evaluate_query_fields(pair):
    rows = [h.SearchEvaluator(s, k=5).evaluate_query("machine learning data", [1, 3])
            for h, s in zip((jharness, tharness), pair)]
    same_metrics(rows[0], rows[1])
    row = rows[1]
    assert 0.0 <= row["precision"] <= 1.0 and row["recall"] > 0.0 and row["mrr"] > 0.0
    assert row["latency_s"] > 0.0


def test_evaluate_aggregates(pair):
    aggs = [h.SearchEvaluator(s, k=5).evaluate(TEST_SET)
            for h, s in zip((jharness, tharness), pair)]
    same_metrics(aggs[0], aggs[1])
    agg = aggs[1]
    assert agg["queries"] == 3 and agg["recall"] > 0.5
    assert "p95_ms" in agg and agg["p50_ms"] > 0 and len(agg["per_query"]) == 3


def test_compare_configs(pair):
    configs = {"semantic": {"semantic_weight": 1.0, "lexical_weight": 0.0},
               "hybrid": {"semantic_weight": 0.7, "lexical_weight": 0.3}}
    outs = [h.SearchEvaluator(s, k=5).compare_configs(TEST_SET, configs)
            for h, s in zip((jharness, tharness), pair)]
    same_metrics(outs[0], outs[1])
    assert set(outs[1]) == {"semantic", "hybrid"}


def test_test_set_from_feedback(pair):
    sets = []
    for h, s in zip((jharness, tharness), pair):
        s.search("machine learning", top_k=2)
        s.log_feedback("machine learning", 1, 1)
        s.log_feedback("machine learning", 3, 1)
        sets.append(h.SearchEvaluator(s).create_test_set_from_feedback())
    assert sets[1] == sets[0] == [{"query": "machine learning",
                                   "relevant_doc_ids": [1, 3]}]


def test_recall_parity_vs_oracle(pair):
    queries = ["machine learning", "cooking pasta", "neural networks",
               "stock market", "web browsers javascript"]
    outs = [h.recall_parity(s, queries, k=5) for h, s in zip((jharness, tharness), pair)]
    same_metrics(outs[0], outs[1])
    assert outs[1]["mean_jaccard"] >= 0.99 and outs[1]["min_jaccard"] >= 0.9


def test_stage_timer_and_spans(pair):
    from hybridsearch_tpu_torch.utils.tracing import StageTimer

    pair[1].search("machine learning", top_k=3)
    stats = pair[1].get_stats()["stages"]
    assert "encode" in stats
    assert "hybrid_fused" in stats or {"semantic", "lexical", "fuse_topk"} <= set(stats)
    t = StageTimer(window=4)
    for i in range(10):
        t.record("x", 0.001 * (i + 1))
    assert t.stats()["x"]["count"] == 10 and t.stats()["x"]["p50_ms"] >= 7.0


def test_chunked_pipeline_persistence(tmp_path):
    from hybridsearch_tpu_torch.pipelines import ChunkedPipeline

    docs = ["First doc. It has sentences. Several of them actually.",
            "Second doc about entirely different gardens and flowers."]
    db = str(tmp_path / "chunks.db")
    enc = convert.hashing_encoder(np.asarray(JEnc(dim=64).table), device=CPU)
    p = ChunkedPipeline(encoder=enc, db_path=db, chunker_kwargs={"max_chars": 30},
                        device=CPU)
    p.index(docs)
    before = p.search("gardens flowers", top_k=1).results
    p2 = ChunkedPipeline(encoder=enc, db_path=db, chunker_kwargs={"max_chars": 30},
                         device=CPU)
    assert p2.reload() > 2 and p2.parents == docs
    assert p2.search("gardens flowers", top_k=1).results[0][2] == before[0][2] == 1


# -- BEIR -------------------------------------------------------------------------------------


def _tiny_beir(root):
    os.makedirs(root / "qrels")
    corpus = [{"_id": "d1", "title": "ML", "text": "machine learning models learn"},
              {"_id": "d2", "title": "", "text": "pasta needs boiling water"},
              {"_id": "d3", "title": "NN", "text": "neural networks have layers"}]
    with open(root / "corpus.jsonl", "w") as f:
        for r in corpus:
            f.write(json.dumps(r) + "\n")
    with open(root / "queries.jsonl", "w") as f:
        f.write(json.dumps({"_id": "q1", "text": "machine learning"}) + "\n")
        f.write(json.dumps({"_id": "q2", "text": "cooking pasta"}) + "\n")
    with open(root / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.write("q1\td1\t1\nq2\td2\t1\nq1\td3\t0\n")


def test_beir_loader_and_evaluate(tmp_path):
    root = tmp_path / "beir"
    _tiny_beir(root)
    docs, keys, test_set = tbeir.load_beir(str(root))
    assert (docs, keys, test_set) == jbeir.load_beir(str(root))
    assert len(docs) == 3 and keys["d2"] == 1
    assert {t["query"]: t["relevant_doc_ids"] for t in test_set} == {
        "machine learning": [0], "cooking pasta": [1]}
    aggs = [b.evaluate_beir(s, str(root), k=2) for b, s in zip(
        (jbeir, tbeir), searchers(64, use_query_memory=False))]
    same_metrics(aggs[0], aggs[1])
    assert aggs[1]["docs"] == 3 and aggs[1]["queries"] == 2 and aggs[1]["recall"] == 1.0


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return tsynth.generate_synth_beir(str(tmp_path_factory.mktemp("synth") / "beir"))


def _digest(root, name):
    with open(os.path.join(root, name), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_synth_beir_files_equal_the_jax_generator(synth_root, tmp_path):
    jroot = jsynth.generate_synth_beir(str(tmp_path / "jax"))
    for name in ("corpus.jsonl", "queries.jsonl", os.path.join("qrels", "test.tsv")):
        assert _digest(synth_root, name) == _digest(jroot, name), name
    assert _digest(tsynth.generate_synth_beir(str(tmp_path / "again")),
                   "corpus.jsonl") == _digest(synth_root, "corpus.jsonl")


def test_load_beir_on_synth_beir(synth_root):
    docs, keys, test_set = tbeir.load_beir(synth_root)
    assert (docs, keys, test_set) == jbeir.load_beir(synth_root)
    assert len(docs) == len(keys) and test_set
    assert all(0 <= i < len(docs) for t in test_set for i in t["relevant_doc_ids"])
    small = tbeir.load_beir(synth_root, max_docs=50)
    assert len(small[0]) == 50 and small == jbeir.load_beir(synth_root, max_docs=50)


def test_synth_beir_chain_matches_pinned_metrics(synth_root):
    with open(os.path.join(REPO, "benchmarks", "expected_synth_beir.json")) as f:
        pins = json.load(f)
    _j, s = searchers(128, use_query_memory=False)
    agg = tbeir.evaluate_beir(s, synth_root, k=pins["config"]["k"])
    for name, want in pins["metrics"].items():
        assert abs(float(agg[name]) - want) <= pins["tol"], (name, agg[name], want)


# -- multilingual -------------------------------------------------------------------------------


def test_tokenizer_scripts():
    from hybridsearch_tpu.text.extractor import extract_tokens as jx
    from hybridsearch_tpu_torch.text.extractor import extract_tokens as tx

    for text in ("aprendizaje automático de modelos", "机器学习模型",
                 "машинное обучение моделей", "The Quick brown-fox runs!"):
        assert tx(text) == jx(text)
    assert "automático" in tx("aprendizaje automático de modelos")
    assert "机器" in tx("机器学习模型") and "学习" in tx("机器学习模型")
    assert "обучение" in tx("машинное обучение моделей")
    assert tx("The Quick brown-fox runs!") == ["quick", "brown", "fox", "runs"]


def test_byte_trigram_encoder_all_scripts():
    from hybridsearch_tpu_torch.models.encoder import ByteTrigramEncoder

    enc = ByteTrigramEncoder(dim=64, device=CPU)
    texts = ["hello world", "机器学习", "обучение", "تدريب", "नेटवर्क"]
    vecs = enc.encode(texts).numpy()
    assert vecs.shape == (5, 64)
    norms = np.linalg.norm(vecs, axis=1)
    assert (norms > 0).all()
    np.testing.assert_allclose(enc.encode(["机器学习"]).numpy()[0], vecs[1], rtol=1e-5)
    assert abs(float(np.dot(vecs[0] / norms[0], vecs[1] / norms[1]))) < 0.9


def test_multilingual_retrieval_quality():
    """The eval with the fallback encoder's table carried across equals
    JAX's; the port's own table meets the same quality bars."""
    from hybridsearch_tpu.services.language import MultilingualEmbedder as JEmb
    from hybridsearch_tpu_torch.services.language import MultilingualEmbedder as TEmb

    jemb, temb = JEmb(), TEmb(device=CPU)
    temb.encoder.table = torch.from_numpy(np.array(jemb.encoder.table))
    same_metrics(jml.eval_retrieval(), tml.eval_retrieval(temb.encoder.encode))
    r = tml.eval_retrieval(device=CPU)
    assert r["p_at_1"] >= 0.9, r
    b = tml.eval_bm25(device=CPU)
    same_metrics(jml.eval_bm25(), b)
    assert b["p_at_1"] >= 0.8, b


def test_language_detection_sane():
    d = tml.eval_detection()
    assert d == jml.eval_detection() and d["accuracy"] >= 0.7, d


# -- the OOD-English eval -------------------------------------------------------------------------


def test_ood_english_corpus_and_evals():
    assert tood.corpus_and_queries() == jood.corpus_and_queries()
    assert tood.triples() == jood.triples()
    same_metrics(jood.eval_bm25(), tood.eval_bm25(device=CPU))
    jenc, tenc = searchers(128)[0].indexer.encoder, _ENC[128][1]
    same_metrics(jood.eval_retrieval(jenc.encode), tood.eval_retrieval(tenc.encode))

    def scorer(pairs):  # a tensor on the way out, as a cross-encoder's predict
        return torch.tensor([float(len(set(q.split()) & set(d.split()))) for q, d in pairs])

    got = tood.eval_cross_encoder(scorer)
    same_metrics(jood.eval_cross_encoder(lambda p: scorer(p).numpy()), got)
    assert 0.0 <= got["pairwise_acc"] <= 1.0 and got["n_triples"] > 0
