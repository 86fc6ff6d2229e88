"""The index lifecycle of the port against the JAX package, on the CPU:
BM25's delta segment (mirroring ``tests/test_bm25_delta.py``), tombstones,
``DenseIndex`` add / compact / save / load, the ``Indexer``'s
``add_documents``, ``delete_documents``, ``reload``, ``save`` / ``load``
and ``export_json`` / ``import_json`` (mirroring the lifecycle cases of
``tests/test_index_searcher.py``), files of each package read by the other,
and ``search_batch`` after adds on the regime-1 path and both at-scale
ladders, the scatter and fuzzy modes and the feedback API.

BM25 state is integer- or float64-derived and held equal exactly; a
pending delta too. Embeddings are float32 sums in another order (atol
1e-5); served results are held as in ``tests/test_torch_searcher.py``: ids
exact except inside near-ties within eps_num = 1e-4, values rtol 1e-4.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.evaluation import oracle
from hybridsearch_tpu.index.builder import Indexer as JIndexer
from hybridsearch_tpu.index.dense_index import DenseIndex as JDense
from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import supertile as jst
from hybridsearch_tpu.retrieval import searcher as jsm
from hybridsearch_tpu.text.extractor import HashVocabulary as JHashVocab
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.builder import Indexer
from hybridsearch_tpu_torch.index.dense_index import DenseIndex
from hybridsearch_tpu_torch.index.sparse_index import BM25
from hybridsearch_tpu_torch.ops import supertile as tst
from hybridsearch_tpu_torch.retrieval import searcher as tsm
from hybridsearch_tpu_torch.text.extractor import extract_tokens
from hybridsearch_tpu_torch.text.fuzzy import levenshtein, partial_ratio

CPU = torch.device("cpu")
EPS = 1e-4


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        gv, wv = np.array([v for v, _c, _i in g]), np.array([v for v, _c, _i in w])
        np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
        for j, (a, b) in enumerate(zip(g, w)):
            if a[2] != b[2]:  # a differing id only inside a near-tie
                assert (np.abs(wv - wv[j]) <= EPS).sum() > 1, (j, a, b)


def _bm25_state_equal(tb, jb):
    ts, js = tb._state, jb._state
    tv, jv = ts.vocab, js.vocab
    assert (list(tv.id_to_hash) if hasattr(tv, "id_to_hash") else tv.id_to_token) == (
        list(jv.id_to_hash) if hasattr(jv, "id_to_hash") else jv.id_to_token)
    assert ts.n_docs == js.n_docs
    for name in ("indptr", "doc_ids", "weights"):
        np.testing.assert_array_equal(getattr(ts.postings, name).numpy(),
                                      np.asarray(getattr(js.postings, name)))
    assert (ts.delta_seg is None) == (js.delta_seg is None)
    if ts.delta_seg is not None:
        for a, b in zip(ts.delta_seg.tf, js.delta_seg.tf):
            assert np.array_equal(a, b)
        np.testing.assert_array_equal(ts.delta_seg.postings.weights.numpy(),
                                      np.asarray(js.delta_seg.postings.weights))
    assert (ts.tf_cache is None) == (js.tf_cache is None)
    if ts.tf_cache is not None:
        for a, b in zip(ts.tf_cache, js.tf_cache):
            assert np.array_equal(a, b)
        np.testing.assert_array_equal(ts.frozen[0], js.frozen[0])
        assert ts.frozen[1:] == js.frozen[1:]


# -- BM25's delta segment (tests/test_bm25_delta.py) ---------------------------

def corpus(rng, n, length=12, vocab=200):
    words = [f"w{i}" for i in range(vocab)]
    return [" ".join(rng.choice(words, size=length)) for _ in range(n)]


def toks(texts):
    return [extract_tokens(t) for t in texts]


@pytest.fixture
def drng():
    return np.random.default_rng(7)


def _both(texts):
    return BM25(device=CPU).fit(texts), JBM25().fit(texts)


def test_add_lands_in_delta_segment(drng):
    tb, jb = _both(corpus(drng, 120))
    assert tb._state.delta_seg is None
    extra = toks(corpus(drng, 3))
    po = tb._state.postings
    tb.add_tokens(extra)
    jb.add_tokens(extra)
    assert tb._state.delta_seg is not None and tb._state.n_docs == 123
    assert tb._state.postings is po  # no weight recompute
    _bm25_state_equal(tb, jb)


def test_delta_docs_surface_in_search(drng):
    tb, jb = _both(corpus(drng, 120))
    for bm in (tb, jb):
        bm.add_tokens(toks(["zebra quagga okapi unique animals"]))
    assert tb._state.delta_seg is not None
    res = tb.search("zebra okapi", top_k=3)
    assert res and res[0][0] == 120
    assert res == jb.search("zebra okapi", top_k=3)


def test_delta_scores_match_compacted_ranking(drng):
    texts, extra = corpus(drng, 150), corpus(drng, 4)
    tb, jb = _both(texts)
    tb.add_tokens(toks(extra))
    jb.add_tokens(toks(extra))
    queries = [" ".join(t.split()[:3]) for t in extra]
    stale = tb.batch_scores(queries).numpy()
    np.testing.assert_array_equal(stale, jb.batch_scores(queries))
    exact = BM25(device=CPU).fit(texts + extra).batch_scores(queries).numpy()
    assert stale.shape == exact.shape
    assert (np.argmax(stale, 1) == np.argmax(exact, 1)).all()
    tb.compact()
    assert tb._state.delta_seg is None
    np.testing.assert_allclose(tb.batch_scores(queries).numpy(), exact,
                               rtol=1e-6, atol=1e-7)


def test_staleness_is_bounded_by_frozen_stats(drng):
    """A pre-compaction score is the score under the epoch's (df, avg_len,
    n_docs), the delta's own df for terms born in it."""
    from hybridsearch_tpu_torch.ops import bm25 as tops
    from hybridsearch_tpu_torch.text.extractor import Vocabulary

    texts, extra = corpus(drng, 150), corpus(drng, 5)
    tb, _ = _both(texts)
    tb.add_tokens(toks(extra))
    q = " ".join(extra[0].split()[:4])
    got = tb.batch_scores([q])[0].numpy()
    df_e, avg_e, _ = BM25(device=CPU).fit(texts)._state.frozen
    vocab = Vocabulary()
    t, d, c, lens = BM25._encode_coo(toks(texts + extra), vocab, 0)
    df_full = np.zeros(len(vocab), dtype=np.int64)
    df_full[:len(df_e)] = df_e
    np.add.at(df_full, t[(d >= 150) & (t >= len(df_e))], 1)
    w = tops.compute_eager_weights(t, d, c, lens, 150, len(vocab), df=df_full,
                                   avg_len=avg_e)
    qids = vocab.encode(extract_tokens(q))
    want = np.zeros(155)
    for tid, did, wt in zip(t, d, w):
        if tid in qids:
            want[did] += wt
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5, atol=1e-6)


def test_drift_threshold_triggers_full_recompute(drng):
    tb, jb = _both(corpus(drng, 100))
    extra = toks(corpus(drng, 65))  # 65 > DELTA_MIN_DOCS = 64 >= 1% of 100
    tb.add_tokens(extra)
    jb.add_tokens(extra)
    assert tb._state.delta_seg is None and tb._state.n_docs == 165
    _bm25_state_equal(tb, jb)
    assert tb.search("w0 w1", top_k=3) == jb.search("w0 w1", top_k=3)


def test_avg_len_drift_triggers_full_recompute(drng):
    tb, jb = _both(corpus(drng, 100, length=12))
    extra = toks(corpus(drng, 1, length=60))
    tb.add_tokens(extra)
    jb.add_tokens(extra)
    assert tb._state.delta_seg is None
    _bm25_state_equal(tb, jb)


def test_candidate_scores_cover_delta_docs(drng):
    tb, jb = _both(corpus(drng, 130))
    for bm in (tb, jb):
        bm.add_tokens(toks(["zebra quagga okapi wild"]))
    assert tb._state.delta_seg is not None
    cand = np.array([0, 130, -1])
    out = tb.candidate_scores("zebra okapi", cand)
    assert out.shape == (3,) and out[1] > 0.0 and out[2] == 0.0
    np.testing.assert_allclose(out[1], tb.score_all("zebra okapi")[130], rtol=1e-6)
    np.testing.assert_array_equal(out, jb.candidate_scores("zebra okapi", cand))


@pytest.mark.parametrize("builder", ["super_postings", "impact_postings"])
def test_at_scale_builders_compact_first(drng, builder):
    """A tier built while a delta is pending would drop the new docs'
    lexical scores: every at-scale builder and query encoder compacts on
    entry."""
    tb, _ = _both(corpus(drng, 130))
    tb.add_tokens(toks(corpus(drng, 2) + ["zebra only here"]))
    assert tb._state.delta_seg is not None
    built = getattr(tb, builder)()
    assert tb._state.delta_seg is None
    assert built.n_docs == 133
    tb.add_tokens(toks(["okapi only here"]))
    if builder == "impact_postings":
        imp, enc = tb.encode_queries_impact(["okapi"], p_depth=256)
        assert imp.n_docs == 134 and enc.full_postings[0] is tb.postings.doc_ids
    else:
        sp, _enc = tb.encode_queries_super(["okapi"])
        assert sp.n_docs == 134
    assert tb._state.delta_seg is None


def test_save_compacts_first(drng, tmp_path):
    tb, _ = _both(corpus(drng, 120))
    tb.add_tokens(toks(["unique zebra document"]))
    path = str(tmp_path / "bm25.npz")
    tb.save(path)
    for loaded in (BM25(device=CPU).load(path), JBM25().load(path)):
        assert loaded.n_docs == 121
        res = loaded.search("zebra", top_k=1)
        assert res and res[0][0] == 120


def test_new_terms_only_in_delta_score_correctly(drng):
    tb, jb = _both(corpus(drng, 120))
    for bm in (tb, jb):
        bm.add_tokens(toks(["xylophone quixotic jazz"]))
    full = tb.score_all("xylophone")
    assert full.shape == (121,)
    assert full[120] > 0.0 and (full[:120] == 0.0).all()
    np.testing.assert_array_equal(full, jb.score_all("xylophone"))


def test_repeated_small_adds_accumulate_then_compact(drng):
    tb, jb = _both(corpus(drng, 200))
    for _ in range(3):
        extra = toks(corpus(drng, 1))
        tb.add_tokens(extra)
        jb.add_tokens(extra)
    assert tb._state.delta_seg is not None
    assert len(tb._state.delta_seg.tf[3]) == 3 and tb._state.n_docs == 203
    _bm25_state_equal(tb, jb)
    tb.compact()
    jb.compact()
    _bm25_state_equal(tb, jb)
    extra = toks(corpus(drng, 1))
    tb.add_tokens(extra)
    jb.add_tokens(extra)
    assert tb._state.n_docs == 204
    _bm25_state_equal(tb, jb)


def test_add_cost_is_independent_of_corpus_size(drng):
    """The O(delta) contract, pinned structurally: a 1-doc add leaves the
    main postings and the tf cache as they were."""
    tb, _ = _both(corpus(drng, 300))
    po, tf = tb._state.postings, tb._state.tf_cache
    tb.add_tokens(toks(corpus(drng, 1)))
    assert tb._state.postings is po and tb._state.tf_cache is tf


# -- tombstones and the class API ----------------------------------------------

def test_bm25_delete_hides_docs_until_the_next_fit(demo_docs):
    tb, jb = BM25(device=CPU).fit(demo_docs), JBM25().fit(demo_docs)
    q = "machine learning data"
    top = tb.search(q, top_k=3)
    for bm in (tb, jb):
        bm.delete([top[0][0], top[0][0]])
    got = tb.search(q, top_k=3)
    assert top[0][0] not in [i for i, _s in got] and got == jb.search(q, top_k=3)
    tb.fit(demo_docs)
    assert tb.search(q, top_k=3) == top


def test_bm25_class_api_matches_oracle(demo_docs):
    bm = BM25(device=CPU).fit(demo_docs)
    orc = oracle.BM25Oracle().fit([extract_tokens(d) for d in demo_docs])
    q = "machine learning data"
    want = orc.score_all(extract_tokens(q))
    assert bm.score(q, 1) == pytest.approx(float(want[1]), rel=1e-4)
    np.testing.assert_allclose(bm.score_batch(q, [0, 1, 2]), want[:3], rtol=1e-4,
                               atol=1e-5)
    want_top = [int(i) for i in np.argsort(-want, kind="stable")[:3] if want[i] > 0]
    assert [h[0] for h in bm.search(q, top_k=3)] == want_top


@pytest.mark.parametrize("kind", ["tokens", "hashes"])
def test_bm25_files_cross_between_packages(demo_docs, tmp_path, kind):
    """Each package loads the other's ``.npz`` (a string vocabulary and a
    hash vocabulary) and scores equal to the writer."""
    tb = BM25(device=CPU)
    jb = JBM25()
    if kind == "tokens":
        tb.fit(demo_docs)
        jb.fit(demo_docs)
    else:
        tb.fit_hashes(demo_docs)
        jb.fit_coo_from_hashes(*__import__(
            "hybridsearch_tpu_torch.text.extractor", fromlist=["x"]).token_hashes_docs(
                demo_docs))
    queries = ["machine learning data", "cooking pasta", "neural networks"]
    tb.save(str(tmp_path / "t.npz"))
    jb.save(str(tmp_path / "j.npz"))
    from_port = JBM25().load(str(tmp_path / "t.npz"))
    from_jax = BM25(device=CPU).load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(np.asarray(from_port.batch_scores(queries)),
                                  tb.batch_scores(queries).numpy())
    np.testing.assert_array_equal(from_jax.batch_scores(queries).numpy(),
                                  np.asarray(jb.batch_scores(queries)))
    for q in queries:
        assert from_jax.search(q, 3) == jb.search(q, 3)
    assert type(from_jax.vocab).__name__ == type(tb.vocab).__name__


def test_super_postings_files_cross_between_packages(demo_docs, tmp_path):
    rng = np.random.default_rng(5)
    texts = [" ".join(rng.choice([f"t{i}" for i in range(60)], size=8))
             for _ in range(700)]
    tsp = BM25(device=CPU).fit(texts).super_postings(super_tiles=2)
    jsp = JBM25().fit(texts).super_postings(super_tiles=2)
    tst.save_super_postings(tsp, str(tmp_path / "t"))
    jst.save_super_postings(jsp, str(tmp_path / "j"))
    for got, want in ((tst.load_super_postings(str(tmp_path / "j"), device=CPU), jsp),
                      (jst.load_super_postings(str(tmp_path / "t")), tsp),
                      (tst.load_super_postings(str(tmp_path / "t"), device=CPU), tsp)):
        for name in ("sup_max", "sup_pos", "ids_rows", "ws_rows", "starts_host",
                     "df_host", "win_max_host"):
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)), name)
        assert (got.n_docs, got.n_super, got.super_tiles) == (
            want.n_docs, want.n_super, want.super_tiles)


# -- DenseIndex (tests/test_index_searcher.py) ---------------------------------

def test_dense_add_grows_like_jax(rng):
    vecs = rng.standard_normal((10, 32)).astype(np.float32)
    t = DenseIndex(dim=32, capacity_round=8, device=CPU).build(vecs)
    j = JDense(dim=32, capacity_round=8).build(vecs)
    for m in (3, 1, 20):  # within capacity, then a grow
        new = rng.standard_normal((m, 32)).astype(np.float32)
        assert t.add(new).tolist() == j.add(new).tolist()
        assert (t.n_docs, t.capacity) == (j.n_docs, j.capacity)
        # float32 normalization in another order: the last bit may differ
        np.testing.assert_allclose(t._snap.docs.numpy(), np.asarray(j._snap.docs),
                                   atol=1e-6)
        np.testing.assert_array_equal(t._snap.bias.numpy(), np.asarray(j._snap.bias))
    _vals, found = t.search(vecs[4:5], 1)
    assert found[0, 0] == 4
    assert t.add(np.zeros((0, 32), np.float32)).shape == (0,)


def test_dense_delete_compact_and_get_vectors_like_jax(rng):
    vecs = rng.standard_normal((20, 16)).astype(np.float32)
    t = DenseIndex(dim=16, device=CPU).build(vecs)
    j = JDense(dim=16).build(vecs)
    _, ids = t.search(vecs[3:4], 1)
    assert ids[0, 0] == 3
    for idx in (t, j):
        idx.delete([3, 9])
    _, ids2 = t.search(vecs[3:4], 1)
    assert ids2[0, 0] != 3
    np.testing.assert_allclose(t.get_vectors([0, 5, 19, 40]),
                               j.get_vectors([0, 5, 19, 40]), atol=1e-6)
    m = t.compact()
    np.testing.assert_array_equal(m, j.compact())
    assert m[3] == -1 and m[9] == -1 and t.n_docs == 18 and t.deleted_count == 0
    np.testing.assert_allclose(t._snap.docs.numpy(), np.asarray(j._snap.docs),
                               atol=1e-6)
    np.testing.assert_array_equal(t._snap.bias.numpy(), np.asarray(j._snap.bias))


def test_dense_files_cross_between_packages(rng, tmp_path):
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    t = DenseIndex(dim=16, device=CPU).build(vecs)
    j = JDense(dim=16).build(vecs)
    t.delete([7])
    j.delete([7])
    t.save(str(tmp_path / "t"))
    j.save(str(tmp_path / "j"))
    assert json.load(open(tmp_path / "t" / "manifest.json")) == json.load(
        open(tmp_path / "j" / "manifest.json"))
    for got, want in ((DenseIndex.load(str(tmp_path / "j"), device=CPU), j),
                      (JDense.load(str(tmp_path / "t")), t)):
        assert got.n_docs == 50 and got.deleted_count == 1
        np.testing.assert_array_equal(np.asarray(got._snap.docs),
                                      np.asarray(want._snap.docs))
        np.testing.assert_array_equal(np.asarray(got._snap.bias),
                                      np.asarray(want._snap.bias))
    own = DenseIndex.load(str(tmp_path / "t"), device=CPU)
    _, ids = own.search(vecs[11:12], 1)
    assert ids[0, 0] == 11


def test_padding_rows_never_displace_negative_scores(rng):
    d = 32
    base = rng.standard_normal(d).astype(np.float32)
    docs = np.stack([-base + 0.01 * rng.standard_normal(d) for _ in range(6)])
    idx = DenseIndex(dim=d, capacity_round=64, device=CPU).build(docs.astype(np.float32))
    idx.add(-base[None, :])  # an added row takes a padding slot
    assert idx.capacity > idx.n_docs
    vals, ids = idx.search(base[None, :], 7)
    assert set(ids[0].tolist()) == set(range(7)) and (vals[0] < 0).all()


# -- Indexer ------------------------------------------------------------------

def _texts(rng, n, topics=6, n_vocab=120):
    vocab = [f"w{i}" for i in range(n_vocab)]
    tops = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(topics)]
    return [f"{tops[i % topics]} The " + " ".join(rng.choice(vocab, size=8))
            for i in range(n)]


def _indexers(db=":memory:", jdb=":memory:", dim=64, layout="source"):
    jcfg, cfg = JConfig(), EngineConfig()
    jcfg.index.layout = cfg.index.layout = layout
    jenc = JEnc(dim=dim)
    jidx = JIndexer(db_path=jdb, encoder=jenc, config=jcfg)
    tidx = Indexer(db_path=db, encoder=convert.hashing_encoder(np.asarray(jenc.table),
                                                               device=CPU),
                   config=cfg, device=CPU)
    return tidx, jidx


def _assert_same_index(tidx, jidx):
    assert tidx.contents == jidx.contents and tidx.doc_ids == jidx.doc_ids
    ts, js = tidx.dense._snap, jidx.dense._snap
    assert (ts.n, ts.capacity) == (js.n, js.capacity)
    np.testing.assert_allclose(ts.docs.numpy(), np.asarray(js.docs), atol=1e-5)
    np.testing.assert_array_equal(ts.bias.numpy(), np.asarray(js.bias))
    # the true count (P5: the JAX package counts a repeated id twice)
    assert tidx.dense.deleted_count == int(np.isinf(ts.bias[:ts.n].numpy()).sum())
    _bm25_state_equal(tidx.bm25, jidx.bm25)
    assert tidx.bm25._tombstones == jidx.bm25._tombstones
    assert tidx.store.count_documents() == jidx.store.count_documents()
    assert tidx.store.deleted_ids() == jidx.store.deleted_ids()


def test_indexer_adds_and_deletes_match_jax(rng):
    texts = _texts(rng, 400)
    tidx, jidx = _indexers()
    for idx in (tidx, jidx):
        idx.index_documents(texts[:300])
    assert tidx.add_documents([]) == []
    for part, delta in ((texts[300:395], False), (texts[395:], True)):
        ids = tidx.add_documents(part)
        assert ids == jidx.add_documents(part)
        assert (tidx.bm25._state.delta_seg is not None) == delta
        _assert_same_index(tidx, jidx)
    assert tidx.dense.n_docs == tidx.bm25.n_docs == tidx.store.count_documents() == 400
    for idx in (tidx, jidx):
        idx.delete_documents([3, 399, 3])
    _assert_same_index(tidx, jidx)
    assert 399 not in [i for i, _s in tidx.bm25.search(texts[399], top_k=5)]


def test_add_after_load_refits_like_jax(rng, tmp_path):
    """A loaded BM25 has no tf cache: the next add refits on every doc (a
    string vocabulary), in both packages."""
    texts = _texts(rng, 120)
    tidx, jidx = _indexers(db=str(tmp_path / "t.db"), jdb=str(tmp_path / "j.db"))
    for idx, d in ((tidx, "t"), (jidx, "j")):
        idx.index_documents(texts[:100])
        idx.save(str(tmp_path / d))
    t2 = Indexer.load(str(tmp_path / "t"), encoder=tidx.encoder, device=CPU)
    j2 = JIndexer.load(str(tmp_path / "j"), encoder=jidx.encoder)
    assert t2.bm25._state.tf_cache is None
    t2.add_documents(texts[100:])
    j2.add_documents(texts[100:])
    _assert_same_index(t2, j2)


def test_indexer_save_load_no_reembed(rng, tmp_path):
    texts = _texts(rng, 60)
    db = str(tmp_path / "docs.db")
    tidx, _ = _indexers(db=db)
    tidx.index_documents(texts)
    tidx.add_documents(["an added zebra doc"])
    tidx.delete_documents([5])
    want = tidx.bm25.score_all("zebra z1t2")
    tidx.save(str(tmp_path / "engine"))
    tidx.close()

    class Boom:
        dim = 64
        name = "boom"

        def encode(self, texts, batch_size=64):
            raise AssertionError("load must not re-embed")

    t2 = Indexer.load(str(tmp_path / "engine"), encoder=Boom(), db_path=db, device=CPU)
    assert t2.dense.n_docs == len(t2.contents) == 61 and t2.dense.deleted_count == 1
    np.testing.assert_array_equal(t2.bm25.score_all("zebra z1t2"), want)
    assert t2.bm25._tombstones == {5}
    manifest = json.load(open(tmp_path / "engine" / "engine_manifest.json"))
    assert manifest["n_docs"] == 61 and manifest["db_path"] == db
    assert manifest["config"]["index"]["dim"] == 64


def test_indexer_reload_matches_jax(rng, tmp_path):
    texts = _texts(rng, 80)
    tidx, jidx = _indexers(db=str(tmp_path / "t.db"), jdb=str(tmp_path / "j.db"))
    for idx in (tidx, jidx):
        idx.index_documents(texts)
        idx.delete_documents([2, 40])
        idx.dense = type(idx.dense)(dim=64, **({"device": CPU}
                                               if idx is tidx else {}))
        assert idx.reload() == 80
    _assert_same_index(tidx, jidx)
    assert tidx.bm25._tombstones == {2, 40} and tidx.dense.deleted_count == 2


def test_export_import_json_matches_jax(rng, tmp_path):
    texts = _texts(rng, 30)
    tidx, jidx = _indexers()
    for idx, d in ((tidx, "t"), (jidx, "j")):
        idx.index_documents(texts[:25])
        idx.add_documents(texts[25:])
        idx.export_json(str(tmp_path / f"{d}.json"))
    t_dump, j_dump = (json.load(open(tmp_path / f"{d}.json")) for d in "tj")
    assert t_dump["documents"] == j_dump["documents"]
    assert t_dump["doc_ids"] == j_dump["doc_ids"]
    np.testing.assert_allclose(t_dump["vectors"], j_dump["vectors"], atol=1e-5)

    class Boom:
        dim = 64

        def encode(self, texts, batch_size=64):
            raise AssertionError("import must not re-embed")

    t2 = Indexer(encoder=Boom(), device=CPU)
    j2 = JIndexer(encoder=Boom())
    assert t2.import_json(str(tmp_path / "j.json")) == 30
    j2.import_json(str(tmp_path / "j.json"))
    _assert_same_index(t2, j2)


# -- search_batch after adds ---------------------------------------------------

def _serve_pair(layout, texts, adds):
    """A JAX and a port searcher over the same corpus, built by
    index_documents (the clustered build carried to the port with its tf
    cache, so both add in O(delta)), then grown by ``adds``."""
    jcfg = JConfig()
    jcfg.index.layout = layout
    js = jsm.Searcher(encoder=JEnc(dim=64), use_query_memory=False, config=jcfg)
    js.indexer.index_documents(texts)
    cfg = EngineConfig()
    cfg.index.layout = layout
    enc = convert.hashing_encoder(np.asarray(js.indexer.encoder.table), device=CPU)
    if layout == "source":
        ts = tsm.Searcher(encoder=enc, use_query_memory=False, config=cfg, device=CPU)
        ts.indexer.index_documents(texts)
    else:
        snap, st = js.indexer.dense._snap, js.indexer.bm25._state
        po = st.postings
        vocab = (np.asarray(st.vocab.id_to_hash, np.uint64)
                 if isinstance(st.vocab, JHashVocab) else st.vocab.id_to_token)
        cfg.index.dim = 64
        idx = convert.indexer(
            js.indexer.contents, enc,
            convert.dense_index(np.asarray(snap.docs), np.asarray(snap.bias), snap.n,
                                device=CPU),
            convert.bm25_index(vocab, np.asarray(po.indptr), np.asarray(po.doc_ids),
                               np.asarray(po.weights), po.n_docs, device=CPU,
                               tf_cache=st.tf_cache, frozen=st.frozen),
            config=cfg)
        ts = tsm.Searcher(indexer=idx, use_query_memory=False, config=cfg)
    for part in adds:
        js.indexer.add_documents(part)
        ts.indexer.add_documents(part)
    _bm25_state_equal(ts.indexer.bm25, js.indexer.bm25)
    return js, ts


def _lifecycle_corpus():
    rng = np.random.default_rng(21)
    vocab = [f"w{i}" for i in range(300)]
    topics = [[f"z{z}t{j}" for j in range(8)] for z in range(12)]
    texts = [" ".join(list(rng.choice(topics[i % 12], 4)) + list(rng.choice(vocab, 8)))
             for i in range(1400)]
    queries = ([" ".join(rng.choice(topics[z], 2)) for z in range(12)]
               + [f"{vocab[i]} {vocab[i + 9]}" for i in range(4)]
               + ["zebra okapi", "nothing matches"])
    # the first add trips the drift bound (a merge), the second stays under
    # it (a pending delta)
    adds = (texts[1000:1300], texts[1300:1320] + ["zebra okapi quagga"])
    return texts[:1000], adds, queries


@pytest.fixture(scope="module")
def source_pair():
    base, adds, queries = _lifecycle_corpus()
    js, ts = _serve_pair("source", base, adds)
    return js, ts, queries


@pytest.fixture(scope="module")
def clustered_pair():
    base, adds, queries = _lifecycle_corpus()
    js, ts = _serve_pair("clustered", base, adds)
    return js, ts, queries


def test_search_batch_after_adds_regime_one_matches_jax(source_pair):
    js, ts, queries = source_pair
    assert ts.indexer.bm25._state.delta_seg is not None
    got = ts.search_batch(queries, top_k=5, log=False)
    assert ts.indexer.bm25._state.delta_seg is None  # compacted on entry
    _same_results(got, js.search_batch(queries, top_k=5, log=False))
    assert got[queries.index("zebra okapi")][0][2] == 1320


@pytest.mark.parametrize("layout", ["source", "clustered"])
def test_search_batch_after_adds_at_scale_matches_jax(source_pair, clustered_pair,
                                                      monkeypatch, layout):
    """Both at-scale ladders (the impact ladder on the source layout, the
    supertile ladder on the clustered one) after adds, threshold lowered
    as in tests/test_torch_searcher.py."""
    js, ts, queries = source_pair if layout == "source" else clustered_pair
    monkeypatch.setattr(jsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    ladder = "impact_ladder" if layout == "source" else "supertile_ladder"
    calls = []
    real = getattr(tsm, ladder)
    monkeypatch.setattr(tsm, ladder, lambda *a, **k: calls.append(1) or real(*a, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = js.search_batch(queries, top_k=5, log=False)
        got = ts.search_batch(queries, top_k=5, log=False)
    assert calls
    _same_results(got, want)


@pytest.mark.parametrize("mode", ["scatter", "fuzzy"])
def test_scatter_and_fuzzy_modes_match_jax(source_pair, mode):
    js, ts, queries = source_pair
    kw = {"semantic_mode": "scatter"} if mode == "scatter" else {"lexical_mode": "fuzzy"}
    jm = jsm.Searcher(indexer=js.indexer, use_query_memory=False, config=js.config, **kw)
    tm = tsm.Searcher(indexer=ts.indexer, use_query_memory=False, config=ts.config, **kw)
    qs = queries if mode == "scatter" else ["z1t2 z1t5", "w7 w16", "zebra okpai"]
    for k in (3, 10):
        _same_results(tm.search_batch(qs, top_k=k, log=False),
                      jm.search_batch(qs, top_k=k, log=False))


def test_scatter_mode_at_scale_takes_dense_search(source_pair, monkeypatch):
    """Above the at-scale threshold the scatter mode still fuses two [B, n]
    arms: the top 2k of DenseIndex.search, and BM25's batch_scores."""
    js, ts, queries = source_pair
    monkeypatch.setattr(jsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    tm = tsm.Searcher(indexer=ts.indexer, use_query_memory=False, config=ts.config,
                      semantic_mode="scatter")
    jm = jsm.Searcher(indexer=js.indexer, use_query_memory=False, config=js.config,
                      semantic_mode="scatter")
    seen = []
    real = ts.indexer.dense.search
    monkeypatch.setattr(ts.indexer.dense, "search",
                        lambda q, k: seen.append(k) or real(q, k))
    monkeypatch.setattr(tsm, "impact_ladder", None)  # must not be reached
    _same_results(tm.search_batch(queries, top_k=4, log=False),
                  jm.search_batch(queries, top_k=4, log=False))
    assert seen == [8]


def test_fuzzy_helpers_match_the_jax_fallback():
    from hybridsearch_tpu.text import native as jnative

    pairs = [("machine lerning", "machine learning models learn"), ("", "abc"),
             ("abc", "abc"), ("kitten", "sitting"), ("zebra", "a zebr crossing"),
             ("café", "un café noir")]
    for a, b in pairs:
        assert levenshtein(a, b) == jnative.levenshtein(a, b)
        assert partial_ratio(a, b) == jnative.partial_ratio(a, b)


def test_fuzzy_mode_refuses_large_corpus(demo_docs, monkeypatch):
    s = tsm.Searcher(encoder=convert.hashing_encoder(np.asarray(JEnc(dim=64).table),
                                                     device=CPU),
                     lexical_mode="fuzzy", device=CPU)
    s.indexer.index_documents(demo_docs)
    res = s.search("machine lerning", top_k=3)  # a typo still matches
    assert any(r[2] == 1 for r in res)
    monkeypatch.setattr(tsm.Searcher, "FUZZY_MAX_DOCS", len(demo_docs) - 1)
    with pytest.raises(ValueError, match="fuzzy"):
        s.search("machine learning", top_k=3)


def test_deleted_docs_never_surface_after_adds(source_pair, monkeypatch):
    js, ts, queries = source_pair
    base, adds, _q = _lifecycle_corpus()
    js2, ts2 = _serve_pair("source", base, adds)
    first = ts2.search_batch(queries[:3], top_k=5, log=False)
    dead = sorted({i for row in first for _v, _c, i in row[:2]} | {1320})
    ts2.indexer.delete_documents(dead)
    js2.indexer.delete_documents(dead)
    for threshold in (10**9, 100):
        monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", threshold)
        monkeypatch.setattr(jsm, "SPARSE_HYBRID_MIN_DOCS", threshold)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = ts2.search_batch(queries, top_k=5, log=False)
            _same_results(got, js2.search_batch(queries, top_k=5, log=False))
        assert not {i for row in got for _v, _c, i in row} & set(dead)
    for q in queries:
        assert not {i for i, _s in ts2.indexer.bm25.search(q, top_k=10)} & set(dead)


def test_feedback_and_stats(demo_docs):
    s = tsm.Searcher(encoder=convert.hashing_encoder(np.asarray(JEnc(dim=64).table),
                                                     device=CPU), device=CPU)
    s.indexer.index_documents(demo_docs)
    s.search("machine learning", top_k=3)
    stats = s.get_stats()
    assert stats["total_queries"] >= 1 and stats["total_documents"] == 12
    assert "encode" in stats["stages"]
    assert s.query_memory.get_optimal_weights() is None
    for _ in range(10):
        s.search("machine learning", top_k=1, semantic_weight=0.6, lexical_weight=0.4)
        s.log_feedback("machine learning", 1, 1)
    sw, lw = s.query_memory.get_optimal_weights()
    assert 0.0 <= sw <= 1.0 and 0.0 <= lw <= 1.0
    qid = s.last_query_id
    s.record_feedback(qid, 3, clicked=True)
    rows = s.indexer.store.feedback_test_set(min_rating=1)
    assert rows
    with pytest.raises(KeyError):
        s.record_feedback(10**6, 1)
    quiet = tsm.Searcher(indexer=s.indexer, use_query_memory=False)
    quiet.log_feedback("q", 1, 1)
    quiet.record_feedback(1, 1)
    assert quiet.get_stats()["total_documents"] == 12


# -- each package serves the other's saved index -------------------------------

def test_indexes_saved_by_either_package_serve_equal(tmp_path):
    base, adds, queries = _lifecycle_corpus()
    rng = np.random.default_rng(3)
    dead = rng.choice(1000, 20, replace=False).tolist()
    results = {}
    for who in ("jax", "port"):
        tidx, jidx = _indexers(db=str(tmp_path / f"{who}_t.db"),
                               jdb=str(tmp_path / f"{who}_j.db"))
        idx = jidx if who == "jax" else tidx
        idx.index_documents(base)
        idx.add_documents(adds[1])
        idx.delete_documents(dead)
        idx.save(str(tmp_path / who))
        searcher = (jsm.Searcher(indexer=idx, use_query_memory=False, config=idx.config)
                    if who == "jax" else
                    tsm.Searcher(indexer=idx, use_query_memory=False, config=idx.config))
        results[who] = searcher.search_batch(queries, top_k=5, log=False)
        idx.close()
        enc = tidx.encoder if who == "jax" else jidx.encoder
        db = str(tmp_path / f"{who}_{'j' if who == 'jax' else 't'}.db")
        if who == "jax":  # the port serves the JAX package's directory
            other = Indexer.load(str(tmp_path / who), encoder=enc, db_path=db,
                                 device=CPU)
            s2 = tsm.Searcher(indexer=other, use_query_memory=False,
                              config=other.config)
        else:  # the JAX package serves the port's
            other = JIndexer.load(str(tmp_path / who), encoder=enc, db_path=db)
            s2 = jsm.Searcher(indexer=other, use_query_memory=False,
                              config=other.config)
        assert other.bm25._tombstones == set(dead)
        _same_results(s2.search_batch(queries, top_k=5, log=False), results[who])
    _same_results(results["port"], results["jax"])


# -- the R4 pin: non-ASCII terms reach their docs ------------------------------

@pytest.mark.parametrize("route", ["index_documents", "add_documents"])
def test_non_ascii_query_terms_reach_their_document(route):
    """The port tokenizes with extract_tokens on both sides (ROADMAP R4): a
    query's accented or CJK term finds its document, indexed in one build
    or added later."""
    rng = np.random.default_rng(9)
    filler = _texts(rng, 42)
    # docs of the corpus's length, so that the add stays a delta
    special = [filler.pop() + " café", filler.pop() + " 東京"]
    s = tsm.Searcher(encoder=convert.hashing_encoder(np.asarray(JEnc(dim=64).table),
                                                     device=CPU),
                     use_query_memory=False, device=CPU)
    if route == "index_documents":
        s.indexer.index_documents(filler + special)
    else:
        s.indexer.index_documents(filler)
        s.indexer.add_documents(special)
        assert s.indexer.bm25._state.delta_seg is not None
    got = s.search_batch(["café", "東京"], top_k=3, semantic_weight=0.0,
                         lexical_weight=1.0, log=False)
    assert got[0][0][2] == 40 and got[1][0][2] == 41
    assert s.indexer.bm25.search("café", top_k=1)[0][0] == 40


# -- convert carries a growing BM25 --------------------------------------------

@pytest.mark.parametrize("pending", [False, True])
def test_carried_bm25_adds_like_jax(drng, pending):
    """A JAX BM25 carried with its tf cache, frozen stats and pending delta
    adds as the JAX one does after the same add; without them the carried
    index is a loaded one and refuses to add."""
    jb = JBM25().fit(corpus(drng, 200))
    if pending:
        jb.add_tokens(toks(corpus(drng, 2)))
    st = jb._state
    po = st.postings
    seg = st.delta_seg
    tb = convert.bm25_index(
        st.vocab.id_to_token, np.asarray(po.indptr), np.asarray(po.doc_ids),
        np.asarray(po.weights), po.n_docs, device=CPU, tf_cache=st.tf_cache,
        frozen=st.frozen,
        delta_seg=None if seg is None else (seg.tf, np.asarray(seg.postings.indptr),
                                            np.asarray(seg.postings.doc_ids),
                                            np.asarray(seg.postings.weights)))
    _bm25_state_equal(tb, jb)
    q = ["w1 w2 w3", "w40"]
    np.testing.assert_array_equal(tb.batch_scores(q).numpy(), jb.batch_scores(q))
    for extra in (corpus(drng, 1), corpus(drng, 70)):
        tb.add_tokens(toks(extra))
        jb.add_tokens(toks(extra))
        _bm25_state_equal(tb, jb)
    bare = convert.bm25_index(st.vocab.id_to_token, np.asarray(po.indptr),
                              np.asarray(po.doc_ids), np.asarray(po.weights),
                              po.n_docs, device=CPU)
    with pytest.raises(ValueError):
        bare.add_tokens(toks(corpus(drng, 1)))
