"""The port's text, encoder, BM25, supertile-build, k-means and Indexer
code against the JAX package's, on the CPU.

Text and BM25 state are integer- or float64-derived and must match
exactly; embeddings and centroids are float32 sums in another order
(atol 1e-5). Random draws that ``jax.random`` makes and a torch generator
cannot repeat (the encoder table, k-means seeds) are carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.index import builder as jbuilder
from hybridsearch_tpu.index.ivf import kmeans_assign as j_assign
from hybridsearch_tpu.index.ivf import kmeans_fit as j_fit
from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import bm25 as jbm25_ops
from hybridsearch_tpu.ops.supertile import build_super_postings as j_build_sp
from hybridsearch_tpu.ops.supertile import encode_super_queries as j_encode_sp
from hybridsearch_tpu.text import extractor as jx
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index import builder as tbuilder
from hybridsearch_tpu_torch.index.ivf import kmeans_assign, kmeans_fit
from hybridsearch_tpu_torch.index.sparse_index import BM25
from hybridsearch_tpu_torch.models.encoder import HashingEncoder
from hybridsearch_tpu_torch.ops import bm25 as tbm25_ops
from hybridsearch_tpu_torch.ops.supertile import (
    build_super_postings,
    encode_super_queries,
)
from hybridsearch_tpu_torch.text import extractor as tx

CPU = torch.device("cpu")


def _texts(rng, n, n_vocab=120, topics=6):
    vocab = [f"w{i}" for i in range(n_vocab)]
    tops = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(topics)]
    return [f"{tops[i % topics]} The " + " ".join(rng.choice(vocab, size=8))
            for i in range(n)]


def _jax_hashes(texts):
    """The JAX package's Python token hashing (no native library needed)."""
    toks = [jx.extract_tokens(t) for t in texts]
    h = np.array([jx.stable_token_hash(t) for ts in toks for t in ts], np.uint64)
    return h, np.array([len(ts) for ts in toks], np.int64)


def _triples(vocab_hashes, indptr, doc_ids, weights):
    """(hash, doc, weight) of every posting, sorted: vocab-order free."""
    indptr = np.asarray(indptr, np.int64)
    nnz = int(indptr[-1])
    h = np.repeat(np.asarray(vocab_hashes, np.uint64), np.diff(indptr))
    d = np.asarray(doc_ids)[:nnz].astype(np.int64)
    w = np.asarray(weights)[:nnz]
    order = np.lexsort((d, h))
    return h[order], d[order], w[order]


def _jax_vocab_hashes(vocab):
    if isinstance(vocab, jx.HashVocabulary):
        return np.asarray(vocab.id_to_hash, np.uint64)
    return np.array([jx.stable_token_hash(t) for t in vocab.id_to_token], np.uint64)


@pytest.mark.parametrize("text", [
    "Hello, the WORLD: foo_bar 12 and x-y", "", "   ", "The a an",
    "Ünïcödé café 中文分词 the test", "tab\tsep\nnew line"])
def test_text_matches_jax(text):
    assert tx.extract_tokens(text) == jx.extract_tokens(text)
    assert tx.preprocess_text(text) == jx.preprocess_text(text)
    assert tx.STOP_HASHES == jx.STOP_HASHES
    h, c = tx.token_hashes_docs([text, text.upper()])
    jh, jc = _jax_hashes([text, text.upper()])
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(c, jc)


def test_hashing_encoder_matches_jax_with_carried_table():
    rng = np.random.default_rng(0)
    texts = _texts(rng, 40) + ["", "the", "Ünïcödé café 中文", " ".join(
        f"w{i}" for i in range(400))]  # > max_tokens features
    je = JEnc(dim=64)
    te = convert.hashing_encoder(np.asarray(je.table), device=CPU)
    np.testing.assert_allclose(te.encode(texts).numpy(), je.encode(texts),
                               rtol=1e-5, atol=1e-6)
    # the port's own table: seeded, N(0, 1/dim), on the encoder's device
    own = HashingEncoder(dim=64, device=CPU)
    t = own.table
    assert t.shape == (1 << 15, 64) and abs(float(t.std()) - 0.125) < 0.01
    assert torch.equal(t, HashingEncoder(dim=64, device=CPU).table)


def test_bm25_fit_matches_jax():
    """Hash-vocab fit (the bulk path) and token-vocab fit, exactly."""
    rng = np.random.default_rng(1)
    texts = _texts(rng, 300)
    jb = JBM25().fit_coo_from_hashes(*_jax_hashes(texts))
    tb = BM25(device=CPU).fit_hashes(texts)
    assert tb.vocab.id_to_hash == jb.vocab.id_to_hash
    jpo, tpo = jb.postings, tb.postings
    np.testing.assert_array_equal(tpo.indptr.numpy(), np.asarray(jpo.indptr))
    np.testing.assert_array_equal(tpo.doc_ids.numpy(), np.asarray(jpo.doc_ids))
    np.testing.assert_array_equal(tpo.weights.numpy(), np.asarray(jpo.weights))
    assert tpo.max_postings == jpo.max_postings

    jt = JBM25().fit(texts)
    tt = BM25(device=CPU).fit(texts)
    assert tt.vocab.id_to_token == jt.vocab.id_to_token
    np.testing.assert_array_equal(tt.postings.weights.numpy(),
                                  np.asarray(jt.postings.weights))

    queries = ["z1t2 w3 w40", "w7", "nothing here", "z0t0 z0t1 z0t2 w1 w2"]
    jg = jb.encode_queries_bucketed(queries)
    tg = tb.encode_queries_bucketed(queries)
    want = jbm25_ops.bm25_scores_bucketed(jpo, jg, batch=len(queries))
    got = tbm25_ops.local_bucketed_scores(tpo.doc_ids, tpo.weights, tg,
                                          tpo.n_docs, len(queries))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1), (1, 2, 0), (2, 1, 0)])
def test_bm25_scores_runs_sums_terms_in_order_like_jax(order):
    """Doc 3 is in three runs with weights 1e8, 1 and -1e8, whose float32
    sum depends on the order it is taken in (0 or 1). The port adds the run
    columns in term order: equal bit for bit to the sequential sum in
    column order and to the JAX package's index-order add, whose CPU
    scatter adds in index order (checked here: every column order gives
    JAX the sequential sum too)."""
    doc_ids = np.array([3, 5, 3, 7, 1, 3] + [0] * 8, np.int32)
    weights = np.array([1e8, 2.0, 1.0, 3.0, 4.0, -1e8] + [0] * 8, np.float32)
    starts = np.array([[0, 2, 4], [4, 2, 0]], np.int32)[:, list(order)]
    lengths = np.full((2, 3), 2, np.int32)
    want = np.asarray(jbm25_ops._bm25_scores_runs(
        jnp.asarray(doc_ids), jnp.asarray(weights), jnp.asarray(starts),
        jnp.asarray(lengths), 8, 4))
    got = tbm25_ops.bm25_scores_runs(
        torch.from_numpy(doc_ids), torch.from_numpy(weights), torch.from_numpy(starts),
        torch.from_numpy(lengths), 8, 4).numpy()
    seq = np.zeros((2, 8), np.float32)
    for b in range(2):
        for t in range(3):
            for i in range(starts[b, t], starts[b, t] + lengths[b, t]):
                seq[b, doc_ids[i]] = np.float32(seq[b, doc_ids[i]] + weights[i])
    assert np.array_equal(got, seq) and np.array_equal(want, seq)
    assert set(seq[:, 3].tolist()) <= {0.0, 1.0}


def test_super_postings_and_query_encode_match_jax():
    rng = np.random.default_rng(2)
    V, N, nnz = 300, 4096, 20000
    t = np.sort(rng.integers(0, V, nnz))
    d = rng.integers(0, N, nnz)
    key = np.unique(t * N + d)  # a term's postings hold each doc once
    t, d = key // N, key % N
    w = rng.random(len(t)).astype(np.float32)
    jsp = j_build_sp(t, d, w, N, V, super_tiles=8)
    tsp = build_super_postings(t, d, w, N, V, CPU, super_tiles=8)
    for name in ("sup_max", "sup_pos", "ids_rows", "ws_rows"):
        np.testing.assert_array_equal(getattr(tsp, name).numpy(),
                                      np.asarray(getattr(jsp, name)))
    for name in ("starts_host", "df_host", "win_max_host", "n_super", "n_docs"):
        np.testing.assert_array_equal(getattr(tsp, name), getattr(jsp, name))

    lists = [list(rng.integers(0, V, int(rng.integers(0, 12)))) for _ in range(9)]
    for wcap in (None, 512):
        je, te = j_encode_sp(jsp, lists, wcap=wcap), encode_super_queries(
            tsp, lists, wcap=wcap)
        for name in ("term_ids", "starts", "lens"):
            np.testing.assert_array_equal(getattr(te, name).numpy(),
                                          np.asarray(getattr(je, name)))
        np.testing.assert_array_equal(te.complete, je.complete)
        np.testing.assert_array_equal(te.full_touched, je.full_touched)
        assert te.wcaps == je.wcaps and te.t_pad == je.t_pad


def _jax_kmeans_draws(n, k, seed=0, iters=10):
    """The initial-centroid and empty-cluster re-seed rows jax.random draws
    inside hybridsearch_tpu.index.ivf.kmeans_fit."""
    key = jax.random.PRNGKey(seed)
    init = np.array(jax.random.choice(key, n, (k,), replace=False))
    keys = jax.random.split(key, iters)
    reseed = np.stack([np.array(jax.random.randint(kk, (k,), 0, n))
                       for kk in keys])
    return init, reseed


def test_kmeans_and_cluster_permutation_match_jax_with_injected_draws(monkeypatch):
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((12, 32)).astype(np.float32) * 3
    v = (centers[rng.integers(0, 12, 900)]
         + rng.standard_normal((900, 32)).astype(np.float32))
    k = 30  # sqrt(900): some clusters empty out and re-seed
    init, reseed = _jax_kmeans_draws(len(v), k)
    jc = np.asarray(j_fit(jnp.asarray(v), k, seed=0))
    tc = kmeans_fit(torch.from_numpy(v), k, init_idx=torch.from_numpy(init),
                    reseed_idx=torch.from_numpy(reseed)).numpy()
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    np.testing.assert_array_equal(
        kmeans_assign(torch.from_numpy(v), torch.from_numpy(jc)).numpy(),
        np.asarray(j_assign(jnp.asarray(v), jnp.asarray(jc))))
    monkeypatch.setattr(tbuilder, "kmeans_fit", lambda vec, kk, seed=0: kmeans_fit(
        vec, kk, seed=seed, init_idx=torch.from_numpy(init),
        reseed_idx=torch.from_numpy(reseed)))
    perm_j, cent_j, assign_j = jbuilder._cluster_permutation(v)
    perm_t, cent_t, assign_t = tbuilder._cluster_permutation(torch.from_numpy(v))
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_allclose(cent_t.numpy(), np.asarray(cent_j), atol=1e-5)
    np.testing.assert_array_equal(assign_t, np.asarray(assign_j))


def test_index_documents_matches_jax_build(monkeypatch):
    """The port's own clustered build reproduces the JAX index state: the
    same permutation (k-means draws injected), dense snapshot, store and
    BM25 postings."""
    rng = np.random.default_rng(4)
    texts = _texts(rng, 700)
    jcfg = JConfig()
    jcfg.index.layout = "clustered"
    jenc = JEnc(dim=64)
    jidx = jbuilder.Indexer(encoder=jenc, config=jcfg)
    jidx.index_documents(texts)

    init, reseed = _jax_kmeans_draws(len(texts), int(np.sqrt(len(texts))))
    monkeypatch.setattr(tbuilder, "kmeans_fit", lambda vec, kk, seed=0: kmeans_fit(
        vec, kk, seed=seed, init_idx=torch.from_numpy(init),
        reseed_idx=torch.from_numpy(reseed)))
    cfg = EngineConfig()
    cfg.index.layout = "clustered"
    tidx = tbuilder.Indexer(encoder=convert.hashing_encoder(np.asarray(jenc.table),
                                                            device=CPU),
                            config=cfg, device=CPU)
    out = tidx.index_documents(texts)
    assert out["indexed"] == len(texts) and out["dim"] == 64
    assert tidx.contents == jidx.contents
    assert tidx.doc_ids == jidx.doc_ids
    js, ts = jidx.dense._snap, tidx.dense._snap
    assert (ts.n, ts.capacity) == (js.n, js.capacity)
    np.testing.assert_allclose(ts.docs.numpy(), np.asarray(js.docs), atol=1e-5)
    np.testing.assert_array_equal(ts.bias.numpy(), np.asarray(js.bias))
    jst, tst = jidx.bm25._state, tidx.bm25._state
    for a, b in zip(_triples(tst.vocab.id_to_hash, tst.postings.indptr.numpy(),
                             tst.postings.doc_ids.numpy(),
                             tst.postings.weights.numpy()),
                    _triples(_jax_vocab_hashes(jst.vocab),
                             np.asarray(jst.postings.indptr),
                             np.asarray(jst.postings.doc_ids),
                             np.asarray(jst.postings.weights))):
        np.testing.assert_array_equal(a, b)
    assert tidx.store.get_document(5)["content"] == jidx.store.get_document(5)["content"]

    # the JAX build's permutation, carried with convert.indexer, puts the
    # source corpus in the same index order
    perm = jbuilder._cluster_permutation(
        jidx.embed([jx.preprocess_text(t) for t in texts]))[0]
    carried = convert.indexer([jx.preprocess_text(t) for t in texts],
                              tidx.encoder, tidx.dense, tidx.bm25, config=cfg,
                              perm=perm)
    assert carried.contents == jidx.contents


def test_dense_delete_counts_each_row_once():
    """A row named twice in one delete, or deleted again later, is
    tombstoned and counted once: the true count, held here rather than
    against the JAX package, whose delete counts a repeated id twice."""
    from hybridsearch_tpu_torch.index.dense_index import DenseIndex

    rng = np.random.default_rng(0)
    idx = DenseIndex(dim=8, device=CPU).build(rng.standard_normal((10, 8)))
    idx.delete([3, 3])
    assert (idx.deleted_count, len(idx)) == (1, 9)
    idx.delete([3])
    assert (idx.deleted_count, len(idx)) == (1, 9)
    idx.delete(np.array([5, 3, 7, 5]))
    assert (idx.deleted_count, len(idx)) == (3, 7)
    dead = torch.isinf(idx._snap.bias[:10]).nonzero().flatten().tolist()
    assert dead == [3, 5, 7]


def test_dense_delete_rejects_out_of_range_ids():
    """An id past the capacity raises IndexError before BM25, the store or
    the dense tombstones change, as JAX ``Indexer.delete_documents`` does;
    a negative id raises too, where the JAX package wraps it to the end of
    the capacity (a reference fault the port does not copy)."""
    rng = np.random.default_rng(5)
    texts = _texts(rng, 20)
    jenc = JEnc(dim=32)
    jidx = jbuilder.Indexer(encoder=jenc)
    jidx.index_documents(texts)
    with pytest.raises(IndexError):
        jidx.delete_documents([99999])
    assert jidx.store.deleted_ids() == []

    tidx = tbuilder.Indexer(encoder=convert.hashing_encoder(np.asarray(jenc.table),
                                                            device=CPU), device=CPU)
    tidx.index_documents(texts)
    bias = tidx.dense._snap.bias.clone()
    for bad in ([99999], [-1], [2, 99999], [-1, 3]):
        with pytest.raises(IndexError):
            tidx.delete_documents(bad)
        assert tidx.dense.deleted_count == 0
        assert torch.equal(tidx.dense._snap.bias, bias)
        assert not tidx.bm25._tombstones
        assert tidx.store.deleted_ids() == []
    assert tidx.delete_documents([2]) == 1
    assert (tidx.dense.deleted_count, tidx.store.deleted_ids()) == (1, [2])


@pytest.mark.parametrize("n, capacity_round", [(300, 4096), (1000, 65536)],
                         ids=["scan", "tiled"])
def test_dense_search_extra_bias_matches_jax(n, capacity_round):
    """``DenseIndex.search(extra_bias=)``, the metadata pre-filter: an [n]
    bias (shorter than capacity; -inf masks, finite values shift) added to
    the tombstone bias gives JAX's values (atol 1e-5) and ids (outside
    near-ties within 1e-4), on both of JAX's routes (its scan below a
    65,536-row capacity, its tiled top-k from there)."""
    from hybridsearch_tpu.index.dense_index import DenseIndex as JDense
    from hybridsearch_tpu_torch.index.dense_index import DenseIndex

    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    bias = np.where(rng.random(n) < 0.25, 0.0, -np.inf).astype(np.float32)
    bias[:8] = 0.05  # a finite shift reaches the scores too
    jidx = JDense(dim=32, capacity_round=capacity_round).build(vecs)
    tidx = DenseIndex(dim=32, capacity_round=capacity_round, device=CPU).build(vecs)
    for ix in (jidx, tidx):
        ix.delete([3, 17])
    jv, ji = jidx.search(q, 10, extra_bias=jnp.asarray(bias))
    for eb in (bias, torch.from_numpy(bias)):
        tv, ti = tidx.search(q, 10, extra_bias=eb)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
        for b in range(len(q)):
            for j in np.nonzero(ti[b] != ji[b])[0]:
                assert (np.abs(jv[b] - jv[b, j]) <= 1e-4).sum() > 1
        keep = (bias == 0.0) | (bias == np.float32(0.05))
        keep[[3, 17]] = False
        assert keep[ti].all()


def test_dense_search_without_extra_bias_is_unchanged():
    """``extra_bias=None`` leaves the search as it was bit for bit (the
    tombstone bias alone into ``tiled_dense_topk``), and a zero bias gives
    the same rows."""
    from hybridsearch_tpu_torch.index.dense_index import DenseIndex
    from hybridsearch_tpu_torch.ops.dense import l2_normalize, tiled_dense_topk

    rng = np.random.default_rng(12)
    tidx = DenseIndex(dim=16, device=CPU).build(rng.standard_normal((500, 16)))
    tidx.delete([1, 2, 40])
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    snap = tidx._snap
    vals, idxs = tiled_dense_topk(l2_normalize(q), snap.docs, 12, bias=snap.bias)
    valid = (idxs >= 0) & (idxs < snap.n)
    want = (torch.where(valid, vals, float("-inf")).numpy(),
            torch.where(valid, idxs, -1).numpy())
    for got in (tidx.search(q, 12), tidx.search(q, 12, extra_bias=None),
                tidx.search(q, 12, extra_bias=np.zeros(500, np.float32))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
