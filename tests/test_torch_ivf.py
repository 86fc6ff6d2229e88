"""The port's single-device IVF index (index/ivf.py ``IVFIndex``), the
Indexer's IVF build (``ann="ivf"``, one k-means for layout and quantizer
on a clustered build, ``DenseIndex.reserve_rows``) and scatter mode through
the IVF, against the JAX package's, on the CPU, on the same inputs (made
with numpy from a seed; a JAX IVF's arrays carried across with
``convert.ivf_index``, k-means draws injected where the port's generator
cannot repeat ``jax.random``).

Tolerances: chunk tables and ids are integer data and must be equal
(ids modulo near-ties within 1e-4); centroids and scores are float32 sums
in another order (atol 1e-5); searcher rows as tests/test_torch_searcher.py.
"""

import jax
import numpy as np
import pytest
import torch

from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.index.ivf import IVFIndex as JIVF
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.retrieval import searcher as jsm
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index import builder as tbuilder
from hybridsearch_tpu_torch.index.ivf import IVFIndex, kmeans_fit
from hybridsearch_tpu_torch.retrieval import searcher as tsm

CPU = torch.device("cpu")
EPS = 1e-4


def _same_topk(got_v, got_i, want_v, want_i):
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)
    diff = np.asarray(got_i) != np.asarray(want_i)
    for b, j in zip(*np.nonzero(diff)):
        row = want_v[b]
        assert (np.abs(row - row[j]) <= EPS).sum() > 1, (b, j)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        _same_topk([[v for v, _c, _i in g]], [[i for _v, _c, i in g]],
                   [[v for v, _c, _i in w]], [[i for _v, _c, i in w]])


def _clustered(rng, n_clusters=20, per=100, d=64):
    centers = rng.standard_normal((n_clusters, d)) * 3
    return np.concatenate([c + 0.3 * rng.standard_normal((per, d))
                           for c in centers]).astype(np.float32)


def _exact(q, docs, k):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    dn = docs / np.linalg.norm(docs, axis=1, keepdims=True)
    s = qn @ dn.T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def _carried(j: JIVF) -> IVFIndex:
    return convert.ivf_index(np.asarray(j._centroids), np.asarray(j._docs_perm),
                             np.asarray(j._chunk_starts), np.asarray(j._chunk_lens),
                             np.asarray(j._perm_to_orig), j._cap, j.n_docs,
                             nprobe=j.nprobe, device=CPU)


def _jax_kmeans_draws(n, k, seed=0, iters=10):
    """The initial-centroid and re-seed rows jax.random draws inside
    hybridsearch_tpu.index.ivf.kmeans_fit."""
    key = jax.random.PRNGKey(seed)
    init = np.array(jax.random.choice(key, n, (k,), replace=False))
    reseed = np.stack([np.array(jax.random.randint(kk, (k,), 0, n))
                       for kk in jax.random.split(key, iters)])
    return init, reseed


def _inject_draws(monkeypatch, n, k):
    init, reseed = _jax_kmeans_draws(n, k)
    monkeypatch.setattr(tbuilder, "kmeans_fit", lambda vec, kk, seed=0: kmeans_fit(
        vec, kk, seed=seed, init_idx=torch.from_numpy(init),
        reseed_idx=torch.from_numpy(reseed)))


# -- the index ----------------------------------------------------------------------

@pytest.mark.parametrize("nprobe", [1, 4, 8, 10**9])
def test_converted_jax_ivf_searches_like_jax(nprobe):
    rng = np.random.default_rng(0)
    docs = _clustered(rng)
    j = JIVF(dim=64, n_clusters=32, nprobe=8).build(docs)
    t = _carried(j)
    qs = docs[rng.integers(0, len(docs), 16)] + 0.05 * rng.standard_normal(
        (16, 64)).astype(np.float32)
    jv, ji = j.search(qs, 10, nprobe=nprobe)
    tv, ti = t.search(qs, 10, nprobe=nprobe)
    _same_topk(tv, ti, jv, ji)
    tv2, ti2 = t.search(torch.from_numpy(qs), 10, nprobe=nprobe)  # tensor queries
    assert np.array_equal(tv, tv2) and np.array_equal(ti, ti2)


def test_converted_split_chunks_search_like_jax():
    """One tight cluster split into 32-row chunks sharing its centroid."""
    rng = np.random.default_rng(1)
    docs = (np.ones((200, 32)) + 0.01 * rng.standard_normal((200, 32))).astype(np.float32)
    j = JIVF(dim=32, n_clusters=4, chunk_cap=32).build(docs)
    t = _carried(j)
    n_chunks = int(t._centroids.shape[0])
    assert n_chunks >= 200 // 32
    for npr in (2, n_chunks):
        jv, ji = j.search(docs[:5], 3, nprobe=npr)
        tv, ti = t.search(docs[:5], 3, nprobe=npr)
        _same_topk(tv, ti, jv, ji)
        assert (ti >= 0).all()


def test_port_built_ivf_at_full_probe_is_exact():
    rng = np.random.default_rng(2)
    docs = _clustered(rng, n_clusters=5, per=40)
    ivf = IVFIndex(dim=64, n_clusters=8, device=CPU).build(docs)
    assert ivf.n_docs == 200 and ivf._docs_perm.shape[0] == 200 + ivf._cap
    qs = rng.standard_normal((4, 64)).astype(np.float32)
    tv, ti = ivf.search(qs, 5, nprobe=10**9)
    ev, ei = _exact(qs, docs, 5)
    _same_topk(tv, ti, ev, ei)


def test_port_built_ivf_recall_on_clustered_data():
    rng = np.random.default_rng(3)
    docs = _clustered(rng)
    ivf = IVFIndex(dim=64, n_clusters=32, nprobe=8, device=CPU).build(docs)
    qs = docs[rng.integers(0, len(docs), 16)] + 0.05 * rng.standard_normal(
        (16, 64)).astype(np.float32)
    _, got = ivf.search(qs, 10)
    _, want = _exact(qs, docs, 10)
    assert np.mean([len(set(got[b]) & set(want[b])) / 10 for b in range(16)]) > 0.9


def test_port_built_ivf_splits_chunks_and_pads_short_probes():
    rng = np.random.default_rng(4)
    docs = (np.ones((200, 32)) + 0.01 * rng.standard_normal((200, 32))).astype(np.float32)
    ivf = IVFIndex(dim=32, n_clusters=4, chunk_cap=32, device=CPU).build(docs)
    lens = ivf._chunk_lens.numpy()
    assert lens.max() <= 32 and lens.sum() == 200
    assert sorted(ivf._perm_to_orig.numpy()[:200].tolist()) == list(range(200))
    # fewer probed rows than k: the empty slots are -inf / -1
    k = int(lens[0]) + 5
    v, i = ivf.search(docs[:1], k, nprobe=1)
    assert (i[0, lens[0]:] == -1).all() and np.isinf(v[0, lens[0]:]).all()


def test_ivf_search_blocks_queries_without_changing_results(monkeypatch):
    """Blocks of queries change only the float32 order of a block's product."""
    from hybridsearch_tpu_torch.index import ivf as ivf_mod

    rng = np.random.default_rng(5)
    docs = _clustered(rng, n_clusters=6, per=50, d=32)
    ivf = IVFIndex(dim=32, n_clusters=8, nprobe=3, device=CPU).build(docs)
    qs = rng.standard_normal((9, 32)).astype(np.float32)
    whole = ivf.search(qs, 7)
    monkeypatch.setattr(ivf_mod, "IVF_GATHER_BYTES", 1)  # one query a block
    blocked = ivf.search(qs, 7)
    _same_topk(blocked[0], blocked[1], whole[0], whole[1])


def test_ivf_search_before_build_and_small_buffer_raise():
    with pytest.raises(RuntimeError):
        IVFIndex(dim=16, device=CPU).search(np.zeros((1, 16), np.float32), 3)
    rng = np.random.default_rng(6)
    ivf = IVFIndex(dim=16, n_clusters=4, chunk_cap=64, device=CPU)
    with pytest.raises(ValueError, match="shared buffer too small"):
        ivf.from_layout(torch.from_numpy(rng.standard_normal((100, 16)).astype(
            np.float32)), 100, rng.standard_normal((4, 16)).astype(np.float32),
            np.sort(rng.integers(0, 4, 100)))


# -- bfloat16 storage ---------------------------------------------------------------

def _inject_ivf_draws(monkeypatch, n, k):
    """The JAX k-means draws, into the port's IVFIndex.build."""
    from hybridsearch_tpu_torch.index import ivf as ivf_mod

    init, reseed = _jax_kmeans_draws(n, k)
    monkeypatch.setattr(ivf_mod, "kmeans_fit", lambda vec, kk, seed=0, iters=10: kmeans_fit(
        vec, kk, seed=seed, iters=iters, init_idx=torch.from_numpy(init),
        reseed_idx=torch.from_numpy(reseed)))


@pytest.mark.parametrize("nprobe", [2, 10**9])
def test_bf16_ivf_build_matches_jax(monkeypatch, nprobe):
    """``storage_dtype=bfloat16`` on both sides, the JAX k-means draws
    injected: the same chunk table and row order, rows in bfloat16 equal
    to JAX's but where the two packages' float32 normalizations round to
    neighbouring bfloat16 values, and the same search results."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    docs = _clustered(rng)
    j = JIVF(dim=64, n_clusters=32, nprobe=8, storage_dtype=jnp.bfloat16).build(docs)
    _inject_ivf_draws(monkeypatch, len(docs), 32)
    t = IVFIndex(dim=64, n_clusters=32, nprobe=8, device=CPU,
                 storage_dtype=torch.bfloat16).build(docs)
    assert t._docs_perm.dtype == torch.bfloat16
    for name in ("_chunk_starts", "_chunk_lens", "_perm_to_orig"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    got = t._docs_perm.float().numpy()
    want = np.asarray(j._docs_perm, np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert (got != want).mean() < 0.01
    qs = docs[rng.integers(0, len(docs), 16)] + 0.05 * rng.standard_normal(
        (16, 64)).astype(np.float32)
    _same_topk(*t.search(qs, 10, nprobe=nprobe), *j.search(qs, 10, nprobe=nprobe))


def test_bf16_ivf_is_the_f32_ivf_rounded():
    """One seed, the same vectors: a bfloat16 build has the float32 build's
    centroids and chunks (k-means runs on the float32 vectors), its rows are
    the float32 rows rounded (half the bytes), and each probe scores them
    in float32: ids equal the float32 index's but where the two docs at a
    slot have float32 scores within 2^-8 (a unit row's bfloat16 rounding
    moves a score at most 2^-9)."""
    rng = np.random.default_rng(8)
    docs = _clustered(rng, n_clusters=12, per=60)
    f32 = IVFIndex(dim=64, n_clusters=16, nprobe=4, device=CPU).build(docs)
    b16 = IVFIndex(dim=64, n_clusters=16, nprobe=4, device=CPU,
                   storage_dtype=torch.bfloat16).build(docs)
    assert torch.equal(b16._centroids, f32._centroids)
    assert torch.equal(b16._chunk_starts, f32._chunk_starts)
    assert torch.equal(b16._docs_perm, f32._docs_perm.to(torch.bfloat16))
    assert (b16._docs_perm.element_size() * 2 == f32._docs_perm.element_size())
    qs = docs[rng.integers(0, len(docs), 16)] + 0.05 * rng.standard_normal(
        (16, 64)).astype(np.float32)
    fv, fi = f32.search(qs, 10)
    bv, bi = b16.search(qs, 10)
    np.testing.assert_allclose(bv, fv, rtol=0, atol=2.0 ** -8)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    dn = docs / np.linalg.norm(docs, axis=1, keepdims=True)
    for b, j in zip(*np.nonzero(bi != fi)):  # the two docs' float32 scores
        assert abs(qn[b] @ dn[bi[b, j]] - fv[b, j]) <= 2.0 ** -8, (b, j)


def test_converted_bf16_ivf_searches_like_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    docs = _clustered(rng)
    j = JIVF(dim=64, n_clusters=32, nprobe=8, storage_dtype=jnp.bfloat16).build(docs)
    t = convert.ivf_index(np.asarray(j._centroids), np.asarray(j._docs_perm, np.float32),
                          np.asarray(j._chunk_starts), np.asarray(j._chunk_lens),
                          np.asarray(j._perm_to_orig), j._cap, j.n_docs, nprobe=8,
                          device=CPU, storage_dtype=torch.bfloat16)
    assert t._docs_perm.dtype == torch.bfloat16
    np.testing.assert_array_equal(t._docs_perm.float().numpy(),
                                  np.asarray(j._docs_perm, np.float32))
    qs = docs[:12] + 0.05 * rng.standard_normal((12, 64)).astype(np.float32)
    _same_topk(*t.search(qs, 10), *j.search(qs, 10))


# -- the Indexer's IVF build and scatter mode ------------------------------------------

def _texts(rng, n, n_vocab=120, topics=6):
    vocab = [f"w{i}" for i in range(n_vocab)]
    tops = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(topics)]
    return [f"{tops[i % topics]} " + " ".join(rng.choice(vocab, size=8))
            for i in range(n)]


def _config(cls, layout, ann="ivf", clusters=8, nprobe=4):
    cfg = cls()
    cfg.index.layout = layout
    cfg.index.ann = ann
    cfg.index.ivf_clusters = clusters
    cfg.index.ivf_nprobe = nprobe
    return cfg


@pytest.fixture(scope="module")
def clustered_pair():
    """One corpus indexed by both packages under layout="clustered",
    ann="ivf", 8 clusters (the port given the JAX k-means draws)."""
    rng = np.random.default_rng(7)
    texts = _texts(rng, 700)
    jenc = JEnc(dim=64)
    js = jsm.Searcher(encoder=jenc, use_query_memory=False, semantic_mode="scatter",
                      config=_config(JConfig, "clustered"))
    js.indexer.index_documents(texts)
    mp = pytest.MonkeyPatch()
    try:
        _inject_draws(mp, len(texts), 8)
        cfg = _config(EngineConfig, "clustered")
        ts = tsm.Searcher(encoder=convert.hashing_encoder(np.asarray(jenc.table),
                                                          device=CPU),
                          use_query_memory=False, semantic_mode="scatter",
                          config=cfg, device=CPU)
        ts.indexer.index_documents(texts)
    finally:
        mp.undo()
    queries = [f"z{z}t1 z{z}t3 w{z + 5}" for z in range(6)] + ["w3 w11 w42", "zzz"]
    return js, ts, texts, queries


def test_clustered_ivf_build_equals_jax(clustered_pair):
    js, ts, _texts_, _q = clustered_pair
    ji, ti = js.indexer.ivf, ts.indexer.ivf
    assert ti is not None and ti.n_docs == ji.n_docs == 700
    assert ti._cap == ji._cap == max(8, 4 * 700 // 8)
    assert ts.indexer.contents == js.indexer.contents
    np.testing.assert_array_equal(ti._chunk_starts.numpy(), np.asarray(ji._chunk_starts))
    np.testing.assert_array_equal(ti._chunk_lens.numpy(), np.asarray(ji._chunk_lens))
    np.testing.assert_array_equal(ti._perm_to_orig.numpy(), np.asarray(ji._perm_to_orig))
    np.testing.assert_allclose(ti._centroids.numpy(), np.asarray(ji._centroids),
                               atol=1e-5)
    assert ts.indexer.dense.capacity == js.indexer.dense.capacity


def test_clustered_ivf_adopts_the_shared_buffer(clustered_pair):
    _js, ts, _texts_, queries = clustered_pair
    ix = ts.indexer
    assert ix.ivf._docs_perm is ix.dense._snap.docs  # one corpus copy
    assert ix.dense.reserve_rows == ix.ivf._cap
    assert ix.dense.capacity >= ix.ivf.n_docs + ix.ivf._cap
    q = ix.encoder.encode(queries)
    n_chunks = int(ix.ivf._chunk_starts.shape[0])
    vals, ids = ix.ivf.search(q, 5, nprobe=n_chunks)
    ev, ei = ix.dense.search(q, 5)
    _same_topk(vals, ids, ev, ei)


def test_scatter_mode_through_the_ivf_matches_jax(clustered_pair, monkeypatch):
    js, ts, _texts_, queries = clustered_pair
    calls = []
    real = IVFIndex.search
    monkeypatch.setattr(IVFIndex, "search",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    got = ts.search_batch(queries, top_k=5, log=False)
    assert calls
    _same_results(got, js.search_batch(queries, top_k=5, log=False))


def test_scatter_mode_through_a_converted_ivf_matches_jax():
    """layout="source", ann="ivf": the JAX build's own k-means, carried over
    with convert.ivf_index, serves scatter mode in both packages alike."""
    rng = np.random.default_rng(8)
    texts = _texts(rng, 600)
    jenc = JEnc(dim=64)
    js = jsm.Searcher(encoder=jenc, use_query_memory=False, semantic_mode="scatter",
                      config=_config(JConfig, "source", clusters=6, nprobe=2))
    js.indexer.index_documents(texts)
    snap, st = js.indexer.dense._snap, js.indexer.bm25._state
    po = st.postings
    cfg = _config(EngineConfig, "source", clusters=6, nprobe=2)
    idx = convert.indexer(
        js.indexer.contents, convert.hashing_encoder(np.asarray(jenc.table), device=CPU),
        convert.dense_index(np.asarray(snap.docs), np.asarray(snap.bias), snap.n,
                            device=CPU),
        convert.bm25_index(np.asarray(st.vocab.id_to_hash, np.uint64),
                           np.asarray(po.indptr), np.asarray(po.doc_ids),
                           np.asarray(po.weights), po.n_docs, device=CPU),
        config=cfg)
    idx.ivf = _carried(js.indexer.ivf)
    ts = tsm.Searcher(indexer=idx, use_query_memory=False, semantic_mode="scatter",
                      config=cfg)
    queries = [f"z{z}t1 w{z}" for z in range(6)] + ["w9 w10"]
    _same_results(ts.search_batch(queries, top_k=5, log=False),
                  js.search_batch(queries, top_k=5, log=False))


def test_source_layout_ivf_build_is_its_own_copy():
    rng = np.random.default_rng(9)
    texts = _texts(rng, 400)
    ts = tsm.Searcher(encoder=_port_encoder(),
                      use_query_memory=False, semantic_mode="scatter",
                      config=_config(EngineConfig, "source", clusters=6, nprobe=6),
                      device=CPU)
    ts.indexer.index_documents(texts)
    ix = ts.indexer
    assert ix.ivf is not None and ix.ivf._docs_perm is not ix.dense._snap.docs
    assert ix.dense.reserve_rows == 0
    q = ix.encoder.encode(["z1t1 w3", "w7 w8"])
    v, i = ix.ivf.search(q, 5, nprobe=10**9)
    ev, ei = ix.dense.search(q, 5)
    _same_topk(v, i, ev, ei)


def _port_encoder():
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    return HashingEncoder(dim=64, device=CPU)


def test_stale_ivf_gives_way_after_an_add(clustered_pair, monkeypatch):
    """After add_documents the IVF no longer covers every doc: scatter mode
    takes DenseIndex.search, and the added doc can be served."""
    _js, ts0, texts, _queries = clustered_pair
    rng = np.random.default_rng(10)
    cfg = _config(EngineConfig, "clustered")
    ts = tsm.Searcher(encoder=_port_encoder(), use_query_memory=False,
                      semantic_mode="scatter", config=cfg, device=CPU)
    ts.indexer.index_documents(texts)
    assert ts.indexer.ivf.n_docs == len(texts)
    (new_id,) = ts.indexer.add_documents(["quasar nebula " + " ".join(
        rng.choice([f"w{i}" for i in range(120)], 3))])
    assert ts.indexer.ivf.n_docs != ts.indexer.dense.n_docs
    used = []
    real_ivf, real_dense = IVFIndex.search, type(ts.indexer.dense).search
    monkeypatch.setattr(IVFIndex, "search",
                        lambda self, *a, **k: used.append("ivf") or real_ivf(self, *a, **k))
    monkeypatch.setattr(type(ts.indexer.dense), "search",
                        lambda self, *a, **k: used.append("dense") or real_dense(self, *a, **k))
    res = ts.search_batch(["quasar nebula"], top_k=3, log=False)
    assert used == ["dense"]
    assert res[0][0][2] == new_id


def test_ivf_clusters_default_keeps_the_layout_permutation(monkeypatch):
    """ann="ivf" with ivf_clusters = 0 runs the layout k-means at sqrt(N)
    clusters, so the clustered permutation is the flat build's."""
    rng = np.random.default_rng(11)
    texts = _texts(rng, 500)
    orders = []
    for ann in ("flat", "ivf"):
        _inject_draws(monkeypatch, len(texts), int(np.sqrt(len(texts))))
        ix = tbuilder.Indexer(encoder=_port_encoder(),
                              config=_config(EngineConfig, "clustered", ann=ann,
                                             clusters=0), device=CPU)
        ix.index_documents(texts)
        orders.append(ix.contents)
        assert (ix.ivf is None) == (ann == "flat")
    assert orders[0] == orders[1]


def test_want_ivf_policy(monkeypatch):
    ix = tbuilder.Indexer(encoder=_port_encoder(), config=EngineConfig(), device=CPU)
    for ann, n, want in (("flat", 10**7, False), ("ivf", 1, True), ("ivf", 0, False),
                         ("auto", tbuilder.IVF_AUTO_MIN_DOCS - 1, False),
                         ("auto", tbuilder.IVF_AUTO_MIN_DOCS, True)):
        ix.config.index.ann = ann
        assert ix._want_ivf(n) is want
    ix.config.index.ann = "auto"
    monkeypatch.setattr(tbuilder, "IVF_AUTO_MIN_DOCS", 50)
    ix.index_documents([f"doc number {i} about topic {i % 5}" for i in range(30)])
    assert ix.ivf is None
    ix.index_documents([f"doc number {i} about topic {i % 5}" for i in range(80)])
    assert ix.ivf is not None and ix.ivf.n_docs == 80
