"""The slice as a whole: the port's supertile prefix, rungs, ladder and
``Searcher.search_batch`` against the JAX package's, on the CPU, on
identical state carried across with ``hybridsearch_tpu_torch.convert``.

Tolerances: fused scores rtol=1e-4, atol=1e-5 (float32 sums in another
order). Ids exact, except where two slots' scores lie within the
certificate margin eps_num=1e-4 (a near-tie the summation order may swap;
torch and jax.lax order exact ties differently too). ``exact`` flags must
be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import supertile as jst
from hybridsearch_tpu.ops.dense import l2_normalize as j_l2n
from hybridsearch_tpu.retrieval import searcher as jsm
from hybridsearch_tpu.text.extractor import HashVocabulary
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.sparse_index import BM25
from hybridsearch_tpu_torch.ops import dense as tdense
from hybridsearch_tpu_torch.ops import supertile as tst
from hybridsearch_tpu_torch.retrieval import searcher as tsm

CPU = torch.device("cpu")
EPS = 1e-4


def _same_topk(got_v, got_i, want_v, want_i):
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)
    diff = np.asarray(got_i) != np.asarray(want_i)
    # a differing id is only allowed inside a near-tie
    for b, j in zip(*np.nonzero(diff)):
        row = want_v[b]
        near = np.abs(row - row[j]) <= EPS
        assert near.sum() > 1, f"row {b} slot {j}: ids differ outside a tie"


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        _same_topk([[v for v, _c, _i in g]], [[i for _v, _c, i in g]],
                   [[v for v, _c, _i in w]], [[i for _v, _c, i in w]])


# -- prefix, rung and ladder on one build ---------------------------------------

def _corpus(rng, n, n_vocab, d):
    vocab = [f"t{i}" for i in range(n_vocab)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 14))))
             for _ in range(n)]
    docs = rng.standard_normal((n, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    return vocab, texts, docs


def _both_builds(texts, super_tiles):
    jb = JBM25().fit(texts)
    jsp = jb.super_postings(super_tiles=super_tiles)
    tb = BM25(device=CPU).fit(texts)
    tsp = tb.super_postings(super_tiles=super_tiles)
    return jb, jsp, tb, tsp


@pytest.mark.parametrize("with_bias", [False, True])
def test_prefix_and_rungs_match_jax(with_bias):
    rng = np.random.default_rng(0)
    n, d = 1500, 32
    vocab, texts, docs = _corpus(rng, n, 80, d)
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 5))))
               for _ in range(7)]
    q = rng.standard_normal((7, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    n_alive = n
    if with_bias:
        bias[rng.choice(n, 100, replace=False)] = -np.inf
        n_alive -= 100
    jb, jsp, tb, tsp = _both_builds(texts, super_tiles=2)  # 256-doc supertiles
    lists = [jb.vocab.encode(x.split()) for x in queries]
    assert lists == [tb.vocab.encode(x.split()) for x in queries]
    jenc, tenc = jst.encode_super_queries(jsp, lists), tst.encode_super_queries(tsp, lists)
    jb_ = jnp.asarray(bias) if with_bias else None
    tb_ = torch.from_numpy(bias) if with_bias else None
    jp = jst.super_prefix(jnp.asarray(q), jnp.asarray(docs), jsp, jenc, bias=jb_,
                          s_max=8)
    tp = tst.super_prefix(torch.from_numpy(q), torch.from_numpy(docs), tsp, tenc,
                          bias=tb_, s_max=8)
    for name in ("ssem", "slex", "smin", "smax"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tp.sup_all.numpy(), np.asarray(jp.sup_all))
    for s_probe in (1, 2, 4, 8):
        jr = jst.hybrid_supertile_topk_rung(jnp.asarray(q), jnp.asarray(docs), jsp,
                                            jenc, jp, 5, 0.7, 0.3, bias=jb_,
                                            s_probe=s_probe, n_alive=n_alive)
        tr = tst.hybrid_supertile_topk_rung(torch.from_numpy(q), torch.from_numpy(docs),
                                            tsp, tenc, tp, 5, 0.7, 0.3, bias=tb_,
                                            s_probe=s_probe, n_alive=n_alive)
        _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
        np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
        if s_probe == 8:  # every supertile probed: the certificate closes
            assert tr.exact.numpy().all()


def test_rung_kernel_route_matches_jax_interpret(monkeypatch):
    """With the kernel routes taken (K2's and K3's wrappers, plain versions
    behind them on the CPU) the rung equals the JAX rung running its Pallas
    kernels in interpret mode."""
    monkeypatch.setenv("HST_SUPER_INTERPRET", "1")  # read at trace time
    monkeypatch.setattr(tdense, "_on_card", lambda t: True)
    monkeypatch.setattr(tst, "_on_card", lambda t: True)
    calls = []
    real = tst.super_scores
    monkeypatch.setattr(tst, "super_scores",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(1)
    n, d = 4096, 128
    vocab, texts, docs = _corpus(rng, n, 60, d)
    queries = [" ".join(rng.choice(vocab, size=3)) for _ in range(9)]
    q = rng.standard_normal((9, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    bias[rng.choice(n, 50, replace=False)] = -np.inf
    jb, jsp, tb, tsp = _both_builds(texts, super_tiles=8)  # 1024-doc supertiles
    lists = [jb.vocab.encode(x.split()) for x in queries]
    jenc, tenc = jst.encode_super_queries(jsp, lists), tst.encode_super_queries(tsp, lists)
    jp = jst.super_prefix(jnp.asarray(q), jnp.asarray(docs), jsp, jenc,
                          bias=jnp.asarray(bias), s_max=2)
    tp = tst.super_prefix(torch.from_numpy(q), torch.from_numpy(docs), tsp, tenc,
                          bias=torch.from_numpy(bias), s_max=2)
    jr = jst.hybrid_supertile_topk_rung(jnp.asarray(q), jnp.asarray(docs), jsp, jenc,
                                        jp, 5, 0.7, 0.3, bias=jnp.asarray(bias),
                                        s_probe=2, n_alive=n - 50)
    tr = tst.hybrid_supertile_topk_rung(torch.from_numpy(q), torch.from_numpy(docs),
                                        tsp, tenc, tp, 5, 0.7, 0.3,
                                        bias=torch.from_numpy(bias), s_probe=2,
                                        n_alive=n - 50)
    assert calls
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))


def test_resident_windows_hold_each_doc_once_per_slot():
    """The placement kernel relies on it for its fixed summation order: a
    slot's window (the nonzero entries of one term slot's chunks) names a
    doc at most once."""
    rng = np.random.default_rng(2)
    vocab, texts, _docs = _corpus(rng, 3000, 40, 8)
    tb = BM25(device=CPU).fit(texts)
    tsp = tb.super_postings(super_tiles=4)
    lists = [tb.vocab.encode(rng.choice(vocab, size=5)) for _ in range(6)]
    enc = tst.encode_super_queries(tsp, lists)
    sup = torch.tensor([[0, 2, 5]] * 6)
    l_cat, w_cat, ovf = tst._resident_windows(
        tsp.sup_pos, tsp.ids_rows, tsp.ws_rows, enc.term_ids, sup,
        tsp.super_docs, enc.wcaps)
    assert not ovf.any()
    ch = tst.PLACE_CHUNK
    l = l_cat.reshape(-1, l_cat.shape[-1] // ch, ch).numpy()
    w = w_cat.reshape(-1, w_cat.shape[-1] // ch, ch).numpy()
    for row_l, row_w in zip(l.reshape(-1, ch), w.reshape(-1, ch)):
        ids = row_l[row_w != 0]
        assert len(ids) == len(np.unique(ids))


# -- search_batch on carried state ---------------------------------------------

def _jax_searcher(texts, dim):
    cfg = JConfig()
    cfg.index.layout = "clustered"
    s = jsm.Searcher(encoder=JEnc(dim=dim), use_query_memory=False, config=cfg)
    s.indexer.index_documents(texts)
    return s


def _carry(js, device=CPU):
    """The port's Searcher over the JAX searcher's exact index state."""
    snap, st = js.indexer.dense._snap, js.indexer.bm25._state
    po = st.postings
    vocab = (np.asarray(st.vocab.id_to_hash, np.uint64)
             if isinstance(st.vocab, HashVocabulary) else st.vocab.id_to_token)
    cfg = EngineConfig()
    cfg.index.layout = "clustered"
    cfg.index.dim = js.indexer.config.index.dim
    idx = convert.indexer(
        js.indexer.contents,
        convert.hashing_encoder(np.asarray(js.indexer.encoder.table), device=device),
        convert.dense_index(np.asarray(snap.docs), np.asarray(snap.bias), snap.n,
                            device=device),
        convert.bm25_index(vocab, np.asarray(po.indptr), np.asarray(po.doc_ids),
                           np.asarray(po.weights), po.n_docs, device=device),
        config=cfg)
    return tsm.Searcher(indexer=idx, use_query_memory=False, config=cfg)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(150)]
    topics = [" ".join(f"z{z}t{j}" for j in range(8)) for z in range(5)]
    texts = [f"{topics[i % 5]} " + " ".join(rng.choice(vocab, size=8))
             for i in range(900)]
    js = _jax_searcher(texts, dim=128)
    return js, _carry(js), vocab


QUERIES = ["z2t1 z2t3 w7", "z4t0 z4t5", "w3 w11 w42", "z0t7", "nothing matches"]


def test_search_batch_below_threshold_matches_jax(pair):
    js, ts, _ = pair
    _same_results(ts.search_batch(QUERIES, top_k=5, log=False),
                  js.search_batch(QUERIES, top_k=5, log=False))


@pytest.mark.parametrize("interpret", [False, True])
def test_search_batch_supertile_route_matches_jax(pair, monkeypatch, interpret):
    """Both packages through the supertile ladder (threshold lowered as in
    tests/test_supertile.py); with ``interpret`` the JAX side runs its
    Pallas kernels and the port takes its kernel routes."""
    js, ts, _ = pair
    monkeypatch.setattr(jsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setenv("HST_TILE_HYBRID", "0")
    if interpret:
        monkeypatch.setenv("HST_SUPER_INTERPRET", "1")
        monkeypatch.setattr(tdense, "_on_card", lambda t: True)
        monkeypatch.setattr(tst, "_on_card", lambda t: True)
    ladders = []
    real = tsm.supertile_ladder
    monkeypatch.setattr(tsm, "supertile_ladder",
                        lambda *a, **k: ladders.append(1) or real(*a, **k))
    want = js.search_batch(QUERIES, top_k=5, log=False)
    got = ts.search_batch(QUERIES, top_k=5, log=False)
    assert ladders
    _same_results(got, want)
    # and the supertile route agrees with the full fused route
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 10**9)
    _same_results(got, ts.search_batch(QUERIES, top_k=5, log=False))


def test_carried_super_postings_equal_the_ports_own_build(pair):
    js, ts, _ = pair
    jsp = js.indexer.bm25.super_postings()
    carried = convert.super_postings(
        *(np.asarray(getattr(jsp, f)) for f in ("sup_max", "sup_pos", "ids_rows",
                                                 "ws_rows")),
        jsp.n_docs, jsp.n_super, jsp.super_tiles, jsp.starts_host, jsp.df_host,
        jsp.win_max_host, device=CPU)
    own = ts.indexer.bm25.super_postings()
    for name in ("sup_max", "sup_pos", "ids_rows", "ws_rows"):
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
    for name in ("starts_host", "df_host", "win_max_host"):
        np.testing.assert_array_equal(getattr(carried, name), getattr(own, name))
    bm = convert.bm25_index(np.asarray(js.indexer.bm25.vocab.id_to_hash, np.uint64)
                            if isinstance(js.indexer.bm25.vocab, HashVocabulary)
                            else js.indexer.bm25.vocab.id_to_token,
                            np.asarray(js.indexer.bm25.postings.indptr),
                            np.asarray(js.indexer.bm25.postings.doc_ids),
                            np.asarray(js.indexer.bm25.postings.weights),
                            js.indexer.bm25.n_docs, device=CPU)
    convert.attach_super_postings(bm, carried)
    assert bm.super_postings() is carried


def test_dense_index_search_matches_jax(pair):
    js, ts, _ = pair
    q = js.indexer.encoder.encode(["z2t1 w7", "w3 w11", "z0t7 z0t1"])
    jv, ji = js.indexer.dense.search(q, 7)
    tv, ti = ts.indexer.dense.search(q, 7)
    _same_topk(tv, ti, jv, ji)


def test_tombstoned_docs_never_returned(pair, monkeypatch):
    js, _ts, vocab = pair
    ts = _carry(js)
    first = ts.search_batch(["z2t1 z2t3"], top_k=5, log=False)[0]
    dead = [i for _v, _c, i in first[:2]]
    ts.indexer.delete_documents(dead)
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    for route in ("supertile", "fused"):
        res = ts.search_batch(["z2t1 z2t3"], top_k=5, log=False)[0]
        assert not set(dead) & {i for _v, _c, i in res}, route
        monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 10**9)


def test_ladder_escalates_and_compacts_like_jax(monkeypatch):
    """supertile_ladder on small supertiles: several rungs, a compacted
    tail, and the same merged result as the JAX ladder."""
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(300)]
    topics = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(12)]
    texts = [f"{topics[i % 12]} " + " ".join(rng.choice(vocab, size=6))
             for i in range(4000)]
    js = _jax_searcher(texts, dim=64)
    ts = _carry(js)
    queries = ([f"z{z}t1 z{z}t3" for z in range(12)]
               + [f"z{z}t0 z{z}t2" for z in range(12)]
               + [f"z{z}t0 z{z}t1 z{z}t3" for z in range(8)]
               + [f"{vocab[i]} {vocab[i + 50]} {vocab[i + 100]}" for i in range(6)])
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "_MIN_ESCALATION_BUCKET", 2)
    jb, tb = js.indexer.bm25, ts.indexer.bm25
    jsp = jb.super_postings(super_tiles=4)
    tsp = tb.super_postings(super_tiles=4)
    lists = [jb._state.vocab.encode(x.split()) for x in queries]
    jenc, tenc = jst.encode_super_queries(jsp, lists), tst.encode_super_queries(tsp, lists)
    jsnap, tsnap = js.indexer.dense._snap, ts.indexer.dense._snap
    jq = j_l2n(jnp.asarray(js.indexer.encoder.encode(queries)))
    tq = tdense.l2_normalize(ts.indexer.encoder.encode(queries))
    seen = []
    real_rung = tst.hybrid_supertile_topk_rung
    monkeypatch.setattr(tst, "hybrid_supertile_topk_rung",
                        lambda q, *a, **k: seen.append(q.shape[0]) or real_rung(q, *a, **k))
    jst_, jr = jsm.supertile_ladder(jq, jsnap.docs, jsp, jenc, 5, 0.7, 0.3,
                                    bias=jsnap.bias, valid_n=jsnap.n,
                                    ladder=(1, 2, 4, 8), uncertified_tol=0.0)
    tst_, tr = tsm.supertile_ladder(tq, tsnap.docs, tsp, tenc, 5, 0.7, 0.3,
                                    bias=tsnap.bias, valid_n=tsnap.n,
                                    ladder=(1, 2, 4, 8), uncertified_tol=0.0)
    assert tr == jr and tr > 1
    assert any(b < len(queries) for b in seen[1:]), seen
    _same_topk(tst_.values, tst_.indices, jst_.values, jst_.indices)
    np.testing.assert_array_equal(tst_.exact, jst_.exact)


def test_subset_batch_rows_and_ladder_state():
    enc = tst.SuperQueryEnc(
        term_ids=torch.arange(18).reshape(6, 3), starts=torch.zeros((6, 3)),
        lens=torch.ones((6, 3)), complete=np.ones(6, bool),
        full_touched=np.arange(6), wcaps=(8, 8, 8), t_pad=3)
    sub = tsm._subset_batch_rows(enc, np.array([4, 1, 1, 1]), 6)
    assert sub.term_ids[0, 0].item() == 12 and sub.full_touched.tolist() == [4, 1, 1, 1]
    assert sub.wcaps == (8, 8, 8) and sub.t_pad == 3
    assert tsm._pow2_bucket(1) == 32 and tsm._pow2_bucket(33) == 64
    st = tsm._LadderState(4)
    st.merge(torch.eye(4, 2), torch.ones((4, 2), dtype=torch.int64),
             torch.tensor([True, False, True, False]))
    assert st.next_rows() is None  # a 32-row bucket cannot undercut 4 rows
