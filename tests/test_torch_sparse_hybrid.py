"""The port's hot-term tables, ``BM25.encode_queries_sparse`` and
``hybrid_sparse_topk`` (ops/bm25.py, index/sparse_index.py, ops/hybrid.py)
against the JAX package's, on the CPU, on the same inputs (made with numpy
from a seed). The hot threshold is lowered with a monkeypatch in both
packages, as tests/test_ops_hybrid.py lowers it, so a small corpus has hot
terms.

Tolerances: the hot tables, the encodes and the run pieces are built by
the same host numpy calls and must be equal bit for bit. Tile bounds sum
the same float32 weights in another order than the JAX scatter-add
(rtol 1e-6). Fused values rtol=1e-4, atol=1e-5; ids equal except inside
near-ties within eps_num=1e-4; ``exact`` flags equal. Certified rows are
also held to the port's own full [B, n] fusion.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.ops import bm25 as jbm25_ops
from hybridsearch_tpu.ops import hybrid as jhy
from hybridsearch_tpu.text.extractor import HashVocabulary
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.index.sparse_index import BM25
from hybridsearch_tpu_torch.ops import bm25 as tbm25_ops
from hybridsearch_tpu_torch.ops import hybrid as thy
from hybridsearch_tpu_torch.ops.fusion import max_normalize
from hybridsearch_tpu_torch.retrieval import searcher as tsm

CPU = torch.device("cpu")
EPS = 1e-4
VOCAB = [f"word{i}" for i in range(1000)]
N, D, B, K = 4096, 64, 4, 10
HOT = 64  # the lowered hot threshold


def _same_topk(got_v, got_i, want_v, want_i):
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)
    diff = np.asarray(got_i) != np.asarray(want_i)
    # a differing id is only allowed inside a near-tie
    for b, j in zip(*np.nonzero(diff)):
        row = want_v[b]
        near = np.abs(row - row[j]) <= EPS
        assert near.sum() > 1, f"row {b} slot {j}: ids differ outside a tie"


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port_oracle(tb, docs, queries, q, w_s, w_l, bias, k, norm="minmax"):
    """Full [B, n] fusion with the port's plain ops: the exact answer."""
    po = tb._state.postings
    n = docs.shape[0]
    lex = tbm25_ops.local_bucketed_scores(po.doc_ids, po.weights,
                                          tb.encode_queries_bucketed(queries), n,
                                          len(queries))
    sem = torch.from_numpy(q) @ torch.from_numpy(docs).T
    if norm == "max":
        return torch.topk(max_normalize(sem) * w_s + max_normalize(lex) * w_l, k)
    bias_t = torch.zeros(n) if bias is None else torch.from_numpy(bias)
    return tsm._fuse_and_topk(sem, lex, w_s, w_l, bias_t, k)


def _check_exact_rows(res, ovals, oidx):
    ex = res.exact.numpy()
    for b in np.nonzero(ex)[0]:
        _same_topk(res.values.numpy()[b:b + 1], res.indices.numpy()[b:b + 1],
                   ovals.numpy()[b:b + 1], oidx.numpy()[b:b + 1])
    return ex


@pytest.fixture
def lowered(monkeypatch):
    """Both packages with the hot threshold at HOT."""
    for mod in (jbm25_ops, tbm25_ops):
        monkeypatch.setattr(mod, "HOT_DF_THRESHOLD", HOT)


def _texts(seed, n=N, hot_every=3):
    rng = np.random.default_rng(seed)
    toks = rng.choice(VOCAB, size=(n, 10))
    return [" ".join(row) + (" verycommon" if hot_every and i % hot_every else "")
            for i, row in enumerate(toks)], rng


def _both(texts):
    return JBM25().fit(texts), BM25(device=CPU).fit(texts)


# -- the hot-term tables ---------------------------------------------------------

def _same_hot_tables(tp, jp):
    np.testing.assert_array_equal(tp.hot_rows_of, jp.hot_rows_of)
    assert (tp.hot_tile_bounds is None) == (jp.hot_tile_bounds is None)
    if jp.hot_tile_bounds is not None:
        np.testing.assert_array_equal(tp.hot_tile_bounds.numpy(),
                                      np.asarray(jp.hot_tile_bounds))


@pytest.mark.parametrize("threshold", [HOT, 400, 10**6])
def test_hot_tables_equal_jax_bit_for_bit(monkeypatch, threshold):
    for mod in (jbm25_ops, tbm25_ops):
        monkeypatch.setattr(mod, "HOT_DF_THRESHOLD", threshold)
    texts, _ = _texts(0, n=3000)
    jb, tb = _both(texts)
    jp, tp = jb._state.postings, tb._state.postings
    _same_hot_tables(tp, jp)
    assert (jp.hot_tile_bounds is None) == (threshold == 10**6)
    if tp.hot_tile_bounds is not None:
        H = int((tp.hot_rows_of >= 0).sum())
        assert tp.hot_tile_bounds.shape == (H + 1, -(-3000 // 128))
        assert not tp.hot_tile_bounds[H].any()  # the pad row


def test_hot_tables_keep_the_hottest_terms(monkeypatch):
    for mod in (jbm25_ops, tbm25_ops):
        monkeypatch.setattr(mod, "HOT_DF_THRESHOLD", 40)
        monkeypatch.setattr(mod, "MAX_HOT_TERMS", 3)
    texts, _ = _texts(1, n=3000)
    jb, tb = _both(texts)
    _same_hot_tables(tb._state.postings, jb._state.postings)
    po = tb._state.postings
    hot = np.flatnonzero(po.hot_rows_of >= 0)
    assert len(hot) == 3
    cold_long = (po.lengths_host > 40) & (po.hot_rows_of < 0)
    assert cold_long.any()
    assert po.lengths_host[cold_long].max() <= po.lengths_host[hot].min()


def test_hot_tables_survive_load_and_convert(lowered, tmp_path):
    """postings_from_csr builds the tables too: a loaded or converted
    index keeps its hot terms."""
    texts, _ = _texts(2, n=2000)
    jb, tb = _both(texts)
    path = str(tmp_path / "bm25.npz")
    jb.save(path)
    loaded = BM25(device=CPU).load(path)
    _same_hot_tables(loaded._state.postings, jb._state.postings)
    st, po = jb._state, jb._state.postings
    vocab = (np.asarray(st.vocab.id_to_hash, np.uint64)
             if isinstance(st.vocab, HashVocabulary) else st.vocab.id_to_token)
    carried = convert.bm25_index(vocab, np.asarray(po.indptr), np.asarray(po.doc_ids),
                                 np.asarray(po.weights), po.n_docs, device=CPU)
    _same_hot_tables(carried._state.postings, po)
    assert carried._state.postings.hot_tile_bounds is not None


def test_hot_table_rows_are_the_runs_tile_sums(lowered):
    _jb, tb = _both(_texts(3, n=2000)[0])
    po = tb._state.postings
    d, w = po.doc_ids.numpy(), po.weights.numpy()
    for tid in np.flatnonzero(po.hot_rows_of >= 0):
        st, ln = int(po.starts_host[tid]), int(po.lengths_host[tid])
        want = np.zeros(po.hot_tile_bounds.shape[1], np.float64)
        np.add.at(want, d[st:st + ln] // 128, w[st:st + ln])
        np.testing.assert_allclose(po.hot_tile_bounds[int(po.hot_rows_of[tid])].numpy(),
                                   want, rtol=1e-6)


# -- encodes ---------------------------------------------------------------------

def test_encode_hot_terms_and_queries_sparse_equal_jax(lowered):
    texts, rng = _texts(4, n=2000)
    jb, tb = _both(texts)
    queries = (["verycommon " + " ".join(rng.choice(VOCAB, size=2)) for _ in range(3)]
               + [" ".join(rng.choice(VOCAB, size=3)), "zzz"])
    lists = [tb._state.vocab.encode(x.split()) for x in queries]
    jhot = jbm25_ops.encode_hot_terms(jb._state.postings, lists)
    thot = tbm25_ops.encode_hot_terms(tb._state.postings, lists)
    for a, b in zip(thot, jhot):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tbm25_ops.encode_hot_terms(tb._state.postings, lists[3:]) is None
    jg, jh = jb.encode_queries_sparse(queries)
    tg, th = tb.encode_queries_sparse(queries)
    assert [w for w, _s, _l in tg] == [w for w, _s, _l in jg]
    for (_w, ts_, tl), (_v, js_, jl) in zip(tg, jg):
        np.testing.assert_array_equal(ts_, np.asarray(js_))
        np.testing.assert_array_equal(tl, np.asarray(jl))
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the hot term is left out of the pieces: their lengths hold no hot run
    hot_len = int(tb._state.postings.lengths_host[lists[0][0]])
    assert all((tl != hot_len).all() for _w, _s, tl in tg)


def test_encode_queries_sparse_compacts_a_pending_delta(lowered):
    texts, rng = _texts(5, n=2000)
    tb = BM25(device=CPU).fit(texts)
    tb.add_tokens([x.split() for x in _texts(6, n=10)[0]])
    assert tb._state.delta_seg is not None
    groups, hot = tb.encode_queries_sparse(["verycommon word3"])
    assert tb._state.delta_seg is None and hot is not None
    assert tb._state.postings.n_docs == 2010
    assert BM25(device=CPU).encode_queries_sparse(["a"]) == ([], None)


# -- tile bounds ------------------------------------------------------------------

def test_bm25_tile_bounds_match_jax_and_a_float64_sum():
    texts, rng = _texts(7, n=3000, hot_every=0)
    jb, tb = _both(texts)
    queries = [" ".join(rng.choice(VOCAB, size=int(rng.integers(1, 6))))
               for _ in range(5)]
    po = tb._state.postings
    n_tiles = -(-3000 // 128)
    for width, st, ln in tb.encode_queries_bucketed(queries):
        got = thy._bm25_tile_bounds(po.doc_ids, po.weights, torch.from_numpy(st),
                                    torch.from_numpy(ln), n_tiles)
        jp = jb._state.postings
        want = jhy._bm25_tile_bounds(jp.doc_ids, jp.weights, jnp.asarray(st),
                                     jnp.asarray(ln), n_tiles, width)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        ref = np.zeros((len(queries), n_tiles))
        d, w = po.doc_ids.numpy(), po.weights.numpy()
        for b in range(len(queries)):
            for s0, l0 in zip(st[b], ln[b]):
                np.add.at(ref[b], d[s0:s0 + l0] // 128, w[s0:s0 + l0])
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
        # dropped past n_tiles: a narrower range keeps its own tiles' sums
        part = thy._bm25_tile_bounds(po.doc_ids, po.weights, torch.from_numpy(st),
                                     torch.from_numpy(ln), 5)
        assert torch.equal(part, got[:, :5])


# -- hybrid_sparse_topk -------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    texts = [" ".join(row) for row in rng.choice(VOCAB, size=(N, 12))]
    docs = _unit(rng, N, D)
    queries = [" ".join(rng.choice(VOCAB, size=3)) for _ in range(B)]
    return JBM25().fit(texts), BM25(device=CPU).fit(texts), docs, queries, \
        _unit(rng, B, D)


def _both_sparse(jb, tb, docs, queries, q, k, w_s, w_l, bias=None, sparse=False,
                 **kw):
    if sparse:
        jg, jhot = jb.encode_queries_sparse(queries)
        tg, thot = tb.encode_queries_sparse(queries)
    else:
        jg, jhot = jb.encode_queries_bucketed(queries), None
        tg, thot = tb.encode_queries_bucketed(queries), None
    jr = jhy.hybrid_sparse_topk(jnp.asarray(q), jnp.asarray(docs), jb._state.postings,
                                jg, k, w_s, w_l,
                                bias=None if bias is None else jnp.asarray(bias),
                                block_n=1024, hot=jhot, **kw)
    tr = thy.hybrid_sparse_topk(torch.from_numpy(q), torch.from_numpy(docs),
                                tb._state.postings, tg, k, w_s, w_l,
                                bias=None if bias is None else torch.from_numpy(bias),
                                hot=thot, **kw)
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
    return tr


def test_sparse_hybrid_minmax_matches_jax_and_oracle(corpus):
    jb, tb, docs, queries, q = corpus
    res = _both_sparse(jb, tb, docs, queries, q, K, 0.7, 0.3)
    assert _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.7, 0.3,
                                                None, K)).all()


def test_sparse_hybrid_with_tombstones_matches_jax_and_oracle(corpus):
    jb, tb, docs, queries, q = corpus
    bias = np.zeros(N, np.float32)
    dead = np.random.default_rng(12).choice(N, size=200, replace=False)
    bias[dead] = -np.inf
    res = _both_sparse(jb, tb, docs, queries, q, K, 0.6, 0.4, bias=bias)
    assert _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.6, 0.4,
                                                bias, K)).all()
    assert not np.isin(res.indices.numpy(), dead).any()


def test_sparse_hybrid_max_norm_matches_jax_and_oracle(corpus):
    jb, tb, docs, queries, q = corpus
    res = _both_sparse(jb, tb, docs, queries, q, K, 0.5, 0.5, norm="max")
    ovals, _ = _port_oracle(tb, docs, queries, q, 0.5, 0.5, None, K, norm="max")
    assert res.exact.all()
    np.testing.assert_allclose(res.values.numpy(), ovals.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_sparse_hybrid_semantic_only_matches_jax_and_oracle(corpus):
    jb, tb, docs, _queries, q = corpus
    queries = ["zzz qqq xxx"] * B
    res = _both_sparse(jb, tb, docs, queries, q, K, 0.7, 0.3)
    assert _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.7, 0.3,
                                                None, K)).all()


@pytest.mark.parametrize("budget", [dict(m_tiles=1, c_lex=8, k_dense=K),
                                    dict(m_tiles=4, c_lex=64, k_dense=32)])
def test_sparse_hybrid_starved_budget_matches_jax_exact_or_flagged(corpus, budget):
    jb, tb, docs, queries, q = corpus
    res = _both_sparse(jb, tb, docs, queries, q, K, 0.1, 0.9, **budget)
    _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.1, 0.9, None, K))


def test_sparse_hybrid_hot_terms_match_jax_and_oracle(lowered):
    texts, rng = _texts(13)
    jb, tb = _both(texts)
    assert tb._state.postings.hot_tile_bounds is not None
    docs = _unit(rng, N, D)
    queries = ["verycommon " + " ".join(rng.choice(VOCAB, size=2)) for _ in range(B)]
    q = _unit(np.random.default_rng(5), B, D)
    # a stopword-grade term inflates every tile's bound: certification needs
    # every tile as a candidate here
    res = _both_sparse(jb, tb, docs, queries, q, K, 0.7, 0.3, sparse=True,
                       k_dense=64, m_tiles=32, c_lex=512, n_alive=N)
    assert _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.7, 0.3,
                                                None, K)).all()


def test_sparse_hybrid_with_and_without_hot_tables_agree(lowered):
    """The same queries through the hot tables and through plain run
    pieces (threshold back up) give the same top-k."""
    texts, rng = _texts(14)
    tb = BM25(device=CPU).fit(texts)
    docs = _unit(rng, N, D)
    queries = ["verycommon " + " ".join(rng.choice(VOCAB, size=2)) for _ in range(B)]
    q = torch.from_numpy(_unit(np.random.default_rng(6), B, D))
    groups, hot = tb.encode_queries_sparse(queries)
    kw = dict(k_dense=64, m_tiles=32, c_lex=512)
    with_hot = thy.hybrid_sparse_topk(q, torch.from_numpy(docs), tb._state.postings,
                                      groups, K, 0.7, 0.3, hot=hot, **kw)
    plain = thy.hybrid_sparse_topk(q, torch.from_numpy(docs), tb._state.postings,
                                   tb.encode_queries_bucketed(queries), K, 0.7, 0.3,
                                   **kw)
    assert hot is not None and with_hot.exact.all() and plain.exact.all()
    _same_topk(with_hot.values.numpy(), with_hot.indices.numpy(),
               plain.values.numpy(), plain.indices.numpy())


def test_sparse_hybrid_values_sorted_and_ids_unique(corpus):
    _jb, tb, docs, queries, q = corpus
    res = thy.hybrid_sparse_topk(torch.from_numpy(q), torch.from_numpy(docs),
                                 tb._state.postings, tb.encode_queries_bucketed(queries),
                                 K, 0.7, 0.3)
    v, i = res.values.numpy(), res.indices.numpy()
    assert (np.diff(v, axis=1) <= 0).all()
    assert ((i >= -1) & (i < N)).all()
    for row in i:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("trial", range(6))
def test_sparse_hybrid_certificate_soundness_fuzz(monkeypatch, trial):
    """Wherever the port claims exact, its top-k equals its full fusion:
    random corpora, weights, budgets, hot thresholds and tombstones."""
    rng = np.random.default_rng(300 + trial)
    monkeypatch.setattr(tbm25_ops, "HOT_DF_THRESHOLD", int(rng.choice([32, 128, 65536])))
    n = int(rng.choice([512, 1024, 2048]))
    vocab = VOCAB[:int(rng.choice([50, 200, 800]))]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 14))))
             for _ in range(n)]
    tb = BM25(device=CPU).fit(texts)
    docs = _unit(rng, n, 32)
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 5))))
               for _ in range(3)]
    q = _unit(rng, 3, 32)
    w_s = float(rng.choice([0.3, 0.5, 0.7, 1.0]))
    bias, n_alive = np.zeros(n, np.float32), n
    if rng.random() < 0.5:
        bias[rng.choice(n, size=n // 10, replace=False)] = -np.inf
        n_alive -= n // 10
    groups, hot = tb.encode_queries_sparse(queries)
    res = thy.hybrid_sparse_topk(
        torch.from_numpy(q), torch.from_numpy(docs), tb._state.postings, groups, 5,
        w_s, 1.0 - w_s, bias=torch.from_numpy(bias), hot=hot, n_alive=n_alive,
        k_dense=int(rng.choice([8, 64, 256])), m_tiles=int(rng.choice([1, 4, 16])),
        c_lex=int(rng.choice([16, 128, 512])))
    ovals, _ = _port_oracle(tb, docs, queries, q, w_s, 1.0 - w_s, bias, 5)
    for b in np.nonzero(res.exact.numpy())[0]:
        np.testing.assert_allclose(res.values.numpy()[b], ovals.numpy()[b],
                                   rtol=1e-4, atol=1e-4)
