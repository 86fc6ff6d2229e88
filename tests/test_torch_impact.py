"""The port's impact-pruned lexical arm (ops/impact.py, ops/cuda_impact.py),
``hybrid_impact_topk`` and the impact ladder of ``Searcher.search_batch``
against the JAX package's, on the CPU, on the same inputs (made with
numpy from a seed; index state carried across with
``hybridsearch_tpu_torch.convert``).

Tolerances: the tier build, the query encode and the run slices are
integer or copied float32 data and must be equal. The candidate rescore
sums the same float32 weights in another order than the JAX one-hot dot
(rtol 1e-6). Fused scores rtol=1e-4, atol=1e-5 (float32 sums in another
order); ids exact except inside near-ties within the certificate margin
eps_num=1e-4 (torch and jax.lax order ties differently too); ``exact``
flags equal.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import bm25 as jbm25_ops
from hybridsearch_tpu.ops import hybrid as jhy
from hybridsearch_tpu.ops import impact as jimp
from hybridsearch_tpu.ops.pallas_impact import (
    pallas_onehot_rescore,
    pallas_slice_runs,
)
from hybridsearch_tpu.retrieval import searcher as jsm
from hybridsearch_tpu.text.extractor import HashVocabulary
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.sparse_index import BM25
from hybridsearch_tpu_torch.ops import bm25 as tbm25_ops
from hybridsearch_tpu_torch.ops import cuda_impact
from hybridsearch_tpu_torch.ops import hybrid as thy
from hybridsearch_tpu_torch.ops import impact as timp
from hybridsearch_tpu_torch.ops.fusion import max_normalize
from hybridsearch_tpu_torch.retrieval import searcher as tsm
from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

CPU = torch.device("cpu")
EPS = 1e-4
VOCAB = [f"word{i}" for i in range(1000)]
N, D, B, K = 4096, 64, 4, 10


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


def _coo(rng, V, nd, n_pairs):
    """(term, doc, weight) triples with unique (term, doc) pairs, as BM25's
    COO guarantees."""
    key = np.unique(rng.integers(0, V, n_pairs) * nd + rng.integers(0, nd, n_pairs))
    t, d = key // nd, key % nd
    w = (rng.random(len(key)) + 0.01).astype(np.float32)
    return t.astype(np.int64), d.astype(np.int64), w


def _both_tiers(t, d, w, nd, V, p_max):
    return (jimp.build_impact_postings(t, d, w, nd, V, p_max=p_max),
            timp.build_impact_postings(t, d, w, nd, V, p_max=p_max, device=CPU))


# -- build, encode, slice, rescore ----------------------------------------------

@pytest.mark.parametrize("p_max", [4, 16, 4096])
def test_build_impact_postings_matches_jax(p_max):
    rng = np.random.default_rng(0)
    V, nd = 60, 500
    t, d, w = _coo(rng, V, nd, 5000)
    w[::7] = w[3]  # ties in weight keep CSR (doc) order in both builds
    j, p = _both_tiers(t, d, w, nd, V, p_max)
    np.testing.assert_array_equal(p.doc_ids.numpy(), np.asarray(j.doc_ids))
    np.testing.assert_array_equal(p.weights.numpy(), np.asarray(j.weights))
    for name in ("starts_host", "lengths_host", "slack_host", "weights_host",
                 "df_host"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
    assert (p.n_docs, p.p_max) == (j.n_docs, j.p_max)
    ids = p.doc_ids.numpy()
    for s0, ln in zip(p.starts_host, p.lengths_host):
        run = ids[s0:s0 + ln]
        assert len(np.unique(run)) == len(run)
        assert (np.diff(p.weights.numpy()[s0:s0 + ln]) <= 0).all()


@pytest.mark.parametrize("with_hot", [False, True])
@pytest.mark.parametrize("p_depth", [4, 64])
def test_encode_impact_queries_matches_jax(with_hot, p_depth):
    rng = np.random.default_rng(1)
    V, nd = 50, 800
    # terms 0-5 are stopword-grade (df 400 > p_max), the rest small
    t_hot = np.repeat(np.arange(6), 400)
    d_hot = np.concatenate([rng.choice(nd, 400, replace=False) for _ in range(6)])
    t_small, d_small, _ = _coo(rng, V, nd, 3000)
    keep = t_small >= 6
    t = np.concatenate([t_hot, t_small[keep]]).astype(np.int64)
    d = np.concatenate([d_hot, d_small[keep]]).astype(np.int64)
    w = (rng.random(len(t)) + 0.01).astype(np.float32)
    j, p = _both_tiers(t, d, w, nd, V, p_max=128)
    df = np.bincount(t, minlength=V)
    full_starts = np.concatenate([[0], np.cumsum(df)])[:-1].astype(np.int64)
    full = dict(full_starts=full_starts, full_lengths=df.astype(np.int64)) \
        if with_hot else {}
    lists = [[0, 7, 9], [10, 11], list(range(6, 16)), [0, 1, 2, 3, 4, 5],
             list(rng.integers(0, V, 40)), [], [3, 30]]
    je = jimp.encode_impact_queries(j, lists, p_depth=p_depth, **full)
    te = timp.encode_impact_queries(p, lists, p_depth=p_depth, **full)
    for name in ("starts", "lengths", "slack"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)))
    for name in ("complete", "certifiable_deeper", "corrected_complete",
                 "full_touched"):
        np.testing.assert_array_equal(getattr(te, name), getattr(je, name))
    assert te.t_pad == je.t_pad == 32
    for name in ("hot_starts", "hot_lens", "hot_cols"):
        if with_hot:
            np.testing.assert_array_equal(getattr(te, name).numpy(),
                                          np.asarray(getattr(je, name)))
        else:
            assert getattr(te, name) is None and getattr(je, name) is None
    assert not te.complete[3] and te.complete[5]  # stopwords; the empty query


@pytest.mark.parametrize("p", [4, 64, 256])
def test_slice_impact_runs_matches_jax(p):
    rng = np.random.default_rng(2)
    V, nd = 40, 700
    t, d, w = _coo(rng, V, nd, 6000)
    j, tp = _both_tiers(t, d, w, nd, V, p_max=256)
    lists = [list(rng.integers(0, V, int(rng.integers(1, 9)))) for _ in range(5)]
    je = jimp.encode_impact_queries(j, lists, p_depth=p)
    te = timp.encode_impact_queries(tp, lists, p_depth=p)
    ji, jw = jimp.slice_impact_runs(j.doc_ids, j.weights, je.starts, je.lengths,
                                    p_depth=p, n_docs=nd + 5)
    ti, tw = timp.slice_impact_runs(tp.doc_ids, tp.weights, te.starts,
                                    te.lengths, p_depth=p, n_docs=nd + 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for ids in lists:  # the numpy oracles of the two tiers agree
        np.testing.assert_array_equal(timp.impact_scores_np(tp, ids, p),
                                      jimp.impact_scores_np(j, ids, p))


def test_slice_runs_matches_pallas_interpret():
    """Unmasked (every length >= p), K6's plain version equals the raw
    prefix copies of the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    nnz, b, t, p = 5000, 4, 8, 64
    ids = rng.integers(0, 1000, nnz + p).astype(np.int32)
    ws = rng.random(nnz + p).astype(np.float32)
    starts = rng.integers(0, nnz, (b, t)).astype(np.int32)
    oi, ow = pallas_slice_runs(jnp.asarray(ids), jnp.asarray(ws),
                               jnp.asarray(starts), p=p, align=1, interpret=True)
    ti, tw = cuda_impact.slice_runs(torch.from_numpy(ids), torch.from_numpy(ws),
                                    torch.from_numpy(starts),
                                    torch.full((b, t), p, dtype=torch.int32),
                                    p, 1000)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(oi))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(ow))


def _rescore_inputs(rng, Bq, T, p, C, nd):
    """Posting rows as the path builds them (T columns of p, a doc at most
    once per column below nd, pads (nd, 0) in column tails) and candidates
    with repeats, sentinels (nd, nd + 2) and -1."""
    ids = np.full((Bq, T, p), nd, np.int32)
    ws = np.zeros((Bq, T, p), np.float32)
    for b in range(Bq):
        for t in range(T):
            ln = int(rng.integers(0, p + 1))
            ids[b, t, :ln] = rng.choice(nd, ln, replace=False)
            ws[b, t, :ln] = rng.random(ln) + 0.01
    ids, ws = ids.reshape(Bq, T * p), ws.reshape(Bq, T * p)
    cand = rng.integers(0, nd, (Bq, C)).astype(np.int32)
    cand[:, :C // 4] = ids[:, :C // 4]  # planted hits
    cand[:, -5:] = [nd, nd + 2, -1, cand[0, 0], cand[0, 1]]
    cand[:, 1::17] = cand[:, 0:1]  # repeated candidates
    return cand, ids, ws


@pytest.mark.parametrize("Bq", [5, 8])
def test_onehot_rescore_matches_jax(Bq):
    rng = np.random.default_rng(4)
    T, p, C, nd = 8, 64, 256, 300
    cand, ids, ws = _rescore_inputs(rng, Bq, T, p, C, nd)
    got = timp.onehot_rescore(torch.from_numpy(cand), torch.from_numpy(ids),
                              torch.from_numpy(ws), p, nd).numpy()
    want = np.asarray(jimp.onehot_rescore(jnp.asarray(cand), jnp.asarray(ids),
                                          jnp.asarray(ws), bq=2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if Bq % 8 == 0:
        pal = np.asarray(pallas_onehot_rescore(
            jnp.asarray(cand), jnp.asarray(ids), jnp.asarray(ws), w_blk=512,
            interpret=True))
        np.testing.assert_allclose(got, pal, rtol=1e-6, atol=0)
    assert (got[:, -5:-2] == 0).all()  # sentinels and -1 score 0
    np.testing.assert_array_equal(got[:, 1::17], np.repeat(got[:, :1], len(got[0, 1::17]), 1))


def test_rescore_plain_adds_columns_in_order():
    """K7's contract on the CPU: the plain version's sums are the columns'
    hit weights added in order t = 0 .. T-1 (what the kernel does)."""
    rng = np.random.default_rng(5)
    T, p, C, nd = 6, 32, 64, 100
    cand, ids, ws = _rescore_inputs(rng, 3, T, p, C, nd)
    got = cuda_impact.rescore_plain(torch.from_numpy(cand), torch.from_numpy(ids),
                                    torch.from_numpy(ws), p, nd).numpy()
    for b in range(3):
        for c in range(C):
            acc = np.float32(0.0)
            for t in range(T):
                col = ids[b, t * p:(t + 1) * p]
                hit = np.nonzero((col == cand[b, c]) & (0 <= cand[b, c] < nd))[0]
                if len(hit):
                    acc = np.float32(acc + ws[b, t * p + hit[0]])
            assert got[b, c] == acc


def test_rescore_slots_and_limits():
    assert [cuda_impact.rescore_slots(c) for c in (128, 1024, 4096, 10240)] == [
        8, 11, 13, 14]
    assert cuda_impact.rescore_slots(13107) == 14
    assert cuda_impact.rescore_slots(13108) == 15


def test_cand_scores_bisect_matches_jax():
    rng = np.random.default_rng(6)
    V, nd = 20, 3000
    t, d, w = _coo(rng, V, nd, 20000)
    order = np.lexsort((d, t))
    t, d, w = t[order], d[order], w[order]
    df = np.bincount(t, minlength=V)
    st = np.concatenate([[0], np.cumsum(df)])[:-1]
    hs = np.zeros((4, 4), np.int32)
    hl = np.zeros((4, 4), np.int32)
    for b in range(4):
        for h in range(int(rng.integers(1, 5))):
            tid = int(rng.integers(0, V))
            hs[b, h], hl[b, h] = st[tid], df[tid]
    cand = rng.integers(0, nd + 3, (4, 128)).astype(np.int32)
    cand[:, :20] = d[:20]
    got = tbm25_ops.cand_scores_bisect(
        torch.from_numpy(d.astype(np.int32)), torch.from_numpy(w),
        torch.from_numpy(hs), torch.from_numpy(hl), torch.from_numpy(cand)).numpy()
    want = np.asarray(jbm25_ops.cand_scores_bisect(
        jnp.asarray(d.astype(np.int32)), jnp.asarray(w), jnp.asarray(hs),
        jnp.asarray(hl), jnp.asarray(cand)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got > 0).any()


# -- hybrid_impact_topk against JAX and the full-fusion oracle -----------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    texts = [" ".join(row) for row in rng.choice(VOCAB, size=(N, 12))]
    docs = _unit(rng, N, D)
    queries = [" ".join(rng.choice(VOCAB, size=3)) for _ in range(B)]
    q = _unit(rng, B, D)
    return JBM25().fit(texts), BM25(device=CPU).fit(texts), docs, queries, q


def _port_oracle(tb, docs, queries, q, w_s, w_l, bias, k, norm="minmax"):
    """Full [B, n] fusion with the port's plain ops: the exact answer."""
    po = tb._state.postings
    n = docs.shape[0]
    lex = tbm25_ops.local_bucketed_scores(po.doc_ids, po.weights,
                                          tb.encode_queries_bucketed(queries), n,
                                          len(queries))
    sem = torch.from_numpy(q) @ torch.from_numpy(docs).T
    bias_t = torch.zeros(n) if bias is None else torch.from_numpy(bias)
    if norm == "max":
        fused = max_normalize(sem) * w_s + max_normalize(lex) * w_l
        return torch.topk(fused, k, dim=1)
    return tsm._fuse_and_topk(sem, lex, w_s, w_l, bias_t, k)


def _both_hybrids(jb, tb, docs, queries, q, k, w_s, w_l, bias=None, p_max=4096,
                  enc_depth=None, **kw):
    pd = kw["p_depth"] if enc_depth is None else enc_depth
    jimp_, jenc = jb.encode_queries_impact(queries, p_depth=pd, p_max=p_max)
    timp_, tenc = tb.encode_queries_impact(queries, p_depth=pd, p_max=p_max)
    jr = jhy.hybrid_impact_topk(jnp.asarray(q), jnp.asarray(docs), jimp_, jenc, k,
                                w_s, w_l, bias=None if bias is None
                                else jnp.asarray(bias), block_n=1024, **kw)
    tr = thy.hybrid_impact_topk(torch.from_numpy(q), torch.from_numpy(docs), timp_,
                                tenc, k, w_s, w_l, bias=None if bias is None
                                else torch.from_numpy(bias), **kw)
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
    return tr, tenc


def _check_exact_rows(res, ovals, oidx):
    ex = res.exact.numpy()
    for b in np.nonzero(ex)[0]:
        _same_topk(res.values.numpy()[b:b + 1], res.indices.numpy()[b:b + 1],
                   ovals.numpy()[b:b + 1], oidx.numpy()[b:b + 1])
    return ex


def test_hybrid_minmax_matches_jax_and_oracle(corpus):
    jb, tb, docs, queries, q = corpus
    res, _ = _both_hybrids(jb, tb, docs, queries, q, K, 0.7, 0.3, k_dense=512,
                           c_per_term=64, p_depth=256)
    assert _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.7, 0.3,
                                                None, K)).all()


def test_hybrid_with_tombstones_matches_jax_and_oracle(corpus):
    jb, tb, docs, queries, q = corpus
    rng = np.random.default_rng(8)
    bias = np.zeros(N, np.float32)
    dead = rng.choice(N, size=200, replace=False)
    bias[dead] = -np.inf
    res, _ = _both_hybrids(jb, tb, docs, queries, q, K, 0.6, 0.4, bias=bias,
                           k_dense=512, c_per_term=64, p_depth=256,
                           n_alive=N - 200)
    assert _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.6, 0.4,
                                                bias, K)).all()
    assert not np.isin(res.indices.numpy(), dead).any()


def test_hybrid_max_norm_matches_jax_and_oracle(corpus):
    jb, tb, docs, queries, q = corpus
    res, _ = _both_hybrids(jb, tb, docs, queries, q, K, 0.5, 0.5, norm="max",
                           k_dense=512, c_per_term=64, p_depth=256)
    ovals, _ = _port_oracle(tb, docs, queries, q, 0.5, 0.5, None, K, norm="max")
    assert res.exact.all()
    np.testing.assert_allclose(res.values.numpy(), ovals.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_hybrid_semantic_only_matches_jax_and_oracle(corpus):
    jb, tb, docs, _queries, q = corpus
    queries = ["zzz qqq xxx"] * B
    res, _ = _both_hybrids(jb, tb, docs, queries, q, K, 0.7, 0.3, k_dense=512,
                           c_per_term=64, p_depth=256)
    assert _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.7, 0.3,
                                                None, K)).all()


@pytest.mark.parametrize("kd_tiles", [4, 64])
def test_hybrid_probe_tile_budget_matches_jax_and_oracle(corpus, kd_tiles):
    """kd_tiles bounds the dense arm's pass 3; its coverage flag gates the
    certificate."""
    jb, tb, docs, queries, q = corpus
    res, _ = _both_hybrids(jb, tb, docs, queries, q, K, 0.7, 0.3, k_dense=512,
                           c_per_term=64, p_depth=256, kd_tiles=kd_tiles)
    _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.7, 0.3, None, K))


def test_hybrid_shallow_slice_never_claims_exact(corpus):
    jb, tb, docs, queries, q = corpus
    res, tenc = _both_hybrids(jb, tb, docs, queries, q, K, 0.7, 0.3, k_dense=512,
                              c_per_term=1, p_depth=1, enc_depth=256)
    deep = (tenc.lengths > 1).any(dim=1).numpy()
    assert deep.any() and not res.exact.numpy()[deep].any()


def test_hybrid_starved_budget_exact_or_flagged(corpus):
    jb, tb, docs, queries, q = corpus
    res, _ = _both_hybrids(jb, tb, docs, queries, q, K, 0.1, 0.9, k_dense=K,
                           c_per_term=8, p_depth=256)
    _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.1, 0.9, None, K))


def _hot_corpus(seed, frac, n=2048, nq=4):
    rng = np.random.default_rng(seed)
    toks = rng.choice(VOCAB, size=(n, 10))
    texts = [" ".join(r) + (" common" if rng.random() < frac else "") for r in toks]
    docs = _unit(rng, n, D)
    queries = ["common " + " ".join(rng.choice(VOCAB, size=3)) for _ in range(nq)]
    return JBM25().fit(texts), BM25(device=CPU).fit(texts), docs, queries, \
        _unit(rng, nq, D)


def test_hybrid_margin_correction_matches_jax_and_oracle():
    """'common' is in every doc: the tier truncates it hard; the margin
    correction must still give the full-fusion values, never claimed
    exact (the true lexical min is not provably 0)."""
    jb, tb, docs, queries, q = _hot_corpus(9, 1.0)
    res, tenc = _both_hybrids(jb, tb, docs, queries, q, K, 0.5, 0.5, p_max=256,
                              k_dense=512, c_per_term=64, p_depth=256)
    assert tenc.hot_starts is not None
    ovals, _ = _port_oracle(tb, docs, queries, q, 0.5, 0.5, None, K)
    np.testing.assert_allclose(res.values.numpy(), ovals.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert not res.exact.numpy().any()


def test_hybrid_margin_certificate_closes_like_jax():
    jb, tb, docs, queries, q = _hot_corpus(424, 0.8, nq=6)
    res, tenc = _both_hybrids(jb, tb, docs, queries, q, K, 0.5, 0.5, p_max=256,
                              k_dense=1024, c_per_term=64, p_depth=256,
                              margin=256)
    assert not tenc.complete.any() and tenc.corrected_complete.all()
    ex = _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.5, 0.5,
                                              None, K))
    assert ex.mean() >= 0.5


def test_hybrid_full_postings_keyword_matches_jax():
    """``full_postings=`` passed explicitly on an enc that lacks the pair
    gives what JAX gives with the same keyword, and what the port gives
    with the pair on the enc."""
    jb, tb, docs, queries, q = _hot_corpus(9, 1.0)
    jimp_, jenc = jb.encode_queries_impact(queries, p_depth=256, p_max=256)
    timp_, tenc = tb.encode_queries_impact(queries, p_depth=256, p_max=256)
    assert tenc.hot_starts is not None and tenc.full_postings is not None
    jpair, tpair = jenc.full_postings, tenc.full_postings
    kw = dict(k_dense=512, c_per_term=64, p_depth=256)
    jr = jhy.hybrid_impact_topk(jnp.asarray(q), jnp.asarray(docs), jimp_,
                                jenc._replace(full_postings=None), K, 0.5, 0.5,
                                block_n=1024, full_postings=jpair, **kw)
    tr = thy.hybrid_impact_topk(torch.from_numpy(q), torch.from_numpy(docs), timp_,
                                tenc._replace(full_postings=None), K, 0.5, 0.5,
                                full_postings=tpair, **kw)
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
    on_enc = thy.hybrid_impact_topk(torch.from_numpy(q), torch.from_numpy(docs),
                                    timp_, tenc, K, 0.5, 0.5, **kw)
    for a, b in zip(tr, on_enc):
        assert torch.equal(a, b)
    # without the pair there is no margin correction: other values
    bare = thy.hybrid_impact_topk(torch.from_numpy(q), torch.from_numpy(docs), timp_,
                                  tenc._replace(full_postings=None), K, 0.5, 0.5, **kw)
    assert not torch.equal(bare.values, tr.values)


@pytest.mark.parametrize("trial", range(8))
def test_certificate_soundness_fuzz(trial):
    """Wherever the port claims exact, its top-k equals the port's own full
    [B, n] fusion, over random corpora, weights, budgets, prune depths and
    tombstones."""
    rng = np.random.default_rng(77 + trial)
    n = int(rng.choice([512, 1024, 2048]))
    n_vocab = int(rng.choice([50, 200, 800]))
    vocab = [f"t{i}" for i in range(n_vocab)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 14))))
             for _ in range(n)]
    tb = BM25(device=CPU).fit(texts)
    docs = _unit(rng, n, 32)
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 5))))
               for _ in range(3)]
    q = _unit(rng, 3, 32)
    w_s = float(rng.choice([0.3, 0.5, 0.7, 1.0]))
    kd = int(rng.choice([8, 64, 512]))
    cp = int(rng.choice([4, 16, 64]))
    pd = int(rng.choice(timp.IMPACT_P_LADDER[:2]))
    p_max = int(rng.choice([16, 256, 4096]))
    bias = np.zeros(n, np.float32)
    n_alive = n
    if rng.random() < 0.5:
        bias[rng.choice(n, size=n // 10, replace=False)] = -np.inf
        n_alive -= n // 10
    imp, enc = tb.encode_queries_impact(queries, p_depth=pd, p_max=p_max)
    if rng.random() < 0.5:
        enc = enc._replace(full_postings=None)
    res = thy.hybrid_impact_topk(torch.from_numpy(q), torch.from_numpy(docs), imp,
                                 enc, 5, w_s, 1.0 - w_s,
                                 bias=torch.from_numpy(bias), k_dense=kd,
                                 c_per_term=cp, p_depth=pd, n_alive=n_alive)
    ovals, _ = _port_oracle(tb, docs, queries, q, w_s, 1.0 - w_s, bias, 5)
    for b in np.nonzero(res.exact.numpy())[0]:
        np.testing.assert_allclose(res.values.numpy()[b], ovals.numpy()[b],
                                   rtol=1e-4, atol=1e-4)


def test_rescore_columns_hold_each_doc_once():
    """K7 needs no atomics because a column (one term slot's slice) names a
    doc below n_docs at most once: checked on real slices of a fitted
    tier, at every ladder depth, with hot-term queries."""
    jb, tb, docs, queries, q = _hot_corpus(10, 0.9, nq=6)
    for pd in timp.IMPACT_P_LADDER:
        imp, enc = tb.encode_queries_impact(queries + ["word1 word2 common"],
                                            p_depth=pd, p_max=256)
        ids, _ws = timp.slice_impact_runs(imp.doc_ids, imp.weights, enc.starts,
                                          enc.lengths, min(pd, imp.p_max),
                                          docs.shape[0])
        for col in ids.reshape(-1, ids.shape[-1]).numpy():
            real = col[col < docs.shape[0]]
            assert len(np.unique(real)) == len(real)


# -- search_batch on a layout="source" corpus -------------------------------------

def _source_pair(texts, dim):
    js = jsm.Searcher(encoder=JEnc(dim=dim), use_query_memory=False,
                      config=JConfig())
    js.indexer.index_documents(texts)
    snap, st = js.indexer.dense._snap, js.indexer.bm25._state
    po = st.postings
    vocab = (np.asarray(st.vocab.id_to_hash, np.uint64)
             if isinstance(st.vocab, HashVocabulary) else st.vocab.id_to_token)
    cfg = EngineConfig()
    cfg.index.dim = dim
    assert cfg.index.layout == "source"
    idx = convert.indexer(
        js.indexer.contents,
        convert.hashing_encoder(np.asarray(js.indexer.encoder.table), device=CPU),
        convert.dense_index(np.asarray(snap.docs), np.asarray(snap.bias), snap.n,
                            device=CPU),
        convert.bm25_index(vocab, np.asarray(po.indptr), np.asarray(po.doc_ids),
                           np.asarray(po.weights), po.n_docs, device=CPU),
        config=cfg)
    return js, tsm.Searcher(indexer=idx, use_query_memory=False, config=cfg)


@pytest.fixture(scope="module")
def source_pair():
    rng = np.random.default_rng(11)
    vocab = [f"w{i}" for i in range(400)]
    topics = [[f"z{z}t{j}" for j in range(10)] for z in range(20)]
    texts = [" ".join(list(rng.choice(topics[i % 20], 4)) + list(rng.choice(vocab, 8))
                      + (["common"] if i % 3 else []))
             for i in range(3000)]
    queries = ([" ".join(rng.choice(topics[z], 2)) for z in range(12)]
               + [f"common {vocab[i]} {vocab[i + 7]}" for i in range(6)]
               + ["nothing matches", "w1 w2 w3 w4 w5 w6 w7 w8 w9 w10"])
    js, ts = _source_pair(texts, dim=64)
    return js, ts, queries


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        _same_topk([[v for v, _c, _i in g]], [[i for _v, _c, i in g]],
                   [[v for v, _c, _i in w]], [[i for _v, _c, i in w]])


def _record_rungs(monkeypatch):
    """Batch size of every hybrid_impact_topk call, per package."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", jhy), ("torch", thy)):
        real = mod.hybrid_impact_topk
        monkeypatch.setattr(
            mod, "hybrid_impact_topk",
            lambda q, *a, _r=real, _k=key, **kw: seen[_k].append(q.shape[0])
            or _r(q, *a, **kw))
    return seen


def test_search_batch_source_layout_takes_the_impact_ladder_like_jax(
        source_pair, monkeypatch):
    js, ts, queries = source_pair
    monkeypatch.setattr(jsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    seen = _record_rungs(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = js.search_batch(queries, top_k=5, log=False)
        got = ts.search_batch(queries, top_k=5, log=False)
    assert seen["torch"] and seen["torch"] == seen["jax"]
    _same_results(got, want)
    # and where everything certified, the full fused route agrees
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 10**9)
    _same_results(got, ts.search_batch(queries, top_k=5, log=False))


def test_impact_ladder_escalates_and_compacts_like_jax(source_pair, monkeypatch):
    """A starved first rung forces escalation; with a small bucket floor the
    uncertified tail re-runs compacted, in both packages alike."""
    js, ts, queries = source_pair
    ladder = ((16, 2, 256), (256, 16, 1024), (1024, 64, 4096))
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "SPARSE_HYBRID_MIN_DOCS", 100)
        monkeypatch.setattr(mod, "_IMPACT_LADDER", ladder)
        monkeypatch.setattr(mod, "_MIN_ESCALATION_BUCKET", 2)
    seen = _record_rungs(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = js.search_batch(queries, top_k=5, log=False)
        got = ts.search_batch(queries, top_k=5, log=False)
    assert seen["torch"] == seen["jax"], seen
    assert len(seen["torch"]) > 1 and min(seen["torch"][1:]) < len(queries)
    _same_results(got, want)


def test_search_batch_uncertified_counter_increments(source_pair, monkeypatch):
    _js, ts, _queries = source_pair
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "_IMPACT_LADDER", ((10, 1, 256),))
    before = GLOBAL_COUNTERS.get("hybrid_sparse_uncertified")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = ts.search_batch(["w3 w9 w27", "common w5", "z1t1 w2", "w8"],
                              top_k=5, log=False)
    assert GLOBAL_COUNTERS.get("hybrid_sparse_uncertified") > before
    assert all(len(r) == 5 for r in res)


def test_carried_impact_postings_equal_the_ports_own_build(source_pair):
    js, ts, _queries = source_pair
    j = js.indexer.bm25.impact_postings(p_max=256)
    carried = convert.impact_postings(
        np.asarray(j.doc_ids), np.asarray(j.weights), j.n_docs, j.p_max,
        j.starts_host, j.lengths_host, j.slack_host, j.weights_host, j.df_host,
        device=CPU)
    own = ts.indexer.bm25.impact_postings(p_max=256)
    assert torch.equal(carried.doc_ids, own.doc_ids)
    assert torch.equal(carried.weights, own.weights)
    for name in ("starts_host", "lengths_host", "slack_host", "weights_host",
                 "df_host"):
        np.testing.assert_array_equal(getattr(carried, name), getattr(own, name))
    assert (carried.n_docs, carried.p_max) == (own.n_docs, own.p_max)
    bm = ts.indexer.bm25
    convert.attach_impact_postings(bm, carried)
    assert bm.impact_postings(p_max=128) is carried
    deeper = bm.impact_postings(p_max=2 * carried.p_max)  # rebuilt
    assert deeper is not carried and deeper.p_max == 2 * carried.p_max
