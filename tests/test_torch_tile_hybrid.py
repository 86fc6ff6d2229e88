"""The port's clustered routes against the JAX package's, on the CPU, on the
same inputs (made with numpy from a seed; index state carried across with
``hybridsearch_tpu_torch.convert``): ``hybrid_tile_topk`` and the tile
ladder (``HST_SUPER_HYBRID=0``), the one-call ``hybrid_supertile_topk``,
``hybrid_impact_topk(kd_tiles=128)`` and the impact ladder on a clustered
index (both gates ``0``).

Tolerances (as tests/test_torch_impact.py): fused values rtol=1e-4,
atol=1e-5 (float32 sums in another order); ids equal except inside
near-ties within the certificate margin eps_num=1e-4 (torch and jax.lax
order exact ties differently too); ``exact`` flags equal. Certified rows
are also held to the port's own full [B, n] fusion.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import dense as jdense
from hybridsearch_tpu.ops import hybrid as jhy
from hybridsearch_tpu.ops import supertile as jst
from hybridsearch_tpu.retrieval import searcher as jsm
from hybridsearch_tpu.text.extractor import HashVocabulary
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.sparse_index import BM25
from hybridsearch_tpu_torch.ops import bm25 as tbm25_ops
from hybridsearch_tpu_torch.ops import dense as tdense
from hybridsearch_tpu_torch.ops import hybrid as thy
from hybridsearch_tpu_torch.ops import supertile as tst
from hybridsearch_tpu_torch.retrieval import searcher as tsm

CPU = torch.device("cpu")
EPS = 1e-4
VOCAB = [f"word{i}" for i in range(600)]


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


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port_oracle(tb, docs, queries, q, w_s, w_l, bias, k):
    """Full [B, n] min-max fusion with the port's plain ops."""
    po = tb._state.postings
    n = docs.shape[0]
    lex = tbm25_ops.local_bucketed_scores(po.doc_ids, po.weights,
                                          tb.encode_queries_bucketed(queries), n,
                                          len(queries))
    sem = torch.from_numpy(q) @ torch.from_numpy(docs).T
    bias_t = torch.zeros(n) if bias is None else torch.from_numpy(bias)
    return tsm._fuse_and_topk(sem, lex, w_s, w_l, bias_t, k)


def _check_exact_rows(res, ovals, oidx):
    ex = res.exact.numpy()
    for b in np.nonzero(ex)[0]:
        _same_topk(res.values.numpy()[b:b + 1], res.indices.numpy()[b:b + 1],
                   ovals.numpy()[b:b + 1], oidx.numpy()[b:b + 1])
    return ex


def _corpus(seed, n, n_vocab=None, nq=4, d=32, common=0.0):
    """Texts over a word vocabulary (``common``: the share of docs that also
    hold the word "common"), unit doc rows and queries."""
    rng = np.random.default_rng(seed)
    vocab = VOCAB[:n_vocab] if n_vocab else VOCAB
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 14))))
             + (" common" if rng.random() < common else "") for _ in range(n)]
    queries = [("common " if common else "")
               + " ".join(rng.choice(vocab, size=int(rng.integers(1, 4))))
               for _ in range(nq)]
    return (JBM25().fit(texts), BM25(device=CPU).fit(texts), _unit(rng, n, d),
            queries, _unit(rng, nq, d))


def _both_tiles(jb, tb, docs, queries, q, k, w_s, w_l, bias=None, p_max=4096,
                p_depth=1024, n_alive=None, **kw):
    jimp, jenc = jb.encode_queries_impact(queries, p_depth=p_depth, p_max=p_max)
    timp, tenc = tb.encode_queries_impact(queries, p_depth=p_depth, p_max=p_max)
    jr = jhy.hybrid_tile_topk(jnp.asarray(q), jnp.asarray(docs), jimp, jenc, k,
                              w_s, w_l, bias=None if bias is None else jnp.asarray(bias),
                              p_depth=p_depth, n_alive=n_alive, block_n=1024, **kw)
    tr = thy.hybrid_tile_topk(torch.from_numpy(q), torch.from_numpy(docs), timp,
                              tenc, k, w_s, w_l,
                              bias=None if bias is None else torch.from_numpy(bias),
                              p_depth=p_depth, n_alive=n_alive, **kw)
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
    return tr, tenc


# -- hybrid_tile_topk -------------------------------------------------------------

def test_tile_hybrid_full_coverage_matches_jax_and_oracle():
    """p_depth covers every df and kt every tile: every query certifies."""
    jb, tb, docs, queries, q = _corpus(0, 2048, n_vocab=120)
    res, _ = _both_tiles(jb, tb, docs, queries, q, 5, 0.7, 0.3, kt=64, p_depth=4096)
    assert res.exact.all()
    ovals, oidx = _port_oracle(tb, docs, queries, q, 0.7, 0.3, None, 5)
    _check_exact_rows(res, ovals, oidx)


@pytest.mark.parametrize("kt", [2, 8, 32])
def test_tile_hybrid_probe_budgets_match_jax_and_oracle(kt):
    jb, tb, docs, queries, q = _corpus(1, 4096, nq=6)
    res, _ = _both_tiles(jb, tb, docs, queries, q, 10, 0.7, 0.3, kt=kt, p_depth=256)
    _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.7, 0.3, None, 10))


def test_tile_hybrid_tombstones_match_jax_and_are_never_returned():
    jb, tb, docs, queries, q = _corpus(2, 1024, n_vocab=80, nq=3)
    rng = np.random.default_rng(20)
    bias = np.zeros(1024, np.float32)
    dead = rng.choice(1024, size=256, replace=False)
    bias[dead] = -np.inf
    res, _ = _both_tiles(jb, tb, docs, queries, q, 10, 0.6, 0.4, bias=bias, kt=16,
                         n_alive=1024 - 256)
    ri = res.indices.numpy()
    assert not np.isin(ri[ri >= 0], dead).any()
    _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.6, 0.4, bias, 10))


def test_tile_hybrid_max_norm_matches_jax():
    jb, tb, docs, queries, q = _corpus(3, 2048, nq=4)
    _both_tiles(jb, tb, docs, queries, q, 10, 0.5, 0.5, kt=8, norm="max")


def test_tile_hybrid_margin_correction_matches_jax():
    """'common' is in most docs and the tier truncates it at p_max=256: the
    cushion's lexical scores are corrected by bisecting its full run."""
    jb, tb, docs, queries, q = _corpus(4, 2048, nq=6, common=0.8)
    res, tenc = _both_tiles(jb, tb, docs, queries, q, 10, 0.5, 0.5, p_max=256,
                            p_depth=256, kt=8, margin=256)
    assert tenc.hot_starts is not None and not tenc.complete.any()
    _check_exact_rows(res, *_port_oracle(tb, docs, queries, q, 0.5, 0.5, None, 10))


@pytest.mark.parametrize("trial", range(6))
def test_tile_hybrid_certificate_soundness_fuzz(trial):
    """Wherever the port claims exact, its top-k equals the port's full
    fusion: random corpora, weights, budgets, depths, margins, tombstones."""
    rng = np.random.default_rng(1234 + trial)
    n = int(rng.choice([512, 1024, 3000]))
    n_vocab = int(rng.choice([50, 300]))
    jb_unused, tb, docs, queries, q = _corpus(50 + trial, n, n_vocab=n_vocab, nq=3)
    del jb_unused
    w_s = float(rng.choice([0.3, 0.7, 1.0]))
    kt, pd = int(rng.choice([2, 8, 64])), int(rng.choice([64, 1024]))
    p_max, margin = int(rng.choice([256, 4096])), int(rng.choice([16, 128]))
    bias, n_alive = None, n
    if rng.random() < 0.5:
        bias = np.zeros(n, np.float32)
        bias[rng.choice(n, size=n // 10, replace=False)] = -np.inf
        n_alive -= n // 10
    imp, enc = tb.encode_queries_impact(queries, p_depth=pd, p_max=p_max)
    res = thy.hybrid_tile_topk(torch.from_numpy(q), torch.from_numpy(docs), imp, enc,
                               5, w_s, 1.0 - w_s,
                               bias=None if bias is None else torch.from_numpy(bias),
                               kt=kt, p_depth=pd, margin=margin, n_alive=n_alive)
    ovals, _ = _port_oracle(tb, docs, queries, q, w_s, 1.0 - w_s, bias, 5)
    for b in np.nonzero(res.exact.numpy())[0]:
        np.testing.assert_allclose(res.values.numpy()[b], ovals.numpy()[b],
                                   rtol=1e-4, atol=1e-4)


# -- the one-call supertile entry ---------------------------------------------------

@pytest.fixture(scope="module")
def super_pair():
    rng = np.random.default_rng(6)
    vocab = [f"t{i}" for i in range(80)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 14))))
             for _ in range(3000)]
    jb, tb = JBM25().fit(texts), BM25(device=CPU).fit(texts)
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 5))))
               for _ in range(7)]
    return (jb, jb.super_postings(super_tiles=4), tb, tb.super_postings(super_tiles=4),
            queries, _unit(rng, 3000, 32), _unit(rng, 7, 32))


@pytest.mark.parametrize("s_probe", [2, 4])
@pytest.mark.parametrize("with_bias", [False, True])
def test_supertile_one_call_matches_jax_and_the_ports_prefix_and_rung(
        super_pair, s_probe, with_bias):
    jb, jsp, tb, tsp, queries, docs, q = super_pair
    n = docs.shape[0]
    bias = None
    if with_bias:
        bias = np.zeros(n, np.float32)
        bias[np.random.default_rng(7).choice(n, size=300, replace=False)] = -np.inf
    lists = [jb._state.vocab.encode(x.split()) for x in queries]
    jenc, tenc = jst.encode_super_queries(jsp, lists), tst.encode_super_queries(tsp, lists)
    jb_ = None if bias is None else jnp.asarray(bias)
    tb_ = None if bias is None else torch.from_numpy(bias)
    jr, jprobes = jst.hybrid_supertile_topk(
        jnp.asarray(q), jnp.asarray(docs), jsp, jenc, 5, 0.7, 0.3, bias=jb_,
        s_probe=s_probe, block_n=1024, return_probes=True)
    tq, td = torch.from_numpy(q), torch.from_numpy(docs)
    tr, tprobes = tst.hybrid_supertile_topk(tq, td, tsp, tenc, 5, 0.7, 0.3, bias=tb_,
                                            s_probe=s_probe, return_probes=True)
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
    np.testing.assert_array_equal(tprobes.numpy(), np.asarray(jprobes))
    assert (np.diff(tprobes.numpy(), axis=1) > 0).all()  # ascending, distinct
    pfx = tst.super_prefix(tq, td, tsp, tenc, bias=tb_, s_max=s_probe)
    rung = tst.hybrid_supertile_topk_rung(tq, td, tsp, tenc, pfx, 5, 0.7, 0.3,
                                          bias=tb_, s_probe=s_probe)
    for a, b in zip(tr, rung):
        assert torch.equal(a, b)
    assert isinstance(tst.hybrid_supertile_topk(tq, td, tsp, tenc, 5, 0.7, 0.3,
                                                bias=tb_, s_probe=s_probe),
                      thy.HybridTopK)
    if tr.exact.any():
        lex = tbm25_ops.local_bucketed_scores(
            tb._state.postings.doc_ids, tb._state.postings.weights,
            tb.encode_queries_bucketed(queries), n, len(queries))
        ovals, oidx = tsm._fuse_and_topk(tq @ td.T, lex, 0.7, 0.3,
                                         torch.zeros(n) if tb_ is None else tb_, 5)
        _check_exact_rows(tr, ovals, oidx)


def test_supertile_one_call_levers_equal_the_default(super_pair, monkeypatch):
    """scores_dedup / place_fused take their kernel routes (plain versions
    here) and give the default's bits."""
    _jb, _jsp, tb, tsp, queries, docs, q = super_pair
    lists = [tb._state.vocab.encode(x.split()) for x in queries]
    tenc = tst.encode_super_queries(tsp, lists)
    tq, td = torch.from_numpy(q), torch.from_numpy(docs)
    base = tst.hybrid_supertile_topk(tq, td, tsp, tenc, 5, 0.7, 0.3, s_probe=4)
    lev = tst.hybrid_supertile_topk(tq, td, tsp, tenc, 5, 0.7, 0.3, s_probe=4,
                                    scores_dedup=True, place_fused=True)
    for a, b in zip(base, lev):
        assert torch.equal(a, b)


# -- hybrid_impact_topk(kd_tiles=128) -----------------------------------------------

@pytest.fixture(scope="module")
def wide_corpus():
    """20,480 docs: 160 tiles, so a 128-tile budget binds pass 3."""
    return _corpus(8, 20480, nq=4, d=32)


def test_dense_probe_budget_of_128_tiles_matches_jax(wide_corpus):
    _jb, _tb, docs, _queries, q = wide_corpus
    jv, ji, jmin, jmax, jcov = jdense.tiled_dense_topk(
        jnp.asarray(q), jnp.asarray(docs), 512, block_n=4096, with_stats=True,
        probe_tiles=128)
    tv, ti, tmin, tmax, tcov = tdense.tiled_dense_topk(
        torch.from_numpy(q), torch.from_numpy(docs), 512, with_stats=True,
        probe_tiles=128)
    _same_topk(tv.numpy(), ti.numpy(), jv, ji)
    np.testing.assert_allclose(tmin.numpy(), np.asarray(jmin), rtol=1e-6)
    np.testing.assert_allclose(tmax.numpy(), np.asarray(jmax), rtol=1e-6)
    np.testing.assert_array_equal(tcov.numpy(), np.asarray(jcov))


def test_impact_hybrid_kd_tiles_128_matches_jax_and_oracle(wide_corpus):
    jb, tb, docs, queries, q = wide_corpus
    kw = dict(k_dense=512, c_per_term=64, p_depth=256, kd_tiles=128)
    jimp, jenc = jb.encode_queries_impact(queries, p_depth=256)
    timp, tenc = tb.encode_queries_impact(queries, p_depth=256)
    jr = jhy.hybrid_impact_topk(jnp.asarray(q), jnp.asarray(docs), jimp, jenc, 10,
                                0.7, 0.3, block_n=4096, **kw)
    tr = thy.hybrid_impact_topk(torch.from_numpy(q), torch.from_numpy(docs), timp,
                                tenc, 10, 0.7, 0.3, **kw)
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
    _check_exact_rows(tr, *_port_oracle(tb, docs, queries, q, 0.7, 0.3, None, 10))


# -- search_batch under the two gates ------------------------------------------------

def _carry(js):
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
        convert.hashing_encoder(np.asarray(js.indexer.encoder.table), device=CPU),
        convert.dense_index(np.asarray(snap.docs), np.asarray(snap.bias), snap.n,
                            device=CPU),
        convert.bm25_index(vocab, np.asarray(po.indptr), np.asarray(po.doc_ids),
                           np.asarray(po.weights), po.n_docs, device=CPU),
        config=cfg)
    return tsm.Searcher(indexer=idx, use_query_memory=False, config=cfg)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(9)
    vocab = [f"w{i}" for i in range(400)]
    topics = [[f"z{z}t{j}" for j in range(10)] for z in range(20)]
    texts = [" ".join(list(rng.choice(topics[i % 20], 4)) + list(rng.choice(vocab, 8))
                      + (["common"] if i % 3 else []))
             for i in range(3000)]
    queries = ([" ".join(rng.choice(topics[z], 2)) for z in range(12)]
               + [f"common {vocab[i]} {vocab[i + 7]}" for i in range(6)]
               + ["nothing matches", "w1 w2 w3 w4 w5 w6 w7 w8 w9 w10"])
    cfg = JConfig()
    cfg.index.layout = "clustered"
    js = jsm.Searcher(encoder=JEnc(dim=64), use_query_memory=False, config=cfg)
    js.indexer.index_documents(texts)
    return js, _carry(js), queries


def _record(monkeypatch, mods, name):
    """Batch size (and keywords) of every call of ``name``, per package."""
    seen = {"jax": [], "torch": []}
    for key, mod in zip(("jax", "torch"), mods):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda q, *a, _r=real, _k=key, **kw: seen[_k].append(
                (q.shape[0], kw.get("kt"), kw.get("kd_tiles"))) or _r(q, *a, **kw))
    return seen


def _served(js, ts, queries):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (js.search_batch(queries, top_k=5, log=False),
                ts.search_batch(queries, top_k=5, log=False))


NO_TERMS = "nothing matches"  # no term of the corpus: an all-zero lexical arm


def _same_as_jax_tile_route(got, want, queries, w_l=0.3):
    """Rows equal to the JAX tile route's, except a query with no term of
    the corpus: there the port gives full fusion's values, w_l above JAX's
    (R8), on the same ids."""
    for g, w, x in zip(got, want, queries):
        if x == NO_TERMS:
            assert [i for *_y, i in g] == [i for *_y, i in w]
            w = [(v + w_l, c, i) for v, c, i in w]
        _same_results([g], [w])


def test_search_batch_tile_gate_takes_the_tile_ladder_like_jax(pair, monkeypatch):
    js, ts, queries = pair
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setenv("HST_SUPER_HYBRID", "0")
    seen = _record(monkeypatch, (jhy, thy), "hybrid_tile_topk")
    want, got = _served(js, ts, queries)
    assert seen["torch"] and seen["torch"] == seen["jax"], seen
    assert seen["torch"][0][1] == tsm._TILE_LADDER[0]
    _same_as_jax_tile_route(got, want, queries)
    # every query certified: the full fused route agrees, values too
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 10**9)
    _same_results(got, ts.search_batch(queries, top_k=5, log=False))


def test_tile_route_normalizes_an_all_zero_lexical_arm_to_ones(pair, monkeypatch):
    """R8: a query with no term of the corpus. Full fusion min-max-normalizes
    its all-zero lexical arm to ones, so every doc gains w_l; the JAX tile
    route adds 0 (the same ids, values w_l lower). The port's tile route
    gives the full fusion's values."""
    js, ts, _queries = pair
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setenv("HST_SUPER_HYBRID", "0")
    want, got = _served(js, ts, [NO_TERMS])
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 10**9)
    full = ts.search_batch([NO_TERMS], top_k=5, log=False)
    _same_results(got, full)
    assert [i for *_x, i in got[0]] == [i for *_x, i in want[0]]
    np.testing.assert_allclose([v for v, *_x in got[0]],
                               [v + 0.3 for v, *_x in want[0]], rtol=1e-5)


def test_tile_ladder_escalates_and_compacts_like_jax(pair, monkeypatch):
    """Small probe budgets force escalation; with a small bucket floor the
    uncertified tail re-runs compacted, in both packages alike."""
    js, ts, queries = pair
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "SPARSE_HYBRID_MIN_DOCS", 100)
        monkeypatch.setattr(mod, "_TILE_LADDER", (1, 4, 16))
        monkeypatch.setattr(mod, "_MIN_ESCALATION_BUCKET", 2)
    monkeypatch.setenv("HST_SUPER_HYBRID", "0")
    seen = _record(monkeypatch, (jhy, thy), "hybrid_tile_topk")
    want, got = _served(js, ts, queries)
    assert seen["torch"] == seen["jax"], seen
    assert len(seen["torch"]) > 1
    _same_as_jax_tile_route(got, want, queries)


def test_search_batch_both_gates_off_take_the_impact_ladder_like_jax(pair, monkeypatch):
    js, ts, queries = pair
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setenv("HST_SUPER_HYBRID", "0")
    monkeypatch.setenv("HST_TILE_HYBRID", "0")
    tiles = _record(monkeypatch, (jhy, thy), "hybrid_tile_topk")
    seen = _record(monkeypatch, (jhy, thy), "hybrid_impact_topk")
    want, got = _served(js, ts, queries)
    assert not tiles["torch"] and not tiles["jax"]
    # 3,000 docs: below 1M the first rung takes no kd_tiles budget
    assert seen["torch"] and seen["torch"] == seen["jax"], seen
    assert all(kd is None for _b, _kt, kd in seen["torch"])
    _same_results(got, want)


def test_impact_ladder_on_a_large_clustered_index_bounds_its_first_rung(
        pair, monkeypatch):
    """From _KD_TILES_MIN_DOCS docs (lowered here; the JAX package pins
    1,000,000) the first rung alone passes kd_tiles, and every row the
    ladder certifies is the full fusion's."""
    _js, ts, queries = pair
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "_KD_TILES_MIN_DOCS", 1000)
    monkeypatch.setattr(tsm, "_KD_TILES", 4)  # 3,000 docs fill 24 tiles
    monkeypatch.setenv("HST_SUPER_HYBRID", "0")
    monkeypatch.setenv("HST_TILE_HYBRID", "0")
    ladders = []
    real = tsm.impact_ladder

    def recording(*a, **kw):
        st, rungs = real(*a, **kw)
        ladders.append((kw["kd_tiles"], st.exact.copy()))
        return st, rungs

    monkeypatch.setattr(tsm, "impact_ladder", recording)
    seen = _record(monkeypatch, (jhy, thy), "hybrid_impact_topk")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = ts.search_batch(queries, top_k=5, log=False)
    (kd, exact), = ladders
    assert kd == 4 and exact.any()
    assert seen["torch"][0][2] == 4
    assert all(k is None for *_x, k in seen["torch"][1:])
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 10**9)
    full = ts.search_batch(queries, top_k=5, log=False)
    for b in np.nonzero(exact)[0]:
        _same_results([got[b]], [full[b]])


def test_supertile_gate_default_still_takes_the_supertile_ladder(pair, monkeypatch):
    _js, ts, queries = pair
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    calls = []
    real = tsm.supertile_ladder
    monkeypatch.setattr(tsm, "supertile_ladder",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    real_tile = tsm.tile_ladder
    monkeypatch.setattr(tsm, "tile_ladder",
                        lambda *a, **k: calls.append(2) or real_tile(*a, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts.search_batch(queries, top_k=5, log=False)
        monkeypatch.setenv("HST_SUPER_HYBRID", "0")
        ts.search_batch(queries, top_k=5, log=False)
    assert calls == [1, 2]
