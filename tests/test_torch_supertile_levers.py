"""The supertile ladder's two opt-in levers (``EngineConfig.perf``
``scores_dedup`` and ``place_fused``: kernels K4 and K5) against the JAX
package's, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version; the JAX side
runs its Pallas kernels in interpret mode (``HST_SUPER_INTERPRET=1``), with
its env gates ``HST_SCORES_DEDUP`` / ``HST_PLACE_FUSED`` set, as
tests/test_supertile.py does. Inputs come from a seeded numpy generator.

Tolerances: ``dedup_pairs`` is integer bookkeeping and must be equal. The
dedup scores sum the same float32 products as the JAX kernel in another
order: rtol = atol = 1e-5 (as tests/test_supertile.py holds the JAX kernel
to K2); against the port's own K2 plain version they must be equal, since
both are the same per-pair dot. The fused placement adds at most a few
float32 weights per cell: atol 1e-6 against JAX, and equal to the port's
two-step path (window gather + K3's plain version), which adds the same
weights in the same slot order. Rung and searcher: fused scores rtol=1e-4,
atol=1e-5, ids equal outside near-ties within eps_num = 1e-4, certified
flags equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import pallas_supertile as jps
from hybridsearch_tpu.ops import supertile as jst
from hybridsearch_tpu.retrieval import searcher as jsm
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.ops import cuda_supertile as tcs
from hybridsearch_tpu_torch.ops import dense as tdense
from hybridsearch_tpu_torch.ops import supertile as tst
from hybridsearch_tpu_torch.retrieval import searcher as tsm

CPU = torch.device("cpu")
EPS = 1e-4


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same_topk(got_v, got_i, want_v, want_i):
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)
    for b, j in zip(*np.nonzero(np.asarray(got_i) != np.asarray(want_i))):
        near = np.abs(want_v[b] - want_v[b][j]) <= EPS
        assert near.sum() > 1, f"row {b} slot {j}: ids differ outside a tie"


# -- dedup_pairs and K4 ---------------------------------------------------------

@pytest.mark.parametrize("B,S,n_super", [(16, 4, 6), (8, 2, 4), (5, 3, 40)])
def test_dedup_pairs_matches_jax(B, S, n_super):
    """Heavy duplication across the batch (tests/test_supertile.py's case)
    and a batch whose B*S is no multiple of the 8-pair group."""
    rng = np.random.default_rng(B * 100 + S)
    sup = np.sort(rng.integers(0, n_super, (B, S)), axis=1).astype(np.int32)
    want = jps.dedup_pairs(jnp.asarray(sup))
    got = tst.dedup_pairs(torch.from_numpy(sup))
    for name, g, w in zip(("tid", "qid", "rep", "inv"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    tid, _qid, _rep, inv = got
    assert torch.equal(tid[inv].reshape(B, S), torch.from_numpy(sup))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_super_scores_dedup_matches_pallas_and_k2(dtype):
    """Duplicated probes across queries and a probe past the last full
    supertile, whose chunk indices clamp to the last chunk."""
    rng = np.random.default_rng(11)
    B, D, sd, ch, S = 8, 128, 512, 256, 2
    N = 4 * sd + 2 * ch
    docs, q = _unit(rng, N, D), _unit(rng, B, D)
    sup = np.sort(rng.integers(0, 5, (B, S)), axis=1).astype(np.int32)
    sup[0] = [3, 5]  # supertile 5 starts past the end: every chunk clamps
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jtid, jqid, jrep, jinv = jps.dedup_pairs(jnp.asarray(sup))
    jq, jdocs = jnp.asarray(q).astype(jdt), jnp.asarray(docs).astype(jdt)
    want = np.asarray(jnp.take(jps.pallas_super_scores_dedup(
        jnp.take(jq, jqid, axis=0), jdocs, jtid, jrep, sd, ch=ch,
        interpret=True), jinv, axis=0).reshape(B, S * sd))

    tdt = getattr(torch, dtype)
    tq, tdocs = torch.from_numpy(q).to(tdt), torch.from_numpy(docs).to(tdt)
    tid, qid, _rep, inv = tst.dedup_pairs(torch.from_numpy(sup))
    out = tcs.super_scores_dedup(tq[qid], tdocs, tid, sd, ch=ch)  # plain on the CPU
    assert out.shape == (B * S, sd)
    got = out[inv].reshape(B, S * sd)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tcs.super_scores_plain(tq, tdocs, torch.from_numpy(sup),
                                                   sd, ch=ch))


# -- K5 -------------------------------------------------------------------------

def _windows_case():
    """A 2,048-doc CSR in 512-doc supertiles (4 of them), term slots with
    per-slot caps, and probes that give an overflowing window (term 0 is
    in every doc: 512 entries a supertile against a 256 cap), empty
    windows (term 1 only in supertile 0, the query-pad term V) and a probe
    past the position table (supertile 5)."""
    rng = np.random.default_rng(12)
    n_docs, V, st = 2048, 40, 4
    t = [np.zeros(n_docs, np.int64), np.ones(300, np.int64)]
    d = [np.arange(n_docs), np.arange(300)]
    for term in range(2, V):
        docs = np.sort(rng.choice(n_docs, int(rng.integers(20, 400)), replace=False))
        t.append(np.full(len(docs), term))
        d.append(docs)
    t, d = np.concatenate(t), np.concatenate(d)
    w = (rng.random(len(t)) * 5 + 0.1).astype(np.float32)
    sp = tst.build_super_postings(t, d, w, n_docs, V, CPU, super_tiles=st)
    term_ids = torch.tensor([[2, 0, 1], [0, 1, V], [5, 6, 7], [V, V, V],
                             [9, 9, 3], [1, 2, 0]])
    sup_s = torch.tensor([[0, 1], [1, 5], [2, 3], [0, 3], [3, 5], [0, 2]])
    wcaps = (512, 256, 384)
    return sp, term_ids, sup_s, wcaps


def test_place_fused_matches_pallas_and_the_two_step_path():
    sp, term_ids, sup_s, wcaps = _windows_case()
    B, S = sup_s.shape
    lo, hi, base, ovf = tst._flat_windows(sp.sup_pos, term_ids, sup_s,
                                           sp.super_docs, wcaps)
    assert ovf.any() and not ovf.all()
    assert (lo == hi).any() and ((lo == 0) & (hi == 0)).any()
    got = tcs.place_fused(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps,
                          sp.super_tiles)  # plain on the CPU
    assert got.shape == (B * S, sp.super_tiles, 128)
    # the two-step path: staged windows, then K3's plain version
    l_cat, w_cat, ovf2 = tst._resident_windows(sp.sup_pos, sp.ids_rows, sp.ws_rows,
                                               term_ids, sup_s, sp.super_docs, wcaps)
    two = tcs.place_windows_plain(l_cat.reshape(B * S, -1), w_cat.reshape(B * S, -1),
                                  sp.super_tiles)
    assert torch.equal(got, two) and torch.equal(ovf, ovf2)
    want = jps.pallas_place_fused(
        jnp.asarray(lo.numpy().astype(np.int32)), jnp.asarray(hi.numpy().astype(np.int32)),
        jnp.asarray(base.numpy().astype(np.int32)), jnp.asarray(sp.ids_rows.numpy()),
        jnp.asarray(sp.ws_rows.numpy()), wcaps=wcaps, super_tiles=sp.super_tiles,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # an overflowing window keeps only the entries the cap's rows reach
    row = int(torch.nonzero(((hi - lo) > torch.tensor(wcaps)).any(dim=1))[0])
    assert 0 < float(got[row].count_nonzero()) < float(
        (hi[row] - lo[row]).clamp(min=0).sum())


def test_gated_wrappers_refuse_other_devices():
    meta = torch.empty((256, 128), device="meta")
    with pytest.raises(ValueError):
        tcs.super_scores_dedup(torch.empty((4, 128), device="meta"), meta,
                               torch.zeros(4, dtype=torch.int32, device="meta"), 256,
                               ch=128)
    z = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tcs.place_fused(z, z, torch.zeros(2, dtype=torch.int32, device="meta"),
                        torch.zeros((4, 128), dtype=torch.int32, device="meta"),
                        torch.zeros((4, 128), device="meta"), (512, 512, 512))
    assert tcs.super_scores_dedup.launches == 0 and tcs.place_fused.launches == 0


# -- the rung and the searcher with both levers ---------------------------------

@pytest.fixture
def levers_on(monkeypatch):
    """The JAX rung with both gates in interpret mode (its jit caches
    dropped around the test, since the gates are read at trace time) and
    the port on its kernel routes, with calls to each wrapper counted."""
    for name in ("HST_SUPER_INTERPRET", "HST_PLACE_FUSED", "HST_SCORES_DEDUP"):
        monkeypatch.setenv(name, "1")
    monkeypatch.setenv("HST_TILE_HYBRID", "0")
    monkeypatch.setattr(tdense, "_on_card", lambda t: True)
    monkeypatch.setattr(tst, "_on_card", lambda t: True)
    calls = {}
    for name in ("super_scores", "super_scores_dedup", "place_windows", "place_fused"):
        real = getattr(tst, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(tst, name, counted)
    jst._super_rung_impl.clear_cache()
    yield calls
    jst._super_rung_impl.clear_cache()


@pytest.mark.parametrize("n_q,s_probe,scores_kernel",
                         [(8, 2, "super_scores_dedup"), (9, 1, "super_scores")])
def test_rung_with_both_levers_matches_jax(levers_on, n_q, s_probe, scores_kernel):
    """B*S % 8 == 0 takes K4, as the JAX rung's condition; otherwise K2.
    The placement is K5 either way."""
    rng = np.random.default_rng(13)
    n, d = 4096, 128
    vocab = [f"t{i}" for i in range(60)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 14)))) for _ in range(n)]
    queries = [" ".join(rng.choice(vocab, size=3)) for _ in range(n_q)]
    docs, q = _unit(rng, n, d), _unit(rng, n_q, d)
    bias = np.zeros(n, np.float32)
    bias[rng.choice(n, 50, replace=False)] = -np.inf
    from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
    from hybridsearch_tpu_torch.index.sparse_index import BM25

    jb, tb = JBM25().fit(texts), BM25(device=CPU).fit(texts)
    jsp, tsp = jb.super_postings(super_tiles=8), tb.super_postings(super_tiles=8)
    lists = [jb.vocab.encode(x.split()) for x in queries]
    jenc, tenc = jst.encode_super_queries(jsp, lists), tst.encode_super_queries(tsp, lists)
    jp = jst.super_prefix(jnp.asarray(q), jnp.asarray(docs), jsp, jenc,
                          bias=jnp.asarray(bias), s_max=2)
    tp = tst.super_prefix(torch.from_numpy(q), torch.from_numpy(docs), tsp, tenc,
                          bias=torch.from_numpy(bias), s_max=2)
    jr = jst.hybrid_supertile_topk_rung(jnp.asarray(q), jnp.asarray(docs), jsp, jenc,
                                        jp, 5, 0.7, 0.3, bias=jnp.asarray(bias),
                                        s_probe=s_probe, n_alive=n - 50)
    tr = tst.hybrid_supertile_topk_rung(torch.from_numpy(q), torch.from_numpy(docs),
                                        tsp, tenc, tp, 5, 0.7, 0.3,
                                        bias=torch.from_numpy(bias), s_probe=s_probe,
                                        n_alive=n - 50, scores_dedup=True,
                                        place_fused=True)
    assert levers_on == {scores_kernel: 1, "place_fused": 1}
    _same_topk(tr.values.numpy(), tr.indices.numpy(), jr.values, jr.indices)
    np.testing.assert_array_equal(tr.exact.numpy(), np.asarray(jr.exact))
    # and bit for bit the rung without the levers
    levers_on.clear()
    base = tst.hybrid_supertile_topk_rung(torch.from_numpy(q), torch.from_numpy(docs),
                                          tsp, tenc, tp, 5, 0.7, 0.3,
                                          bias=torch.from_numpy(bias), s_probe=s_probe,
                                          n_alive=n - 50)
    assert levers_on == {"super_scores": 1, "place_windows": 1}
    for a, b in zip(tr, base):
        assert torch.equal(a, b)


def _carry(js, cfg):
    snap, st = js.indexer.dense._snap, js.indexer.bm25._state
    po = st.postings
    idx = convert.indexer(
        js.indexer.contents,
        convert.hashing_encoder(np.asarray(js.indexer.encoder.table), device=CPU),
        convert.dense_index(np.asarray(snap.docs), np.asarray(snap.bias), snap.n,
                            device=CPU),
        convert.bm25_index(np.asarray(st.vocab.id_to_hash, np.uint64),
                           np.asarray(po.indptr), np.asarray(po.doc_ids),
                           np.asarray(po.weights), po.n_docs, device=CPU),
        config=cfg)
    return tsm.Searcher(indexer=idx, use_query_memory=False, config=cfg)


def test_searcher_with_both_levers_matches_jax(levers_on, monkeypatch):
    """tests/test_supertile.py's gated composition end to end: the JAX
    searcher with both gates against the port's Searcher with
    ``cfg.perf.scores_dedup = cfg.perf.place_fused = True``, on the JAX
    index's state; the port's config is the JAX config's JSON."""
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(300)]
    topics = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(12)]
    texts = [f"{topics[i % 12]} " + " ".join(rng.choice(vocab, size=6))
             for i in range(17000)]
    # B*S divisible by 8 and topic overlap: duplicated probes across the batch
    queries = [f"z{z}t1 z{z}t3 {vocab[z]}" for z in (2, 2, 5, 5)] + \
              [f"z{z}t0 {vocab[10 + z]}" for z in (7, 7, 9, 11)]
    jcfg = JConfig()
    jcfg.index.layout = "clustered"
    jcfg.index.dim = 128
    js = jsm.Searcher(encoder=JEnc(dim=128), use_query_memory=False, config=jcfg)
    js.indexer.index_documents(texts)
    assert js.indexer.dense._snap.docs.shape[0] % 1024 == 0
    jcfg.perf.scores_dedup = jcfg.perf.place_fused = True
    cfg = EngineConfig.from_json(jcfg.to_json())
    assert cfg.perf.scores_dedup is True and cfg.perf.place_fused is True
    ts = _carry(js, cfg)
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "SPARSE_HYBRID_MIN_DOCS", 100)
    flags = {}
    for key, mod in (("jax", jsm), ("port", tsm)):
        real = mod.supertile_ladder

        def recording(*a, _real=real, _key=key, **k):
            st, rungs = _real(*a, **k)
            flags[_key] = np.asarray(st.exact).copy()
            return st, rungs

        monkeypatch.setattr(mod, "supertile_ladder", recording)
    want = js.search_batch(queries, top_k=5, log=False)
    got = ts.search_batch(queries, top_k=5, log=False)
    assert levers_on.get("super_scores_dedup") and levers_on.get("place_fused")
    assert "super_scores" not in levers_on and "place_windows" not in levers_on
    np.testing.assert_array_equal(flags["port"], flags["jax"])
    for g, w in zip(got, want):
        assert len(g) == len(w)
        _same_topk([[v for v, _c, _i in g]], [[i for _v, _c, i in g]],
                   [[v for v, _c, _i in w]], [[i for _v, _c, i in w]])


# -- PerfConfig -----------------------------------------------------------------

def test_perf_config_json_round_trip():
    """A JAX-written config with every perf key loads with the two levers'
    values (the five TPU-only keys are dropped), and the port's own JSON
    round-trips."""
    jcfg = JConfig()
    jcfg.perf.place_fused, jcfg.perf.scores_dedup = True, False
    jcfg.perf.dedup_mxu, jcfg.perf.pallas_tpb, jcfg.perf.place_skip = True, 16, True
    cfg = EngineConfig.from_json(jcfg.to_json())
    assert (cfg.perf.place_fused, cfg.perf.scores_dedup) == (True, False)
    assert not hasattr(cfg.perf, "dedup_mxu")
    assert EngineConfig.from_json(cfg.to_json()) == cfg
    default = EngineConfig.from_json(JConfig().to_json())
    assert default.perf.place_fused is None and default.perf.scores_dedup is None
