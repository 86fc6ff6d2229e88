"""The port's mesh (hybridsearch_tpu_torch/parallel/) against the JAX
package's, on the CPU: the sharded dense top-k, sharded BM25 top-k and
scores, the exact collective hybrid, the sharded supertile program (full
and partial probe, tombstones) and ``Searcher`` on a mesh (the exact
program, the supertile ladder on carried state, the scatter fallback and
its downgrade counter).

The port runs in one spawned world of 4 gloo ranks for the whole module
(tests/_torch_mesh_worker.py); the JAX side runs here on a 4-device mesh
of the 8 virtual CPU devices. Inputs are made with numpy from a seed;
``hybridsearch_tpu_torch.convert`` carries JAX states across. Every rank
must return the same answer.

Tolerances: scores rtol=1e-4, atol=1e-5 (float32 sums in another order);
ids exact, except where two slots' scores lie within eps_num=1e-4 (a
near-tie the summation order may swap). Integer build outputs (CSR,
run pieces, supertile tables) must be equal.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_mesh_worker as worker
from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import bm25 as jbm25
from hybridsearch_tpu.ops import supertile as jst
from hybridsearch_tpu.parallel import collectives as jcol
from hybridsearch_tpu.parallel.mesh import build_mesh as jbuild_mesh
from hybridsearch_tpu.parallel.mesh import pad_to_shards
from hybridsearch_tpu.retrieval import searcher as jsm
from hybridsearch_tpu.text.extractor import HashVocabulary
from hybridsearch_tpu_torch.parallel.dryrun import launch
from hybridsearch_tpu_torch.parallel.mesh import build_mesh

S = 4
EPS = 1e-4
QUERIES = ["machine learning artificial intelligence", "cooking pasta",
           "stock market quarter", "neural networks brains", "zzz nothing"]


def _l2n(x):
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _same_topk(got_v, got_i, want_v, want_i):
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)
    diff = np.asarray(got_i) != np.asarray(want_i)
    for b, j in zip(*np.nonzero(diff)):
        row = want_v[b]
        assert (np.abs(row - row[j]) <= EPS).sum() > 1, (b, j)


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        _same_topk([[v for v, _i in g]], [[i for _v, i in g]],
                   [[v for v, _i in w]], [[i for _v, i in w]])


def _jrows(results):
    return [[(float(v), int(i)) for v, _c, i in row] for row in results]


# -- inputs ------------------------------------------------------------------------

def _dense_case(seed, N, D, B, k, block_n, dead=None, q_rows=None):
    rng = np.random.default_rng(seed)
    docs = _l2n(rng.standard_normal((N, D)))
    q = docs[q_rows] if q_rows is not None else _l2n(rng.standard_normal((B, D)))
    n_pad = pad_to_shards(N, S)
    docs_pad = np.zeros((n_pad, D), np.float32)
    docs_pad[:N] = docs
    bias = None
    if dead is not None:
        bias = np.zeros(n_pad, np.float32)
        bias[dead] = -np.inf
    return {"docs": docs_pad, "q": q, "k": k, "block_n": block_n, "n": N, "bias": bias}


def _coo(rng, n, V, max_df):
    tl, dl, wl = [], [], []
    for t in range(V):
        df = int(rng.integers(1, max_df))
        tl.append(np.full(df, t))
        dl.append(np.sort(rng.choice(n, size=df, replace=False)))
        wl.append(rng.exponential(1.0, df).astype(np.float32))
    return (np.concatenate(tl).astype(np.int64), np.concatenate(dl).astype(np.int64),
            np.concatenate(wl))


def _hybrid_case(seed, n, D, V, max_df, B, k):
    rng = np.random.default_rng(seed)
    per = -(-(-(-n // S)) // 128) * 128
    n_pad = per * S
    t, d, w = _coo(rng, n, V, max_df)
    docs = np.zeros((n_pad, D), np.float32)
    docs[:n] = _l2n(rng.standard_normal((n, D)))
    bias = np.full(n_pad, -np.inf, np.float32)
    bias[:n] = 0.0
    dead = rng.choice(n, size=min(30, n // 10), replace=False)
    bias[dead] = -np.inf
    bias[[per - 1, per]] = -np.inf  # the edges of shards 0 and 1
    terms = [list(map(int, rng.choice(V, size=int(rng.integers(1, 5)), replace=False)))
             for _ in range(B - 1)] + [[]]
    return {"t": t, "d": d, "w": w, "n": n, "V": V, "per": per, "docs": docs,
            "bias": bias, "q": _l2n(rng.standard_normal((B, D))), "terms": terms,
            "k": k}


def _supertile_case(seed, n, dead=0, runs=((4, 0.7, 0.3), (1, 0.6, 0.4)), k=5):
    rng = np.random.default_rng(seed)
    V, st = 80, 2
    per = -(-(-(-n // S)) // 128) * 128
    n_pad = per * S
    t, d, w = _coo(rng, n, V, 120)
    docs = np.zeros((n_pad, 32), np.float32)
    docs[:n] = _l2n(rng.standard_normal((n, 32)))
    bias = np.full(n_pad, -np.inf, np.float32)
    bias[:n] = 0.0
    dead_ids = rng.choice(n, size=dead, replace=False) if dead else np.zeros(0, int)
    bias[dead_ids] = -np.inf
    terms = [list(map(int, rng.choice(V, size=3, replace=False))) for _ in range(4)]
    return {"t": t, "d": d, "w": w, "n": n, "V": V, "per": per, "st": st,
            "docs": docs, "bias": bias, "dead": dead_ids, "terms": terms,
            "q": _l2n(rng.standard_normal((4, 32))), "k": k, "runs": list(runs),
            "n_alive": n - len(dead_ids)}


def _carried_searcher(jmesh):
    """A JAX clustered mesh searcher and the state the port carries."""
    rng = np.random.default_rng(5)
    vocab = [f"w{i}" for i in range(120)]
    topics = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(4)]
    texts = [f"{topics[i % 4]} " + " ".join(rng.choice(vocab, size=6))
             for i in range(800)]
    cfg = JConfig()
    cfg.index.layout = "clustered"
    js = jsm.Searcher(encoder=JEnc(dim=64), mesh=jmesh, use_query_memory=False,
                      config=cfg)
    js.indexer.index_documents(texts)
    snap, st = js.indexer.dense._snap, js.indexer.bm25._state
    sh = st.sharded
    ssp, _placed = js.indexer.bm25.super_postings_sharded(state=st)
    t, d, c, lens = st.tf_cache
    bm = js.indexer.bm25
    w = jbm25.compute_eager_weights(t, d, c, lens, st.n_docs, len(st.vocab), k1=bm.k1,
                                    b=bm.b, variant=bm.variant, delta=bm.delta)
    vocab_field = (np.asarray(st.vocab.id_to_hash, np.uint64)
                   if isinstance(st.vocab, HashVocabulary) else list(st.vocab.id_to_token))
    inp = {"table": np.asarray(js.indexer.encoder.table), "n": snap.n,
           "snap_docs": np.asarray(snap.docs), "snap_bias": np.asarray(snap.bias),
           "vocab": vocab_field, "per": sh.docs_per_shard,
           "bm25": (np.asarray(sh.indptr), np.asarray(sh.doc_ids),
                    np.asarray(sh.weights)),
           "ssp": (ssp.sup_max, ssp.sup_pos, ssp.ids_rows, ssp.ws_rows,
                   ssp.docs_per_shard, ssp.n_docs, ssp.super_tiles, ssp.df_host,
                   ssp.win_max_host),
           "coo": (t, d, w), "contents": list(js.indexer.contents),
           "queries": ["z2t1 z2t3 w7", "z0t0 z0t5", "w3 w11 w42"]}
    return js, inp


@pytest.fixture(scope="module", autouse=True)
def _jax_counters_kept():
    """The JAX package warns of a mesh hybrid's downgrade only at its
    process-wide counter's first count, and tests/test_advice_fixes.py
    asserts that warning: the JAX fallbacks this module runs give the
    counters back as they found them."""
    from hybridsearch_tpu.utils.tracing import GLOBAL_COUNTERS

    saved = GLOBAL_COUNTERS.all()
    yield
    with GLOBAL_COUNTERS._lock:
        GLOBAL_COUNTERS._counts.clear()
        GLOBAL_COUNTERS._counts.update(saved)


@pytest.fixture(scope="module")
def jmesh():
    return jbuild_mesh(n_data=S, devices=jax.devices()[:S])


@pytest.fixture(scope="module")
def world(jmesh, demo_docs, tmp_path_factory):
    """(inputs, the JAX searcher of the carried state, every rank's
    results): one 4-rank world runs every check of this module."""
    js, carried = _carried_searcher(jmesh)
    table = np.asarray(JEnc(dim=128).table)
    inputs = {
        "mesh": {"bad_n_data": 3},
        "dense_topk": _dense_case(1, 1000, 64, 3, 7, 128),
        "dense_topk_bias": _dense_case(2, 256, 32, 1, 5, 64, dead=[10], q_rows=[10]),
        "hybrid_topk": _hybrid_case(3, 3000, 32, 200, 300, 5, 7),
        "hybrid_topk_wide": _hybrid_case(4, 4 * 66000, 8, 40, 2000, 3, 5),
        "supertile": _supertile_case(7, 4000),
        "supertile_dead": _supertile_case(3, 4000, dead=400, runs=((4, 0.7, 0.3),),
                                          k=8),
        "searcher": {"table": table, "docs": list(demo_docs), "queries": QUERIES},
        "supertile_searcher": carried,
        "downgrade": {"table": np.asarray(JEnc(dim=64).table), "docs": list(demo_docs),
                      "query": "machine learning"},
        "fallbacks": {"table": np.asarray(JEnc(dim=64).table), "docs": list(demo_docs),
                      "queries": QUERIES},
    }
    results = launch(worker.run_checks, S, args=("parallel", inputs),
                     workdir=str(tmp_path_factory.mktemp("world")), timeout_s=240)
    return inputs, js, results


def _ranks(world, name):
    """Every rank's result of a check, each rank's equal to rank 0's."""
    _inputs, _js, results = world
    outs = [r[name] for r in results]
    for o in outs:
        assert "error" not in o, o.get("error")
    for o in outs[1:]:
        _assert_equal(o, outs[0])
    return outs


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            if key not in ("data_index", "local"):  # rank-local fields
                _assert_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_build_mesh_needs_a_process_group(world):
    """Without an initialized group build_mesh raises (a mesh never falls
    back to one device); in the world it lays the ranks out and refuses a
    shape that does not fit."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process"):
        build_mesh()
    outs = [r["mesh"] for r in world[2]]
    assert [o["data_index"] for o in outs] == list(range(S))
    _ranks(world, "mesh")
    assert outs[0]["shards"] == S and outs[0]["backend"] == "gloo"
    assert "needs 3 ranks" in outs[0]["bad_shape_error"]
    assert outs[0]["pad"] == pad_to_shards(1000, S)


def _jax_dense(jmesh, inp):
    docs = jax.device_put(inp["docs"], NamedSharding(jmesh, P("data", None)))
    bias = None
    if inp["bias"] is not None:
        bias = jax.device_put(inp["bias"], NamedSharding(jmesh, P("data")))
    run = jax.jit(lambda q, d, b: jcol.sharded_dense_topk(
        jmesh, q, d, inp["k"], block_n=inp["block_n"], valid_n=inp["n"],
        bias_sharded=b))
    return run(jnp.asarray(inp["q"]), docs, bias)


def test_sharded_dense_topk_matches_jax(world, jmesh):
    """N = 1000 over 4 shards of 256 rows (the last shard part padding)."""
    got = _ranks(world, "dense_topk")[0]
    v, i = _jax_dense(jmesh, world[0]["dense_topk"])
    _same_topk(got["vals"], got["ids"], np.asarray(v), np.asarray(i))
    inp = world[0]["dense_topk"]
    s = inp["q"] @ inp["docs"][:inp["n"]].T
    want = np.argsort(-s, axis=1, kind="stable")[:, :inp["k"]]
    for b in range(len(want)):
        assert set(got["ids"][b].tolist()) == set(want[b].tolist())


def test_sharded_dense_topk_with_bias_mask(world, jmesh):
    got = _ranks(world, "dense_topk_bias")[0]
    assert 10 not in got["ids"][0].tolist()
    v, i = _jax_dense(jmesh, world[0]["dense_topk_bias"])
    _same_topk(got["vals"], got["ids"], np.asarray(v), np.asarray(i))


def _jax_hybrid(jmesh, inp):
    sh = jbm25.build_sharded_postings(inp["t"], inp["d"], inp["w"], inp["n"], inp["V"],
                                      n_shards=S, mesh=jmesh,
                                      docs_per_shard=inp["per"])
    groups = jbm25.encode_run_pieces_sharded(sh.starts_host, sh.lengths_host,
                                             inp["terms"], sh.max_postings)
    docs = jax.device_put(inp["docs"], NamedSharding(jmesh, P("data", None)))
    bias = jax.device_put(inp["bias"], NamedSharding(jmesh, P("data")))
    v, i = jax.jit(lambda q, d, b: jcol.sharded_hybrid_topk(
        jmesh, q, d, sh.doc_ids, sh.weights, groups, inp["k"], 0.7, 0.3,
        valid_n=inp["n"], bias_sharded=b))(jnp.asarray(inp["q"]), docs, bias)
    bv, bi = jax.jit(lambda: jbm25.sharded_bm25_topk(jmesh, sh, groups, inp["k"]))()
    cols = jax.jit(lambda: jbm25.sharded_bm25_scores(jmesh, sh, groups))()
    return sh, groups, (v, i), (bv, bi), np.asarray(cols)


@pytest.mark.parametrize("case", ["hybrid_topk", "hybrid_topk_wide"])
def test_sharded_hybrid_topk_matches_jax(world, jmesh, case):
    """The exact collective hybrid: n not a multiple of the shards' rows,
    tombstones at shard edges; "wide" has 66,048 docs a shard (past 65,536:
    the tiled local top-k)."""
    outs = _ranks(world, case)
    inp = world[0][case]
    _sh, _g, (v, i), _bm, _cols = _jax_hybrid(jmesh, inp)
    _same_topk(outs[0]["vals"], outs[0]["ids"], np.asarray(v), np.asarray(i))
    dead = set(np.flatnonzero(~np.isfinite(inp["bias"][:inp["n"]])).tolist())
    assert not dead & set(outs[0]["ids"].ravel().tolist())


@pytest.mark.parametrize("case", ["hybrid_topk", "hybrid_topk_wide"])
def test_sharded_bm25_postings_topk_and_scores_match_jax(world, jmesh, case):
    """Each rank's shard of the postings and its run pieces equal the JAX
    stacks' row for that shard; top-k and each rank's columns of the
    scores equal the JAX results."""
    inp = world[0][case]
    sh, groups, _hy, (bv, bi), cols = _jax_hybrid(jmesh, inp)
    outs = [r[case] for r in world[2]]
    per = inp["per"]
    for r, o in enumerate(outs):
        assert "error" not in o, o.get("error")
        loc = o["local"]
        np.testing.assert_array_equal(loc["indptr"], np.asarray(sh.indptr)[r])
        np.testing.assert_array_equal(loc["doc_ids"], np.asarray(sh.doc_ids)[r])
        assert o["max_postings"] == sh.max_postings
        assert o["widths"] == [g[0] for g in groups]
        for (w, s_, l_), (jw, js_, jl_) in zip(loc["groups"], groups):
            np.testing.assert_array_equal(s_, np.asarray(js_)[r])
            np.testing.assert_array_equal(l_, np.asarray(jl_)[r])
        np.testing.assert_allclose(loc["bm25_cols"], cols[:, r * per:(r + 1) * per],
                                   rtol=1e-4, atol=1e-5)
        _same_topk(o["bm25_vals"], o["bm25_ids"], np.asarray(bv), np.asarray(bi))


def _oracle(inp, w_s, w_l, k):
    n = inp["n"]
    docs = inp["docs"][:n]
    sem = inp["q"] @ docs.T
    lex = np.zeros((len(inp["terms"]), n), np.float32)
    for b, terms in enumerate(inp["terms"]):
        for t in terms:
            m = inp["t"] == t
            np.add.at(lex[b], inp["d"][m], inp["w"][m])
    alive = np.isfinite(inp["bias"][:n])

    def mmn(x):
        mn = np.min(np.where(alive[None, :], x, np.inf), 1, keepdims=True)
        mx = np.max(np.where(alive[None, :], x, -np.inf), 1, keepdims=True)
        r = mx - mn
        return np.where(r > 1e-12, (x - mn) / np.maximum(r, 1e-12), 1.0)

    fused = np.where(alive[None, :], w_s * mmn(sem) + w_l * mmn(lex), -np.inf)
    oidx = np.argsort(-fused, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(fused, oidx, axis=1), oidx


def _jax_supertile(jmesh, inp, s_probe, w_s, w_l):
    ssp = jst.build_super_postings_sharded(inp["t"], inp["d"], inp["w"], inp["n"],
                                           inp["V"], docs_per_shard=inp["per"],
                                           n_shards=S, super_tiles=inp["st"])
    enc = jst.encode_super_queries_sharded(ssp, inp["terms"])
    put3 = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                    NamedSharding(jmesh, P("data", None, None)))
    docs = jax.device_put(inp["docs"], NamedSharding(jmesh, P("data", None)))
    bias = jax.device_put(inp["bias"], NamedSharding(jmesh, P("data")))
    # one jit around the shard_map: run eagerly, each of its ops compiles alone
    run = jax.jit(lambda q, d, b, *tables: jcol.sharded_supertile_topk(
        jmesh, q, d, *tables, enc, k=inp["k"], semantic_weight=w_s,
        lexical_weight=w_l, s_probe=s_probe, valid_n=inp["n"], n_alive=inp["n_alive"],
        bias_sharded=b, super_tiles=inp["st"]))
    v, i, e = run(jnp.asarray(inp["q"]), docs, bias, put3(ssp.sup_max),
                  put3(ssp.sup_pos), put3(ssp.ids_rows), put3(ssp.ws_rows))
    return ssp, np.asarray(v), np.asarray(i), np.asarray(e)


def test_sharded_supertile_full_probe_matches_jax_and_oracle(world, jmesh):
    """Every local supertile probed: every row certifies, and equals the
    JAX program and full-corpus fusion (n = 4000: the last shard holds
    padding rows)."""
    outs = _ranks(world, "supertile")
    inp = world[0]["supertile"]
    ssp, v, i, e = _jax_supertile(jmesh, inp, 4, 0.7, 0.3)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["local"]["sup_max"], ssp.sup_max[r])
        np.testing.assert_array_equal(o["local"]["sup_pos"], ssp.sup_pos[r])
        np.testing.assert_array_equal(o["df"], ssp.df_host)
        np.testing.assert_array_equal(o["win_max"], ssp.win_max_host)
    got = outs[0]["runs"][4]
    assert got["exact"].all() and e.all()
    _same_topk(got["vals"], got["ids"], v, i)
    ov, oi = _oracle(inp, 0.7, 0.3, inp["k"])
    _same_topk(got["vals"], got["ids"], ov, oi)


def test_sharded_supertile_partial_probe_soundness(world, jmesh):
    """One probe a shard: a certified row equals full fusion, and the
    port certifies no row the JAX program does not (its certificate adds
    the single-device margin eps_num)."""
    inp = world[0]["supertile"]
    got = _ranks(world, "supertile")[0]["runs"][1]
    _ssp, v, _i, e = _jax_supertile(jmesh, inp, 1, 0.6, 0.4)
    ov, oi = _oracle(inp, 0.6, 0.4, inp["k"])
    assert not (got["exact"] & ~e).any()
    for b in np.flatnonzero(got["exact"]):
        _same_topk(got["vals"][b:b + 1], got["ids"][b:b + 1], ov[b:b + 1], oi[b:b + 1])
        np.testing.assert_allclose(got["vals"][b], v[b], rtol=1e-4, atol=1e-5)


def test_sharded_supertile_tombstones(world, jmesh):
    inp = world[0]["supertile_dead"]
    got = _ranks(world, "supertile_dead")[0]["runs"][4]
    ids = got["ids"]
    assert not np.isin(ids[ids >= 0], inp["dead"]).any()
    assert got["exact"].all()
    _ssp, v, i, _e = _jax_supertile(jmesh, inp, 4, 0.7, 0.3)
    _same_topk(got["vals"], got["ids"], v, i)
    ov, oi = _oracle(inp, 0.7, 0.3, inp["k"])
    _same_topk(got["vals"], got["ids"], ov, oi)


def test_searcher_on_mesh_matches_jax_and_single(world, jmesh, demo_docs):
    """index_documents + search_batch on the mesh (the exact collective
    program) against the JAX mesh searcher and the port's single-device
    searcher; the lexical arm against the JAX mesh BM25."""
    got = _ranks(world, "searcher")[0]
    js = jsm.Searcher(encoder=JEnc(dim=128), mesh=jmesh, use_query_memory=False)
    js.indexer.index_documents(demo_docs)
    _same_rows(got["mesh"], _jrows(js.search_batch(QUERIES, top_k=6, log=False)))
    _same_rows(got["mesh"], got["single"])
    assert {i for _v, i in got["mesh"][0][:4]} & {1, 3, 6, 8, 10}
    np.testing.assert_allclose(got["lex_mesh"], js.indexer.bm25.score_all(QUERIES[0]),
                               rtol=1e-4, atol=1e-5)


def test_sharded_hybrid_respects_tombstones(world):
    got = _ranks(world, "searcher")[0]
    assert got["deleted"] not in [i for _v, i in got["after_delete"][0]]
    assert got["deleted_count"] == 1


def test_searcher_mesh_supertile_route_matches_jax(world):
    """The JAX clustered mesh index carried into the port: the exact
    collective program, the sharded supertile ladder (threshold lowered to
    100 docs) and the ladder gated off (``HST_SUPER_HYBRID=0``) all return
    what the JAX searcher's exact collective program returns (which
    tests/test_sharded_supertile.py holds the JAX ladder to); the port's
    own sharded supertile build of the carried COO equals the carried
    one."""
    got = _ranks(world, "supertile_searcher")[0]
    js = world[1]
    qs = world[0]["supertile_searcher"]["queries"]
    exact = _jrows(js.search_batch(qs, top_k=5, log=False))
    _same_rows(got["exact_program"], exact)
    _same_rows(got["supertile"], exact)
    _same_rows(got["gated"], exact)
    assert got["uncertified"] in (0, 1)
    assert got["own_build_equal"]


def test_exactness_downgrade_counter(world, jmesh, demo_docs):
    """BM25 refitted on another corpus length: the mesh hybrid's
    precondition fails, the semantic arm becomes the scatter of the top 2k
    (warned, counted once) and the collective fusion serves the rows the
    JAX package's fallback serves."""
    outs = _ranks(world, "downgrade")
    assert all(o["counted"] == 1 and o["warned"] for o in outs)
    js = jsm.Searcher(encoder=JEnc(dim=64), mesh=jmesh, use_query_memory=False)
    js.indexer.index_documents(demo_docs)
    js.indexer.bm25.fit(demo_docs[:5])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jrows([js.search("machine learning", top_k=2, log=False)])
    _same_rows(outs[0]["rows"], want)


def test_mesh_fallback_arms_are_rank_local(world, jmesh, demo_docs, monkeypatch):
    """The collective fusion over each rank's own columns: BM25 refitted
    with its own shard width (each rank scores its shard at the dense
    rows' width, no gather) and the fuzzy lexical arm serve the rows the
    JAX package's fallback serves (scores rtol=1e-4, atol=1e-5; ids up to
    near-ties within 1e-4). The JAX side's fuzzy arm takes its Python
    ``partial_ratio``: the C++ one can count one edit too few (ROADMAP
    R11)."""
    from hybridsearch_tpu.text import native as jnative

    monkeypatch.setattr(jnative, "_lib", lambda: None)
    outs = _ranks(world, "fallbacks")
    assert outs[0]["bm25_per"] != outs[0]["dense_per"]  # the shard is rebuilt
    js = jsm.Searcher(encoder=JEnc(dim=64), mesh=jmesh, use_query_memory=False)
    js.indexer.index_documents(demo_docs)
    js.indexer.bm25.docs_per_shard = None
    js.indexer.bm25.fit(demo_docs)
    fuzzy = jsm.Searcher(indexer=js.indexer, use_query_memory=False,
                         lexical_mode="fuzzy")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_rows(outs[0]["unaligned"],
                   _jrows(js.search_batch(QUERIES, top_k=3, log=False)))
        _same_rows(outs[0]["fuzzy"],
                   _jrows(fuzzy.search_batch(QUERIES, top_k=3, log=False)))
