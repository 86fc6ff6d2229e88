"""The port's indexes on a mesh against the JAX package's, on the CPU:
``DenseIndex`` (build, add, tombstones at shard edges, n not a multiple of
the shards' rows, save at 4 shards and load at 4, a 1-shard save loaded at
4, growth past the sharded capacity and compaction, which move rows
between ranks), ``BM25`` (sharded fit, search, scores, a saved
single-device state loaded onto the mesh, adds), the sharded ``IVFIndex``
(its own build at full probe, a JAX build carried across, bfloat16
storage), the ``Indexer`` (build, delete, save / load on the mesh, a JAX
single-device save loaded onto it, adds within and past the capacity, the
JSON export) and ``HybridBM25Pipeline`` on the mesh; then a world of one
rank, the degenerate mesh, against the single device.

The port runs in one spawned world of 4 gloo ranks for the 4-rank checks
and one of 1 rank (tests/_torch_mesh_worker.py); the JAX side runs here
on a 4-device mesh of the 8 virtual CPU devices. Every rank must return
the same answer.

Tolerances: scores rtol=1e-4, atol=1e-5; ids exact except inside a
near-tie of eps_num=1e-4; a saved manifest and bias byte for byte, saved
and exported rows rtol=1e-5, atol=1e-6 (the packages normalize in another
float order); a save loaded back bit for bit; bfloat16 rows within one
bfloat16 step (2^-7 relative) of JAX's.
"""

import json
import os

import jax
import numpy as np
import pytest

import _torch_mesh_worker as worker
from hybridsearch_tpu.config import EngineConfig as JConfig
from hybridsearch_tpu.index.builder import Indexer as JIndexer
from hybridsearch_tpu.index.dense_index import DenseIndex as JDense
from hybridsearch_tpu.index.ivf import IVFIndex as JIVF
from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.parallel.mesh import build_mesh as jbuild_mesh
from hybridsearch_tpu.pipelines import create_pipeline as jcreate_pipeline
from hybridsearch_tpu.retrieval.searcher import Searcher as JSearcher
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.config import EngineConfig as TConfig
from hybridsearch_tpu_torch.index.builder import Indexer as TIndexer
from hybridsearch_tpu_torch.index.dense_index import DenseIndex as TDense
from hybridsearch_tpu_torch.parallel.dryrun import launch
from hybridsearch_tpu_torch.pipelines import create_pipeline as tcreate_pipeline

S = 4
EPS = 1e-4
QUERIES = ["machine learning artificial intelligence", "cooking pasta",
           "stock market quarter", "neural networks brains"]
MORE = ["pasta with tomato sauce and basil", "a quarter of machine learning"]
# enough docs to pass the Indexer's dense capacity on the mesh
GROW_DOCS = [f"note {i} on {w} and the quarter" for i, w in enumerate(
    ["pasta", "neural networks", "machine learning", "stock market"] * 5)]


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


def _clustered(rng, n_clusters=12, per=64, d=64):
    centers = rng.standard_normal((n_clusters, d)) * 3
    return np.concatenate([c + 0.3 * rng.standard_normal((per, d))
                           for c in centers]).astype(np.float32)


def _jax_dense(jmesh, inp, save_dir=None):
    """The JAX mesh index through the same mutations as the port's."""
    idx = JDense(dim=inp["vecs"].shape[1], mesh=jmesh, block_n=64,
                 capacity_round=inp["round"]).build(inp["vecs"])
    out = {"search": idx.search(inp["q"], inp["k"])}
    idx.add(inp["new"])
    out["search_added"] = idx.search(inp["new"][2:3], 1)
    idx.delete(inp["dead"])
    out["search_dead"] = idx.search(inp["q"], inp["k"])
    out["search_bias"] = idx.search(inp["q"], inp["k"],
                                    extra_bias=jax.numpy.asarray(inp["extra_bias"]))
    out["capacity"] = idx.capacity
    if save_dir:
        idx.save(save_dir)
    return _grow_and_compact(idx, inp, out)


def _grow_and_compact(idx, inp, out):
    """Growth past the capacity, compaction, half the rows tombstoned and
    compaction again (the worker's ``_grow_and_compact``)."""
    out["grow_ids"] = idx.add(inp["grow"])
    out.update(grow_capacity=idx.capacity, grow_search=idx.search(inp["q_grow"], inp["k"]),
               grow_vectors=idx.get_vectors(inp["grow_get"]))
    out["compact_mapping"] = idx.compact()
    out.update(compact_capacity=idx.capacity,
               compact_search=idx.search(inp["q_grow"], inp["k"]))
    idx.delete(inp["dead2"])
    out["shrink_mapping"] = idx.compact()
    out.update(shrink_capacity=idx.capacity, shrink_n=idx.n_docs,
               shrink_search=idx.search(inp["q_grow"], inp["k"]),
               shrink_vectors=idx.get_vectors(list(range(idx.n_docs))))
    return out


def _port_dense_single(inp):
    """The same mutations on the port's single-device index."""
    idx = TDense(dim=inp["vecs"].shape[1], capacity_round=inp["round"], device="cpu")
    idx.build(inp["vecs"])
    idx.add(inp["new"])
    idx.delete(inp["dead"])
    return _grow_and_compact(idx, inp, {})


@pytest.fixture(scope="module")
def jmesh():
    return jbuild_mesh(n_data=S, devices=jax.devices()[:S])


@pytest.fixture(scope="module")
def jdense(jmesh, world, tmp_path_factory):
    """The JAX mesh index's results and its save, once for the module."""
    save_dir = str(tmp_path_factory.mktemp("jax_mesh_save"))
    return _jax_dense(jmesh, world[0]["dense_index"], save_dir=save_dir), save_dir


@pytest.fixture(scope="module")
def world(jmesh, demo_docs, tmp_path_factory):
    """(inputs, the JAX saves, each world's results): one 4-rank world runs
    every 4-rank check, one 1-rank world the degenerate mesh."""
    tmp = tmp_path_factory.mktemp("sharded_index")
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((300, 64)).astype(np.float32)
    one_dir = str(tmp / "one_shard")
    JDense(dim=64, capacity_round=8).build(vecs).save(one_dir)
    # the rows a shard is 80: tombstones at both edges of shards 0 and 1
    dense = {"vecs": vecs, "round": 8, "q": vecs[[123, 79, 80, 299]], "k": 3,
             "new": rng.standard_normal((5, 64)).astype(np.float32),
             "dead": np.array([79, 80, 159, 7]), "get": [0, 79, 80, 250, 304],
             "save_dir": str(tmp / "mesh_save"), "one_shard_dir": one_dir}
    # the metadata pre-filter's bias over the 305 rows after the add: about
    # half masked, across every shard, with a finite shift on a few rows
    eb = np.where(np.random.default_rng(7).random(305) < 0.5, 0.0, -np.inf)
    eb[[78, 81, 123]] = 0.05
    dense["extra_bias"] = eb.astype(np.float32)
    # 40 rows take the 305 past the capacity of 320 (80 a shard -> 88);
    # then half of the 345 rows die, so the compaction shrinks the capacity
    dense.update(grow=rng.standard_normal((40, 64)).astype(np.float32),
                 q_grow=np.concatenate([vecs[[7, 123, 299]],
                                        rng.standard_normal((3, 64)).astype(np.float32)]),
                 grow_get=[0, 79, 80, 87, 88, 175, 176, 319, 320, 344],
                 dead2=np.arange(0, 341, 2))
    single_npz = str(tmp / "single_bm25.npz")
    JBM25().fit(demo_docs).save(single_npz)
    bm25 = {"docs": list(demo_docs), "queries": QUERIES + ["zzz nothing"],
            "cand": [0, 3, 5, -1, 11], "dir": str(tmp), "npz": single_npz}
    docs_ivf = _clustered(np.random.default_rng(1))
    jivf = JIVF(dim=64, n_clusters=16, nprobe=6, mesh=jmesh).build(docs_ivf)
    q_ivf = docs_ivf[np.random.default_rng(2).integers(0, len(docs_ivf), 8)] + \
        0.05 * np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    jb16 = JIVF(dim=64, n_clusters=16, nprobe=6, mesh=jmesh,
                storage_dtype=jax.numpy.bfloat16).build(docs_ivf)
    ivf = {"docs": docs_ivf, "q": q_ivf, "draws": _jax_kmeans_draws(len(docs_ivf), 16),
           "arrays": _ivf_arrays(jivf), "arrays_b16": _ivf_arrays(jb16)}
    table = np.asarray(JEnc(dim=128).table)
    single_db = str(tmp / "single.db")
    cfg = JConfig()
    cfg.index.dim = 128
    jix = JIndexer(db_path=single_db, encoder=JEnc(dim=128), config=cfg)
    jix.index_documents(demo_docs)
    jix.save(str(tmp / "single_index"))
    jix.close()
    indexer = {"table": table, "round": 8, "docs": list(demo_docs),
               "queries": QUERIES, "dead": [1, 3], "more": MORE, "dir": str(tmp),
               "single_dir": str(tmp / "single_index"), "single_db": single_db,
               "grow_docs": GROW_DOCS, "dump": str(tmp / "mesh_dump.json")}
    inputs = {"dense_index": dense, "bm25": bm25, "ivf": ivf, "indexer": indexer}
    four = launch(worker.run_checks, S, args=("index", inputs),
                  workdir=str(tmp / "world4"), timeout_s=240)
    one_in = {"searcher_world1": {"table": table, "docs": list(demo_docs),
                                  "queries": QUERIES}}
    one = launch(worker.run_checks, 1, args=("index", one_in),
                 workdir=str(tmp / "world1"), timeout_s=240)
    return inputs, (jivf, jb16), four, one


def _ivf_arrays(j):
    return (np.asarray(j._centroids), np.asarray(j._docs_perm, np.float32),
            np.asarray(j._chunk_starts), np.asarray(j._chunk_lens),
            np.asarray(j._perm_to_orig), j._cap, j.n_docs)


def _jax_kmeans_draws(n, k, seed=0, iters=10):
    """The rows jax.random draws inside the JAX kmeans_fit (the initial
    centroids, then [iters, k] re-seeds of empty clusters)."""
    key = jax.random.PRNGKey(seed)
    init = np.array(jax.random.choice(key, n, (k,), replace=False))
    reseed = np.stack([np.array(jax.random.randint(kk, (k,), 0, n))
                       for kk in jax.random.split(key, iters)])
    return init, reseed


def _ranks(results, name):
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
            if not key.startswith("local_"):  # a rank's own part
                _assert_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_dense_index_on_mesh_matches_jax(world, jdense):
    """Build at 300 rows (80 a shard at capacity_round 8, the last shard
    part padding), search, add within the capacity, tombstones at shard
    edges (one named twice, counted once), and rows of every shard read
    back."""
    inputs, _jivf, four, _one = world
    got = _ranks(four, "dense_index")[0]
    inp = inputs["dense_index"]
    want = jdense[0]
    assert got["capacity"] == want["capacity"] == 320
    assert [o["local_rows"] for o in (r["dense_index"] for r in four)] == [80] * S
    for key in ("search", "search_added", "search_dead"):
        _same_topk(got[key][0], got[key][1], want[key][0], want[key][1])
    assert got["search"][1][0, 0] == 123 and got["search"][1][3, 0] == 299
    np.testing.assert_array_equal(got["added"], np.arange(300, 305))
    assert got["search_added"][1][0, 0] == 302
    assert got["deleted_count"] == len(inp["dead"])
    assert not set(inp["dead"].tolist()) & set(got["search_dead"][1].ravel().tolist())
    vecs = np.concatenate([inp["vecs"], inp["new"]])
    unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    np.testing.assert_allclose(got["vectors"], unit[inp["get"]], rtol=1e-5, atol=1e-6)


def test_dense_index_on_mesh_extra_bias_matches_jax(world, jdense):
    """``DenseIndex.search(extra_bias=)`` on the mesh: each rank adds its
    own rows' part of the [n] bias (zero-padded to capacity) to its
    tombstone bias; every rank's answer is JAX's, and no masked or
    tombstoned row comes back."""
    inputs, _jivf, four, _one = world
    got = _ranks(four, "dense_index")[0]["search_bias"]
    want = jdense[0]["search_bias"]
    _same_topk(got[0], got[1], want[0], want[1])
    inp = inputs["dense_index"]
    ids = got[1].ravel()
    assert np.isfinite(inp["extra_bias"][ids]).all()
    assert not set(inp["dead"].tolist()) & set(ids.tolist())


def test_dense_index_save_at_four_shards_is_the_jax_layout(world, jdense):
    """Every rank writes its own rows into the JAX layout: the same files
    as a JAX mesh index's save of the same state (the manifest and the
    bias byte for byte, each shard file of the same shape, its rows within
    the tolerance: the two packages normalize in another float order), and
    the index loaded back at 4 shards equals the saved one."""
    inputs, _jivf, four, _one = world
    got = _ranks(four, "dense_index")[0]
    inp = inputs["dense_index"]
    jax_dir = jdense[1]
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(inp["save_dir"]))
    for name in names:
        if name.startswith("shard_"):
            a = np.load(os.path.join(jax_dir, name))
            b = np.load(os.path.join(inp["save_dir"], name))
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
            continue
        with open(os.path.join(jax_dir, name), "rb") as a, \
                open(os.path.join(inp["save_dir"], name), "rb") as b:
            assert a.read() == b.read(), name
    assert got["loaded_equal"] and got["loaded_deleted"] == len(inp["dead"])
    _same_topk(got["loaded_search"][0], got["loaded_search"][1],
               got["search_dead"][0], got["search_dead"][1])


def test_one_shard_save_loaded_at_four(world):
    inputs, _jivf, four, _one = world
    got = _ranks(four, "dense_index")[0]
    want = JDense.load(inputs["dense_index"]["one_shard_dir"]).search(
        inputs["dense_index"]["q"], 3)
    _same_topk(got["one_shard_search"][0], got["one_shard_search"][1], *want)


def test_sharded_bm25_matches_jax_and_single(world, demo_docs):
    """BM25 fitted on the mesh scores and ranks as the JAX package's BM25
    and the port's single-device one (tests/test_parallel.py holds the JAX
    mesh BM25 to the JAX single-device one; tests/test_torch_parallel.py
    the sharded ops to the JAX mesh's)."""
    inputs, _jivf, four, _one = world
    got = _ranks(four, "bm25")[0]
    assert got["sharded"]
    jm = JBM25().fit(demo_docs)
    for q, scores, hits, single in zip(inputs["bm25"]["queries"], got["scores"],
                                       got["search"], got["single_search"]):
        np.testing.assert_allclose(scores, jm.score_all(q), rtol=1e-4, atol=1e-5)
        assert hits == jm.search(q, top_k=3) == single, q
    want = jm.candidate_scores(inputs["bm25"]["queries"][0],
                               np.array(inputs["bm25"]["cand"]))
    np.testing.assert_allclose(got["cand"], want, rtol=1e-4, atol=1e-5)
    assert "cannot be saved" in got["save"]
    jm.add_tokens([["machine", "learning", "pasta"]])
    assert got["added_n"] == jm.n_docs == len(demo_docs) + 1
    assert got["added_search"] == jm.search("pasta", top_k=3)


def test_single_device_bm25_loaded_onto_the_mesh(world):
    """A saved single-device state loaded onto the mesh takes the sharded
    postings (the JAX package keeps it single-device there)."""
    inputs, _jivf, four, _one = world
    got = _ranks(four, "bm25")[0]
    single = JBM25().load(inputs["bm25"]["npz"])
    assert got["loaded_sharded"]
    for q, hits in zip(inputs["bm25"]["queries"], got["loaded_search"]):
        assert hits == single.search(q, top_k=3), q


def test_ivf_sharded_matches_jax_and_exact(world, jmesh):
    """The port's own sharded build at full probe equals exact search; a
    JAX sharded build carried across serves what the JAX one serves at the
    default probe (each rank probing ceil(6 / 4) chunks) and at full
    probe; from_layout refuses a mesh."""
    inputs, (jivf, _jb16), four, _one = world
    got = _ranks(four, "ivf")[0]
    inp = inputs["ivf"]
    qn = inp["q"] / np.linalg.norm(inp["q"], axis=1, keepdims=True)
    dn = inp["docs"] / np.linalg.norm(inp["docs"], axis=1, keepdims=True)
    s = qn @ dn.T
    want = np.argsort(-s, axis=1, kind="stable")[:, :10]
    _same_topk(got["own_full"][0], got["own_full"][1],
               np.take_along_axis(s, want, 1), want)
    _same_topk(got["carried"][0], got["carried"][1], *jivf.search(inp["q"], 10))
    _same_topk(got["carried_full"][0], got["carried_full"][1],
               *jivf.search(inp["q"], 10, nprobe=10**9))
    assert "single-device" in got["from_layout"]


def test_indexer_on_mesh_build_save_load(world, demo_docs):
    """The Indexer on the mesh serves what the JAX Indexer serves (its
    single-device fused program, which tests/test_parallel.py holds the
    JAX mesh to); after deletes, saved and loaded back onto the mesh (BM25
    refitted, aligned with the dense shards) it serves the same rows bit
    for bit; a JAX single-device save (with its bm25.npz) loaded onto the
    mesh serves what the JAX single-device searcher serves; adds keep it
    live."""
    inputs, _jivf, four, _one = world
    got = _ranks(four, "indexer")[0]
    inp = inputs["indexer"]
    cfg = JConfig()
    cfg.index.capacity_round = 8
    js = JSearcher(encoder=JEnc(dim=128), use_query_memory=False, config=cfg)
    js.indexer.index_documents(demo_docs)
    _same_rows(got["built"], _jrows(js.search_batch(QUERIES, top_k=5, log=False)))
    js.indexer.delete_documents(inp["dead"])
    _same_rows(got["deleted"], _jrows(js.search_batch(QUERIES, top_k=5, log=False)))
    assert got["loaded"] == got["deleted"] and got["loaded_aligned"]
    single = JSearcher(indexer=JIndexer.load(inp["single_dir"], encoder=JEnc(dim=128),
                                             db_path=inp["single_db"]),
                       use_query_memory=False)
    _same_rows(got["single_saved"], _jrows(single.search_batch(QUERIES, top_k=5,
                                                               log=False)))
    js.indexer.add_documents(MORE)
    _same_rows(got["added"], _jrows(js.search_batch(QUERIES, top_k=5, log=False)))


@pytest.mark.parametrize("step", ["grow", "compact", "shrink"])
def test_dense_growth_and_compaction_on_mesh(world, jdense, step):
    """Growth past the sharded capacity (320 -> 352 at 88 rows a shard),
    compaction (tombstones at shard edges) and, with half the rows dead, a
    compaction that shrinks the capacity: every rank's capacity, ids,
    mappings and rows equal the JAX mesh index's and the port's
    single-device index's; rows changed rank (each rank received some in
    the growth), and the snapshot before the growth kept its buffers."""
    inputs, _jivf, four, _one = world
    inp = inputs["dense_index"]
    got = _ranks(four, "dense_index")[0]
    want, single = jdense[0], _port_dense_single(inp)
    assert got[f"{step}_capacity"] == want[f"{step}_capacity"]
    _same_topk(*got[f"{step}_search"], *want[f"{step}_search"])
    _same_topk(*got[f"{step}_search"], *single[f"{step}_search"])
    if step == "grow":
        assert got["grow_capacity"] == 352 and got["grow_cow"]
        np.testing.assert_array_equal(got["grow_ids"], np.arange(305, 345))
        np.testing.assert_array_equal(got["grow_ids"], want["grow_ids"])
        # rank r takes rows [88 r, 88 (r + 1)): 8 r + 8 of them from rank r + 1
        assert [r["dense_index"]["local_grow_moved"] for r in four] == [8, 16, 24, 0]
        for other in (want, single):
            np.testing.assert_allclose(got["grow_vectors"], other["grow_vectors"],
                                       rtol=1e-5, atol=1e-6)
    else:
        for other in (want, single):
            np.testing.assert_array_equal(got[f"{step}_mapping"], other[f"{step}_mapping"])
        assert got.get("compact_deleted", 0) == 0
    if step == "shrink":
        assert got["shrink_capacity"] == 192 < got["compact_capacity"] == 352
        assert got["shrink_n"] == single["shrink_n"] == 170
        np.testing.assert_allclose(got["shrink_vectors"], single["shrink_vectors"],
                                   rtol=0, atol=0)


def _jax_indexer_steps(jmesh, inp, path):
    """The Indexer steps of the worker's ``check_indexer`` on a JAX mesh,
    then its export; returns the dense capacity before and after the add
    past it."""
    cfg = JConfig()
    cfg.index.capacity_round = inp["round"]
    jix = JIndexer(db_path=":memory:", encoder=JEnc(dim=128), config=cfg, mesh=jmesh)
    jix.index_documents(inp["docs"])
    jix.delete_documents(inp["dead"])
    jix.add_documents(inp["more"])
    cap = jix.dense.capacity
    jix.add_documents(inp["grow_docs"])
    jix.export_json(path)
    return cap, jix.dense.capacity


def test_indexer_add_past_capacity_and_export_on_mesh(world, jmesh, tmp_path):
    """``add_documents`` past the dense capacity grows the mesh's rows and
    realigns BM25 (rows as the JAX single-device searcher serves them), and
    ``export_json`` writes the file the JAX mesh Indexer and the port's
    single-device Indexer write after the same steps (documents and ids
    equal, vectors within 1e-6); imported back onto the mesh and onto one
    device it holds the same rows."""
    inputs, _jivf, four, _one = world
    inp = inputs["indexer"]
    got = _ranks(four, "indexer")[0]
    cap_before, cap_after = got["grown_capacity"]
    assert cap_after > cap_before and got["grown_aligned"]
    cfg = JConfig()
    cfg.index.capacity_round = 8
    js = JSearcher(encoder=JEnc(dim=128), use_query_memory=False, config=cfg)
    js.indexer.index_documents(inp["docs"])
    js.indexer.delete_documents(inp["dead"])
    js.indexer.add_documents(inp["more"] + inp["grow_docs"])
    _same_rows(got["grown"], _jrows(js.search_batch(QUERIES, top_k=5, log=False)))
    assert _jax_indexer_steps(jmesh, inp, str(tmp_path / "jax.json")) == (cap_before,
                                                                          cap_after)
    tcfg = TConfig()
    tcfg.index.capacity_round = 8
    tix = TIndexer(db_path=":memory:", config=tcfg, device="cpu",
                   encoder=convert.hashing_encoder(inp["table"], device="cpu"))
    tix.index_documents(inp["docs"])
    tix.delete_documents(inp["dead"])
    tix.add_documents(inp["more"] + inp["grow_docs"])
    tix.export_json(str(tmp_path / "single.json"))
    with open(inp["dump"]) as f:
        text = f.read()
    mesh_dump = json.loads(text)
    assert text == json.dumps(mesh_dump)  # json.dump's own text, byte for byte
    for other in ("jax.json", "single.json"):
        with open(tmp_path / other) as f:
            want = json.load(f)
        assert mesh_dump["documents"] == want["documents"]
        assert mesh_dump["doc_ids"] == want["doc_ids"]
        np.testing.assert_allclose(np.asarray(mesh_dump["vectors"]),
                                   np.asarray(want["vectors"]), rtol=1e-5, atol=1e-6)
    vecs = np.asarray(mesh_dump["vectors"], np.float32)
    assert got["imported_n"] == len(vecs) == len(inp["docs"]) + len(MORE) + len(GROW_DOCS)
    np.testing.assert_allclose(got["imported_vectors"], vecs, rtol=1e-6, atol=1e-7)
    one = TIndexer(db_path=":memory:", encoder=convert.hashing_encoder(inp["table"],
                                                                       device="cpu"),
                   device="cpu")
    assert one.import_json(inp["dump"]) == len(vecs)
    np.testing.assert_allclose(one.dense.get_vectors(list(range(one.dense.n_docs))), vecs, rtol=1e-6, atol=1e-7)
    assert one.contents == mesh_dump["documents"]


@pytest.mark.parametrize("dead", [False, True])
def test_hybrid_bm25_on_mesh(world, jmesh, demo_docs, dead):
    """``HybridBM25Pipeline.search`` on the mesh: the divide-by-max fusion
    rank by rank with one all-reduce of both arms' maxima, equal to the
    port's single-device pipeline and, with no tombstone, to the JAX
    pipeline on a 4-device mesh (ids, values within 1e-5). With tombstones
    the maxima still count the dead rows, as the single device's do (the
    JAX mesh's scatter arm zeroes a dead row's cosine instead)."""
    inputs, _jivf, four, _one = world
    inp = inputs["indexer"]
    got = _ranks(four, "indexer")[0]["hybrid_bm25_dead" if dead else "hybrid_bm25"]
    single = tcreate_pipeline("hybrid_bm25", device="cpu",
                              encoder=convert.hashing_encoder(inp["table"], device="cpu"))
    single.index(demo_docs)
    if dead:
        single.indexer.delete_documents(inp["dead"])
    want = _jrows([single.search(q, top_k=5).results for q in QUERIES])
    _same_rows(got, want)
    assert all(len(row) == 5 for row in got)
    if not dead:
        jp = jcreate_pipeline("hybrid_bm25", encoder=JEnc(dim=128), mesh=jmesh)
        jp.index(demo_docs)
        # two queries: each JAX mesh search compiles anew (3-4 s)
        _same_rows(got[:2], _jrows([jp.search(q, top_k=5).results for q in QUERIES[:2]]))
    else:
        assert not set(inp["dead"]) & {i for row in got for _v, i in row}


def test_bf16_ivf_sharded_matches_jax(world):
    """Sharded bfloat16 storage: the port's own build (the JAX k-means
    draws injected) holds on every rank the JAX bfloat16 build's ids and
    its rows within one bfloat16 step, and serves what the JAX build
    serves; so does the JAX build carried across."""
    inputs, (_jivf, jb16), four, _one = world
    outs = _ranks(four, "ivf")
    got = outs[0]
    assert got["b16_dtypes"] == ("torch.bfloat16", "torch.bfloat16")
    rows_s = np.asarray(jb16._docs_perm, np.float32)
    ids_s = np.asarray(jb16._perm_to_orig)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["local_b16_ids"], ids_s[r])
        np.testing.assert_allclose(o["local_b16_rows"], rows_s[r], rtol=2.0 ** -7, atol=0)
    q = inputs["ivf"]["q"]
    _same_topk(*got["b16"], *jb16.search(q, 10))
    _same_topk(*got["b16_full"], *jb16.search(q, 10, nprobe=10**9))
    _same_topk(*got["b16_carried"], *jb16.search(q, 10))


def test_pipelines_take_the_mesh(world):
    _inputs, _jivf, four, _one = world
    ix = _ranks(four, "indexer")[0]
    assert ix["basic"][0] and ix["basic"][0][0][1] == ix["built"][0][0][1]


def test_degenerate_mesh_of_one_rank(world, demo_docs):
    """A world of one rank: the mesh programs (with their collectives)
    serve what the single-device searcher serves."""
    _inputs, _jivf, _four, one = world
    got = _ranks(one, "searcher_world1")[0]
    _same_rows(got["mesh"], got["single"])
    js = JSearcher(encoder=JEnc(dim=128), use_query_memory=False)
    js.indexer.index_documents(demo_docs)
    _same_rows(got["mesh"], _jrows(js.search_batch(QUERIES, top_k=6, log=False)))
    assert got["deleted"] not in [i for _v, i in got["after_delete"][0]]
