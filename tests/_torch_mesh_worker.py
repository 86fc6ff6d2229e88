"""Rank code of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_sharded_index.py, tests/test_torch_training_mesh.py): each test module starts one world of
ranks (``hybridsearch_tpu_torch.parallel.dryrun.launch``) that runs every
check of the module and returns, per check, each rank's result (or the
error it raised). This module imports torch, numpy and the port only, so
the spawned ranks start without JAX.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch

CPU = torch.device("cpu")


def run_checks(rank: int, world: int, module: str, inputs: dict,
               device: str = "cpu") -> dict:
    """Build the mesh over the world on ``device`` and run every check of
    ``module`` (a key of ``CHECKS``) that ``inputs`` names; a check that
    raises records its traceback (every rank raises alike, so no
    collective is left waiting)."""
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(device=device)
    out = {}
    for name, fn in CHECKS[module].items():
        if name not in inputs:
            continue
        try:
            out[name] = fn(mesh, inputs[name])
        except Exception:  # noqa: BLE001  (reported to the test)
            out[name] = {"error": traceback.format_exc()}
    return out


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rows(results):
    return [[(float(v), int(i)) for v, _c, i in row] for row in results]


# -- the collectives (tests/test_torch_parallel.py) ---------------------------

def check_mesh(mesh, inp):
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh, pad_to_shards, shard_count

    try:
        build_mesh(n_data=inp["bad_n_data"])
        bad = None
    except ValueError as e:
        bad = str(e)
    return {"shards": shard_count(mesh), "data_index": mesh.data_index,
            "backend": mesh.backend, "bad_shape_error": bad,
            "pad": pad_to_shards(1000, shard_count(mesh))}


def check_dense_topk(mesh, inp):
    from hybridsearch_tpu_torch.parallel.collectives import sharded_dense_topk
    from hybridsearch_tpu_torch.parallel.mesh import doc_sharding

    sh = doc_sharding(mesh)
    bias = sh.local(inp["bias"]) if inp.get("bias") is not None else None
    v, i = sharded_dense_topk(mesh, torch.from_numpy(inp["q"]), sh.local(inp["docs"]),
                              inp["k"], block_n=inp["block_n"], valid_n=inp["n"],
                              bias_local=bias)
    return {"vals": _np(v), "ids": _np(i)}


def check_hybrid_topk(mesh, inp):
    from hybridsearch_tpu_torch.ops.bm25 import (
        build_sharded_postings,
        encode_run_pieces_sharded,
        sharded_bm25_scores,
        sharded_bm25_topk,
    )
    from hybridsearch_tpu_torch.parallel.collectives import sharded_hybrid_topk
    from hybridsearch_tpu_torch.parallel.mesh import doc_sharding, shard_count

    sh = doc_sharding(mesh)
    po = build_sharded_postings(inp["t"], inp["d"], inp["w"], inp["n"], inp["V"],
                                shard_count(mesh), mesh.data_index, mesh.device,
                                docs_per_shard=inp["per"])
    groups = encode_run_pieces_sharded(po, inp["terms"])
    B = len(inp["terms"])
    v, i = sharded_hybrid_topk(mesh, torch.from_numpy(inp["q"]), sh.local(inp["docs"]),
                               po.doc_ids, po.weights, groups, inp["k"], 0.7, 0.3,
                               valid_n=inp["n"], bias_local=sh.local(inp["bias"]))
    bv, bi = sharded_bm25_topk(mesh, po, groups, inp["k"], B)
    return {"vals": _np(v), "ids": _np(i), "bm25_vals": _np(bv), "bm25_ids": _np(bi),
            "max_postings": po.max_postings, "widths": [w for w, _s, _l in groups],
            "local": {"bm25_cols": _np(sharded_bm25_scores(po, groups, B)),
                      "indptr": _np(po.indptr), "doc_ids": _np(po.doc_ids),
                      "groups": [(w, s, l) for w, s, l in groups]}}


def check_supertile(mesh, inp):
    from hybridsearch_tpu_torch.ops.supertile import (
        build_super_postings_sharded,
        encode_super_queries_sharded,
    )
    from hybridsearch_tpu_torch.parallel.collectives import sharded_supertile_topk
    from hybridsearch_tpu_torch.parallel.mesh import doc_sharding, shard_count

    sh = doc_sharding(mesh)
    ssp = build_super_postings_sharded(inp["t"], inp["d"], inp["w"], inp["n"], inp["V"],
                                       docs_per_shard=inp["per"],
                                       n_shards=shard_count(mesh),
                                       shard=mesh.data_index, device=mesh.device,
                                       super_tiles=inp["st"])
    enc = encode_super_queries_sharded(ssp, inp["terms"])
    bias = sh.local(inp["bias"]) if inp.get("bias") is not None else None
    out = {"local": {"sup_max": _np(ssp.sup_max), "sup_pos": _np(ssp.sup_pos)},
           "df": ssp.df_host, "win_max": ssp.win_max_host, "runs": {}}
    for s_probe, w_s, w_l in inp["runs"]:
        v, i, e = sharded_supertile_topk(
            mesh, torch.from_numpy(inp["q"]), sh.local(inp["docs"]), ssp.sup_max,
            ssp.sup_pos, ssp.ids_rows, ssp.ws_rows, enc, inp["k"], w_s, w_l,
            s_probe=s_probe, valid_n=inp["n"], n_alive=inp["n_alive"],
            bias_local=bias, super_tiles=inp["st"])
        out["runs"][s_probe] = {"vals": _np(v), "ids": _np(i), "exact": _np(e)}
    return out


def _encoder(table, mesh):
    from hybridsearch_tpu_torch import convert

    return convert.hashing_encoder(table, device=mesh.device)


def check_searcher(mesh, inp):
    """The port's own index_documents on the mesh, served, then the
    single-device Searcher on the same docs; tombstones last."""
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    out = {}
    enc = _encoder(inp["table"], mesh)
    meshy = Searcher(encoder=enc, mesh=mesh, use_query_memory=False)
    meshy.indexer.index_documents(inp["docs"])
    plain = Searcher(encoder=_encoder(inp["table"], mesh), use_query_memory=False,
                     device=CPU)
    plain.indexer.index_documents(inp["docs"])
    out["mesh"] = _rows(meshy.search_batch(inp["queries"], top_k=6, log=False))
    out["single"] = _rows(plain.search_batch(inp["queries"], top_k=6, log=False))
    out["lex_mesh"] = meshy.indexer.bm25.score_all(inp["queries"][0])
    top = out["mesh"][0][0][1]
    meshy.indexer.dense.delete([top])
    out["after_delete"] = _rows(meshy.search_batch(inp["queries"][:1], top_k=11,
                                                   log=False))
    out["deleted"] = top
    out["deleted_count"] = meshy.indexer.dense.deleted_count
    return out


def check_supertile_searcher(mesh, inp):
    """The JAX mesh searcher's state carried into the port: the exact
    collective program, then the supertile ladder (threshold lowered), then
    again under HST_SUPER_HYBRID=0."""
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval import searcher as tsm
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

    cfg = EngineConfig()
    cfg.index.layout = "clustered"
    cfg.index.dim = inp["table"].shape[1]
    dense = convert.dense_index(inp["snap_docs"], inp["snap_bias"], inp["n"],
                                mesh=mesh)
    bm = convert.sharded_bm25_index(inp["vocab"], *inp["bm25"], inp["n"],
                                    inp["per"], mesh)
    convert.attach_sharded_super_postings(
        bm, convert.sharded_super_postings(*inp["ssp"], mesh=mesh))
    idx = convert.indexer(inp["contents"], _encoder(inp["table"], mesh), dense, bm,
                          config=cfg)
    s = tsm.Searcher(indexer=idx, use_query_memory=False, config=cfg)
    out = {"exact_program": _rows(s.search_batch(inp["queries"], top_k=5, log=False))}
    old = tsm.SPARSE_HYBRID_MIN_DOCS
    tsm.SPARSE_HYBRID_MIN_DOCS = 100
    try:
        before = GLOBAL_COUNTERS.get("hybrid_sharded_uncertified")
        out["supertile"] = _rows(s.search_batch(inp["queries"], top_k=5, log=False))
        out["uncertified"] = GLOBAL_COUNTERS.get("hybrid_sharded_uncertified") - before
        os.environ["HST_SUPER_HYBRID"] = "0"
        out["gated"] = _rows(s.search_batch(inp["queries"], top_k=5, log=False))
    finally:
        os.environ.pop("HST_SUPER_HYBRID", None)
        tsm.SPARSE_HYBRID_MIN_DOCS = old
    # the port's own sharded supertile build of the carried COO
    t, d, w = inp["coo"]
    from hybridsearch_tpu_torch.ops.supertile import build_super_postings_sharded
    from hybridsearch_tpu_torch.parallel.mesh import shard_count

    own = build_super_postings_sharded(t, d, w, inp["n"], len(inp["vocab"]),
                                       inp["per"], shard_count(mesh), mesh.data_index,
                                       mesh.device)
    carried = bm.super_postings_sharded()
    out["own_build_equal"] = all(
        torch.equal(getattr(own, f), getattr(carried, f)[:getattr(own, f).shape[0]])
        for f in ("sup_max", "sup_pos", "ids_rows", "ws_rows")) and bool(
        (own.df_host == carried.df_host).all()
        and (own.win_max_host == carried.win_max_host).all())
    return out


def check_downgrade(mesh, inp):
    import warnings

    from hybridsearch_tpu_torch.retrieval.searcher import Searcher
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

    s = Searcher(encoder=_encoder(inp["table"], mesh), mesh=mesh, use_query_memory=False)
    s.indexer.index_documents(inp["docs"])
    before = GLOBAL_COUNTERS.get("semantic_exactness_downgrade")
    s.indexer.bm25.fit(inp["docs"][:5])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows = _rows([s.search(inp["query"], top_k=2, log=False)])
    return {"rows": rows,
            "counted": GLOBAL_COUNTERS.get("semantic_exactness_downgrade") - before,
            "warned": any("scatter-2k" in str(w.message) for w in caught)}


def check_fallbacks(mesh, inp):
    """The collective fusion of rank-local arms: BM25 refitted unaligned
    with the dense rows (each rank's shard scored at the dense width), and
    the fuzzy lexical arm over each rank's docs."""
    import warnings

    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    s = Searcher(encoder=_encoder(inp["table"], mesh), mesh=mesh, use_query_memory=False)
    s.indexer.index_documents(inp["docs"])
    s.indexer.bm25.docs_per_shard = None
    s.indexer.bm25.fit(inp["docs"])
    fuzzy = Searcher(indexer=s.indexer, use_query_memory=False, lexical_mode="fuzzy")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {"bm25_per": s.indexer.bm25.sharded.docs_per_shard,
                "dense_per": s.indexer.dense._rows(s.indexer.dense.capacity)[1],
                "unaligned": _rows(s.search_batch(inp["queries"], top_k=3, log=False)),
                "fuzzy": _rows(fuzzy.search_batch(inp["queries"], top_k=3, log=False))}


# -- the indexes (tests/test_torch_sharded_index.py) ----------------------------

def check_dense_index(mesh, inp):
    from hybridsearch_tpu_torch.index.dense_index import DenseIndex

    idx = DenseIndex(dim=inp["vecs"].shape[1], capacity_round=inp["round"], mesh=mesh)
    idx.build(inp["vecs"])
    out = {"capacity": idx.capacity, "local_rows": idx._snap.docs.shape[0]}
    out["search"] = idx.search(inp["q"], inp["k"])
    ids = idx.add(inp["new"])
    out["added"] = ids
    out["search_added"] = idx.search(inp["new"][2:3], 1)
    idx.delete(inp["dead"])
    idx.delete(inp["dead"][:2])  # named again: counted once
    out["deleted_count"] = idx.deleted_count
    out["search_dead"] = idx.search(inp["q"], inp["k"])
    out["search_bias"] = idx.search(inp["q"], inp["k"], extra_bias=inp["extra_bias"])
    out["vectors"] = idx.get_vectors(inp["get"])
    idx.save(inp["save_dir"])
    loaded = DenseIndex.load(inp["save_dir"], capacity_round=inp["round"], mesh=mesh)
    out["loaded_search"] = loaded.search(inp["q"], inp["k"])
    out["loaded_equal"] = (torch.equal(loaded._snap.docs, idx._snap.docs)
                           and torch.equal(loaded._snap.bias, idx._snap.bias))
    out["loaded_deleted"] = loaded.deleted_count
    one = DenseIndex.load(inp["one_shard_dir"], capacity_round=inp["round"], mesh=mesh)
    out["one_shard_search"] = one.search(inp["q"], inp["k"])
    out.update(_grow_and_compact(idx, inp))
    return out


def _grow_and_compact(idx, inp):
    """Growth past the sharded capacity, then compaction twice (the second
    after half the rows die, so the capacity shrinks): capacity, ids,
    search rows and mappings, each rank's received rows apart."""
    snap = idx._snap
    before = snap.docs.clone()
    out = {"grow_ids": idx.add(inp["grow"]), "grow_capacity": idx.capacity,
           "local_grow_moved": idx.moved_rows,
           "grow_search": idx.search(inp["q_grow"], inp["k"]),
           "grow_vectors": idx.get_vectors(inp["grow_get"]),
           # copy-on-write: the snapshot before the growth keeps its buffers
           "grow_cow": bool(torch.equal(snap.docs, before))}
    out["compact_mapping"] = idx.compact()
    out.update(compact_capacity=idx.capacity, compact_deleted=idx.deleted_count,
               local_compact_moved=idx.moved_rows,
               compact_search=idx.search(inp["q_grow"], inp["k"]))
    idx.delete(inp["dead2"])
    out["shrink_mapping"] = idx.compact()
    out.update(shrink_capacity=idx.capacity, shrink_n=idx.n_docs,
               shrink_search=idx.search(inp["q_grow"], inp["k"]),
               shrink_vectors=idx.get_vectors(list(range(idx.n_docs))))
    return out


def check_bm25(mesh, inp):
    from hybridsearch_tpu_torch.index.sparse_index import BM25

    bm = BM25(mesh=mesh).fit(inp["docs"])
    single = BM25(device=CPU).fit(inp["docs"])
    out = {"sharded": bm.sharded is not None and bm.postings is None,
           "scores": [bm.score_all(q) for q in inp["queries"]],
           "search": [bm.search(q, top_k=3) for q in inp["queries"]],
           "single_search": [single.search(q, top_k=3) for q in inp["queries"]],
           "cand": bm.candidate_scores(inp["queries"][0], np.array(inp["cand"]))}
    try:
        bm.save(os.path.join(inp["dir"], "mesh.npz"))
        out["save"] = None
    except ValueError as e:
        out["save"] = str(e)
    loaded = BM25(mesh=mesh).load(inp["npz"])
    out["loaded_sharded"] = loaded.sharded is not None
    out["loaded_search"] = [loaded.search(q, top_k=3) for q in inp["queries"]]
    bm.add_tokens([["machine", "learning", "pasta"]])
    out["added_n"] = bm.n_docs
    out["added_search"] = bm.search("pasta", top_k=3)
    return out


def check_ivf(mesh, inp):
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.index.ivf import IVFIndex

    own = IVFIndex(dim=inp["docs"].shape[1], n_clusters=16, nprobe=6, mesh=mesh)
    own.build(inp["docs"])
    out = {"own_full": own.search(inp["q"], 10, nprobe=10**9)}
    carried = convert.sharded_ivf_index(*inp["arrays"], mesh=mesh, nprobe=6)
    out["carried"] = carried.search(inp["q"], 10)
    out["carried_full"] = carried.search(inp["q"], 10, nprobe=10**9)
    out.update(_bf16_ivf(mesh, inp))
    try:
        own.from_layout(torch.zeros((8, inp["docs"].shape[1])), 4,
                        np.zeros((2, inp["docs"].shape[1]), np.float32), np.zeros(4))
        out["from_layout"] = None
    except ValueError as e:
        out["from_layout"] = str(e)
    return out


def _bf16_ivf(mesh, inp):
    """The sharded build with bfloat16 storage and the JAX k-means draws
    injected (rank 0 fits, ``mesh_kmeans``), and a JAX bfloat16 sharded
    build carried across; each rank's rows and ids apart."""
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.index import ivf as ivf_mod

    init, reseed = inp["draws"]
    real = ivf_mod.kmeans_fit
    ivf_mod.kmeans_fit = lambda v, k, seed=0, iters=10: real(
        v, k, seed=seed, iters=iters, init_idx=torch.from_numpy(init),
        reseed_idx=torch.from_numpy(reseed))
    try:
        b16 = ivf_mod.IVFIndex(dim=inp["docs"].shape[1], n_clusters=16, nprobe=6,
                               mesh=mesh, storage_dtype=torch.bfloat16)
        b16.build(inp["docs"])
    finally:
        ivf_mod.kmeans_fit = real
    carried = convert.sharded_ivf_index(*inp["arrays_b16"], mesh=mesh, nprobe=6,
                                        storage_dtype=torch.bfloat16)
    return {"b16_dtypes": (str(b16._docs_perm.dtype), str(carried._docs_perm.dtype)),
            "local_b16_rows": b16._docs_perm.float().numpy(),
            "local_b16_ids": b16._perm_to_orig.numpy(),
            "b16": b16.search(inp["q"], 10),
            "b16_full": b16.search(inp["q"], 10, nprobe=10**9),
            "b16_carried": carried.search(inp["q"], 10)}


def check_indexer(mesh, inp):
    """Indexer on the mesh: build, serve, tombstone, save, load back (every
    rank its own store), a single-device save loaded onto the mesh, adds
    within and past the dense capacity, the JSON export imported back onto
    the mesh, and HybridBM25Pipeline before and after a delete."""
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.pipelines import create_pipeline
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    cfg = EngineConfig()
    cfg.index.capacity_round = inp["round"]
    db = os.path.join(inp["dir"], f"store_{mesh.data_index}.db")
    ix = Indexer(db_path=db, encoder=_encoder(inp["table"], mesh), config=cfg, mesh=mesh)
    ix.index_documents(inp["docs"])
    s = Searcher(indexer=ix, use_query_memory=False, config=cfg)
    out = {"built": _rows(s.search_batch(inp["queries"], top_k=5, log=False))}
    ix.delete_documents(inp["dead"])
    out["deleted"] = _rows(s.search_batch(inp["queries"], top_k=5, log=False))
    ix.save(os.path.join(inp["dir"], "saved"))
    lx = Indexer.load(os.path.join(inp["dir"], "saved"),
                      encoder=_encoder(inp["table"], mesh), db_path=db, mesh=mesh)
    ls = Searcher(indexer=lx, use_query_memory=False, config=lx.config)
    out["loaded"] = _rows(ls.search_batch(inp["queries"], top_k=5, log=False))
    out["loaded_aligned"] = (lx.bm25.sharded is not None and lx.bm25.sharded.docs_per_shard
                             * lx.bm25.sharded.n_shards == lx.dense.capacity)
    import shutil

    single_db = os.path.join(inp["dir"], f"single_{mesh.data_index}.db")
    shutil.copy(inp["single_db"], single_db)  # a store of its own a rank
    jx = Indexer.load(inp["single_dir"], encoder=_encoder(inp["table"], mesh),
                      db_path=single_db, mesh=mesh)
    js = Searcher(indexer=jx, use_query_memory=False, config=jx.config)
    out["single_saved"] = _rows(js.search_batch(inp["queries"], top_k=5, log=False))
    ix.add_documents(inp["more"])
    out["added"] = _rows(s.search_batch(inp["queries"], top_k=5, log=False))
    # past the dense capacity: the rows grow across the ranks, BM25 refits
    cap = ix.dense.capacity
    ix.add_documents(inp["grow_docs"])
    out["grown"] = _rows(s.search_batch(inp["queries"], top_k=5, log=False))
    out["grown_capacity"] = (cap, ix.dense.capacity)
    out["grown_aligned"] = (ix.bm25.sharded.docs_per_shard * ix.bm25.sharded.n_shards
                            == ix.dense.capacity)
    ix.export_json(inp["dump"])  # rank 0 writes it
    mx = Indexer(db_path=os.path.join(inp["dir"], f"import_{mesh.data_index}.db"),
                 encoder=_encoder(inp["table"], mesh), config=cfg, mesh=mesh)
    out["imported_n"] = mx.import_json(inp["dump"])
    out["imported_vectors"] = mx.dense.get_vectors(list(range(mx.dense.n_docs)))
    out["imported_rows"] = _rows(Searcher(indexer=mx, use_query_memory=False,
                                          config=cfg).search_batch(inp["queries"],
                                                                   top_k=5, log=False))
    basic = create_pipeline("basic", encoder=_encoder(inp["table"], mesh), mesh=mesh)
    basic.index(inp["docs"])
    out["basic"] = _rows([basic.search(inp["queries"][0], top_k=3).results])
    hb = create_pipeline("hybrid_bm25", encoder=_encoder(inp["table"], mesh), mesh=mesh)
    hb.index(inp["docs"])
    out["hybrid_bm25"] = _rows([hb.search(q, top_k=5).results for q in inp["queries"]])
    hb.indexer.delete_documents(inp["dead"])
    out["hybrid_bm25_dead"] = _rows([hb.search(q, top_k=5).results
                                     for q in inp["queries"]])
    return out


def check_card_mesh(mesh, inp):
    """tests/test_torch_gpu_parallel.py: a clustered index on the mesh
    (hashing encoder), one batch through the sharded supertile ladder
    (threshold lowered to 0) with the kernels' counts set to 0 before and
    read after, then through the exact collective program
    (``HST_SUPER_HYBRID=0``)."""
    import hashlib

    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder
    from hybridsearch_tpu_torch.ops import cuda_supertile, cuda_topk
    from hybridsearch_tpu_torch.retrieval import searcher as tsm
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

    cfg = EngineConfig()
    cfg.index.layout, cfg.index.dim = "clustered", 384
    s = tsm.Searcher(config=cfg, use_query_memory=False, mesh=mesh,
                     encoder=HashingEncoder(dim=384, device=mesh.device))
    s.indexer.index_documents(inp["texts"])
    kernels = {"tile_stats": cuda_topk.tile_stats,
               "place_windows": cuda_supertile.place_windows,
               "super_scores_dedup": cuda_supertile.super_scores_dedup}
    for fn in kernels.values():
        fn.launches = 0
    old = tsm.SPARSE_HYBRID_MIN_DOCS
    tsm.SPARSE_HYBRID_MIN_DOCS = 0
    try:
        before = GLOBAL_COUNTERS.get("hybrid_sharded_uncertified")
        ladder = _rows(s.search_batch(inp["queries"], top_k=10, log=False))
        fell_back = GLOBAL_COUNTERS.get("hybrid_sharded_uncertified") - before
        launches = {name: fn.launches for name, fn in kernels.items()}
        os.environ["HST_SUPER_HYBRID"] = "0"
        exact = _rows(s.search_batch(inp["queries"], top_k=10, log=False))
    finally:
        os.environ.pop("HST_SUPER_HYBRID", None)
        tsm.SPARSE_HYBRID_MIN_DOCS = old
    return {"ladder": ladder, "exact": exact, "fell_back": fell_back,
            "launches": launches, "backend": mesh.backend,
            "contents_sha": hashlib.sha256(
                "\n".join(s.indexer.contents).encode()).hexdigest()}


# -- the trainers on a (data 2, model 2) mesh (tests/test_torch_training_mesh.py) --

def _trainer(inp, dtype, mesh):
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.models.bert import BertConfig
    from hybridsearch_tpu_torch.training import ContrastiveTrainer, CrossEncoderTrainer

    cls = ContrastiveTrainer if inp["kind"] == "contrastive" else CrossEncoderTrainer
    tr = cls(cfg=BertConfig(**inp["cfg"], dtype=getattr(torch, dtype)), mesh=mesh,
             learning_rate=inp["lr"])
    tr.params = convert.bert_state(inp["params"])
    return tr


def _np_state(state):
    return {k: _np(v) for k, v in state.items()}


def check_train(mesh, inp):
    """On a data 2 x model 2 mesh, from the given init (flat Flax-layout
    arrays): at each activation dtype the loss and the gathered gradients of
    one batch, the parameters after the step; the AdamW step fed the JAX
    gradients (each rank its slice) from the same init, when the inputs
    hold them; the local shapes of two sharded weights."""
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh

    m22 = build_mesh(n_data=2, n_model=2, device=mesh.device)
    out = {"coords": (m22.data_index, m22.model_index)}
    for dtype in ("bfloat16", "float32"):
        tr = _trainer(inp, dtype, m22)
        loss = tr.loss_and_grads(inp["batch"])
        out[dtype] = {"loss": float(loss), "grads": _np_state(tr.grads())}
        tr.optimizer.step()
        out[dtype]["params"] = _np_state(tr.params)
    out["local_shapes"] = {n: tuple(p.shape) for n, p in tr.model.named_parameters()
                           if n.endswith(("layer_0.attention.query.weight",
                                          "layer_0.mlp_out.weight"))}
    if "jax_grads" in inp:
        tr = _trainer(inp, "float32", m22)
        jax_grads = convert.bert_state(inp["jax_grads"])
        for n, p in tr.model.named_parameters():
            p.grad = tr._local(n, jax_grads[n])
        tr.optimizer.step()
        out["update_rule"] = _np_state(tr.params)
    return out


def check_dryrun_training(mesh, inp):
    from hybridsearch_tpu_torch.parallel.dryrun import _dryrun_training

    return _dryrun_training(inp["world"], mesh.device.type)


CHECKS = {
    "parallel": {
        "mesh": check_mesh,
        "dense_topk": check_dense_topk,
        "dense_topk_bias": check_dense_topk,
        "hybrid_topk": check_hybrid_topk,
        "hybrid_topk_wide": check_hybrid_topk,
        "supertile": check_supertile,
        "supertile_dead": check_supertile,
        "searcher": check_searcher,
        "supertile_searcher": check_supertile_searcher,
        "downgrade": check_downgrade,
        "fallbacks": check_fallbacks,
    },
    "index": {
        "dense_index": check_dense_index,
        "bm25": check_bm25,
        "ivf": check_ivf,
        "indexer": check_indexer,
        "searcher_world1": check_searcher,
    },
    "card": {"card_mesh": check_card_mesh},
    "training": {
        "contrastive": check_train,
        "cross": check_train,
        "dryrun": check_dryrun_training,
    },
}
