"""The single-device routes on the card against the same index carried to
the CPU (plain versions): the tile ladder on a clustered index
(``HST_SUPER_HYBRID=0``: K1, K4 at tile grain, K6), the impact ladder on a
clustered index (both gates ``0``: K1, K4, K6, K7), the one-call supertile
entry (K2, K3), ``hybrid_sparse_topk`` with hot-term tables (K1, K4) and
the IVF index (scatter mode). Each batch served twice on the card is equal
bit for bit.

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_routes.py

Tolerances: fused scores 1e-4 (float32 sums in another order); ids equal
except inside near-ties within the certificate margin eps_num = 1e-4.
Each searcher is given the hashing encoder.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

EPS = 1e-4
N_DOCS = 24576  # 192 tiles: K1's route


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _hashing(device="cuda"):
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    return HashingEncoder(dim=384, device=device)


def _corpus(rng, n_docs):
    topics = [[f"z{z}t{j}" for j in range(24)] for z in range(48)]
    bg = [f"w{i}" for i in range(3000)]
    texts = [" ".join(list(rng.choice(topics[i % 48], 32)) + list(rng.choice(bg, 16))
                      + (["common"] if i % 2 else []))
             for i in range(n_docs)]
    queries = ([" ".join(list(rng.choice(topics[z], 3)) + [bg[z]]) for z in range(32)]
               + [f"common {bg[i]}" for i in range(8)])
    return texts, queries


def _cpu_copy(gpu, layout, **searcher_kw):
    """A CPU Searcher over the card searcher's index state."""
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    snap, st = gpu.indexer.dense._snap, gpu.indexer.bm25._state
    po = st.postings
    cfg = EngineConfig()
    cfg.index.layout = layout
    cfg.index.dim = 384
    idx = convert.indexer(
        gpu.indexer.contents,
        convert.hashing_encoder(gpu.indexer.encoder.table.cpu().numpy(), device="cpu"),
        convert.dense_index(snap.docs.cpu().numpy(), snap.bias.cpu().numpy(), snap.n,
                            device="cpu"),
        convert.bm25_index(np.asarray(st.vocab.id_to_hash, np.uint64),
                           po.indptr.cpu().numpy(), po.doc_ids.cpu().numpy(),
                           po.weights.cpu().numpy(), po.n_docs, device="cpu"),
        config=cfg)
    return sm.Searcher(indexer=idx, use_query_memory=False, config=cfg, **searcher_kw)


def _same_rows(got, want):
    for g, w in zip(got, want):
        gv = np.array([v for v, _c, _i in g])
        wv = np.array([v for v, _c, _i in w])
        np.testing.assert_allclose(gv, wv, rtol=EPS, atol=EPS)
        for j, (a, b) in enumerate(zip([i for *_x, i in g], [i for *_x, i in w])):
            if a != b:
                assert (np.abs(wv - wv[j]) <= EPS).sum() > 1, (j, a, b)


@pytest.fixture(scope="module")
def clustered():
    """A clustered card index and its CPU copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    texts, queries = _corpus(np.random.default_rng(0), N_DOCS)
    cfg = EngineConfig()
    cfg.index.layout = "clustered"
    gpu = sm.Searcher(config=cfg, encoder=_hashing(), use_query_memory=False,
                      device="cuda")
    gpu.indexer.index_documents(texts)
    return gpu, _cpu_copy(gpu, "clustered"), queries


def _route(monkeypatch, clustered, env, kernels):
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    gpu, cpu, queries = clustered
    monkeypatch.setattr(sm, "SPARSE_HYBRID_MIN_DOCS", 0)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    before = [k.launches for k in kernels]
    got = gpu.search_batch(queries, top_k=10, log=False)
    after = [k.launches for k in kernels]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert gpu.search_batch(queries, top_k=10, log=False) == got
    _same_rows(got, cpu.search_batch(queries, top_k=10, log=False))


def test_gpu_tile_route_matches_the_cpu_route_and_repeats(monkeypatch, clustered):
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_supertile, cuda_topk

    _route(monkeypatch, clustered, {"HST_SUPER_HYBRID": "0"},
           [cuda_topk.tile_stats, cuda_supertile.super_scores_dedup,
            cuda_impact.slice_runs])


def test_gpu_clustered_impact_route_matches_the_cpu_route_and_repeats(
        monkeypatch, clustered):
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_supertile, cuda_topk

    _route(monkeypatch, clustered, {"HST_SUPER_HYBRID": "0", "HST_TILE_HYBRID": "0"},
           [cuda_topk.tile_stats, cuda_supertile.super_scores_dedup,
            cuda_impact.slice_runs, cuda_impact.rescore])


def test_gpu_one_call_supertile_equals_prefix_and_rung(clustered):
    from hybridsearch_tpu_torch.ops import cuda_supertile
    from hybridsearch_tpu_torch.ops import supertile as st
    from hybridsearch_tpu_torch.ops.dense import l2_normalize

    gpu, cpu, queries = clustered
    snap = gpu.indexer.dense._snap
    sp, enc = gpu.indexer.bm25.encode_queries_super(queries)
    q = l2_normalize(gpu.indexer.encoder.encode(queries).float())
    for s_probe in (1, 2):
        before = cuda_supertile.super_scores.launches
        one = st.hybrid_supertile_topk(q, snap.docs, sp, enc, 10, 0.7, 0.3,
                                       bias=snap.bias, s_probe=s_probe)
        assert cuda_supertile.super_scores.launches > before
        pfx = st.super_prefix(q, snap.docs, sp, enc, bias=snap.bias, s_max=s_probe)
        rung = st.hybrid_supertile_topk_rung(q, snap.docs, sp, enc, pfx, 10, 0.7, 0.3,
                                             bias=snap.bias, s_probe=s_probe)
        for a, b in zip(one, rung):
            assert torch.equal(a, b)
        csnap = cpu.indexer.dense._snap
        csp, cenc = cpu.indexer.bm25.encode_queries_super(queries)
        cres = st.hybrid_supertile_topk(q.cpu(), csnap.docs, csp, cenc, 10, 0.7, 0.3,
                                        bias=csnap.bias, s_probe=s_probe)
        np.testing.assert_allclose(one.values.cpu().numpy(), cres.values.numpy(),
                                   rtol=EPS, atol=EPS)
        assert torch.equal(one.exact.cpu(), cres.exact)


def test_gpu_sparse_hybrid_with_hot_terms_matches_the_cpu_and_repeats(
        monkeypatch, clustered):
    from hybridsearch_tpu_torch.index.sparse_index import BM25
    from hybridsearch_tpu_torch.ops import bm25 as bm25_ops
    from hybridsearch_tpu_torch.ops import cuda_supertile, cuda_topk
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.ops.hybrid import hybrid_sparse_topk

    gpu, cpu, queries = clustered
    monkeypatch.setattr(bm25_ops, "HOT_DF_THRESHOLD", 4096)  # "common" is hot
    q = l2_normalize(gpu.indexer.encoder.encode(queries).float())
    kw = dict(k_dense=256, m_tiles=64, c_lex=512, n_alive=N_DOCS)
    kernels = (cuda_topk.tile_stats, cuda_supertile.super_scores_dedup)
    out = []
    for s in (gpu, cpu):
        snap = s.indexer.dense._snap
        bm = BM25(device=snap.docs.device).fit_hashes(s.indexer.contents)
        po = bm._state.postings
        groups, hot = bm.encode_queries_sparse(queries)
        assert po.hot_tile_bounds is not None and hot is not None
        before = [k.launches for k in kernels]
        res = hybrid_sparse_topk(q.to(snap.docs.device), snap.docs, po, groups, 10,
                                 0.7, 0.3, bias=snap.bias, hot=hot, **kw)
        if s is gpu:
            assert all(k.launches > b for k, b in zip(kernels, before))
            again = hybrid_sparse_topk(q, snap.docs, po, groups, 10, 0.7, 0.3,
                                       bias=snap.bias, hot=hot, **kw)
            for a, b in zip(res, again):
                assert torch.equal(a, b)
        out.append([t.cpu() for t in res])
    (gv, _gi, ge), (cv, _ci, ce) = out
    np.testing.assert_allclose(gv.numpy(), cv.numpy(), rtol=EPS, atol=EPS)
    assert torch.equal(ge, ce) and ge.any()


def test_gpu_ivf_scatter_mode_matches_the_cpu_and_repeats(monkeypatch):
    _need_card()
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.index.ivf import IVFIndex
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    texts, queries = _corpus(np.random.default_rng(1), 8192)
    cfg = EngineConfig()
    cfg.index.layout = "clustered"
    cfg.index.ann = "ivf"
    gpu = sm.Searcher(config=cfg, encoder=_hashing(), use_query_memory=False,
                      device="cuda", semantic_mode="scatter")
    gpu.indexer.index_documents(texts)
    ivf = gpu.indexer.ivf
    assert ivf._docs_perm is gpu.indexer.dense._snap.docs
    calls = []
    real = IVFIndex.search
    monkeypatch.setattr(IVFIndex, "search",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    got = gpu.search_batch(queries, top_k=10, log=False)
    assert calls and gpu.search_batch(queries, top_k=10, log=False) == got
    cpu = _cpu_copy(gpu, "clustered", semantic_mode="scatter")
    cpu.indexer.ivf = convert.ivf_index(
        ivf._centroids.cpu().numpy(), ivf._docs_perm.cpu().numpy(),
        ivf._chunk_starts.cpu().numpy(), ivf._chunk_lens.cpu().numpy(),
        ivf._perm_to_orig.cpu().numpy(), ivf._cap, ivf.n_docs, nprobe=ivf.nprobe,
        device="cpu")
    _same_rows(got, cpu.search_batch(queries, top_k=10, log=False))
    # full probe: the exact top-k
    q = gpu.indexer.encoder.encode(queries)
    v, i = ivf.search(q, 10, nprobe=10**9)
    ev, ei = gpu.indexer.dense.search(q, 10)
    np.testing.assert_allclose(v, ev, rtol=EPS, atol=EPS)
