"""The single-device routes on the card against the same index carried to
the CPU (plain versions): the tile ladder on a clustered index
(``HST_SUPER_HYBRID=0``: K1, K4 at tile grain, K6), the impact ladder on a
clustered index (both gates ``0``: K1, K4, K6, K7), the one-call supertile
entry (K2, K3), ``hybrid_sparse_topk`` with hot-term tables (K1, K4) and
the IVF index (scatter mode). Each batch served twice on the card is equal
bit for bit. Then the int8 sweep (``int8_swept_topk``: ``torch._int_mm``
with a small batch padded, K4 at tile grain in pass 3) and the bfloat16
IVF against the CPU.

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


# -- the int8 sweep and the bfloat16 IVF ----------------------------------------------

def _unit_rows(n, d, seed, clusters=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    if clusters:  # in cluster order, as the clustered layout keeps them
        cents = torch.randn((clusters, d), generator=g) * 3
        x = cents[torch.randint(0, clusters, (n,), generator=g).sort().values] + x
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("B,D", [(1, 384), (5, 384), (16, 384), (17, 384), (40, 100)])
def test_gpu_int8_product_pads_small_batches(B, D):
    """``torch._int_mm`` takes more than 16 rows and depths that are
    multiples of 8: the padded product equals the exact int32 product."""
    _need_card()
    from hybridsearch_tpu_torch.ops.dense import _int8_product

    g = torch.Generator().manual_seed(B * 1000 + D)
    q8 = torch.randint(-127, 128, (B, D), generator=g, dtype=torch.int8)
    d8 = torch.randint(-127, 128, (1024, D), generator=g, dtype=torch.int8)
    got = _int8_product(q8.cuda(), d8.cuda())
    assert got.dtype == torch.int32 and got.shape == (B, 1024)
    assert torch.equal(got.cpu(), q8.int() @ d8.int().T)


def test_gpu_int8_swept_topk_matches_the_cpu_and_the_exact_topk():
    """The sweep on the card (``torch._int_mm``, K4 at tile grain in pass
    3) against the same call on the CPU: the certificates differ on at most
    2 rows (float order at the margin), ids are equal and values within
    1e-5 on rows both certify; certified rows, and every row with every
    tile probed, equal the card's exact ``tiled_dense_topk`` (K1, K4) bit
    for bit; K4 launched."""
    _need_card()
    from hybridsearch_tpu_torch.ops import cuda_supertile
    from hybridsearch_tpu_torch.ops.dense import (
        int8_swept_topk,
        quantize_corpus_int8,
        tiled_dense_topk,
    )

    docs = _unit_rows(N_DOCS, 384, 1, clusters=64)
    q = docs[::N_DOCS // 48] + _unit_rows(48, 384, 2)  # near docs of every cluster
    q = q / q.norm(dim=1, keepdim=True)
    bias = torch.zeros(N_DOCS)
    bias[torch.randperm(N_DOCS, generator=torch.Generator().manual_seed(3))[:500]] = -np.inf
    d8c, scc, resc = quantize_corpus_int8(docs)
    cpu = int8_swept_topk(q, d8c, scc, docs, resc, 10, bias=bias)
    d_g, q_g, b_g = docs.cuda(), q.cuda(), bias.cuda()
    d8, sc, res = quantize_corpus_int8(d_g)
    cuda_supertile.super_scores_dedup.launches = 0
    gv, gi, gc = int8_swept_topk(q_g, d8, sc, d_g, res, 10, bias=b_g)
    assert cuda_supertile.super_scores_dedup.launches > 0
    assert gc.any()
    both = (gc.cpu() & cpu[2]).numpy()
    assert both.sum() >= int(gc.sum()) - 2
    np.testing.assert_allclose(gv.cpu().numpy()[both], cpu[0].numpy()[both],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gi.cpu().numpy()[both], cpu[1].numpy()[both])
    ev, ei = tiled_dense_topk(q_g, d_g, 10, bias=b_g)
    assert torch.equal(gv[gc], ev[gc]) and torch.equal(gi[gc], ei[gc])
    # every tile probed (the last rung of an escalation): all rows certified
    fv, fi, fc = int8_swept_topk(q_g[:4], d8, sc, d_g, res, 10,
                                 probe_tiles=N_DOCS // 128, bias=b_g)
    assert bool(fc.all()) and torch.equal(fv, ev[:4]) and torch.equal(fi, ei[:4])


def test_gpu_bf16_ivf_matches_the_cpu_and_the_f32_index():
    """A bfloat16 IVF built on the card: its rows are bfloat16 (half the
    bytes of the float32 build of the same vectors and seed, whose
    centroids and chunks it shares), the same arrays carried to the CPU
    serve the same rows, and its ids equal the float32 index's but where
    the two docs at a slot have float32 scores within 2^-8."""
    _need_card()
    from hybridsearch_tpu_torch.index.ivf import IVFIndex

    docs = _unit_rows(N_DOCS, 384, 4, clusters=96)
    q = _unit_rows(64, 384, 5)
    f32 = IVFIndex(dim=384, n_clusters=128, nprobe=8, device="cuda").build(docs)
    b16 = IVFIndex(dim=384, n_clusters=128, nprobe=8, device="cuda",
                   storage_dtype=torch.bfloat16).build(docs)
    assert b16._docs_perm.dtype == torch.bfloat16
    assert b16._docs_perm.nbytes * 2 == f32._docs_perm.nbytes
    assert torch.equal(b16._chunk_starts, f32._chunk_starts)
    assert torch.equal(b16._docs_perm, f32._docs_perm.to(torch.bfloat16))
    cpu = IVFIndex(dim=384, nprobe=8, device="cpu").load_arrays(
        b16._centroids.cpu(), b16._docs_perm.cpu(), b16._chunk_starts.cpu(),
        b16._chunk_lens.cpu(), b16._perm_to_orig.cpu(), b16._cap, b16.n_docs)
    bv, bi = b16.search(q, 10)
    cv, ci = cpu.search(q, 10)
    np.testing.assert_allclose(bv, cv, rtol=0, atol=1e-5)
    for b, j in zip(*np.nonzero(bi != ci)):
        assert (np.abs(cv[b] - cv[b][j]) <= 1e-5).sum() > 1, (b, j)
    fv, fi = f32.search(q, 10)
    np.testing.assert_allclose(bv, fv, rtol=0, atol=2.0 ** -8)
    s = (q @ docs.T).numpy()  # float32 scores of every doc
    for b, j in zip(*np.nonzero(bi != fi)):
        assert abs(s[b, bi[b, j]] - fv[b, j]) <= 2.0 ** -8, (b, j)
