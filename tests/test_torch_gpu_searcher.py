"""search_batch on the card against the same index carried to the CPU
(plain versions), and the launch counters that show the kernels ran: the
supertile ladder on a clustered index (K1-K3) and the impact ladder on a
``layout="source"`` index (K1, K6, K7).

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_searcher.py

Tolerances: fused scores 1e-4 (float32 sums in another order); ids equal
except inside near-ties within the certificate margin eps_num = 1e-4.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

EPS = 1e-4


def _corpus(rng, n_docs):
    topics = [[f"z{z}t{j}" for j in range(24)] for z in range(48)]
    bg = [f"w{i}" for i in range(3000)]
    texts = [" ".join(list(rng.choice(topics[i % 48], 32)) + list(rng.choice(bg, 16)))
             for i in range(n_docs)]
    queries = [" ".join(list(rng.choice(topics[z], 3)) + [bg[z]]) for z in range(40)]
    return texts, queries


def _cpu_copy(gpu, layout):
    """A CPU Searcher over the card searcher's index state."""
    from hybridsearch_tpu_torch import convert
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    snap, st = gpu.indexer.dense._snap, gpu.indexer.bm25._state
    po = st.postings
    cfg = EngineConfig()
    cfg.index.layout = layout
    idx = convert.indexer(
        gpu.indexer.contents,
        convert.hashing_encoder(gpu.indexer.encoder.table.cpu().numpy(), device="cpu"),
        convert.dense_index(snap.docs.cpu().numpy(), snap.bias.cpu().numpy(), snap.n,
                            device="cpu"),
        convert.bm25_index(np.asarray(st.vocab.id_to_hash, np.uint64),
                           po.indptr.cpu().numpy(), po.doc_ids.cpu().numpy(),
                           po.weights.cpu().numpy(), po.n_docs, device="cpu"),
        config=cfg)
    return sm.Searcher(indexer=idx, use_query_memory=False, config=cfg)


def _same_rows(got, want):
    for g, w in zip(got, want):
        gv = np.array([v for v, _c, _i in g])
        wv = np.array([v for v, _c, _i in w])
        np.testing.assert_allclose(gv, wv, rtol=EPS, atol=EPS)
        for j, (a, b) in enumerate(zip([i for *_x, i in g], [i for *_x, i in w])):
            if a != b:
                assert (np.abs(wv - wv[j]) <= EPS).sum() > 1, (j, a, b)


def _route_matches_cpu(monkeypatch, layout, kernels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    rng = np.random.default_rng(0)
    texts, queries = _corpus(rng, 24576)  # 192 tiles: K1's route
    cfg = EngineConfig()
    cfg.index.layout = layout
    gpu = sm.Searcher(config=cfg, use_query_memory=False, device="cuda")
    gpu.indexer.index_documents(texts)
    cpu = _cpu_copy(gpu, layout)
    monkeypatch.setattr(sm, "SPARSE_HYBRID_MIN_DOCS", 0)
    before = [k.launches for k in kernels]
    got = gpu.search_batch(queries, top_k=10, log=False)
    after = [k.launches for k in kernels]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    _same_rows(got, cpu.search_batch(queries, top_k=10, log=False))


def test_gpu_supertile_route_matches_the_cpu_route(monkeypatch):
    from hybridsearch_tpu_torch.ops import cuda_supertile, cuda_topk

    _route_matches_cpu(monkeypatch, "clustered",
                       [cuda_topk.tile_stats, cuda_supertile.super_scores,
                        cuda_supertile.place_windows])


def test_gpu_impact_route_matches_the_cpu_route(monkeypatch):
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_topk

    _route_matches_cpu(monkeypatch, "source",
                       [cuda_topk.tile_stats, cuda_impact.slice_runs,
                        cuda_impact.rescore])
