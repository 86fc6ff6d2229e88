"""The index lifecycle on the card: an index grown by adds (a merge, then a
pending delta) serves, after ``search_batch`` compacts it, the rows a
one-shot build of the same corpus serves, through the impact ladder's
kernels (K1, K4 at tile grain, K6, K7); its BM25 triples equal the one-shot
build's bit for bit; a tombstoned and then saved and reloaded index serves
the same rows bit for bit; the scatter mode launches K1 and K4.

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_lifecycle.py

Tolerances: fused scores 1e-4 (the grown index sums a query's terms in
another term order); ids equal except inside near-ties within the
certificate margin eps_num = 1e-4.
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


def _searcher(**kw):
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    return Searcher(config=EngineConfig(), encoder=HashingEncoder(dim=384, device="cuda"),
                    use_query_memory=False, device="cuda", **kw)


def _triples(bm):
    st = bm._state
    po = st.postings
    h = np.repeat(np.asarray(st.vocab.id_to_hash, np.uint64),
                  po.lengths_host).astype(np.uint64)
    nnz = len(h)
    d = po.doc_ids[:nnz].cpu().numpy()
    w = po.weights[:nnz].cpu().numpy()
    order = np.lexsort((d, h))
    return h[order], d[order], w[order]


def _same_rows(got, want):
    for g, w in zip(got, want):
        gv = np.array([v for v, _c, _i in g])
        wv = np.array([v for v, _c, _i in w])
        np.testing.assert_allclose(gv, wv, rtol=EPS, atol=EPS)
        for j, (a, b) in enumerate(zip([i for *_x, i in g], [i for *_x, i in w])):
            if a != b:
                assert (np.abs(wv - wv[j]) <= EPS).sum() > 1, (j, a, b)


def test_gpu_grown_index_serves_like_a_one_shot_build(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_supertile, cuda_topk
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    rng = np.random.default_rng(0)
    texts, queries = _corpus(rng, 24576)  # 192 tiles: K1's route
    monkeypatch.setattr(sm, "SPARSE_HYBRID_MIN_DOCS", 0)
    one = _searcher()
    one.indexer.index_documents(texts)
    want = one.search_batch(queries, top_k=10, log=False)
    grown = _searcher(db_path=str(tmp_path / "docs.db"))
    grown.indexer.index_documents(texts[:12288])
    grown.indexer.add_documents(texts[12288:24500])  # past the drift bound
    grown.indexer.add_documents(texts[24500:])  # under it: a pending delta
    assert grown.indexer.bm25._state.delta_seg is not None
    kernels = (cuda_topk.tile_stats, cuda_supertile.super_scores_dedup,
               cuda_impact.slice_runs, cuda_impact.rescore)
    before = [k.launches for k in kernels]
    got = grown.search_batch(queries, top_k=10, log=False)
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert grown.indexer.bm25._state.delta_seg is None
    for a, b in zip(_triples(grown.indexer.bm25), _triples(one.indexer.bm25)):
        assert np.array_equal(a, b)
    diff = (grown.indexer.dense._snap.docs - one.indexer.dense._snap.docs).abs()
    assert float(diff.max()) < 1e-6
    _same_rows(got, want)

    dead = sorted({i for row in got for _v, _c, i in row[:2]})
    grown.indexer.delete_documents(dead)
    served = grown.search_batch(queries, top_k=10, log=False)
    assert not {i for row in served for _v, _c, i in row} & set(dead)
    grown.indexer.save(str(tmp_path / "engine"))
    back = Indexer.load(str(tmp_path / "engine"), encoder=grown.indexer.encoder)
    again = sm.Searcher(indexer=back, use_query_memory=False, config=back.config)
    assert again.search_batch(queries, top_k=10, log=False) == served

    scatter = sm.Searcher(indexer=back, use_query_memory=False, config=back.config,
                          semantic_mode="scatter")
    before = [k.launches for k in kernels[:2]]
    rows = scatter.search_batch(queries, top_k=10, log=False)
    assert all(k.launches > b for k, b in zip(kernels[:2], before))
    assert len(rows) == len(queries) and all(len(r) == 10 for r in rows)
