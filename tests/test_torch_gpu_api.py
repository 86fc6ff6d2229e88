"""The port's API on the card: an ``EngineState`` over 65,536
hashing-encoded docs (the impact ladder at any size: the at-scale
threshold lowered), 16 client threads of ``/search`` through the
continuous batcher, and ``/search/filtered`` on the tiled dense top-k.

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_api.py

Every response must be 200; the batcher must coalesce; K1, K4, K6 and K7
must launch under /search and K1 and K4 under /search/filtered. Rows
equal a direct ``Searcher.search_batch`` of the same queries afterwards,
and the filtered rows a plain masked exact dense top-10 on the card
(normalized product + bias + ``torch.topk``): values within 1e-4, ids
equal outside near-ties within 1e-4.
"""

import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

N_DOCS = 65_536
TIE = 1e-4


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hybridsearch_tpu_torch.api.app import EngineState, build_router
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    card = torch.device("cuda")
    real = sm.SPARSE_HYBRID_MIN_DOCS
    sm.SPARSE_HYBRID_MIN_DOCS = 0
    rng = np.random.default_rng(0)
    topics = [[f"z{z}t{j}" for j in range(24)] for z in range(64)]
    bg = [f"w{i}" for i in range(3000)]
    texts = [" ".join(list(rng.choice(topics[i % 64], 24)) + list(rng.choice(bg, 16)))
             for i in range(N_DOCS)]
    queries = [" ".join(list(rng.choice(topics[z % 64], 3)) + [bg[z]])
               for z in range(128)]
    st = EngineState(encoder=HashingEncoder(dim=384, device=card), device=card)
    st.indexer.index_documents(texts)
    yield st, build_router(st), queries
    st.close()
    sm.SPARSE_HYBRID_MIN_DOCS = real


def _launches():
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_supertile, cuda_topk

    return {"tile_stats": cuda_topk.tile_stats.launches,
            "super_scores_dedup": cuda_supertile.super_scores_dedup.launches,
            "slice_runs": cuda_impact.slice_runs.launches,
            "rescore": cuda_impact.rescore.launches}


def _same_rows(got, want):
    """[(score, doc id)] rows: values within 1e-4, ids equal outside
    near-ties."""
    assert len(got) == len(want)
    gv = np.array([v for v, _i in got])
    wv = np.array([v for v, _i in want])
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-4)
    for j, (a, b) in enumerate(zip(got, want)):
        if a[1] != b[1]:
            assert (np.abs(wv - wv[j]) <= TIE).sum() > 1, (j, a, b)


def test_gpu_search_threads_through_the_batcher(engine):
    st, router, queries = engine
    assert st.warmup(queries[:8], top_k=10) == 7  # buckets 1..64
    before, dispatches = _launches(), st.batcher.dispatches
    out, errs = {}, []

    def client(w):
        for q in queries[w * 8:(w + 1) * 8]:
            code, payload, _ = router.dispatch("POST", "/search",
                                               {"query": q, "top_k": 10})
            if code != 200 or payload["cached"]:
                errs.append((code, payload))
            out[q] = [(r["score"], r["doc_id"]) for r in payload.get("results", [])]

    threads = [threading.Thread(target=client, args=(w,)) for w in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs[:3]
    assert len(out) == 128
    made = st.batcher.dispatches - dispatches
    assert made < 128 and st.batcher.max_seen_batch >= 2
    after = _launches()
    assert all(after[k] > before[k] for k in after), (before, after)
    direct = st.searcher.search_batch(queries, top_k=10, log=False)
    for q, row in zip(queries, direct):
        _same_rows(out[q], [(s, i) for s, _c, i in row])


def test_gpu_search_filtered_on_the_tiled_topk(engine):
    st, router, queries = engine
    from hybridsearch_tpu_torch.ops.dense import l2_normalize

    ids = list(range(0, N_DOCS, 16))
    for i in ids:
        st.indexer.store.set_metadata(i, {"group": (i // 16) % 8})
    before = _launches()
    rows = []
    for q in queries[:16]:
        code, payload, _ = router.dispatch("POST", "/search/filtered",
                                           {"query": q, "filter": "group:3",
                                            "top_k": 10})
        assert code == 200
        rows.append([(r["score"], r["doc_id"]) for r in payload["results"]])
    after = _launches()
    assert after["tile_stats"] > before["tile_stats"]
    assert after["super_scores_dedup"] > before["super_scores_dedup"]
    keep = torch.full((N_DOCS,), float("-inf"), device="cuda")
    keep[torch.tensor([i for i in ids if (i // 16) % 8 == 3], device="cuda")] = 0.0
    snap = st.indexer.dense._snap
    q = l2_normalize(st.indexer.encoder.encode(queries[:16]).float())
    vals, idx = torch.topk(q @ snap.docs[:N_DOCS].T + keep + snap.bias[:N_DOCS], 10)
    for b, row in enumerate(rows):
        assert all((i // 16) % 8 == 3 and i % 16 == 0 for _s, i in row)
        _same_rows(row, list(zip(vals[b].tolist(), idx[b].tolist())))
