"""The pipelines' own tensor code on the card: MMR (batched, padded rows,
per-row lambda) against its plain version on the host, LSH signatures and
the semantic cache, and a small funnel, diversity and HybridBM25 run whose
tensors stay on the card and whose paths launch the port's kernels (K1, K4
at tile grain; K6 and K7 on the impact path).

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_pipelines.py

Tolerances: MMR orders equal outside near-ties within 1e-6 in MMR value
(a float32 product summed in another order may swap them), MMR scores
within 1e-5; LSH signatures bit for bit wherever every projection lies
farther than 1e-5 from 0; a query served alone and in a batch: ids equal
outside near-ties within 1e-4, cross-encoder logits within 1e-3 (float32
activations).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

MMR_TIE = 1e-6
PROJ_EPS = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mmr_near_tie(got, want, rel, emb, lam):
    rel = np.asarray(rel, np.float64)
    e = np.asarray(emb, np.float64)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    sim = e @ e.T
    max_sim = np.zeros(len(rel))
    for g, w in zip(got, want):
        if g != w:
            score = lam * rel - (1 - lam) * max_sim
            return abs(score[g] - score[w]) <= MMR_TIE
        max_sim = np.maximum(max_sim, sim[:, w])
    return True


@pytest.mark.parametrize("lam", [0.5, "rows"])
def test_gpu_mmr_batch_matches_the_host(card, lam):
    from hybridsearch_tpu_torch.ops.mmr import mmr_select, mmr_select_batch

    g = torch.Generator().manual_seed(0)
    B, C, D, k = 256, 30, 384, 10
    rel = torch.rand((B, C), generator=g)
    emb = torch.randn((B, C, D), generator=g)
    valid = torch.ones((B, C), dtype=torch.bool)
    valid[::3, 17:] = False  # short rows padded to C
    lam_t = torch.rand(B, generator=g) if lam == "rows" else lam
    order, scores = mmr_select_batch(rel.to(card), emb.to(card), k,
                                     lam_t.to(card) if lam == "rows" else lam_t,
                                     valid=valid.to(card))
    assert order.device.type == scores.device.type == "cuda"
    want, want_scores = mmr_select_batch(rel, emb, k, lam_t, valid=valid)
    got = order.cpu().numpy()
    assert (got[::3] < 17).all()
    for b in range(B):
        lam_b = float(lam_t[b]) if lam == "rows" else lam
        if (got[b] != want[b].numpy()).any():
            assert _mmr_near_tie(got[b], want[b].numpy(), rel[b].numpy(),
                                 emb[b].numpy(), lam_b), b
        else:
            np.testing.assert_allclose(scores[b].cpu().numpy(), want_scores[b].numpy(),
                                       rtol=0, atol=1e-5)
    one, _ = mmr_select(rel[1].to(card), emb[1].to(card), k, lam_t[1] if lam == "rows"
                        else lam)
    assert one.tolist() == order[1].tolist()


def test_gpu_lsh_signatures_and_semantic_cache(card):
    from hybridsearch_tpu_torch.ops.lsh import lsh_planes, lsh_signatures
    from hybridsearch_tpu_torch.services.semantic_cache import SemanticCache

    planes = lsh_planes(torch.Generator().manual_seed(13), 10, 8, 384)
    g = torch.Generator().manual_seed(1)
    vecs = torch.randn((512, 384), generator=g)
    got = lsh_signatures(planes.to(card), vecs.to(card), 10, 8)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    want = lsh_signatures(planes, vecs, 10, 8)
    proj = vecs.double() @ planes.double().T
    clear = (proj.abs() > PROJ_EPS).all(dim=1)
    assert torch.equal(got.cpu()[clear], want[clear])

    cache = SemanticCache(dim=384, device=card)
    assert cache.planes.device.type == "cuda"
    assert torch.equal(cache.planes.cpu(), SemanticCache(dim=384, device="cpu").planes)
    for i, v in enumerate(vecs[:64].to(card)):
        cache.set(v, i)
    assert [cache.get(v) for v in vecs[:64].to(card)] == list(range(64))
    assert cache.get(vecs[100].numpy()) is None


def _corpus(rng, n_docs):
    topics = [[f"z{z}t{j}" for j in range(24)] for z in range(48)]
    bg = [f"w{i}" for i in range(3000)]
    texts = [" ".join(list(rng.choice(topics[i % 48], 32)) + list(rng.choice(bg, 16)))
             for i in range(n_docs)]
    queries = [" ".join(list(rng.choice(topics[z], 3)) + [bg[z]]) for z in range(40)]
    return texts, queries


def _same_rows(got, want, atol):
    assert len(got) == len(want)
    gv = np.array([v for v, _c, _i in got])
    wv = np.array([v for v, _c, _i in want])
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    for j, (a, b) in enumerate(zip([i for *_x, i in got], [i for *_x, i in want])):
        if a != b:
            assert (np.abs(wv - wv[j]) <= max(atol, 1e-4)).sum() > 1, (j, a, b)


def test_gpu_funnel_diversity_and_hybrid_bm25_stay_on_the_card(card, monkeypatch):
    from hybridsearch_tpu_torch import pipelines as pl
    from hybridsearch_tpu_torch.models.bert import BertConfig
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder
    from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_supertile, cuda_topk
    from hybridsearch_tpu_torch.retrieval import searcher as sm
    from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker

    texts, queries = _corpus(np.random.default_rng(0), 24576)  # 192 tiles
    monkeypatch.setattr(sm, "SPARSE_HYBRID_MIN_DOCS", 0)
    monkeypatch.setattr(pl, "HYBRID_BM25_SPARSE_MIN", 0)
    enc = HashingEncoder(dim=384, device=card)
    ce = MiniLMCrossEncoder(cfg=BertConfig(vocab_size=1024, hidden_dim=64, num_layers=1,
                                           num_heads=2, mlp_dim=128, max_position=64,
                                           dtype=torch.float32),
                            dim=64, max_seq_len=64, device=card)
    funnel = pl.create_pipeline("multi_stage", encoder=enc, device=card,
                                reranker=CrossEncoderReranker(model=ce))
    funnel.index(texts)
    k1, k4, k6, k7 = (cuda_topk.tile_stats, cuda_supertile.super_scores_dedup,
                      cuda_impact.slice_runs, cuda_impact.rescore)
    before = [k.launches for k in (k1, k4)]
    batched = funnel.search_batch(queries)
    assert all(k.launches > b for k, b in zip((k1, k4), before))
    for q, b in zip(queries[:8], batched):
        _same_rows(b.results, funnel.search(q).results, atol=1e-3)

    div = pl.create_pipeline("diversity", encoder=enc, device=card)
    div.indexer, div.searcher = funnel.indexer, funnel.searcher
    seen = []
    real = pl.mmr_select_batch
    monkeypatch.setattr(pl, "mmr_select_batch",
                        lambda *a, **k: seen.append((a, k)) or real(*a, **k))
    before = [k.launches for k in (k1, k4, k6, k7)]
    rows = div.search_batch(queries, top_k=10)
    assert all(k.launches > b for k, b in zip((k1, k4, k6, k7), before))
    (rel, emb, *_r), kw = seen[0]
    assert rel.device.type == emb.device.type == kw["valid"].device.type == "cuda"
    assert all(len(r.results) == 10 for r in rows)

    hyb = pl.create_pipeline("hybrid_bm25", encoder=enc, device=card)
    hyb.indexer, hyb.searcher = funnel.indexer, funnel.searcher
    before = [k.launches for k in (k1, k4, k6, k7)]
    outs = [hyb.search(q, top_k=10) for q in queries[:8]]
    assert all(k.launches > b for k, b in zip((k1, k4, k6, k7), before))
    assert all("exact" in o.metadata and len(o.results) == 10 for o in outs)
