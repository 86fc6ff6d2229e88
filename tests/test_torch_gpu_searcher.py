"""search_batch on the card against the same index carried to the CPU
(plain versions), and the launch counters that show the kernels ran: the
supertile ladder on a clustered index (K1, K2, K5 by default, held to the
CPU's staged windows + K3; with ``scores_dedup`` K4, equal bit for bit to
K2 and to the staged windows + K3 of ``place_fused=False``, also at the
widest caps and every probe depth) and the impact ladder on a
``layout="source"`` index (K1, K6, K7).

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_searcher.py

Tolerances: fused scores 1e-4 (float32 sums in another order); ids equal
except inside near-ties within the certificate margin eps_num = 1e-4.

Each searcher is given the hashing encoder: the Indexer's default would
serve the in-repo transformer checkpoint where one is found, and these
tests hold the kernels' routes, not the encoder.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

EPS = 1e-4


def _hashing():
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    return HashingEncoder(dim=384, device="cuda")


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
    gpu = sm.Searcher(config=cfg, encoder=_hashing(), use_query_memory=False,
                      device="cuda")
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
                        cuda_supertile.place_fused])


def test_gpu_impact_route_matches_the_cpu_route(monkeypatch):
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_topk

    _route_matches_cpu(monkeypatch, "source",
                       [cuda_topk.tile_stats, cuda_impact.slice_runs,
                        cuda_impact.rescore])


def test_gpu_supertile_levers_equal_the_default_route(monkeypatch):
    """The same searcher on K2 and the staged windows + K3
    (``cfg.perf.place_fused = False``), then with ``cfg.perf.scores_dedup =
    True`` on the default placement: K4 and K5 launch instead of K2 and
    K3, and every result row is the same, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs
    from hybridsearch_tpu_torch.retrieval import searcher as sm

    rng = np.random.default_rng(0)
    texts, queries = _corpus(rng, 24576)
    cfg = EngineConfig()
    cfg.index.layout = "clustered"
    gpu = sm.Searcher(config=cfg, encoder=_hashing(), use_query_memory=False,
                      device="cuda")
    gpu.indexer.index_documents(texts)
    monkeypatch.setattr(sm, "SPARSE_HYBRID_MIN_DOCS", 0)
    kernels = (cs.super_scores, cs.place_windows, cs.super_scores_dedup, cs.place_fused)
    before = [k.launches for k in kernels]
    cfg.perf.place_fused = False
    default = gpu.search_batch(queries, top_k=10, log=False)
    cfg.perf.scores_dedup, cfg.perf.place_fused = True, None
    mid = [k.launches for k in kernels]
    levers = gpu.search_batch(queries, top_k=10, log=False)
    after = [k.launches for k in kernels]
    assert mid[0] > before[0] and mid[1] > before[1] and mid[2:] == before[2:]
    assert after[:2] == mid[:2] and after[2] > mid[2] and after[3] > mid[3]
    assert levers == default


def _head_word_corpus(rng, n_docs):
    """Two head words in most docs of every supertile (windows of about
    13,000 and 10,600 entries a 16,384-doc supertile: caps of 16,384),
    then topic and background words."""
    topics = np.array([[f"z{z}t{j}" for j in range(24)] for z in range(64)])
    bg = np.array([f"w{i}" for i in range(3000)])
    tw = topics[np.arange(n_docs)[:, None] % 64, rng.integers(0, 24, (n_docs, 8))]
    bw = bg[rng.integers(0, 3000, (n_docs, 4))]
    head = rng.random((n_docs, 2)) < (0.8, 0.65)
    texts = [" ".join([*t, *b, *(["hw0"] if h[0] else []), *(["hw1"] if h[1] else [])])
             for t, b, h in zip(tw.tolist(), bw.tolist(), head.tolist())]
    queries = [f"hw0 hw1 z{z}t1 z{z}t3 w{z}" for z in range(31)]
    queries.append("hw0 hw1 " + " ".join(f"z5t{j}" for j in range(12))
                   + " " + " ".join(f"w{j}" for j in range(6)))  # 20 terms
    return texts, queries


def test_gpu_default_route_places_with_k5_at_the_widest_caps(monkeypatch):
    """A clustered searcher over 16 supertiles whose batch gives t_pad = 32
    and every slot a 16,384 cap (a head word in every supertile): search_batch
    on the default route launches K5 and not K3, and counts each rung under
    ``supertile_rung_place_fused``; ``place_fused = False`` launches K3 and
    not K5; every row is equal bit for bit, and so is every rung at S = 2, 4,
    8 and 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs
    from hybridsearch_tpu_torch.ops import supertile as st
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.retrieval import searcher as sm
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

    rng = np.random.default_rng(22)
    texts, queries = _head_word_corpus(rng, 16 * 16384)
    cfg = EngineConfig()
    cfg.index.layout = "clustered"
    gpu = sm.Searcher(config=cfg, encoder=_hashing(), use_query_memory=False,
                      device="cuda")
    gpu.indexer.index_documents(texts)
    monkeypatch.setattr(sm, "SPARSE_HYBRID_MIN_DOCS", 0)
    sp, enc = gpu.indexer.bm25.encode_queries_super(queries)
    assert sp.n_super == 16 and enc.t_pad == 32 and enc.wcaps == (16384,) * 32

    counters = ("supertile_rung_place_fused", "supertile_rung_place_staged",
                "ladder_rungs")

    def served():
        """(rows, (K3, K5) launches, the counters' increments) of one batch."""
        k0 = (cs.place_windows.launches, cs.place_fused.launches)
        c0 = [GLOBAL_COUNTERS.get(n) for n in counters]
        rows = gpu.search_batch(queries, top_k=10, log=False)
        k = (cs.place_windows.launches - k0[0], cs.place_fused.launches - k0[1])
        return rows, k, [GLOBAL_COUNTERS.get(n) - b for n, b in zip(counters, c0)]

    default, k_default, c_default = served()
    cfg.perf.place_fused = False
    staged, k_staged, c_staged = served()
    assert k_default[0] == 0 and k_default[1] > 0, k_default
    assert k_staged[0] > 0 and k_staged[1] == 0, k_staged
    assert c_default[0] == c_default[2] > 0 and c_default[1] == 0, c_default
    assert c_staged[1] == c_staged[2] > 0 and c_staged[0] == 0, c_staged
    assert default == staged

    snap = gpu.indexer.dense._snap
    q = l2_normalize(gpu.indexer.encoder.encode(queries).float())
    pfx = st.super_prefix(q, snap.docs, sp, enc, bias=snap.bias, s_max=16)
    for s_probe in (2, 4, 8, 16):
        got, want = (st.hybrid_supertile_topk_rung(
            q, snap.docs, sp, enc, pfx, 10, 0.7, 0.3, bias=snap.bias, s_probe=s_probe,
            n_alive=snap.n, place_fused=flag, return_clauses=True)
            for flag in (None, False))
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            assert torch.equal(a, b), s_probe
