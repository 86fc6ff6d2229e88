"""The mesh on the card: a world of 4 gloo ranks sharing it (NCCL refuses
two ranks on one device) serves a clustered index through the sharded
supertile ladder and the exact collective program; every rank returns
the same rows, every row equals a plain exact fused reference over a
single-device index of the same corpus (the same clustered order, held
by digest), and K1, K3 and K4 (at tile grain) launch on every rank. A
world of one NCCL rank serves the exact collective program too.

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_parallel.py

Tolerances: fused scores 1e-4 (float32 sums in another order); ids equal
except inside near-ties within eps_num = 1e-4.
"""

import hashlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

EPS = 1e-4
N_DOCS = 4 * 24576  # 192 tiles a rank: K1's route; 2 supertiles a rank


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _corpus(rng, n_docs):
    topics = [[f"z{z}t{j}" for j in range(24)] for z in range(48)]
    bg = [f"w{i}" for i in range(3000)]
    texts = [" ".join(list(rng.choice(topics[i % 48], 32)) + list(rng.choice(bg, 16)))
             for i in range(n_docs)]
    queries = [" ".join(list(rng.choice(topics[z], 3)) + [bg[z]]) for z in range(32)]
    return texts, queries


def _reference(single, queries, k=10, sw=0.7, lw=0.3):
    """Plain exact fused top-k over the single-device index: a full cosine
    matmul, BM25's [B, n] scores, alive-masked min-max fusion."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize

    idx = single.indexer
    snap = idx.dense._snap
    n = snap.n
    q = l2_normalize(idx.encoder.encode(list(queries)).float())
    sem = q @ snap.docs[:n].T
    lex = idx.bm25.batch_scores(list(queries))
    alive = (snap.bias[:n] >= 0)[None, :]

    def norm(x):
        mn = torch.where(alive, x, float("inf")).amin(1, keepdim=True)
        mx = torch.where(alive, x, float("-inf")).amax(1, keepdim=True)
        r = mx - mn
        return torch.where(r > 1e-12, (x - mn) / r.clamp_min(1e-12), torch.ones_like(x))

    fused = sw * norm(sem) + lw * norm(lex) + snap.bias[:n][None, :]
    v, i = torch.topk(fused, k, dim=1)
    return v.cpu().numpy(), i.cpu().numpy()


def _same(rows, want_v, want_i):
    for b, row in enumerate(rows):
        got_v = np.array([v for v, _i in row])
        np.testing.assert_allclose(got_v, want_v[b], rtol=1e-4, atol=1e-5)
        for j, (_v, i) in enumerate(row):
            if i != want_i[b][j]:
                assert (np.abs(want_v[b] - want_v[b][j]) <= EPS).sum() > 1, (b, j)


@pytest.fixture(scope="module")
def card_worlds(tmp_path_factory):
    _need_card()
    import _torch_mesh_worker as worker
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder
    from hybridsearch_tpu_torch.parallel.dryrun import launch
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    texts, queries = _corpus(np.random.default_rng(11), N_DOCS)
    inputs = {"card_mesh": {"texts": texts, "queries": queries}}
    four = launch(worker.run_checks, 4, args=("card", inputs, "cuda"), device="cuda",
                  workdir=str(tmp_path_factory.mktemp("card4")), timeout_s=300)
    one = launch(worker.run_checks, 1, args=("card", inputs, "cuda"), backend="nccl",
                 device="cuda", workdir=str(tmp_path_factory.mktemp("card1")),
                 timeout_s=300)
    cfg = EngineConfig()
    cfg.index.layout, cfg.index.dim = "clustered", 384
    single = Searcher(config=cfg, use_query_memory=False, device="cuda",
                      encoder=HashingEncoder(dim=384, device="cuda"))
    single.indexer.index_documents(texts)
    return queries, single, [r["card_mesh"] for r in four], one[0]["card_mesh"]


def test_every_rank_serves_the_same_rows(card_worlds):
    _q, _s, four, _one = card_worlds
    for o in four:
        assert "error" not in o, o.get("error")
        assert o["ladder"] == four[0]["ladder"] and o["exact"] == four[0]["exact"]
        assert o["backend"] == "gloo"


@pytest.mark.parametrize("route", ["ladder", "exact"])
def test_mesh_rows_equal_the_exact_reference(card_worlds, route):
    queries, single, four, _one = card_worlds
    sha = hashlib.sha256("\n".join(single.indexer.contents).encode()).hexdigest()
    assert four[0]["contents_sha"] == sha  # the same clustered order
    _same(four[0][route], *_reference(single, queries))


def test_k1_k3_k4_launch_on_every_rank(card_worlds):
    _q, _s, four, _one = card_worlds
    for o in four:
        assert min(o["launches"].values()) > 0, o["launches"]


def test_world_of_one_nccl_rank(card_worlds):
    queries, single, _four, one = card_worlds
    assert "error" not in one, one.get("error")
    assert one["backend"] == "nccl"
    _same(one["exact"], *_reference(single, queries))
    _same(one["ladder"], *_reference(single, queries))
