"""The port's MMR, LSH, result caches and chunkers against the JAX
package's, on the CPU, fed the same numpy inputs made from a seed (the
mirrors of the MMR and LSH tests of ``tests/test_ops_fusion_mmr.py``, the
cache tests of ``tests/test_services.py`` and the chunker tests of
``tests/test_text.py``).

Tolerances:

- MMR order: exact, except where the two candidates a round would swap lie
  within 1e-6 of each other in MMR value (a float32 product summed in
  another order may swap them); each such swap is counted and the count
  must stay at 0 on these inputs. MMR scores rtol 1e-4 / atol 1e-5.
- LSH signatures: bit for bit wherever every projection of the vector lies
  farther than 1e-5 from 0 (a projection nearer 0 may flip its sign bit
  under another summation order); the rest are counted.
- Caches and chunkers are host code: equal outputs, hits and misses.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.evaluation import oracle
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.ops import lsh as jlsh
from hybridsearch_tpu.ops import mmr as jmmr
from hybridsearch_tpu.services import cache as jcache
from hybridsearch_tpu.services import semantic_cache as jsc
from hybridsearch_tpu.text import chunker as jck
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.ops import lsh as tlsh
from hybridsearch_tpu_torch.ops import mmr as tmmr
from hybridsearch_tpu_torch.services import cache as tcache
from hybridsearch_tpu_torch.services import semantic_cache as tsc
from hybridsearch_tpu_torch.text import chunker as tck

CPU = torch.device("cpu")
MMR_TIE = 1e-6
PROJ_EPS = 1e-5


def _mmr_swaps(got, want, rel, emb, lam):
    """Rounds where ``got`` picks another candidate than ``want``; each must
    be a near-tie (MMR values within MMR_TIE, in float64 over ``want``'s
    picks so far). Stops at the first one: the orders part there."""
    rel = np.asarray(rel, np.float64)
    e = np.asarray(emb, np.float64)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    sim = e @ e.T
    max_sim = np.zeros(len(rel))
    for g, w in zip(got, want):
        if g != w:
            score = lam * rel - (1 - lam) * max_sim
            assert abs(score[g] - score[w]) <= MMR_TIE, (g, w, score[g], score[w])
            return 1
        max_sim = np.maximum(max_sim, sim[:, w])
    return 0


def _mmr_inputs(seed, B, C, D):
    rng = np.random.default_rng(seed)
    return (rng.random((B, C)).astype(np.float32),
            rng.standard_normal((B, C, D)).astype(np.float32))


@pytest.mark.parametrize("lam", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("seed,C,D,k", [(0, 20, 16, 6), (1, 64, 384, 10),
                                        (2, 7, 8, 7)])
def test_mmr_select_matches_jax_and_oracle(seed, C, D, k, lam):
    rel, emb = _mmr_inputs(seed, 1, C, D)
    rel, emb = rel[0], emb[0]
    order, scores = tmmr.mmr_select(torch.from_numpy(rel), torch.from_numpy(emb), k, lam)
    j_order, j_scores = jmmr.mmr_select(jnp.asarray(rel), jnp.asarray(emb), k, lam)
    assert order.dtype == torch.int32 and scores.dtype == torch.float32
    got = order.tolist()
    swaps = _mmr_swaps(got, np.asarray(j_order).tolist(), rel, emb, lam)
    swaps += _mmr_swaps(got, oracle.mmr(rel, emb, k, lam), rel, emb, lam)
    assert swaps == 0
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), rtol=1e-4, atol=1e-5)


def test_mmr_lambda_one_is_pure_relevance():
    rel, emb = _mmr_inputs(3, 1, 12, 8)
    order, _ = tmmr.mmr_select(torch.from_numpy(rel[0]), torch.from_numpy(emb[0]), 5, 1.0)
    assert order.tolist() == np.argsort(-rel[0], kind="stable")[:5].tolist()


def test_mmr_ties_take_the_first_candidate():
    """Equal relevance and identical rows: every round picks the lowest
    index left, in both packages (argmax takes the first maximum)."""
    rel = np.ones(6, np.float32)
    emb = np.ones((6, 4), np.float32)
    order, _ = tmmr.mmr_select(torch.from_numpy(rel), torch.from_numpy(emb), 6, 0.5)
    j_order, _ = jmmr.mmr_select(jnp.asarray(rel), jnp.asarray(emb), 6, 0.5)
    assert order.tolist() == np.asarray(j_order).tolist() == list(range(6))


def test_mmr_batch_matches_per_query_and_jax():
    rel, emb = _mmr_inputs(4, 4, 20, 16)
    order_b, scores_b = tmmr.mmr_select_batch(torch.from_numpy(rel),
                                              torch.from_numpy(emb), 6, 0.5)
    j_order, j_scores = jmmr.mmr_select_batch(jnp.asarray(rel), jnp.asarray(emb), 6, 0.5)
    assert order_b.shape == (4, 6) and order_b.dtype == torch.int32
    swaps = 0
    for b in range(4):
        order_1, scores_1 = tmmr.mmr_select(torch.from_numpy(rel[b]),
                                            torch.from_numpy(emb[b]), 6, 0.5)
        assert order_b[b].tolist() == order_1.tolist()
        np.testing.assert_allclose(scores_b[b].numpy(), scores_1.numpy(), rtol=1e-5)
        swaps += _mmr_swaps(order_b[b].tolist(), np.asarray(j_order[b]).tolist(),
                            rel[b], emb[b], 0.5)
    assert swaps == 0
    np.testing.assert_allclose(scores_b.numpy(), np.asarray(j_scores), rtol=1e-4,
                               atol=1e-5)


def test_mmr_batch_padding_never_selected():
    """Rows shorter than C mark the tail invalid; padded entries must not
    appear in the selection even at lam=0 (diversity only)."""
    rel, emb = _mmr_inputs(5, 3, 12, 8)
    valid = np.ones((3, 12), dtype=bool)
    valid[0, 6:] = False
    valid[2, 5:] = False
    for lam in (0.0, 0.5, 1.0):
        order, _ = tmmr.mmr_select_batch(torch.from_numpy(rel), torch.from_numpy(emb), 4,
                                         lam, valid=torch.from_numpy(valid))
        j_order, _ = jmmr.mmr_select_batch(jnp.asarray(rel), jnp.asarray(emb), 4, lam,
                                           valid=jnp.asarray(valid))
        order = order.numpy()
        assert (order[0] < 6).all() and (order[2] < 5).all()
        np.testing.assert_array_equal(order, np.asarray(j_order))


def test_mmr_batch_per_row_lambda():
    """lam can be a [B] vector: row 0 pure relevance, row 1 diverse."""
    rel, emb = _mmr_inputs(6, 2, 15, 8)
    lam = np.asarray([1.0, 0.3], dtype=np.float32)
    order, _ = tmmr.mmr_select_batch(torch.from_numpy(rel), torch.from_numpy(emb), 5,
                                     torch.from_numpy(lam))
    j_order, _ = jmmr.mmr_select_batch(jnp.asarray(rel), jnp.asarray(emb), 5,
                                       jnp.asarray(lam))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert order[0].tolist() == np.argsort(-rel[0], kind="stable")[:5].tolist()
    one, _ = tmmr.mmr_select(torch.from_numpy(rel[1]), torch.from_numpy(emb[1]), 5, 0.3)
    assert order[1].tolist() == one.tolist()


def test_mmr_rounds_make_no_host_sync(monkeypatch):
    """The k rounds read nothing back to the host: on the card they queue
    behind the product without a sync."""
    rel, emb = _mmr_inputs(7, 3, 16, 8)
    rel_t, emb_t = torch.from_numpy(rel), torch.from_numpy(emb)
    valid = torch.ones((3, 16), dtype=torch.bool)

    def refuse(*_a, **_k):
        raise AssertionError("host sync inside the MMR rounds")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    order, scores = tmmr.mmr_select_batch(rel_t, emb_t, 5, 0.5, valid=valid)
    monkeypatch.undo()
    assert order.shape == (3, 5) and scores.shape == (3, 5)


# -- LSH -----------------------------------------------------------------------------


def _signatures_agree(got, want, proj):
    """Equal rows wherever every |projection| > PROJ_EPS; returns the count
    of rows left out (some projection near 0)."""
    clear = (np.abs(proj) > PROJ_EPS).all(axis=1)
    np.testing.assert_array_equal(np.asarray(got)[clear], np.asarray(want)[clear])
    return int((~clear).sum())


@pytest.mark.parametrize("T,K,D,B", [(10, 8, 64, 40), (10, 8, 384, 256), (4, 16, 32, 9)])
def test_lsh_signatures_match_jax_with_carried_planes(T, K, D, B):
    planes_j = jlsh.lsh_planes(jax.random.PRNGKey(7), T, K, D)
    planes = convert.lsh_planes(np.asarray(planes_j), device=CPU)
    vecs = np.random.default_rng(B).standard_normal((B, D)).astype(np.float32)
    got = tlsh.lsh_signatures(planes, torch.from_numpy(vecs), T, K)
    want = jlsh.lsh_signatures(planes_j, jnp.asarray(vecs), T, K)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    proj = vecs.astype(np.float64) @ np.asarray(planes_j, np.float64).T
    assert _signatures_agree(got.numpy(), want, proj) == 0


def test_lsh_signatures_deterministic_and_locality():
    planes = tlsh.lsh_planes(torch.Generator().manual_seed(7), 10, 8, 64)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    near = v + 0.01 * torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    far = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    s_v = tlsh.lsh_signatures(planes, v, 10, 8)
    assert torch.equal(s_v, tlsh.lsh_signatures(planes, v, 10, 8))
    s_near = tlsh.lsh_signatures(planes, near, 10, 8)
    s_far = tlsh.lsh_signatures(planes, far, 10, 8)
    assert (s_v == s_near).sum() >= (s_v == s_far).sum()
    assert tuple(s_v.shape) == (1, 10)
    assert int(s_v.min()) >= 0 and int(s_v.max()) < 256


def test_lsh_planes_repeat_from_a_seed():
    a = tlsh.lsh_planes(torch.Generator().manual_seed(13), 10, 8, 32)
    b = tlsh.lsh_planes(torch.Generator().manual_seed(13), 10, 8, 32)
    c = tlsh.lsh_planes(torch.Generator().manual_seed(14), 10, 8, 32)
    assert a.shape == (80, 32) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the semantic cache ------------------------------------------------------------


def _cache_pair(dim, **kw):
    jc = jsc.SemanticCache(dim=dim, **kw)
    tc = tsc.SemanticCache(dim=dim, planes=convert.lsh_planes(np.asarray(jc.planes),
                                                              device=CPU),
                           device=CPU, **kw)
    return jc, tc


def test_semantic_cache_hit_and_miss():
    rng = np.random.default_rng(0)
    jc, tc = _cache_pair(64, similarity_threshold=0.95)
    v = rng.standard_normal(64).astype(np.float32)
    for c in (jc, tc):
        c.set(v, {"results": [1, 2, 3]})
    near = v + 0.001 * rng.standard_normal(64).astype(np.float32)
    far = rng.standard_normal(64).astype(np.float32)
    for c in (jc, tc):
        assert c.get(near) == {"results": [1, 2, 3]}
        assert c.get(far) is None
    assert tc.stats() == jc.stats()
    assert tc.stats()["hits"] == 1 and tc.stats()["misses"] == 1
    assert tc.invalidate() == jc.invalidate() == 1
    assert tc.get(near) is None


@pytest.mark.parametrize("dim", [64, 384])
def test_semantic_cache_hits_where_jax_hits(dim):
    """With carried planes, the port's cache hits and misses exactly where
    the JAX one does: set 60 vectors, then get them back, perturbed at
    three scales, and fresh ones; tensors and numpy vectors alike."""
    rng = np.random.default_rng(dim)
    jc, tc = _cache_pair(dim, similarity_threshold=0.9)
    base = rng.standard_normal((60, dim)).astype(np.float32)
    for i, v in enumerate(base):
        jc.set(v, i)
        tc.set(torch.from_numpy(v) if i % 2 else v, i)
    probes = [base + s * rng.standard_normal(base.shape).astype(np.float32)
              for s in (0.0, 0.05, 0.3)]
    probes.append(rng.standard_normal((60, dim)).astype(np.float32))
    got = [tc.get(torch.from_numpy(v) if i % 3 else v)
           for i, v in enumerate(np.concatenate(probes))]
    want = [jc.get(v) for v in np.concatenate(probes)]
    assert got == want
    assert got[:60] == list(range(60))
    assert tc.stats() == jc.stats()
    assert 0 < tc.stats()["misses"] < len(got)


def test_semantic_cache_ttl_expiry():
    rng = np.random.default_rng(1)
    c = tsc.SemanticCache(dim=16, ttl_seconds=0.05, device=CPU)
    v = rng.standard_normal(16).astype(np.float32)
    c.set(v, "x")
    assert c.get(v) == "x"
    time.sleep(0.1)
    assert c.get(v) is None


def test_semantic_cache_planes_from_a_seed_or_given():
    a = tsc.SemanticCache(dim=32, seed=5, device=CPU)
    b = tsc.SemanticCache(dim=32, seed=5, device=CPU)
    assert torch.equal(a.planes, b.planes) and a.planes.shape == (80, 32)
    with pytest.raises(ValueError, match="planes of shape"):
        tsc.SemanticCache(dim=32, planes=torch.zeros(80, 16), device=CPU)


def test_inmemory_backend_lru():
    for mod in (tsc, jsc):
        b = mod.InMemoryBackend(max_entries=2)
        b.set("a", 1)
        b.set("b", 2)
        b.get("a")  # refresh a
        b.set("c", 3)  # evicts b
        assert b.get("a") == 1 and b.get("b") is None and b.get("c") == 3
        assert len(b) == 2
        b.delete("a")
        b.clear()
        assert len(b) == 0


class _FakeRedis:
    """The slice of a redis client the caches call, over a dict."""

    def __init__(self):
        self.store, self.ttls = {}, {}

    def get(self, key):
        return self.store.get(key)

    def set(self, key, value):
        self.store[key] = value

    def setex(self, key, ttl, value):
        self.store[key] = value
        self.ttls[key] = ttl

    def delete(self, key):
        self.store.pop(key, None)

    def scan_iter(self, pattern):
        prefix = pattern.rstrip("*")
        return [k for k in list(self.store) if k.startswith(prefix)]


def test_redis_backends_with_an_injected_client():
    """The backends alike in both packages; the port's cache stores through
    the backend it is given even while that backend is empty (the JAX
    cache's ``backend or InMemoryBackend(...)`` drops an empty one, whose
    len() is 0: a reference fault the port does not copy)."""
    for mod in (tsc, jsc):
        client = _FakeRedis()
        backend = mod.RedisBackend(client)
        backend.set("a", {"rows": [3]}, ttl=30)
        backend.set("b", 1)
        assert backend.get("a") == {"rows": [3]} and client.ttls == {"hst:semcache:a": 30}
        assert len(backend) == 2 and backend.get("c") is None
        backend.delete("a")
        backend.clear()
        assert len(backend) == 0 and not client.store
    client = _FakeRedis()
    c = tsc.SemanticCache(dim=16, backend=tsc.RedisBackend(client), ttl_seconds=30,
                          device=CPU)
    v = np.random.default_rng(2).standard_normal(16).astype(np.float32)
    key = c.set(v, {"rows": [3]})
    assert c.get(v) == {"rows": [3]} and client.ttls == {"hst:semcache:" + key: 30}
    assert c.invalidate() == 1 and not client.store
    for mod in (tcache, jcache):
        client = _FakeRedis()
        rc = mod.RedisCache(client, ttl_seconds=10)
        assert rc.get("k") is None
        rc.set("k", [1, 2])
        assert rc.get("k") == [1, 2] and client.ttls["hst:cache:k"] == 10
        rc.invalidate("k")
        rc.set("j", 1)
        rc.invalidate()
        assert not client.store
        assert rc.stats() == {"hits": 1, "misses": 1, "hit_rate": 0.5}


# -- exact caches -----------------------------------------------------------------


def test_make_key_matches_jax():
    for q, kw in (("q", {"k": 5}), ("q", {"k": 6}), ("hé", {"a": [1, 2], "b": None})):
        assert tcache.make_key(q, **kw) == jcache.make_key(q, **kw)
    assert tcache.make_key("q", k=5) != tcache.make_key("q", k=6)


def test_inmemory_cache_ttl_lru_and_stats():
    c = tcache.InMemoryCache(max_entries=10, ttl_seconds=0.05)
    c.set("k", "v")
    assert c.get("k") == "v"
    time.sleep(0.1)
    assert c.get("k") is None
    assert c.stats()["hits"] == 1 and c.stats()["misses"] == 1
    small = tcache.InMemoryCache(max_entries=2)
    for key in "abc":
        small.set(key, key)
    assert small.get("a") is None and len(small) == 2
    small.invalidate("b")
    small.invalidate()
    assert len(small) == 0


def test_cached_search_decorator():
    calls = {"n": 0}

    @tcache.cached_search()
    def search(query, top_k=5):
        calls["n"] += 1
        return [query, top_k]

    assert search("a") == ["a", 5]
    assert search("a") == ["a", 5]
    assert calls["n"] == 1
    search("a", top_k=7)
    assert calls["n"] == 2
    assert search.cache.stats()["hits"] == 1


def test_linear_scan_semantic_cache_matches_jax():
    rng = np.random.default_rng(3)
    tc = tcache.LinearScanSemanticCache(similarity_threshold=0.9)
    jc = jcache.LinearScanSemanticCache(similarity_threshold=0.9)
    vecs = rng.standard_normal((20, 32)).astype(np.float32)
    for i, v in enumerate(vecs):
        tc.set(v, i)
        jc.set(v, i)
    probes = np.concatenate([vecs + 0.001, rng.standard_normal((20, 32)).astype(np.float32)])
    assert [tc.get(p) for p in probes] == [jc.get(p) for p in probes]
    assert tc.get(vecs[4] + 0.001) == 4


# -- chunkers ------------------------------------------------------------------------


def _texts(seed, n=12):
    rng = np.random.default_rng(seed)
    words = ["python", "code", "garden", "tulip", "market", "stock", "data", "the",
             "a", "bloom", "water", "learning", "model", "fast"]
    out = []
    for _ in range(n):
        paras = []
        for _p in range(int(rng.integers(1, 4))):
            sents = [" ".join(rng.choice(words, int(rng.integers(2, 14)))).capitalize()
                     + str(rng.choice([".", "!", "?"]))
                     for _s in range(int(rng.integers(1, 7)))]
            paras.append(" ".join(sents))
        out.append("\n\n".join(paras))
    return out + ["", "   ", "no terminal punctuation at all", "x" * 1200]


def _chunks(chunks):
    return [(c.content, c.doc_id, c.chunk_index, c.start_char, c.end_char, c.metadata)
            for c in chunks]


@pytest.mark.parametrize("strategy,kw", [
    ("sentence", {"max_chars": 45, "overlap_sentences": 1}),
    ("sentence", {"max_chars": 120, "overlap_sentences": 0}),
    ("paragraph", {"min_chars": 30, "max_chars": 120}),
    ("sliding", {"window_chars": 100, "overlap_chars": 30}),
    ("sliding_window", {"window_chars": 300, "overlap_chars": 50}),
])
def test_chunkers_match_jax(strategy, kw):
    got = tck.get_chunker(strategy, **kw)
    want = jck.get_chunker(strategy, **kw)
    assert type(got).__name__ == type(want).__name__
    for i, text in enumerate(_texts(len(strategy) + len(kw))):
        assert _chunks(got.chunk(text, doc_id=i)) == _chunks(want.chunk(text, doc_id=i))


def test_semantic_chunker_matches_jax_with_a_carried_encoder():
    jenc = JEnc(dim=64)
    tenc = convert.hashing_encoder(np.asarray(jenc.table), device=CPU)
    for threshold in (0.2, 0.5):
        got = tck.SemanticChunker(encoder=tenc, similarity_threshold=threshold,
                                  max_chars=200)
        want = jck.SemanticChunker(encoder=jenc, similarity_threshold=threshold,
                                   max_chars=200)
        for i, text in enumerate(_texts(9)):
            assert _chunks(got.chunk(text, doc_id=i)) == _chunks(want.chunk(text, doc_id=i))


def test_sentence_chunker_overlap():
    text = "One sentence here. Two sentences now. Third one arrives. Fourth closes."
    chunks = tck.SentenceChunker(max_chars=45, overlap_sentences=1).chunk(text, doc_id=7)
    assert len(chunks) >= 2
    assert all(c.doc_id == 7 for c in chunks)
    # overlap: the last sentence of chunk i appears in chunk i+1
    assert chunks[0].content.split(". ")[-1].rstrip(".") in chunks[1].content


def test_paragraph_and_sliding_chunkers():
    text = "Short.\n\n" + ("Long paragraph sentence. " * 20) + "\n\nAnother tail."
    chunks = tck.ParagraphChunker(min_chars=30, max_chars=120).chunk(text)
    assert all(len(c.content) <= 130 for c in chunks) and len(chunks) >= 3
    chunks = tck.SlidingWindowChunker(window_chars=300, overlap_chars=50).chunk("x" * 1000)
    assert [c.start_char for c in chunks[:2]] == [0, 250]
    assert all(len(c.content) <= 300 for c in chunks)
    with pytest.raises(ValueError):
        tck.SlidingWindowChunker(window_chars=10, overlap_chars=10)


def test_semantic_chunker_default_encoder_on_the_asked_device():
    """Given no encoder, the chunker serves ``default_encoder`` (hashing
    here, as the test settings pin it) on the device it was given."""
    text = ("Python code uses functions. Python modules import packages. "
            "Gardens bloom with tulips in spring. Flowers need water and sun.")
    ch = tck.SemanticChunker(similarity_threshold=0.2, device="cpu")
    assert len(ch.chunk(text)) >= 2
    assert ch.encoder.device == CPU


def test_get_chunker_factory():
    assert isinstance(tck.get_chunker("sentence"), tck.SentenceChunker)
    assert isinstance(tck.get_chunker("sliding_window"), tck.SlidingWindowChunker)
    assert isinstance(tck.get_chunker("semantic", device="cpu"), tck.SemanticChunker)
    with pytest.raises(ValueError):
        tck.get_chunker("bogus")


def test_rag_imports_requests_only_inside_its_providers():
    import importlib

    mod = "hybridsearch_tpu_torch.retrieval.rag"
    src = importlib.import_module(mod).__loader__.get_source(mod)
    top = [ln for ln in src.splitlines() if ln.startswith(("import ", "from "))]
    assert not any("requests" in ln for ln in top)
    assert src.count("    import requests") == 3
