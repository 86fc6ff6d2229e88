"""BM25's query API and the ops beneath it (``bm25_scores``,
``bm25_scores_bucketed``, ``bm25_topk``, the candidate scorers) and its
incremental adds, in the port against the JAX package and the float64
dict oracle, on the CPU.

The ops are plain tensor code in both packages, summing each doc's terms
in the same order, so scores are held equal bit for bit to the JAX ones
and within rtol 1e-4 to the float64 oracle; the fitted state (term ids,
the float64 tf cache and frozen stats, the float32 weights) is held equal
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.evaluation.oracle import BM25Oracle
from hybridsearch_tpu.index.sparse_index import BM25 as JBM25
from hybridsearch_tpu.ops import bm25 as jops
from hybridsearch_tpu_torch.index.sparse_index import BM25, BM25Plus
from hybridsearch_tpu_torch.ops import bm25 as tops
from hybridsearch_tpu_torch.text.extractor import (
    HashVocabulary,
    extract_tokens,
    stable_token_hash,
    token_hashes_docs,
)

CPU = torch.device("cpu")
QUERIES = ["machine learning data", "neural networks", "cooking pasta water",
           "nonexistent zzz term", "learning learning", ""]


def _fit(texts, variant="bm25"):
    cls = BM25Plus if variant == "bm25plus" else BM25
    return cls(device=CPU).fit(texts)


def _jfit(texts, variant="bm25"):
    from hybridsearch_tpu.index.sparse_index import BM25Plus as JBM25Plus

    return (JBM25Plus if variant == "bm25plus" else JBM25)().fit(texts)


@pytest.mark.parametrize("variant", ["bm25", "bm25plus"])
def test_bm25_scores_match_oracle_and_jax(demo_docs, variant):
    tb, jb = _fit(demo_docs, variant), _jfit(demo_docs, variant)
    orc = BM25Oracle(variant=variant).fit([extract_tokens(d) for d in demo_docs])
    qt = tb._encode_queries(QUERIES)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(jb._encode_queries(QUERIES)))
    got = tops.bm25_scores(tb.postings, qt).numpy()
    want = np.asarray(jops.bm25_scores(jb.postings, jb._encode_queries(QUERIES)))
    np.testing.assert_array_equal(got, want)
    for i, q in enumerate(QUERIES):
        np.testing.assert_allclose(got[i], orc.score_all(extract_tokens(q)),
                                   rtol=1e-4, atol=1e-5, err_msg=q)


def test_bm25_repeated_query_terms_count_twice(demo_docs):
    tb = _fit(demo_docs)
    orc = BM25Oracle().fit([extract_tokens(d) for d in demo_docs])
    got = tops.bm25_scores(tb.postings, tb._encode_queries(["learning learning"]))[0]
    np.testing.assert_allclose(got.numpy(), orc.score_all(["learning", "learning"]),
                               rtol=1e-4, atol=1e-5)
    assert tb.score_all("learning learning")[1] == pytest.approx(
        2 * tb.score_all("learning")[1], rel=1e-6)


def test_bm25_topk_and_candidates_match_jax(demo_docs):
    tb, jb = _fit(demo_docs), _jfit(demo_docs)
    qt, jqt = tb._encode_queries(["machine learning"]), jb._encode_queries(
        ["machine learning"])
    scores = tops.bm25_scores(tb.postings, qt)
    vals, idx = tops.bm25_topk(scores, 3)
    jv, ji = jops.bm25_topk(jops.bm25_scores(jb.postings, jqt), 3)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    cand = np.array([[0, 5, 11, 3, -1]], np.int32)
    got = tops.bm25_candidate_scores(tb.postings, qt, torch.from_numpy(cand)).numpy()
    want = np.asarray(jops.bm25_candidate_scores(jb.postings, jqt, jnp.asarray(cand)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 4] == 0.0
    np.testing.assert_array_equal(got[0, :4], scores[0, [0, 5, 11, 3]].numpy())


def test_bm25_topk_tiled_above_65536_docs_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.random((2, 70_000)).astype(np.float32)
    s[:, ::7] = 0.0  # ties
    vals, idx = tops.bm25_topk(torch.from_numpy(s), 9)
    jv, ji = jops.bm25_topk(jnp.asarray(s), 9)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_bm25_empty_query_scores_zero(demo_docs):
    tb = _fit(demo_docs)
    qt = torch.full((1, 8), tb.postings.vocab_size, dtype=torch.int64)
    assert not tops.bm25_scores(tb.postings, qt).any()
    assert tb.search("zzz nothing", top_k=3) == []
    assert not tb.batch_scores([""]).any()


def test_bucketed_scores_equal_the_term_id_kernel(demo_docs):
    tb, jb = _fit(demo_docs), _jfit(demo_docs)
    got = tb.batch_scores(QUERIES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jb.batch_scores(QUERIES)))
    np.testing.assert_allclose(
        got.numpy(), tops.bm25_scores(tb.postings, tb._encode_queries(QUERIES)).numpy(),
        rtol=1e-6, atol=1e-7)
    groups = tb.encode_queries_bucketed(QUERIES)
    np.testing.assert_array_equal(
        tops.bm25_scores_bucketed(tb.postings, groups, len(QUERIES)).numpy(),
        got.numpy())


@pytest.mark.parametrize("cand", [[0, 3, 11, 5, -1], [1, 1, -1, 7, 0, 2, 9, 10]])
def test_candidate_scores_runs_match_full_and_jax(demo_docs, cand):
    tb, jb = _fit(demo_docs), _jfit(demo_docs)
    q = "machine learning data"
    cand = np.asarray(cand, np.int32)
    full = tb.score_all(q)
    groups = tb.encode_queries_bucketed([q])
    got = tops.bm25_candidate_scores_runs(tb.postings, groups,
                                          torch.from_numpy(cand[None, :]))[0].numpy()
    want = np.asarray(jops.bm25_candidate_scores_runs(
        jb.postings, jb.encode_queries_bucketed([q]), jnp.asarray(cand[None, :])))[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.where(cand >= 0, full[cand], 0.0))
    np.testing.assert_array_equal(tb.candidate_scores(q, cand),
                                  jb.candidate_scores(q, cand))


def test_candidate_scores_runs_over_split_runs():
    """A run longer than the widest bucket is split into pieces; every
    piece is searched."""
    W = tops.LENGTH_BUCKETS[-1]
    n = 2 * W + 300
    ids = np.arange(n, dtype=np.int64)
    po = tops.build_postings_arrays(np.zeros(n, np.int64), ids,
                                    np.linspace(1, 2, n).astype(np.float32), n, 1,
                                    CPU, presorted=True)
    groups = tops.encode_run_pieces(po.starts_host, po.lengths_host, [[0]],
                                    po.max_postings)
    cand = torch.tensor([[0, W - 1, W, 2 * W + 299, n, -1]])
    got = tops.bm25_candidate_scores_runs(po, groups, cand)[0].numpy()
    w = po.weights.numpy()
    np.testing.assert_array_equal(got, [w[0], w[W - 1], w[W], w[n - 1], 0.0, 0.0])


def test_class_api_matches_jax(demo_docs):
    tb, jb = _fit(demo_docs), _jfit(demo_docs)
    q = "machine learning data"
    np.testing.assert_array_equal(tb.score_all(q), jb.score_all(q))
    assert tb.score(q, 1) == jb.score(q, 1)
    assert tb.score_batch(q, [0, 1, 2]) == jb.score_batch(q, [0, 1, 2])
    assert tb.search(q, top_k=4) == jb.search(q, top_k=4)
    empty = BM25(device=CPU)
    assert empty.score_all(q).shape == (0,) and empty.search(q) == []
    assert empty.batch_scores([q, q]).shape == (2, 0)


def _state(bm):
    """(term keys, tf cache, frozen stats, float32 weights, delta) of a BM25
    of either package, term ids as given."""
    st = bm._state
    vocab = st.vocab
    keys = (list(vocab.id_to_hash) if hasattr(vocab, "id_to_hash")
            else list(vocab.id_to_token))
    seg = st.delta_seg
    return (keys, st.tf_cache, st.frozen, np.asarray(st.postings.weights),
            None if seg is None else (seg.tf, np.asarray(seg.postings.weights),
                                      np.asarray(seg.postings.indptr)))


def _assert_same_state(tb, jb):
    tk, ttf, tfr, tw, tseg = _state(tb)
    jk, jtf, jfr, jw, jseg = _state(jb)
    assert tk == jk  # term ids equal
    assert tb.n_docs == jb.n_docs
    for a, b in zip(ttf, jtf):  # float64 counts and doc lengths, bit for bit
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(tfr[0], jfr[0])
    assert tfr[1:] == jfr[1:]  # avg_len and len_sum, float64, exactly
    np.testing.assert_array_equal(tw, jw)
    assert (tseg is None) == (jseg is None)
    if tseg is not None:
        for a, b in zip(tseg[0], jseg[0]):
            assert np.array_equal(a, b)
        np.testing.assert_array_equal(tseg[1], jseg[1])
        np.testing.assert_array_equal(tseg[2], jseg[2])


@pytest.mark.parametrize("n_more", [3, 50])  # delta; past the drift bound
def test_add_tokens_matches_jax_and_a_full_refit(rng, n_more):
    vocab = [f"tok{i}" for i in range(200)]
    first = [list(rng.choice(vocab, size=12)) for _ in range(300)]
    more = [list(rng.choice(vocab, size=9)) + [f"new{i}"] for i in range(n_more)]
    tb, jb = BM25(device=CPU).fit_tokens(first), JBM25().fit_tokens(first)
    old = tb._state
    tb.add_tokens(more)
    jb.add_tokens(more)
    _assert_same_state(tb, jb)
    assert (tb._state.delta_seg is not None) == (n_more == 3)
    # snapshot safety: the old state's vocab did not grow
    assert len(old.vocab) == old.postings.vocab_size
    tb.compact()
    jb.compact()
    _assert_same_state(tb, jb)
    full = BM25(device=CPU).fit_tokens(first + more)
    for name in ("indptr", "doc_ids", "weights"):
        assert torch.equal(getattr(tb.postings, name), getattr(full.postings, name))


def test_add_tokens_requires_a_tf_cache(tmp_path):
    with pytest.raises(ValueError):
        BM25(device=CPU).add_tokens([["a", "b"]])
    bm = BM25(device=CPU).fit(["a b c", "c d"])
    bm.save(str(tmp_path / "b.npz"))
    with pytest.raises(ValueError):
        BM25(device=CPU).load(str(tmp_path / "b.npz")).add_tokens([["a"]])
    with pytest.raises(ValueError):  # add_hashes needs a hash vocabulary
        bm.add_hashes(*token_hashes_docs(["a"]))


def test_fit_hashes_scores_equal_fit(rng):
    vocab = [f"word{i}" for i in range(300)] + ["the", "and", "of"]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(5, 20))))
             for _ in range(200)]
    a, b = BM25(device=CPU).fit(texts), BM25(device=CPU).fit_hashes(texts)
    assert isinstance(b.vocab, HashVocabulary)
    queries = [" ".join(rng.choice(vocab, size=3)) for _ in range(8)]
    np.testing.assert_allclose(a.batch_scores(queries).numpy(),
                               b.batch_scores(queries).numpy(), rtol=1e-6, atol=1e-7)


_MIXED = ["café au lait résumé", "Привет мир и ещё", "日本語のテキスト処理",
          "x" * 300 + " long", "plain ascii words", "café again 日本"]


@pytest.mark.parametrize("path", ["add_tokens", "add_hashes"])
def test_hash_vocab_adds_match_jax_term_ids(rng, path):
    """Adds to a hash-vocabulary state through both port routes give the
    ids the JAX package's token-by-token ``HashVocabulary.add`` gives, on
    any script (the port and the JAX Python path share extract_tokens and
    the FNV-1a hash), with and without a pending delta."""
    words = [f"word{i}" for i in range(150)]
    base = [" ".join(rng.choice(words, size=10)) for _ in range(300)] + _MIXED[:2]
    hashes, counts = token_hashes_docs(base)
    tb = BM25(device=CPU).fit_coo_from_hashes(hashes, counts)
    jb = JBM25().fit_coo_from_hashes(hashes, counts)
    for extra in (_MIXED[2:] + ["word3 brand new"], [" ".join(
            rng.choice(words, size=10)) + f" fresh{i}" for i in range(70)]):
        toks = [extract_tokens(t) for t in extra]
        jb.add_tokens(toks)
        if path == "add_tokens":
            tb.add_tokens(toks)
        else:
            tb.add_hashes(*token_hashes_docs(extra))
        _assert_same_state(tb, jb)
    assert tb._state.delta_seg is None  # the second add tripped the bound


def test_vectorised_hash_ids_equal_token_by_token(rng):
    hv = HashVocabulary.from_hashes(sorted(stable_token_hash(f"w{i}") for i in range(50)))
    one = hv.copy()
    stream = [f"w{i}" for i in rng.integers(0, 120, 2000)]
    want = [one.add(t) for t in stream]
    got = hv.add_hashes(np.array([stable_token_hash(t) for t in stream], np.uint64))
    assert got.tolist() == want and hv.id_to_hash == one.id_to_hash
    assert hv.hash_to_id == one.hash_to_id
    empty = HashVocabulary()
    assert empty.add_hashes(np.array([5, 3, 5], np.uint64)).tolist() == [0, 1, 0]
    assert empty.add_hashes(np.zeros(0, np.uint64)).tolist() == []


def test_fit_hashes_add_and_roundtrip_equal_a_fresh_fit(rng, tmp_path):
    vocab = [f"word{i}" for i in range(100)]
    texts = [" ".join(rng.choice(vocab, size=10)) for _ in range(80)]
    extra = [" ".join(rng.choice(vocab, size=10)) for _ in range(20)]
    inc = BM25(device=CPU).fit_hashes(texts)
    inc.add_hashes(*token_hashes_docs(extra))
    full = BM25(device=CPU).fit_hashes(texts + extra)
    queries = [" ".join(rng.choice(vocab, size=3)) for _ in range(5)]
    inc.compact()
    np.testing.assert_allclose(inc.batch_scores(queries).numpy(),
                               full.batch_scores(queries).numpy(), rtol=1e-6, atol=1e-7)
    path = str(tmp_path / "bm25_hash.npz")
    full.save(path)
    loaded = BM25(device=CPU).load(path)
    assert loaded.vocab.id_to_hash == full.vocab.id_to_hash
    np.testing.assert_array_equal(loaded.batch_scores(queries).numpy(),
                                  full.batch_scores(queries).numpy())
