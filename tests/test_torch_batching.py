"""The port's continuous batcher (hybridsearch_tpu_torch/api/batching.py)
against the JAX package's, on the CPU: every case of
tests/test_batching.py through both packages (engine states built alike,
the hashing encoder's table carried across). Rows served through either
batcher must equal their package's direct search, and the two packages'
rows must agree (scores rtol 1e-4 / atol 1e-5, ids equal outside
near-ties within 1e-4). Then the pad buckets and the counters.
"""

import threading
import time

import numpy as np
import pytest
import torch

from hybridsearch_tpu.api import batching as jb
from hybridsearch_tpu.api.app import EngineState as JState
from hybridsearch_tpu.api.app import build_router as j_build
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.api import batching as tb
from hybridsearch_tpu_torch.api.app import EngineState as TState
from hybridsearch_tpu_torch.api.app import build_router as t_build

CPU = torch.device("cpu")
TIE = 1e-4


@pytest.fixture(scope="module")
def states(demo_docs):
    jenc = JEnc(dim=128)
    tenc = convert.hashing_encoder(np.asarray(jenc.table), device=CPU)
    out = (JState(encoder=jenc), TState(encoder=tenc, device=CPU))
    for st, build in zip(out, (j_build, t_build)):
        code, _, _ = build(st).dispatch("POST", "/index", {"documents": demo_docs})
        assert code == 200
    yield out
    for st in out:
        st.close()


def same_rows(got, want):
    """(score, content, id) rows: scores within tolerance, ids equal outside
    near-ties."""
    assert len(got) == len(want)
    gv = np.array([s for s, _c, _i in got], np.float64)
    wv = np.array([s for s, _c, _i in want], np.float64)
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
    for j, (g, w) in enumerate(zip(got, want)):
        if g[2] != w[2]:
            assert (np.abs(wv - wv[j]) <= TIE).sum() > 1, f"slot {j}"
        else:
            assert g[1] == w[1]


def test_batched_results_match_direct(states):
    vias = []
    for st in states:
        direct = st.searcher.search("machine learning", top_k=3, semantic_weight=0.7,
                                    lexical_weight=0.3, log=False)
        via, qid = st.batcher.submit("machine learning", 3, 0.7, 0.3)
        assert [(round(s, 5), i) for s, _c, i in direct] == [
            (round(s, 5), i) for s, _c, i in via]
        assert qid is not None
        vias.append(via)
    same_rows(vias[1], vias[0])


QUERIES = ["machine learning", "cooking pasta", "neural networks", "python programming",
           "deep learning", "italian food", "data science", "web development"]


def _submit_all(st, queries, k=3, sw=0.7, lw=0.3):
    results, errs = {}, []

    def worker(q):
        try:
            rows, _ = st.batcher.submit(q, k, sw, lw)
            results[q] = rows
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs
    return results


class _HoldFirstDispatch:
    """Holds the batcher's first dispatch until every one of ``n`` submits
    is in it or in the queue behind it, so the rest coalesce however fast a
    dispatch runs (a tiny batch on the CPU can finish before the next
    thread submits)."""

    def __init__(self, batcher, n: int):
        self.batcher, self.n = batcher, n
        self.entered, self.release = threading.Event(), threading.Event()
        self.first = []

    def __enter__(self):
        real = self.batcher._dispatch

        def held(batch):
            if not self.first:
                self.first.append(len(batch))
                self.entered.set()
                self.release.wait(60)
            return real(batch)

        self.batcher._dispatch = held
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def _watch(self):
        self.entered.wait(60)
        deadline = time.time() + 60
        while (self.first[0] + len(self.batcher._queue) < self.n
               and time.time() < deadline):
            time.sleep(0.001)
        self.release.set()

    def __exit__(self, *exc):
        self.release.set()
        del self.batcher._dispatch


def test_concurrent_requests_coalesce(states):
    outs = []
    for st in states:
        before = st.batcher.dispatches
        with _HoldFirstDispatch(st.batcher, len(QUERIES)):
            results = _submit_all(st, QUERIES)
        assert len(results) == len(QUERIES)
        assert st.batcher.dispatches - before < len(QUERIES)
        assert st.batcher.max_seen_batch >= 2
        for q, rows in results.items():
            direct = st.searcher.search(q, top_k=3, log=False)
            assert [i for _s, _c, i in rows] == [i for _s, _c, i in direct]
        outs.append(results)
    for q in QUERIES:
        same_rows(outs[1][q], outs[0][q])


def test_weight_groups_do_not_mix(states):
    outs = []
    for st in states:
        out = {}

        def worker(tag, sw, lw):
            rows, _ = st.batcher.submit("machine learning", 3, sw, lw)
            out[tag] = rows

        t1 = threading.Thread(target=worker, args=("sem", 1.0, 0.0))
        t2 = threading.Thread(target=worker, args=("lex", 0.0, 1.0))
        t1.start()
        t2.start()
        t1.join(60)
        t2.join(60)
        for tag, sw, lw in (("sem", 1.0, 0.0), ("lex", 0.0, 1.0)):
            d = st.searcher.search("machine learning", top_k=3, semantic_weight=sw,
                                   lexical_weight=lw, log=False)
            assert [i for _s, _c, i in out[tag]] == [i for _s, _c, i in d]
        outs.append(out)
    for tag in ("sem", "lex"):
        same_rows(outs[1][tag], outs[0][tag])


def test_top_k_trimmed_per_request(states):
    for st in states:
        out = {}

        def worker(k):
            rows, _ = st.batcher.submit("machine learning", k, 0.7, 0.3)
            out[k] = rows

        ts = [threading.Thread(target=worker, args=(k,)) for k in (2, 5)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert len(out[2]) <= 2 and len(out[5]) <= 5
        assert [i for _s, _c, i in out[2]] == [i for _s, _c, i in out[5]][:len(out[2])]


@pytest.mark.parametrize("mod", [jb, tb], ids=["jax", "torch"])
def test_queue_timeout_sheds(states, mod):
    st = states[0 if mod is jb else 1]
    b = mod.SearchBatcher(st.searcher, max_batch=4, queue_timeout_s=0.0)
    p = mod._Pending("q", 3, 0.7, 0.3)
    p.t_enq -= 10.0
    b._dispatch([p])
    assert isinstance(p.error, mod.BatchTimeout)
    b.close()


def test_search_route_uses_batcher(states):
    payloads = []
    for st, build in zip(states, (j_build, t_build)):
        before = st.batcher.batched_requests
        code, payload, _ = build(st).dispatch(
            "POST", "/search", {"query": "unique batcher probe", "top_k": 2})
        assert code == 200
        assert st.batcher.batched_requests == before + 1
        assert payload["query_id"] is not None
        payloads.append(payload)
    assert payloads[1]["query_id"] == payloads[0]["query_id"]
    same_rows([(r["score"], r["content"], r["doc_id"]) for r in payloads[1]["results"]],
              [(r["score"], r["content"], r["doc_id"]) for r in payloads[0]["results"]])


def test_buckets_are_the_jax_buckets():
    for max_batch in (1, 4, 64):
        for n in range(1, 80):
            assert tb._bucket(n, max_batch) == jb._bucket(n, max_batch)


class _Recorder:
    """A searcher stand-in recording each dispatch's padded batch."""

    def __init__(self):
        self.calls = []
        self.entered = threading.Event()
        self.gate = threading.Event()

    def search_batch(self, queries, top_k, semantic_weight, lexical_weight, log):
        self.entered.set()
        self.gate.wait(10)
        self.calls.append((list(queries), top_k, semantic_weight, lexical_weight, log))
        return [[(1.0 - i / 10, q, i) for i in range(top_k)] for q in queries]


def test_padding_groups_and_counters():
    """A drain of 5 requests in one weight group pads to 8 with the last
    query, is served at the group's largest top_k and trimmed per request;
    a dispatch error reaches every waiter of its group."""
    rec = _Recorder()
    b = tb.SearchBatcher(rec, max_batch=8, queue_timeout_s=30.0)
    out, errs = {}, []

    def worker(q, k, sw, lw):
        try:
            out[q] = b.submit(q, k, sw, lw)[0]
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    first = threading.Thread(target=worker, args=("first", 1, 0.7, 0.3))
    first.start()
    assert rec.entered.wait(10)  # the dispatcher is held in rec.gate
    threads = [threading.Thread(target=worker, args=(f"q{i}", 2 + i % 3, 0.7, 0.3))
               for i in range(5)]
    threads.append(threading.Thread(target=worker, args=("lex", 4, 0.0, 1.0)))
    for t in threads:
        t.start()
    while len(b._queue) < 6:
        threading.Event().wait(0.001)
    rec.gate.set()
    for t in [first, *threads]:
        t.join(30)
    assert not errs
    assert b.dispatches == 3 and b.batched_requests == 7 and b.max_seen_batch == 5
    group = next(c for c in rec.calls if len(c[0]) == 8)
    assert group[0][5:] == [group[0][4]] * 3 and group[1] == 4 and group[4] is False
    assert all(len(out[f"q{i}"]) == 2 + i % 3 for i in range(5))
    assert next(c for c in rec.calls if c[0] == ["lex"])[2:4] == (0.0, 1.0)
    b.close()

    class _Failing:
        def search_batch(self, *a, **k):
            raise RuntimeError("device fault")

    b = tb.SearchBatcher(_Failing(), max_batch=4)
    with pytest.raises(RuntimeError, match="device fault"):
        b.submit("x", 3, 0.7, 0.3)
    b.close()
