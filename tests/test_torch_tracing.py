"""The port's serving spans and counters (``utils/tracing.py``,
``retrieval/searcher.py``): span counts and nesting inside
``Searcher.search_batch`` on the supertile and impact ladders, their
profiler ranges against their ``StageTimer`` samples, the per-row ladder
and certificate-clause counters, ``StageTimer`` statistics over a stated
window, and the benchmark's span readers (``benchmarks_cuda/metrics/``).

Small source and clustered indexes are forced into the ladder regime
(``SPARSE_HYBRID_MIN_DOCS`` lowered) with starved first rungs, so every
batch escalates."""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.sparse_index import BM25
from hybridsearch_tpu_torch.models.encoder import HashingEncoder
from hybridsearch_tpu_torch.ops import supertile as tst
from hybridsearch_tpu_torch.retrieval import searcher as tsm
from hybridsearch_tpu_torch.utils import tracing
from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS, GLOBAL_TIMER, StageTimer

METRICS = Path(__file__).resolve().parents[1] / "benchmarks_cuda" / "metrics"
LADDER_SPANS = ("ladder.setup", "ladder.encode", "ladder.prefix", "ladder.rung",
                "ladder.merge", "ladder.escalate")
LEAVES = ("encode", "search.format") + LADDER_SPANS
CLAUSE_COUNTERS = tuple(f"supertile_rows_failing_{c}" for c in tst.CERT_CLAUSES)
LADDER_COUNTERS = ("ladder_batches", "ladder_rungs", "ladder_rows",
                   "ladder_rows_certified")


def _searcher(texts, layout):
    cfg = EngineConfig()
    cfg.index.dim = 64
    cfg.index.layout = layout
    cfg.serving.uncertified_tol = 0.0
    s = tsm.Searcher(config=cfg, encoder=HashingEncoder(dim=64, device="cpu"),
                     use_query_memory=False, device="cpu")
    s.indexer.index_documents(texts)
    return s


@pytest.fixture(scope="module")
def source():
    rng = np.random.default_rng(11)
    vocab = [f"w{i}" for i in range(400)]
    topics = [[f"z{z}t{j}" for j in range(10)] for z in range(20)]
    texts = [" ".join(list(rng.choice(topics[i % 20], 4)) + list(rng.choice(vocab, 8))
                      + (["common"] if i % 3 else []))
             for i in range(3000)]
    queries = ([" ".join(rng.choice(topics[z], 2)) for z in range(12)]
               + [f"common {vocab[i]} {vocab[i + 7]}" for i in range(6)]
               + ["nothing matches", "w1 w2 w3 w4 w5 w6 w7 w8 w9 w10"])
    return _searcher(texts, "source"), queries


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(300)]
    topics = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(12)]
    texts = [f"{topics[i % 12]} " + " ".join(rng.choice(vocab, size=6))
             for i in range(4000)]
    queries = ([f"z{z}t1 z{z}t3" for z in range(12)]
               + [f"z{z}t0 z{z}t1 z{z}t3" for z in range(8)]
               + [f"{vocab[i]} {vocab[i + 50]} {vocab[i + 100]}" for i in range(6)]
               # more terms than the widest term pad: never term-complete
               + [" ".join(vocab[200:240])])
    return _searcher(texts, "clustered"), queries


@pytest.fixture
def impact_regime(monkeypatch):
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "_IMPACT_LADDER",
                        ((16, 2, 256), (256, 16, 1024), (1024, 64, 4096)))
    monkeypatch.setattr(tsm, "_MIN_ESCALATION_BUCKET", 2)


@pytest.fixture
def supertile_regime(monkeypatch):
    """512-doc supertiles (8 on the 4,000-doc index) and a ladder from one
    probe, so rows escalate."""
    monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    monkeypatch.setattr(tsm, "_SUPER_LADDER", (1, 2, 4, 8))
    monkeypatch.setattr(tsm, "_MIN_ESCALATION_BUCKET", 2)
    real = BM25.super_postings
    monkeypatch.setattr(BM25, "super_postings",
                        lambda self, state=None, super_tiles=128: real(self, state, 4))


@contextlib.contextmanager
def _recording(monkeypatch, ladder):
    """Tee GLOBAL_TIMER's samples and keep each ladder call's (exact, rungs)
    and the counters' values before the body."""
    got = SimpleNamespace(spans={}, calls=[],
                          before={n: GLOBAL_COUNTERS.get(n)
                                  for n in LADDER_COUNTERS + CLAUSE_COUNTERS})
    real_record, real_ladder = GLOBAL_TIMER.record, getattr(tsm, ladder)

    def record(stage, seconds):
        got.spans.setdefault(stage, []).append(seconds)
        real_record(stage, seconds)

    def calling(*a, **k):
        st, rungs = real_ladder(*a, **k)
        got.calls.append((np.asarray(st.exact, bool).copy(), rungs))
        return st, rungs

    monkeypatch.setattr(GLOBAL_TIMER, "record", record)
    monkeypatch.setattr(tsm, ladder, calling)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield got
    got.delta = {n: GLOBAL_COUNTERS.get(n) - v for n, v in got.before.items()}


def _serve(searcher, queries, monkeypatch, ladder):
    with _recording(monkeypatch, ladder) as got:
        searcher.search_batch(queries, top_k=5, log=False)
    assert len(got.calls) == 1
    return got


@pytest.mark.parametrize("case", ["impact", "supertile"])
def test_span_counts_per_search_batch(case, source, clustered, request, monkeypatch):
    request.getfixturevalue(f"{case}_regime")
    searcher, queries = source if case == "impact" else clustered
    got = _serve(searcher, queries, monkeypatch, f"{case}_ladder")
    (_exact, rungs), = got.calls
    assert rungs > 1, "the starved first rung must escalate"
    n = {name: len(got.spans.get(name, ())) for name in
         ("search_batch", "search.format", "encode", "hybrid_sparse") + LADDER_SPANS}
    assert n["search_batch"] == n["search.format"] == n["encode"] == 1
    assert n["hybrid_sparse"] == n["ladder.setup"] == 1
    assert n["ladder.rung"] == n["ladder.merge"] == n["ladder.escalate"] == rungs
    if case == "impact":
        assert n["ladder.encode"] == rungs and n["ladder.prefix"] == 0
    else:
        assert n["ladder.encode"] == 1 and n["ladder.prefix"] == 1


@pytest.mark.parametrize("case", ["impact", "supertile"])
def test_spans_sum_within_their_parents(case, source, clustered, request, monkeypatch):
    request.getfixturevalue(f"{case}_regime")
    searcher, queries = source if case == "impact" else clustered
    got = _serve(searcher, queries, monkeypatch, f"{case}_ladder")
    total = {name: sum(v) for name, v in got.spans.items()}
    ladder = sum(total.get(name, 0.0) for name in LADDER_SPANS)
    assert 0.0 < ladder <= total["hybrid_sparse"]
    for name in LADDER_SPANS:
        assert total.get(name, 0.0) <= total["hybrid_sparse"]
    children = total["hybrid_sparse"] + total["encode"] + total["search.format"]
    assert children <= total["search_batch"]
    assert sum(total[name] for name in LEAVES if name in total) <= total["search_batch"]


@pytest.mark.parametrize("case", ["impact", "supertile"])
def test_profiler_ranges_nest_and_match_the_timer(case, source, clustered, request,
                                                  monkeypatch):
    """Each span is a profiler range on the calling thread, nested under
    ``search_batch``, as long as its StageTimer sample (within 10% or 50
    µs). The durations are compared on the best of three profiled calls:
    a preemption of the test process in the microseconds between a range's
    edge and its clock is the host's noise, not the program's."""
    request.getfixturevalue(f"{case}_regime")
    searcher, queries = source if case == "impact" else clustered
    for _attempt in range(3):
        gc.disable()  # as for preemption: a collection there is noise
        try:
            with _recording(monkeypatch, f"{case}_ladder") as got:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    with record_function("test.caller"):
                        searcher.search_batch(queries, top_k=5, log=False)
        finally:
            gc.enable()
        names = set(got.spans)
        assert {"search_batch", "hybrid_sparse", "ladder.rung"} <= names
        events = [e for e in prof.events() if e.name in names]
        caller, = [e for e in prof.events() if e.name == "test.caller"]
        seen, apart = {}, []
        for e in sorted(events, key=lambda e: e.time_range.start):
            assert e.thread == caller.thread, e.name
            chain, p = [], e.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            if e.name == "search_batch":
                assert chain[0] == "test.caller"
            else:
                assert "search_batch" in chain, (e.name, chain)
            i = seen[e.name] = seen.get(e.name, -1) + 1
            timer_us = got.spans[e.name][i] * 1e6
            range_us = e.time_range.elapsed_us()
            if abs(timer_us - range_us) > max(0.1 * timer_us, 50.0):
                apart.append((e.name, i, timer_us, range_us))
        assert {name: n + 1 for name, n in seen.items()} == {
            name: len(v) for name, v in got.spans.items()}
        if not apart:
            break
    assert not apart, apart


@pytest.mark.parametrize("case", ["impact", "supertile"])
def test_ladder_row_counters(case, source, clustered, request, monkeypatch):
    request.getfixturevalue(f"{case}_regime")
    searcher, queries = source if case == "impact" else clustered
    got = _serve(searcher, queries, monkeypatch, f"{case}_ladder")
    (exact, rungs), = got.calls
    d = got.delta
    assert d["ladder_batches"] == 1 and d["ladder_rungs"] == rungs
    assert d["ladder_rows"] == len(queries) == exact.size
    assert d["ladder_rows"] - d["ladder_rows_certified"] == int((~exact).sum())
    clauses = sum(d[name] for name in CLAUSE_COUNTERS)
    if case == "impact":
        assert clauses == 0
    else:
        assert not exact[-1], "the 40-term query cannot certify"
        # it fails `complete` in every rung it runs (all of them)
        assert d["supertile_rows_failing_complete"] >= rungs
        assert all(d[name] <= exact.size * rungs for name in CLAUSE_COUNTERS)


def test_clause_mask_matches_the_certificate(clustered, supertile_regime):
    """``return_clauses``: the same HybridTopK, and a row's mask is 0 exactly
    where its certificate closes; each bit is the named clause."""
    searcher, queries = clustered
    bm25, snap = searcher.indexer.bm25, searcher.indexer.dense._snap
    sp, enc = bm25.encode_queries_super(queries)
    q = tsm.l2_normalize(searcher.indexer.encoder.encode(queries).float())
    pfx = tst.super_prefix(q, snap.docs, sp, enc, bias=snap.bias, s_max=8)
    masks = []
    for s_probe in (1, 2, 8):
        kw = dict(bias=snap.bias, s_probe=s_probe, n_alive=snap.n)
        plain = tst.hybrid_supertile_topk_rung(q, snap.docs, sp, enc, pfx, 5, 0.7,
                                               0.3, **kw)
        res, mask = tst.hybrid_supertile_topk_rung(q, snap.docs, sp, enc, pfx, 5,
                                                   0.7, 0.3, return_clauses=True, **kw)
        for a, b in zip(plain, res):
            assert torch.equal(a, b)
        assert mask.dtype == torch.uint8 and mask.shape == (len(queries),)
        np.testing.assert_array_equal(mask.numpy() == 0, res.exact.numpy())
        masks.append(mask.numpy())
    bit = {c: 1 << i for i, c in enumerate(tst.CERT_CLAUSES)}
    m = np.concatenate(masks)
    complete = np.tile(np.asarray(enc.complete), 3)
    np.testing.assert_array_equal((m & bit["complete"]) != 0, ~complete)
    lmz = np.tile(np.asarray(enc.full_touched) < snap.n, 3)
    np.testing.assert_array_equal((m & bit["lex_min_zero"]) != 0, ~lmz)
    assert m.max() < 1 << len(tst.CERT_CLAUSES)
    assert (m != 0).any()


def test_merge_returns_per_row_arrays_of_real_rows_only():
    """``merge`` hands back its further per-row tensors on the host, cut to
    the rows the rung ran: a compacted rung's pad rows (past ``len(rows)``)
    are left out; ``finish`` counts the batch once."""
    before = {n: GLOBAL_COUNTERS.get(n) for n in LADDER_COUNTERS}
    st = tsm._LadderState(6)
    v, i = torch.zeros((6, 2)), torch.zeros((6, 2), dtype=torch.int64)
    mask = torch.tensor([0, 0b01010, 0b00001, 0, 0, 0], dtype=torch.uint8)
    got, = st.merge(v, i, torch.tensor([True, False, False, True, True, True]), mask)
    assert got.tolist() == mask.tolist()
    st.rows = np.array([1, 2])
    got = st.merge(v[:4], i[:4], torch.tensor([False, True, False, False]),
                   torch.tensor([0b00010, 0, 0b11111, 0b11111], dtype=torch.uint8),
                   torch.arange(4))
    assert [a.tolist() for a in got] == [[0b00010, 0], [0, 1]]
    assert st.merge(v, i, torch.ones(4, dtype=torch.bool)) == []
    assert st.exact.tolist() == [True, True, True, True, True, True]
    assert st.finish(3) == (st, 3)
    d = {n: GLOBAL_COUNTERS.get(n) - before[n] for n in LADDER_COUNTERS}
    assert d == {"ladder_batches": 1, "ladder_rungs": 3, "ladder_rows": 6,
                 "ladder_rows_certified": 6}
    assert tsm._LadderState(6).finish(0)[1] == 0
    assert {n: GLOBAL_COUNTERS.get(n) - before[n] for n in LADDER_COUNTERS} == d


def test_metrics_exports_the_ladder_counters(source, impact_regime, clustered,
                                             supertile_regime):
    from hybridsearch_tpu_torch.api.app import h_metrics

    for searcher, queries in (source, clustered):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            searcher.search_batch(queries, top_k=5, log=False)
    searcher = clustered[0]
    state = SimpleNamespace(indexer=searcher.indexer, searcher=searcher,
                            semantic_cache=None, batcher=None)
    code, body = h_metrics(state, {}, None, {})
    lines = body["_text"].splitlines()
    assert code == 200
    for name in LADDER_COUNTERS + CLAUSE_COUNTERS:
        assert any(ln.startswith(f"hst_{name}_total ") for ln in lines), name
    assert not any("hybrid_sparse_uncertified" in ln for ln in lines)
    for span in ("search_batch", "search.format", "ladder.merge"):
        assert f'hst_stage_calls_total{{stage="{span}"}}' in body["_text"]


def test_stage_timer_stats_over_a_stated_window(monkeypatch):
    clock = iter([10.0, 10.5, 11.0, 11.0, 13.3, 14.0])
    monkeypatch.setattr(tracing, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    t = StageTimer(window=2)
    for seconds in (0.1, 0.2, 0.3):
        t.record("x", seconds)
    s = t.stats()["x"]
    # the last two samples: from 10.5 - 0.2 to the call at 11.0
    assert s["count"] == 3 and s["samples"] == 2
    assert s["window_s"] == pytest.approx(0.7)
    assert s["rate_per_s"] == pytest.approx(2 / 0.7)
    assert s["mean_ms"] == pytest.approx(250.0)
    assert list(t._samples["x"]) == [0.2, 0.3]
    # idle since the newest sample: the window runs on and the rate falls
    s = t.stats()["x"]
    assert s["window_s"] == pytest.approx(3.0)
    assert s["rate_per_s"] == pytest.approx(2 / 3.0)
    t.reset()
    assert t.stats() == {}


def test_trace_span_records_host_seconds_and_keeps_the_two_argument_record():
    calls = []
    t = StageTimer()
    t.record = lambda *a, **k: calls.append((a, k))
    with tracing.trace_span("s", timer=t):
        pass
    (args, kwargs), = calls
    assert kwargs == {} and args[0] == "s" and 0.0 <= args[1] < 1.0


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + "".join(c if c.isalnum() else "_" for c in name),
        METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, want", [
    ("search.format.ms_per_batch", 1e3 * (0.004 + 0.006) / 2),
    ("ladder.encode.ms_per_batch", 1e3 * (0.001 + 0.002 + 0.003) / 2),
    ("ladder.rung.ms_per_batch", 1e3 * (0.010 + 0.020) / 2),
    ("ladder.merge.ms_per_batch", 1e3 * (0.005 + 0.007) / 2),
    ("ladder.escalate.ms_per_batch", 1e3 * (0.0005 + 0.0015) / 2),
    ("search.unspanned.ms_per_batch",
     1e3 * (0.100 + 0.120 - (0.003 + 0.004 + 0.0002 + 0.0003 + 0.001 + 0.002
                             + 0.003 + 0.002 + 0.010 + 0.020 + 0.005 + 0.007
                             + 0.0005 + 0.0015 + 0.004 + 0.006)) / 2),
])
def test_span_readers(name, want):
    spans = {"search_batch": [0.100, 0.120], "encode": [0.003, 0.004],
             "hybrid_sparse": [0.050, 0.060], "ladder.setup": [0.0002, 0.0003],
             "ladder.encode": [0.001, 0.002, 0.003],
             "ladder.prefix": [0.002], "ladder.rung": [0.010, 0.020],
             "ladder.merge": [0.005, 0.007], "ladder.escalate": [0.0005, 0.0015],
             "search.format": [0.004, 0.006]}
    reader = _reader(name)
    run = SimpleNamespace(spans=spans, latencies_s=[0.11, 0.13])
    assert reader.read(run) == pytest.approx(want)
    # a program without the span (the parent of these spans) reads nothing
    assert reader.read(SimpleNamespace(spans={"encode": [0.003]},
                                       latencies_s=[0.11])) is None
