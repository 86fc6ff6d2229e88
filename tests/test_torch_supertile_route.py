"""The supertile rung's placement route (``ops/supertile.py`` ``place_route``)
and the counter a rung bumps under its route's name, on the CPU.

``EngineConfig.perf.place_fused`` None places with K5 where the corpus is on
the card and K5's plan fits a supertile's buffer, else with staged windows
+ K3; True forces K5, False the staged windows. On CPU tensors K5's wrapper
runs its plain version (the staged windows and K3's plain scatter), so
every route must give the same bits: compared with ``torch.equal``. The
card's side of the rule (``_on_card``) is simulated by a monkeypatch, as
tests/test_torch_supertile_levers.py does. Inputs come from a seeded numpy
generator; no JAX is needed.
"""

import numpy as np
import pytest
import torch

from hybridsearch_tpu_torch.ops import cuda_supertile as tcs
from hybridsearch_tpu_torch.ops import supertile as tst
from hybridsearch_tpu_torch.retrieval import searcher as tsm
from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

CPU = torch.device("cpu")
N_DOCS, DIM, VOCAB, SUPER_TILES = 4096, 32, 50, 4  # 8 supertiles of 512 docs
ROUTES = ("supertile_rung_place_fused", "supertile_rung_place_staged")


@pytest.fixture(scope="module")
def corpus():
    """(SuperPostings, encoded queries, q [B, D], docs [N, D]): a few terms
    in nearly every doc (wide windows), the rest rare."""
    rng = np.random.default_rng(22)
    frac = np.where(np.arange(VOCAB) < 3, 0.9, rng.uniform(0.002, 0.05, VOCAB))
    hits = [np.flatnonzero(rng.random(N_DOCS) < f) for f in frac]
    t = np.concatenate([np.full(len(h), i) for i, h in enumerate(hits)])
    d = np.concatenate(hits)
    w = (rng.random(len(t)) * 4 + 0.05).astype(np.float32)
    sp = tst.build_super_postings(t, d, w, N_DOCS, VOCAB, CPU, super_tiles=SUPER_TILES)
    lists = [[int(x) for x in rng.choice(VOCAB, size=int(rng.integers(1, 6)),
                                         replace=False)] for _ in range(12)]
    enc = tst.encode_super_queries(sp, lists)
    docs = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = rng.standard_normal((len(lists), DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return sp, enc, torch.from_numpy(q), torch.from_numpy(docs)


@pytest.mark.parametrize("flag,on_card,super_tiles,want", [
    (None, False, 128, False),  # off the card: the staged windows
    (None, True, 128, True),  # the card's route: K5
    (None, True, 512, False),  # on the card, but no ring fits beside the buffer
    (False, True, 128, False),  # the yardstick route, forced
    (False, False, 128, False),
    (True, False, 128, True),  # K5 forced (its plain version off the card)
    (True, True, 512, True),  # forced even where no plan fits: the wrapper raises
])
def test_place_route_resolves_the_flag(monkeypatch, flag, on_card, super_tiles, want):
    monkeypatch.setattr(tst, "_on_card", lambda t: on_card)
    assert tst.place_route(flag, torch.zeros(1), super_tiles) is want


@pytest.mark.parametrize("super_tiles,fits", [(1, True), (128, True), (256, True),
                                               (440, True), (460, False), (512, False)])
def test_place_fused_plan_fit_does_not_depend_on_the_sm_count(super_tiles, fits):
    """``place_route`` asks K5's plan for one SM: whether a plan exists is
    the same on every card."""
    assert {tcs.place_fused_plan(super_tiles * 128, sms) is not None
            for sms in (1, 66, 132)} == {fits}


def _counting(monkeypatch):
    calls = {}
    for name in ("place_windows", "place_fused"):
        real = getattr(tst, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(tst, name, counted)
    return calls


@pytest.mark.parametrize("flag,on_card,kernel", [
    (None, False, "place_windows"),
    (None, True, "place_fused"),
    (False, True, "place_windows"),
    (True, False, "place_fused"),
])
def test_rung_takes_the_resolved_route_with_the_same_bits(corpus, monkeypatch, flag,
                                                          on_card, kernel):
    sp, enc, q, docs = corpus
    pfx = tst.super_prefix(q, docs, sp, enc, s_max=4)
    want, want_clauses = tst.hybrid_supertile_topk_rung(
        q, docs, sp, enc, pfx, 5, 0.7, 0.3, s_probe=4, place_fused=False,
        return_clauses=True)
    monkeypatch.setattr(tst, "_on_card", lambda t: on_card)
    calls = _counting(monkeypatch)
    got, clauses = tst.hybrid_supertile_topk_rung(
        q, docs, sp, enc, pfx, 5, 0.7, 0.3, s_probe=4, place_fused=flag,
        return_clauses=True)
    assert calls == {kernel: 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(clauses, want_clauses)


@pytest.mark.parametrize("flag,on_card,route", [
    (None, False, "supertile_rung_place_staged"),
    (None, True, "supertile_rung_place_fused"),
    (False, True, "supertile_rung_place_staged"),
    (True, False, "supertile_rung_place_fused"),
])
def test_ladder_counts_each_rung_under_its_route(corpus, monkeypatch, flag, on_card,
                                                 route):
    """One increment a rung, under the resolved route's name only; the
    ladder's own ``ladder_rungs`` counts the same rungs."""
    sp, enc, q, docs = corpus
    monkeypatch.setattr(tst, "_on_card", lambda t: on_card)
    before = {name: GLOBAL_COUNTERS.get(name) for name in ROUTES + ("ladder_rungs",)}
    st, rungs = tsm.supertile_ladder(q, docs, sp, enc, 5, 0.7, 0.3, ladder=(1, 2, 4, 8),
                                     uncertified_tol=0.0, place_fused=flag)
    after = {name: GLOBAL_COUNTERS.get(name) for name in before}
    assert rungs >= 2  # the escalation ran: more than one rung counted
    assert after[route] - before[route] == rungs
    other, = set(ROUTES) - {route}
    assert after[other] == before[other]
    assert after["ladder_rungs"] - before["ladder_rungs"] == rungs
    assert st.values.shape == (q.shape[0], 5)
