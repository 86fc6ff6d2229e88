#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hybridsearch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                   # the card run
    python3 chip_smoke.py --cpu-rehearsal   # tiny sizes on the CPU

The card run builds the CUDA kernels from ``hybridsearch_tpu_torch/csrc``,
holds each against its plain PyTorch version at the slice's shapes, then
drives the main path through the entry points a user calls: a synthetic,
topic-correlated corpus of 524,288 docs (BEIR Quora's 522,931 rounded up to
32 supertiles of 16,384) is indexed with ``Indexer.index_documents``
(clustered layout, 384-wide hashing encoder, float32), and 8 batches of 256
queries go through ``Searcher.search_batch`` after one warm-up batch. That
route is the supertile ladder: the stats sweep (K1, tile_stats), resident
scores (K2, super_scores) and resident placement (K3, place_windows). The
run fails unless each kernel launched during the timed batches, the batches
reached the ladder's last rung, and every certified query matches a plain
exact fused reference computed on the card. Each kernel is then timed on
the main path's own inputs (K2 at every probe count the ladder gave it).
The P1 check re-runs the clustered build's k-means on the same embeddings
and requires the same centroids, bit for bit, and the same permutation.

The same index is then served again, not re-indexed, with the two perf
levers on (``cfg.perf.scores_dedup`` and ``cfg.perf.place_fused``): the
rungs score pairs sorted by supertile (K4, super_scores_dedup) and place
the lexical windows straight from the CSR (K5, place_fused). Its certified
flags, ids and values must equal the default run's bit for bit; K4 and K5
are timed at every rung beside K2 and the window gather + K3 on the same
work; K4 is held bit-equal to K2 and its whole route (pair sort, group
table, kernel) is timed against K2 at every rung.

The default configuration's path comes next: the same small-topic corpus
indexed under ``layout="source"`` and served through the impact ladder,
whose rungs run the dense sweep (K1), pass 3 of the dense top-k (K4 at
tile grain, tile_scores), the run slices (K6, slice_runs) and the
candidate rescore (K7, rescore); pass 3, K6 and K7 must launch in the
timed batches, and are then timed at every rung the batches reached. Every
kernel keeps its first design as a yardstick (``tile_stats_v1``,
``super_scores_v1``, ``place_windows_v1``, ``super_scores_dedup_v1``,
``place_fused_v1``, ``slice_runs_v1``, ``rescore_v1``), which no served
batch may launch: the kernel check, the per-rung rows of K2, K4, K5, K6
and K7 and the "redesigned kernels" rows (K1 at every batch size of both
paths, K3 at every rung) hold each bit-equal to its first design and time
the two side by side; the rows of K2, K5, K6 and K7 mark
the goal of at least half the kernel's bound met or missed and give each
route's host time (events around back-to-back calls less device time).
"Regime 1" serves a corpus a quarter of the size, below
``SPARSE_HYBRID_MIN_DOCS``, through the full [B, n] fused program; one
batch is served twice and must be equal bit for bit. A corpus with larger topics is served on the
clustered path last. No corpus's topic structure comes from a published
source, so their qps describe these corpora only.

Every phase prints one line with its elapsed seconds before the next
starts. The last two lines are a JSON object of per-kernel numbers and the
device line; per-batch details go to ``chiprun_out/chip_smoke_detail.json``.
Without a CUDA card the run exits non-zero and prints no result;
``--cpu-rehearsal`` runs the same phases on the CPU at tiny sizes,
with the plain versions standing in for the kernels, and prints no device
result.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BUDGET_S = 600.0  # the whole card run, build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# (main-path shapes, rehearsal shapes)
SIZES = {
    "card": dict(n_docs=524_288, dim=384, batch=256, n_batches=8,
                 n_background=30_000, s_max=16, probes=(2, 4, 8, 16)),
    "cpu": dict(n_docs=9_216, dim=128, batch=32, n_batches=2,
                n_background=2_000, s_max=1, probes=(2, 4)),
}
# Two synthetic corpora, neither taken from a published source. Each is
# (docs a topic, words a doc from its topic's vocabulary,
# words from the Zipf background, size of a topic's vocabulary). The main
# path runs "small-topic": small topics drawn in background-heavy docs
# scatter over the supertiles, so batches climb the whole probe ladder.
# "large-topic" gathers each topic in few supertiles and mostly certifies
# at the first rung.
CORPORA = {
    "small-topic": (128, 16, 32, 12),
    "large-topic": (512, 32, 16, 24),
}
DETAIL_PATH = "chiprun_out/chip_smoke_detail.json"
# batch sizes at which the kernel check holds K1 to its first design
K1_V1_BATCHES = (1, 32, 100, 256)
TOP_K = 10
EPS_NUM = 1e-4  # the certificate margin (ops/supertile.py)

KERNEL_META = {
    "tile_stats": ("hybridsearch_tpu_torch/csrc/tile_stats.cu",
                   "hybridsearch_tpu/ops/pallas_topk.py:124"),
    "super_scores": ("hybridsearch_tpu_torch/csrc/super_scores.cu",
                     "hybridsearch_tpu/ops/pallas_supertile.py:33"),
    "place_windows": ("hybridsearch_tpu_torch/csrc/place_windows.cu",
                      "hybridsearch_tpu/ops/pallas_supertile.py:394"),
    "super_scores_dedup": ("hybridsearch_tpu_torch/csrc/super_scores.cu",
                           "hybridsearch_tpu/ops/pallas_supertile.py:110"),
    "place_fused": ("hybridsearch_tpu_torch/csrc/place_fused.cu",
                    "hybridsearch_tpu/ops/pallas_supertile.py:249"),
    "slice_runs": ("hybridsearch_tpu_torch/csrc/slice_runs.cu",
                   "hybridsearch_tpu/ops/pallas_impact.py:39"),
    "rescore": ("hybridsearch_tpu_torch/csrc/impact_rescore.cu",
                "hybridsearch_tpu/ops/pallas_impact.py:104"),
}
# Each served path: its ladder (a function of retrieval/searcher.py) and the
# kernels its rungs launch.
PATHS = {
    "clustered": ("supertile_ladder", ("tile_stats", "super_scores",
                                       "place_windows")),
    # the same ladder with EngineConfig.perf.scores_dedup and .place_fused
    "clustered/levers": ("supertile_ladder", ("tile_stats", "super_scores_dedup",
                                              "place_fused")),
    # pass 3 of its dense top-k runs K4 at tile grain (tile_scores)
    "source": ("impact_ladder", ("tile_stats", "slice_runs", "rescore",
                                 "super_scores_dedup")),
}
# (T, p, C) of the impact kernels' checks: the three rungs of the impact
# ladder at T = 8 term slots (C = k_dense + T * c_per_term), the third rung
# at T = 32, and the margin call (C = 128)
IMPACT_SHAPES = {
    "card": [(8, 256, 1024), (8, 1024, 2048), (8, 4096, 4096),
             (32, 4096, 10240), (8, 1024, 128)],
    "cpu": [(8, 64, 256), (32, 64, 512)],
}


class Clock:
    def __init__(self, budget_s: float):
        self.t0 = time.perf_counter()
        self.budget_s = budget_s

    def phase(self, name: str, detail: str = "") -> None:
        el = time.perf_counter() - self.t0
        print(f"[{el:8.1f}s] {name}{': ' + detail if detail else ''}", flush=True)
        if el > self.budget_s:
            raise RuntimeError(f"over the {self.budget_s:.0f} s budget at {name}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev: torch.device, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls on the
    card, the host clock after a synchronize elsewhere."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def max_err(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        same_inf = torch.isinf(g) & (g == w)
        d = torch.where(same_inf, 0.0, (g - w).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def unit_rows(gen: torch.Generator, n: int, d: int, dev) -> torch.Tensor:
    x = torch.randn((n, d), generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


# -- phase 3: kernels at the slice's shapes on synthetic inputs -----------------

def check_kernels(sz: dict, dev: torch.device, seed: int) -> None:
    """Each kernel against its plain version at the slice's widths, float32
    and (K1, K2) bf16, with K2 at the deepest rung's probe count; on the
    card K1 and K3 also bit-equal to their first designs (``_v1``)."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        place_windows, place_windows_plain, place_windows_v1, super_scores,
        super_scores_plain, super_scores_v1)
    from hybridsearch_tpu_torch.ops.cuda_topk import (
        tile_stats, tile_stats_plain, tile_stats_v1)

    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    N, D, B = sz["n_docs"], sz["dim"], sz["batch"]
    docs = unit_rows(gen, N, D, dev)
    q = unit_rows(gen, B, D, dev)
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=gen, device=dev)[: N // 100]] = float("-inf")
    sd = 16384 if N >= 16384 else 1024
    n_sup = N // sd
    S = min(sz["s_max"], n_sup)
    sup = torch.sort(torch.stack([torch.randperm(n_sup, generator=gen, device=dev)[:S]
                                  for _ in range(B)]), dim=1).values.int()
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-3)):
        d_t, q_t = docs.to(dt), q.to(dt)
        e1 = max_err(tile_stats(q_t, d_t, bias, N - 77, True),
                     tile_stats_plain(q_t, d_t, bias, N - 77, True))
        e2 = max_err(super_scores(q_t, d_t, sup, sd), super_scores_plain(q_t, d_t, sup, sd))
        print(f"    {str(dt)[6:]}: tile_stats err {e1:.3g}, super_scores "
              f"(S={S}) err {e2:.3g} (tol {tol:g})", flush=True)
        if not (e1 <= tol and e2 <= tol):
            raise AssertionError(f"kernel disagrees with its plain version ({dt})")
        if not on_card:
            continue
        same2 = torch.equal(super_scores(q_t, d_t, sup, sd), super_scores_v1(q_t, d_t, sup, sd))
        print(f"    {str(dt)[6:]}: super_scores (S={S}) bit-equal to super_scores_v1: "
              f"{same2}", flush=True)
        if not same2:
            raise AssertionError(f"super_scores differs from super_scores_v1 ({dt})")
        same = []
        for b in K1_V1_BATCHES:
            for with_min in (False, True):
                got = tile_stats(q_t[:b], d_t, bias, N - 77, with_min)
                want = tile_stats_v1(q_t[:b], d_t, bias, N - 77, with_min)
                same.append(all(torch.equal(g, w) for g, w in zip(got, want)))
        print(f"    {str(dt)[6:]}: tile_stats bit-equal to tile_stats_v1 at B in "
              f"{K1_V1_BATCHES}, with_min off and on: {all(same)}", flush=True)
        if not all(same):
            raise AssertionError(f"tile_stats differs from tile_stats_v1 ({dt})")
    # windows as the path lays them out: whole 1024-entry chunks (one 8192
    # slot + seven 1024 slots), no cell twice in a chunk, a margin of
    # out-of-range ids; then kernel and plain version sum in one order
    R, M = 128 * 128, 128 * 128 + 128
    TE = 23_552
    for rows in (B * 2, B * S):
        start = torch.randint(0, M, (rows, TE // 1024, 1), generator=gen, device=dev)
        step = 1021 * torch.arange(1024, device=dev)  # 1021 is prime to M
        l = ((start + step) % M - 64).reshape(rows, TE).int()
        w = torch.rand((rows, TE), generator=gen, device=dev)
        w[:, ::3] = 0.0
        got = place_windows(l, w)
        e3 = max_err(got, place_windows_plain(l, w))
        same3 = torch.equal(got, place_windows_v1(l, w)) if on_card else None
        print(f"    place_windows {rows} rows: err {e3:.3g} (tol 1e-6), bit-equal "
              f"to place_windows_v1 {same3}", flush=True)
        if not e3 <= 1e-6:
            raise AssertionError("place_windows disagrees with its plain version")
        if on_card and not same3:
            raise AssertionError(f"place_windows differs from place_windows_v1 at "
                                 f"{rows} rows")
        del l, w, got
    sync(dev)


def check_gated_kernels(sz: dict, dev: torch.device, seed: int) -> None:
    """K4 and K5 at the slice's widths. K4 on the probe table, written
    query-major, bit-equal to K2 and (on the card) to its first design on
    the pairs ``dedup_pairs`` sorts, unpermuted, at every probe count of
    the ladder, float32
    and bf16, on a batch whose first half probes three shared supertiles
    (runs longer than any pair group) and whose first row probes a
    supertile past the end (clamped chunks), and within 1e-5 of its plain
    version. K5 bit-equal to the staged windows +
    K3 and to its plain version, on a CSR whose windows overflow the 8,192
    cap, with empty windows and probes past the position table, at
    B*S = 2B rows and wcaps = (8192,)*8 (the shape at which the TPU kernel
    faulted) and a mixed cap tuple; on the card K5 also bit-equal to its
    first design there."""
    from hybridsearch_tpu_torch.ops import supertile as st
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        place_fused, place_fused_plain, place_fused_v1, place_windows, super_scores,
        super_scores_dedup, super_scores_dedup_plain, super_scores_dedup_v1,
        window_entries)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    N, D, B = sz["n_docs"], sz["dim"], sz["batch"]
    docs = unit_rows(gen, N, D, dev)
    q = unit_rows(gen, B, D, dev)
    sd = 16384 if N >= 16384 else 1024
    n_sup = N // sd
    for S in sz["probes"]:
        sup = torch.randint(0, n_sup, (B, S), generator=gen, device=dev)
        sup[: B // 2] = torch.randint(0, 3, (B // 2, S), generator=gen, device=dev)
        sup[0, -1] = n_sup + 3
        sup = torch.sort(sup, dim=1).values.int()
        jtid, jqid, _rep, inv = st.dedup_pairs(sup)
        for dt in (torch.float32, torch.bfloat16):
            d_t, q_t = docs.to(dt), q.to(dt)
            k4 = super_scores_dedup(q_t, d_t, sup, sd)
            same = torch.equal(k4, super_scores(q_t, d_t, sup, sd))
            err = max_err(k4[:4], super_scores_dedup_plain(q_t[:4], d_t, sup[:4], sd))
            same_v1 = (torch.equal(super_scores_dedup_v1(q_t[jqid], d_t, jtid, sd)[inv]
                                   .reshape(B, -1), k4)
                       if dev.type == "cuda" else None)
            print(f"    super_scores_dedup S={S} {str(dt)[6:]}: bit-equal to "
                  f"super_scores {same}, to super_scores_dedup_v1 unpermuted {same_v1}, "
                  f"err {err:.3g} against its plain version (tol 1e-5)", flush=True)
            if not (same and err <= 1e-5 and same_v1 is not False):
                raise AssertionError(f"super_scores_dedup disagrees at S={S} ({dt})")
        del k4
    del docs

    # a doc-sorted CSR: every 8th term in 60% of the docs (windows past the
    # 8,192 cap in 16,384-doc supertiles), the rest in 1-30%
    rng = np.random.default_rng(seed + 3)
    V = 64
    t_l, d_l = [], []
    for term in range(V):
        frac = 0.6 if term % 8 == 0 else float(rng.uniform(0.01, 0.3))
        hit = np.flatnonzero(rng.random(N) < frac)
        t_l.append(np.full(len(hit), term))
        d_l.append(hit)
    t_a, d_a = np.concatenate(t_l), np.concatenate(d_l)
    w_a = (rng.random(len(t_a)) * 8 + 0.01).astype(np.float32)
    sp = st.build_super_postings(t_a, d_a, w_a, N, V, dev)
    term_ids = torch.from_numpy(rng.integers(0, V + 1, (B, 8))).to(dev)
    sup_s = torch.from_numpy(np.sort(rng.integers(0, sp.n_super + 1, (B, 2)),
                                     axis=1)).to(dev)
    any_ovf = False
    for wcaps in ((8192,) * 8, (8192, 2048, 2048, 2048, 512, 512, 512, 512)):
        lo, hi, base, ovf = st._flat_windows(sp.sup_pos, term_ids, sup_s,
                                             sp.super_docs, wcaps)
        got = place_fused(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps, sp.super_tiles)
        sync(dev)
        l_w, w_w = window_entries(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps)
        two = torch.equal(got, place_windows(l_w, w_w, sp.super_tiles))
        plain = torch.equal(got, place_fused_plain(lo, hi, base, sp.ids_rows,
                                                   sp.ws_rows, wcaps, sp.super_tiles))
        same_v1 = (torch.equal(got, place_fused_v1(lo, hi, base, sp.ids_rows, sp.ws_rows,
                                                   wcaps, sp.super_tiles))
                   if dev.type == "cuda" else None)
        any_ovf = any_ovf or bool(ovf.any())
        print(f"    place_fused wcaps={wcaps} B*S={lo.shape[0]}: {int(ovf.sum())} "
              f"queries overflow, {int((lo == hi).sum())} empty windows; bit-equal "
              f"to window gather + place_windows {two}, to its plain version "
              f"{plain}, to place_fused_v1 {same_v1}", flush=True)
        if not (two and plain and same_v1 is not False):
            raise AssertionError(f"place_fused disagrees at wcaps={wcaps}")
    if not any_ovf:
        raise AssertionError("the place_fused check had no overflowing window")
    sync(dev)


def check_impact_kernels(sz: dict, dev: torch.device, seed: int, shapes) -> None:
    """K6 and K7 against their plain versions at the impact ladder's shapes,
    bit for bit: postings whose windows name a doc at most once (as a
    term's run does), slices of random starts and lengths, candidates drawn
    from the slices with repeats, sentinels and -1; on the card K6 and K7
    also bit-equal to their first designs."""
    from hybridsearch_tpu_torch.ops.cuda_impact import (
        rescore, rescore_plain, rescore_v1, slice_runs, slice_runs_plain, slice_runs_v1)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    B, nd = sz["batch"], sz["n_docs"]
    nnz = 8 * nd
    # a prime that does not divide nd: any window of < nd entries is unique
    run = (torch.arange(nnz, device=dev) * 7919 % nd).int()
    for T, p, C in shapes:
        ids = torch.cat([run, torch.full((p,), nd, dtype=torch.int32, device=dev)])
        ws = torch.rand(nnz + p, generator=gen, device=dev) + 0.01
        ws[nnz:] = 0.0
        starts = torch.randint(0, nnz - p, (B, T), generator=gen, device=dev).int()
        lengths = torch.randint(0, 2 * p, (B, T), generator=gen, device=dev).int()
        got = slice_runs(ids, ws, starts, lengths, p, nd)
        want = slice_runs_plain(ids, ws, starts, lengths, p, nd)
        e6 = max_err(got, want)
        same6 = all(torch.equal(g, w) for g, w in zip(got, want))
        same6_v1 = (all(torch.equal(g, w) for g, w in zip(
            got, slice_runs_v1(ids, ws, starts, lengths, p, nd)))
            if dev.type == "cuda" else None)
        ids_f, ws_f = got[0].reshape(B, T * p), got[1].reshape(B, T * p)
        pick = torch.randint(0, T * p, (C,), generator=gen, device=dev)
        cand = ids_f[:, pick].clone()
        cand[:, 1::13] = cand[:, :1]
        cand[:, -3:] = torch.tensor([nd, nd + 2, -1], device=dev)
        g7 = rescore(cand, ids_f, ws_f, p, nd)
        w7 = rescore_plain(cand, ids_f, ws_f, p, nd)
        e7 = max_err(g7, w7)
        same_v1 = (torch.equal(g7, rescore_v1(cand, ids_f, ws_f, p, nd))
                   if dev.type == "cuda" else None)
        print(f"    T={T} p={p} C={C}: slice_runs err {e6:.3g}, rescore err "
              f"{e7:.3g} (tol 0, bitwise), slice_runs bit-equal to slice_runs_v1 "
              f"{same6_v1}, rescore bit-equal to rescore_v1 {same_v1}", flush=True)
        if not (same6 and torch.equal(g7, w7) and same6_v1 is not False
                and same_v1 is not False):
            raise AssertionError(f"an impact kernel disagrees with its plain "
                                 f"version at T={T} p={p} C={C}")
    sync(dev)


# -- phase 4: the corpus -------------------------------------------------------

def make_corpus(sz: dict, corpus: str, seed: int):
    """Topic-correlated synthetic corpus (``CORPORA``): each doc draws its
    topic words from its topic's vocabulary and its other words from a
    Zipf(1.1) background of ``n_background`` words, shuffled. Queries: 2-4
    words of one topic plus one background word."""
    rng = np.random.default_rng(seed)
    topic_docs, n_tw, n_bw, tv = CORPORA[corpus]
    n, V = sz["n_docs"], sz["n_background"]
    T = max(1, n // topic_docs)
    words = [f"t{t}x{j}" for t in range(T) for j in range(tv)]
    words += [f"w{r}" for r in range(V)]
    zipf = 1.0 / np.arange(1, V + 1) ** 1.1
    zipf /= zipf.sum()
    topic = rng.integers(0, T, n)
    tw = topic[:, None] * tv + rng.integers(0, tv, (n, n_tw))
    bw = T * tv + rng.choice(V, size=(n, n_bw), p=zipf)
    mat = rng.permuted(np.concatenate([tw, bw], axis=1), axis=1)
    docs = [" ".join([words[i] for i in row]) for row in mat.tolist()]

    def queries(count: int):
        out = []
        qt = rng.integers(0, T, count)
        nw = rng.integers(2, 5, count)
        bg = rng.choice(V, size=count, p=zipf)
        for t, m, b in zip(qt.tolist(), nw.tolist(), bg.tolist()):
            js = rng.choice(tv, size=m, replace=False)
            out.append(" ".join([f"t{t}x{j}" for j in js] + [f"w{b}"]))
        return out

    return docs, queries


# -- phase 4: the plain exact reference -----------------------------------------

def reference_topk(searcher, queries, k: int, sw: float, lw: float):
    """Exact fused top-k with no kernel: full [B, n] cosine, BM25 summed
    from the CSR term by term, alive-masked min-max fusion, top-k. Also
    returns the [B, n] fused scores for tie checks."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.text.extractor import extract_tokens

    idx = searcher.indexer
    snap = idx.dense._snap
    n = snap.n
    st = idx.bm25._state
    po = st.postings
    q = l2_normalize(idx.encoder.encode(list(queries)).float())
    sem = q @ snap.docs[:n].T
    lex = torch.zeros_like(sem)
    indptr = po.indptr.cpu().numpy()
    for b, text in enumerate(queries):
        for t in st.vocab.encode(extract_tokens(text)):
            lo, hi = int(indptr[t]), int(indptr[t + 1])
            lex[b].index_add_(0, po.doc_ids[lo:hi].long(), po.weights[lo:hi])
    bias = snap.bias[:n]
    alive = (bias >= 0)[None, :]

    def norm(x):
        mn = torch.where(alive, x, float("inf")).amin(1, keepdim=True)
        mx = torch.where(alive, x, float("-inf")).amax(1, keepdim=True)
        r = mx - mn
        return torch.where(r > 1e-12, (x - mn) / r.clamp_min(1e-12), torch.ones_like(x))

    fused = sw * norm(sem) + lw * norm(lex) + bias[None, :]
    vals, ids = torch.topk(fused, k, dim=1)
    return vals, ids, fused


def _row_mismatch(res, ref_vals, ref_ids, fused_row):
    """Why a served row differs from the reference, or None: ids must be
    equal except where the two scores at a slot lie within EPS_NUM (a
    near-tie the float32 summation order may swap); values within EPS_NUM."""
    got_ids = [i for _v, _c, i in res]
    got_vals = np.array([v for v, _c, _i in res])
    if len(got_ids) != len(ref_ids):
        return f"{len(got_ids)} results"
    if np.abs(got_vals - ref_vals).max() > EPS_NUM:
        return f"values {got_vals} vs {ref_vals}"
    for j, (g, r) in enumerate(zip(got_ids, ref_ids)):
        if g != r and abs(float(fused_row[g]) - ref_vals[j]) > EPS_NUM:
            return f"slot {j}: doc {g} ({float(fused_row[g])}) vs {r} ({ref_vals[j]})"
    return None


def check_against_reference(results, exact_rows, ref_vals, ref_ids, fused):
    """(certified rows checked, uncertified rows that match anyway,
    jaccard@k of each uncertified row's ids against the reference's). A
    certified row that differs from the reference fails the run."""
    ref_vals, ref_ids = ref_vals.cpu().numpy(), ref_ids.cpu().numpy()
    checked = best_effort_ok = 0
    jaccards = []
    for b in range(len(results)):
        why = _row_mismatch(results[b], ref_vals[b], ref_ids[b], fused[b])
        if exact_rows[b]:
            if why is not None:
                raise AssertionError(f"certified row {b}: {why}")
            checked += 1
        else:
            got = {i for _v, _c, i in results[b]}
            want = set(ref_ids[b].tolist())
            jaccards.append(len(got & want) / max(1, len(got | want)))
            if why is None:
                best_effort_ok += 1
    return checked, best_effort_ok, jaccards


# -- phase 5: the kernels on the main path's own inputs -------------------------

class Capture:
    """Wraps a module-level function to keep the arguments of its first
    call for each value of ``key(args)`` (the main path's own inputs) and
    count, for each key, the launches those calls made: the rise of the
    launch count of ``kernel``, the wrapper that launches (by default the
    wrapped function itself). It then calls the function unchanged."""

    def __init__(self, module, name: str, key=lambda args: None, kernel=None):
        self.module, self.name, self.key = module, name, key
        self.real = getattr(module, name)
        self.kernel = kernel or self.real
        self.calls: dict = {}
        self.counts: dict = {}
        setattr(module, name, self)

    @property
    def args(self):
        return next(iter(self.calls.values()), None)

    def __call__(self, *args, **kwargs):
        key = self.key(args)
        self.calls.setdefault(key, (args, kwargs))
        before = self.kernel.launches
        out = self.real(*args, **kwargs)
        self.counts[key] = self.counts.get(key, 0) + self.kernel.launches - before
        return out

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)


# kernels kept beside their first designs, which they must equal bit for bit
V1_KERNELS = ("tile_stats", "super_scores", "place_windows", "super_scores_dedup",
              "place_fused", "slice_runs", "rescore")


def first_designs() -> tuple:
    """The wrappers of the kernels' first designs (``V1_KERNELS``)."""
    from hybridsearch_tpu_torch.ops import cuda_impact as ci
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs
    from hybridsearch_tpu_torch.ops import cuda_topk

    return (cuda_topk.tile_stats_v1, cs.super_scores_v1, cs.place_windows_v1,
            cs.super_scores_dedup_v1, cs.place_fused_v1, ci.slice_runs_v1, ci.rescore_v1)


def v1_call(name: str, args, kwargs):
    """(the first design's result in the kernel's own layout, a call of the
    first design's kernel alone for timing) on a call's arguments, for a
    kernel in ``V1_KERNELS``. K4's first design took the pairs sorted by
    ``dedup_pairs`` with their query rows gathered and wrote [P, sd] in
    sorted order: its caller's sort, gather and unpermute are done once
    here, outside the timed call."""
    from hybridsearch_tpu_torch.ops import cuda_impact as ci
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs
    from hybridsearch_tpu_torch.ops import cuda_topk
    from hybridsearch_tpu_torch.ops.supertile import dedup_pairs

    if name == "super_scores_dedup":
        q, docs, ids, sd = args[:4]
        ch = kwargs.get("ch", args[4] if len(args) > 4 else 1024)
        tid, qid, _rep, inv = dedup_pairs(ids)
        qp = q[qid]
        run = lambda: cs.super_scores_dedup_v1(qp, docs, tid, sd, ch)  # noqa: E731
        return run()[inv].reshape(ids.shape[0], -1), run
    v1 = {"tile_stats": cuda_topk.tile_stats_v1, "super_scores": cs.super_scores_v1,
          "place_windows": cs.place_windows_v1, "place_fused": cs.place_fused_v1,
          "slice_runs": ci.slice_runs_v1, "rescore": ci.rescore_v1}[name]
    return v1(*args, **kwargs), lambda: v1(*args, **kwargs)


KERNEL_TOL = {"tile_stats": 1e-5, "super_scores": 1e-5, "place_windows": 1e-6,
              "super_scores_dedup": 1e-5, "place_fused": 0.0,
              "slice_runs": 0.0, "rescore": 0.0, "tile_scores": 1e-5}


def kernel_fns(name: str):
    """(kernel wrapper, plain version) of a kernel of the port."""
    from hybridsearch_tpu_torch.ops import cuda_impact, cuda_supertile, cuda_topk

    return {"tile_stats": (cuda_topk.tile_stats, cuda_topk.tile_stats_plain),
            "super_scores": (cuda_supertile.super_scores,
                             cuda_supertile.super_scores_plain),
            "place_windows": (cuda_supertile.place_windows,
                              cuda_supertile.place_windows_plain),
            "super_scores_dedup": (cuda_supertile.super_scores_dedup,
                                   cuda_supertile.super_scores_dedup_plain),
            "place_fused": (cuda_supertile.place_fused,
                            cuda_supertile.place_fused_plain),
            "slice_runs": (cuda_impact.slice_runs, cuda_impact.slice_runs_plain),
            "rescore": (cuda_impact.rescore, cuda_impact.rescore_plain),
            # pass 3 of the dense top-k: K4 at tile grain
            "tile_scores": (cuda_supertile.tile_scores,
                            cuda_supertile.tile_scores_plain)}[name]


def launcher(name: str):
    """The wrapper whose count rises where ``name``'s kernel launches:
    ``tile_scores`` launches K4."""
    return kernel_fns("super_scores_dedup" if name == "tile_scores" else name)[0]


def kernel_row(name: str, args, kwargs, dev: torch.device, plain_reps: int = 3) -> dict:
    """One kernel call of the main path against its plain version: error,
    kernel, plain and library times, and the bound, all on these inputs."""
    kernel, plain = kernel_fns(name)
    fk = lambda: kernel(*args, **kwargs)  # noqa: E731
    fp = lambda: plain(*args, **kwargs)  # noqa: E731
    with _restoring_launches(launcher(name)):  # these launches are not the path's
        got, want = fk(), fp()
        sync(dev)
        err = max_err(got, want)
        del got, want
        if not err <= KERNEL_TOL[name]:
            raise AssertionError(f"{name}: error {err} > {KERNEL_TOL[name]} on "
                                 "main-path inputs")
        ms = time_ms(fk, dev, reps=10, warmup=2)
        dev_ms = device_ms(fk) if dev.type == "cuda" else None
    plain_ms = time_ms(fp, dev, reps=plain_reps)
    bound_ms, bound_by, library = _bound_and_library(name, args, kwargs)
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(library, dev, reps=5) if library else None}


def device_ms(fn, reps: int = 10):
    """Mean device time of one call: CUDA events around replays of a CUDA
    graph holding ``reps`` calls, so the wrapper's host work (done once, at
    capture) is left out. ``ms`` (events around back-to-back calls) also
    counts the device's idle gaps whenever the host work takes longer than
    the kernel. None, with the reason printed, if the calls cannot be
    captured."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        print(f"    device time not measured: graph capture failed: {exc}",
              flush=True)
        return None
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def kernel_numbers(captures: dict, launches: dict, dev: torch.device) -> list:
    out = []
    for name, cap in captures.items():
        if cap.args is None:
            raise AssertionError(f"{name} was never called on the main path")
        args, kwargs = cap.args
        row = {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
               "replaces": KERNEL_META[name][1], "launches": launches[name]}
        row.update(kernel_row(name, args, kwargs, dev))
        if name in V1_KERNELS:
            row.update(v1_fields(name, args, kwargs, dev))
        out.append(row)
    return out


def v1_fields(name: str, args, kwargs, dev: torch.device) -> dict:
    """The kernel's first design (``v1_call``) on the same inputs: whether
    the redesign equals it bit for bit (it must), and its ms and device ms.
    Off the card the first design does not run: all None."""
    if dev.type != "cuda":
        return {"bit_equal_to_v1": None, "v1_ms": None, "v1_device_ms": None}
    kernel, _plain = kernel_fns(name)
    with _restoring_launches(kernel, *first_designs()):
        got = kernel(*args, **kwargs)
        want, run = v1_call(name, args, kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        del got, want
        ms, dev_ms = _timed(run, dev)
    if not same:
        raise AssertionError(f"{name} differs from {name}_v1 on main-path inputs")
    return {"bit_equal_to_v1": same, "v1_ms": ms, "v1_device_ms": dev_ms}


def _fmt(x) -> str:
    return "n/a" if x is None else f"{x:.4f}"


def tile_stats_by_batch(caps: dict, dev: torch.device) -> list:
    """K1 at every batch size the warm-up and timed batches of each path
    (``caps``: path label -> its K1 capture) gave it, beside its first
    design."""
    from hybridsearch_tpu_torch.ops import cuda_topk

    rows = []
    for label, cap in caps.items():
        for B, (args, kwargs) in sorted(cap.calls.items()):
            row = {"path": label, "B": B, "bq": cuda_topk.query_block(B),
                   "launches": cap.counts.get(B, 0)}
            if dev.type == "cuda":
                row.update(kernel_row("tile_stats", args, kwargs, dev, plain_reps=1))
            row.update(v1_fields("tile_stats", args, kwargs, dev))
            rows.append(row)
            if dev.type != "cuda":
                print(f"    tile_stats {label} B={B}: {row['launches']} launches in "
                      "the timed batches; times not reported (cpu rehearsal)",
                      flush=True)
                continue
            print(f"    tile_stats {label} B={B} bq={row['bq']}: {_fmt(row['ms'])} ms "
                  f"(device {_fmt(row['device_ms'])}); tile_stats_v1 "
                  f"{_fmt(row['v1_ms'])} (device {_fmt(row['v1_device_ms'])}), "
                  f"bit-equal {row['bit_equal_to_v1']}; bound "
                  f"{_fmt(row['bound_ms'])} ({row['bound_by']}), plain "
                  f"{_fmt(row['plain_ms'])}, library {_fmt(row['library_ms'])} ms; "
                  f"{row['launches']} launches in the timed batches", flush=True)
    return rows


def place_windows_by_rung(cap: Capture, batch: int, dev: torch.device) -> list:
    """K3 at every rung the clustered path's batches gave it (rows B*S),
    beside its first design, with its own bound and ``index_add_`` time."""
    rows = []
    for BS, (args, kwargs) in sorted(cap.calls.items()):
        row = {"S": BS // batch, "BS": BS, "launches": cap.counts.get(BS, 0)}
        if dev.type == "cuda":
            row.update(kernel_row("place_windows", args, kwargs, dev, plain_reps=1))
        row.update(v1_fields("place_windows", args, kwargs, dev))
        rows.append(row)
        if dev.type != "cuda":
            print(f"    place_windows B*S={BS}: {row['launches']} launches in the "
                  "timed batches; times not reported (cpu rehearsal)", flush=True)
            continue
        print(f"    place_windows S={row['S']} B*S={BS}: {_fmt(row['ms'])} ms (device "
              f"{_fmt(row['device_ms'])}); place_windows_v1 {_fmt(row['v1_ms'])} "
              f"(device {_fmt(row['v1_device_ms'])}), bit-equal "
              f"{row['bit_equal_to_v1']}; bound {_fmt(row['bound_ms'])} "
              f"({row['bound_by']}), plain {_fmt(row['plain_ms'])}, library "
              f"{_fmt(row['library_ms'])} ms; {row['launches']} launches in the "
              "timed batches", flush=True)
    return rows


def super_scores_by_probe(cap: Capture, dev: torch.device) -> list:
    """K2 at every probe count S the warm-up batch's rungs gave it, beside
    its first design (bit-equal), with the goal of at least half its bound
    (device ms at most twice the bound) marked met or missed."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    rows = []
    for S, (args, kwargs) in sorted(cap.calls.items()):
        B = int(args[0].shape[0])
        row = {"S": S, "B": B, "launches": cap.counts.get(S, 0),
               "pair_width": cs.pair_width(B * S, cs.n_units(
                   args[1].shape[0], args[3], kwargs.get("ch", 1024)))}
        row.update(kernel_row("super_scores", args, kwargs, dev, plain_reps=1))
        row.update(v1_fields("super_scores", args, kwargs, dev))
        row["goal_half_of_bound_met"] = row["device_ms"] <= 2 * row["bound_ms"]
        rows.append(row)
        print(f"    super_scores S={S} B={B} pw={row['pair_width']}: {row['ms']:.4f} ms "
              f"(device {row['device_ms']:.4f}); super_scores_v1 {_fmt(row['v1_ms'])} "
              f"(device {_fmt(row['v1_device_ms'])}), bit-equal "
              f"{row['bit_equal_to_v1']}; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}): {100 * row['bound_ms'] / row['device_ms']:.1f}% of "
              f"it, goal 50% {'met' if row['goal_half_of_bound_met'] else 'missed'}; "
              f"plain {row['plain_ms']:.3f} ms, library {_fmt(row['library_ms'])} ms, "
              f"err {row['max_abs_err']:.3g}", flush=True)
    return rows


@contextlib.contextmanager
def _restoring_launches(*kernels):
    """Run comparison calls without counting them as the path's launches."""
    before = [k.launches for k in kernels]
    try:
        yield
    finally:
        for k, n in zip(kernels, before):
            k.launches = n


def _timed(fn, dev) -> tuple:
    """(ms, device ms) of one call: events around back-to-back calls, and
    CUDA graph replays (None off the card)."""
    return time_ms(fn, dev, reps=10, warmup=2), (device_ms(fn) if dev.type == "cuda"
                                                  else None)


def goal_fields(row: dict) -> dict:
    """A kernel row's goals and host time: at least half its bound (device
    ms at most twice the bound), no slower than its first design where it
    has one (device ms), and the route's host ms (events around
    back-to-back calls less device ms: the wrapper's work a call, when it
    outlasts the kernel). None off the card."""
    if row.get("device_ms") is None:
        return {"goal_half_of_bound_met": None, "host_ms": None}
    out = {"goal_half_of_bound_met": row["device_ms"] <= 2 * row["bound_ms"],
           "host_ms": row["ms"] - row["device_ms"]}
    if row.get("v1_device_ms") is not None:
        out["goal_no_slower_than_v1_met"] = row["device_ms"] <= row["v1_device_ms"]
    return out


def _goals_text(row: dict) -> str:
    met = {True: "met", False: "missed", None: "n/a"}
    text = (f"{100 * row['bound_ms'] / row['device_ms']:.1f}% of bound, goal 50% "
            f"{met[row['goal_half_of_bound_met']]}; host {_fmt(row['host_ms'])} ms")
    if "goal_no_slower_than_v1_met" in row:
        text += f"; no slower than v1 {met[row['goal_no_slower_than_v1_met']]}"
    return text


def levers_by_probe(caps: dict, dev: torch.device, show: bool = True) -> tuple:
    """K4 and K5 at every rung of the levers run's warm-up batch, on the
    path's own inputs (``caps``: its captures of K4 and K5, one call of
    each a rung), beside the default route's kernels on the same work. K4's
    wrapper (its whole route: pair sort, group table, kernel) beside its
    first design (bit-equal, unpermuted) and K2 on the rung's probe table
    (bit-equal), and its kernel alone on pairs sorted outside the timed
    call, with the goals (route no slower than K2, kernel within 5% of K2)
    marked met or missed. K5 beside its first design (bit-equal) and the
    window gather + K3 on the same window bounds (bit-equal), with the
    gather alone and K3 alone, its goals (``goal_fields``) marked."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    k4cap, k5cap = caps["super_scores_dedup"], caps["place_fused"]
    if not len(k4cap.calls) == len(k5cap.calls):
        raise AssertionError("the levers run's rungs did not each run K4 and K5")
    rows4, rows5 = [], []
    probes = {}
    for i, (args, kwargs) in sorted(k4cap.calls.items()):
        q3, docs, sup_s, sd = args[:4]
        B, S = (int(x) for x in sup_s.shape)
        ch = kwargs.get("ch", 1024)
        probes[i] = S
        row = {"S": S, "B": B, "pair_width": cs.pair_width(B * S, cs.n_units(
            docs.shape[0], sd, ch))}
        row.update(kernel_row("super_scores_dedup", args, kwargs, dev, plain_reps=1))
        row.update(v1_fields("super_scores_dedup", args, kwargs, dev))
        with _restoring_launches(cs.super_scores, cs.super_scores_dedup):
            k2 = lambda: cs.super_scores(q3, docs, sup_s, sd, **kwargs)  # noqa: E731
            row["bit_equal_to_k2"] = torch.equal(cs.super_scores_dedup(*args, **kwargs),
                                                 k2())
            row["k2_ms"], row["k2_device_ms"] = _timed(k2, dev)
            if dev.type == "cuda":
                # the kernel alone: the pairs sorted once, outside the timed call
                pairs = cs.sort_pairs(sup_s, S)
                qf = q3.float().contiguous()
                out = torch.empty((B, S * sd), device=docs.device)
                row["kernel_ms"], row["kernel_device_ms"] = _timed(
                    lambda: cs._launch_sorted_pairs(qf, docs, *pairs, sd, ch, out), dev)
                del out
        if not row["bit_equal_to_k2"]:
            raise AssertionError(f"super_scores_dedup differs from super_scores at S={S}")
        if dev.type == "cuda":
            row["goal_route_no_slower_met"] = row["device_ms"] <= row["k2_device_ms"]
            row["goal_kernel_within_5pct_met"] = (row["kernel_device_ms"]
                                                  <= 1.05 * row["k2_device_ms"])
        rows4.append(row)
    for i, (args, kwargs) in sorted(k5cap.calls.items()):
        S = probes[i]
        lo, hi, base, ids_rows, ws_rows, wcaps = args[:6]
        st_ = args[6] if len(args) > 6 else kwargs.get("super_tiles", 128)
        row = {"S": S, "BS": int(lo.shape[0]), "wcaps": list(wcaps),
               "launches": k5cap.counts.get(i, 0)}
        row.update(kernel_row("place_fused", args, kwargs, dev, plain_reps=1))
        row.update(v1_fields("place_fused", args, kwargs, dev))
        row.update(goal_fields(row))
        with _restoring_launches(cs.place_fused, cs.place_windows):
            gather = lambda: cs.window_entries(lo, hi, base, ids_rows, ws_rows, wcaps)  # noqa: E731
            l_w, w_w = gather()
            k3 = lambda: cs.place_windows(l_w, w_w, st_)  # noqa: E731
            two = lambda: cs.place_windows(*gather(), st_)  # noqa: E731
            row["bit_equal_to_two_step"] = torch.equal(cs.place_fused(*args, **kwargs), two())
            row["two_step_ms"], row["two_step_device_ms"] = _timed(two, dev)
            row["gather_ms"], row["gather_device_ms"] = _timed(gather, dev)
            row["k3_ms"], row["k3_device_ms"] = _timed(k3, dev)
            del l_w, w_w
        if not row["bit_equal_to_two_step"]:
            raise AssertionError(f"place_fused differs from the two-step path at S={S}")
        rows5.append(row)
    if show:
        met = {True: "met", False: "missed"}
        for r in rows4:
            print(f"    super_scores_dedup S={r['S']} B={r['B']} pw={r['pair_width']}: "
                  f"route (sort, table, kernel) {_fmt(r['ms'])} ms (device "
                  f"{_fmt(r['device_ms'])}), kernel alone {_fmt(r['kernel_ms'])} (device "
                  f"{_fmt(r['kernel_device_ms'])}); super_scores_dedup_v1 "
                  f"{_fmt(r['v1_ms'])} (device {_fmt(r['v1_device_ms'])}), bit-equal "
                  f"{r['bit_equal_to_v1']}; super_scores {_fmt(r['k2_ms'])} (device "
                  f"{_fmt(r['k2_device_ms'])}), bit-equal to super_scores True; goals: "
                  f"route no slower than super_scores "
                  f"{met[r['goal_route_no_slower_met']]}, kernel within 5% "
                  f"{met[r['goal_kernel_within_5pct_met']]}; bound {_fmt(r['bound_ms'])} "
                  f"({r['bound_by']}), plain {_fmt(r['plain_ms'])}, library "
                  f"{_fmt(r['library_ms'])} ms", flush=True)
        for r in rows5:
            print(f"    place_fused S={r['S']} B*S={r['BS']} wcaps={r['wcaps']}: "
                  f"{_fmt(r['ms'])} ms (device {_fmt(r['device_ms'])}); place_fused_v1 "
                  f"{_fmt(r['v1_ms'])} (device {_fmt(r['v1_device_ms'])}), bit-equal "
                  f"{r['bit_equal_to_v1']}; {_goals_text(r)}; window gather + "
                  f"place_windows {_fmt(r['two_step_ms'])} (device "
                  f"{_fmt(r['two_step_device_ms'])}), gather {_fmt(r['gather_ms'])} (device "
                  f"{_fmt(r['gather_device_ms'])}), place_windows {_fmt(r['k3_ms'])} (device "
                  f"{_fmt(r['k3_device_ms'])}); bound {_fmt(r['bound_ms'])} "
                  f"({r['bound_by']}), plain {_fmt(r['plain_ms'])}, library "
                  f"{_fmt(r['library_ms'])} ms; bit-equal to the two-step path", flush=True)
    return rows4, rows5


def tile_scores_by_rung(cap: Capture, dev: torch.device, show: bool = True) -> list:
    """Pass 3 of the dense top-k, K4 at tile grain (``tile_scores``), at
    every rung of the source path (kd tiles a query), on the path's own
    inputs: against its plain version, which is the gather + ``einsum``
    composition pass 3 ran before the kernel (``composition_ms``), with its
    bound and, as the library time, one cuBLAS product over the whole
    corpus and a gather of the tiles' columns (K2's and K4's yardstick);
    launches are K4's launches from the rung's calls in the timed
    batches."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    rows = []
    for KT, (args, kwargs) in sorted(cap.calls.items()):
        q, docs, tiles = args[:3]
        B = int(q.shape[0])
        row = {"tiles_per_query": KT, "B": B, "launches": cap.counts.get(KT, 0),
               "pair_width": cs.pair_width(B * KT, docs.shape[0] // 128)}
        row.update(kernel_row("tile_scores", args, kwargs, dev, plain_reps=1))
        row["composition_ms"] = row["plain_ms"]
        rows.append(row)
        if dev.type == "cuda" and not row["launches"]:
            raise AssertionError(f"pass 3 at kd={KT} never launched K4 in the timed "
                                 "batches")
        if show:
            print(f"    tile_scores (pass 3, K4 at tile grain) kd={KT} B={B} "
                  f"pw={row['pair_width']}: {_fmt(row['ms'])} ms (device "
                  f"{_fmt(row['device_ms'])}), bound {_fmt(row['bound_ms'])} "
                  f"({row['bound_by']}), plain (gather + einsum) {_fmt(row['plain_ms'])}"
                  f", library (matmul + gather) {_fmt(row['library_ms'])} ms, "
                  f"{row['launches']} launches in the timed batches, err "
                  f"{row['max_abs_err']:.3g}", flush=True)
    return rows


def impact_by_rung(captures: dict, dev: torch.device, show: bool = True) -> list:
    """K6 and K7 at every shape the batches gave them (K6 by slice depth p,
    K7 by (C, p): one rescore of the candidate union a rung, one of the
    margin cushion), with the calls of that shape in the timed batches;
    each beside its first design (bit-equal) with its goals
    (``goal_fields``) marked."""
    rows = []
    for name in ("slice_runs", "rescore"):
        cap = captures[name]
        for key, (args, kwargs) in sorted(cap.calls.items()):
            row = {"name": name, "key": key, "B": int(args[0].shape[0]) if
                   name == "rescore" else int(args[2].shape[0]),
                   "launches": cap.counts.get(key, 0)}
            row.update(kernel_row(name, args, kwargs, dev, plain_reps=1))
            row.update(v1_fields(name, args, kwargs, dev))
            row.update(goal_fields(row))
            rows.append(row)
            if not show:
                continue
            v1 = (f"; {name}_v1 {_fmt(row['v1_ms'])} ms (device "
                  f"{_fmt(row['v1_device_ms'])}), bit-equal {row['bit_equal_to_v1']}")
            print(f"    {name} {'p' if name == 'slice_runs' else '(C, p)'}={key} "
                  f"B={row['B']}: {row['ms']:.4f} ms (device {row['device_ms']:.4f}"
                  f" ms){v1}; bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"{_goals_text(row)}; plain {row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']} ms, {row['launches']} launches in the timed "
                  f"batches, err {row['max_abs_err']:.3g}", flush=True)
    return rows


def sortmerge_rescore_torch(cand, ids_flat, ws_flat):
    """The JAX package's sort-merge rescore (ops/impact.py _sortmerge_core)
    composed of PyTorch calls: one key sort with postings before candidates
    of equal id, a segmented prefix sum, a scatter back to candidate order.
    K7's library yardstick only; the port never calls it."""
    B, C = cand.shape
    W = ids_flat.shape[1]
    dev = cand.device
    key = torch.cat([ids_flat.long() * 2, cand.long() * 2 + 1], dim=1)
    w_cat = torch.cat([ws_flat, ws_flat.new_zeros((B, C))], dim=1)
    pos = torch.cat([torch.full((B, W), C, device=dev),
                     torch.arange(C, device=dev).expand(B, C)], dim=1)
    key_s, order = torch.sort(key, dim=1, stable=True)
    w_s = torch.gather(w_cat, 1, order)
    pos_s = torch.gather(pos, 1, order)
    id_s = key_s >> 1
    new_run = torch.ones_like(id_s, dtype=torch.bool)
    new_run[:, 1:] = id_s[:, 1:] != id_s[:, :-1]
    cs = torch.cumsum(w_s, dim=1)
    idx = torch.arange(W + C, device=dev).expand(B, W + C)
    start = torch.cummax(torch.where(new_run, idx, 0), dim=1).values
    base = torch.where(start > 0, torch.gather(cs, 1, (start - 1).clamp_min(0)), 0.0)
    out = torch.zeros((B, C + 1), device=dev).scatter_(1, pos_s, cs - base)
    return out[:, :C]


def _bound_and_library(name, args, kwargs):
    """(least time the card could take for this call's work in ms, what
    bounds it, a PyTorch yardstick computing the same function or None)."""
    if name == "tile_stats":
        q, docs, bias = args[0], args[1], args[2]
        with_min = kwargs.get("with_min", args[4] if len(args) > 4 else False)
        B, D = q.shape
        N = docs.shape[0]
        nbytes = (N * D * docs.element_size() + B * D * q.element_size()
                  + (N * 4 if bias is not None else 0)
                  + (2 if with_min else 1) * (N // 128) * B * 4)
        flops = 2.0 * N * D * B

        def library():
            s = torch.matmul(docs, q.T).view(N // 128, 128, B)
            s.amax(dim=1), s.amin(dim=1)
    elif name in ("super_scores", "super_scores_dedup"):
        # K4 computes K2's function on the same probe table
        from hybridsearch_tpu_torch.ops.cuda_supertile import _chunk_rows

        q, docs, sup, sd = args[0], args[1], args[2], args[3]
        ch = kwargs.get("ch", args[4] if len(args) > 4 else 1024)
        B, D = q.shape
        S = sup.shape[1]
        rows = _chunk_rows(sup, docs.shape[0], sd, ch)  # [B, S*sd] rows read
        unique_rows = int(torch.unique(rows).numel())
        nbytes = (unique_rows * D * docs.element_size() + B * D * q.element_size()
                  + sup.numel() * 4 + B * S * sd * 4)
        flops = 2.0 * B * S * sd * D

        def library():
            # the whole corpus by cuBLAS float32, then the probed columns
            torch.gather(torch.matmul(q, docs.T), 1, rows)
    elif name == "tile_scores":
        q, docs, tiles = args[:3]
        tile = args[3] if len(args) > 3 else kwargs.get("tile", 128)
        B, D = q.shape
        KT = tiles.shape[1]
        n_read = int(torch.unique(tiles).numel())
        # each distinct tile read once, the queries, the tile ids, the output
        nbytes = (n_read * tile * D * docs.element_size() + q.numel() * q.element_size()
                  + tiles.numel() * tiles.element_size() + B * KT * tile * 4)
        flops = 2.0 * B * KT * tile * D

        rows = (tiles.long()[:, :, None] * tile
                + torch.arange(tile, device=docs.device)).reshape(B, KT * tile)

        def library():
            # the whole corpus by cuBLAS float32, then the tiles' columns
            torch.gather(torch.matmul(q, docs.T), 1, rows)
    elif name == "place_fused":
        from hybridsearch_tpu_torch.ops.cuda_supertile import window_entries

        lo, hi, base, ids_rows, ws_rows, wcaps = args[:6]
        st = args[6] if len(args) > 6 else kwargs.get("super_tiles", 128)
        R = st * 128
        BS, T = lo.shape
        caps = torch.tensor([wc // 128 + 1 for wc in wcaps], device=lo.device)
        end = torch.minimum(hi.long(), (lo.long() // 128 + caps) * 128)
        n_read = int((end - lo.long()).clamp_min(0).sum())
        # the window entries read (id and weight), the bounds, the output
        nbytes = (n_read * 8 + BS * T * (lo.element_size() + hi.element_size())
                  + BS * base.element_size() + BS * R * 4)
        flops = float(n_read)
        buf = torch.zeros(BS * R + 1, device=lo.device)
        rowoff = torch.arange(BS, device=lo.device)[:, None] * R

        def library():
            l, w = window_entries(lo, hi, base, ids_rows, ws_rows, wcaps)
            ok = (l >= 0) & (l < R)
            buf.zero_().index_add_(0, torch.where(ok, l.long() + rowoff, BS * R).reshape(-1),
                                   w.reshape(-1))
    elif name == "place_windows":
        l, w = args[0], args[1]
        st = args[2] if len(args) > 2 else kwargs.get("super_tiles", 128)
        R = st * 128
        BS, TE = l.shape
        ok = (l >= 0) & (l < R) & (w != 0)
        # every weight, the id of every nonzero weight (a zero weight's
        # entry adds nothing, so its id is not needed), the output
        nbytes = BS * TE * 4 + int((w != 0).sum()) * 4 + BS * R * 4
        flops = float(ok.sum())
        flat = (l.long() + torch.arange(BS, device=l.device)[:, None] * R)[ok]
        wf = w[ok]
        buf = torch.zeros(BS * R, device=l.device)

        def library():
            buf.zero_().index_add_(0, flat, wf)
    elif name == "slice_runs":
        doc_ids, weights, starts, lengths, p, n_docs = args
        rows = starts.numel()
        # the entries these slices read (the rest of each row is the mask's
        # constants), the starts and lengths, and both outputs
        nbytes = (int(lengths.long().clamp(0, p).sum()) * 8 + rows * 8
                  + rows * p * 8)
        flops = 0.0
        st_l = starts.reshape(-1).long()[:, None]
        ln_l = lengths.reshape(-1).long()[:, None]
        iota = torch.arange(p, device=doc_ids.device)

        def library():
            pos = st_l + iota
            valid = iota < ln_l
            torch.where(valid, doc_ids[pos], n_docs), torch.where(valid, weights[pos], 0.0)
    else:  # rescore
        cand, ids_flat, ws_flat, p, n_docs = args
        B, C = cand.shape
        W = ids_flat.shape[1]
        nbytes = B * C * cand.element_size() + B * W * 8 + B * C * 4
        # one add a posting entry that hits a candidate: at most B * W
        flops = float(B * W)

        def library():
            sortmerge_rescore_torch(cand, ids_flat, ws_flat)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), library


def profile_batch(searcher, queries) -> str:
    """One more batch under torch.profiler: the summed time of the device's
    kernels and copies against the batch's wall time (taken inside the
    profiled region, so profiler start-up is not counted), and the kernels
    that took the most device time. ``trace_span`` ranges also show up on
    the device timeline; they overlap the kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        searcher.search_batch(queries, top_k=TOP_K, log=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per_name: dict = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            n, us = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not per_name:
        return f"wall {wall_ms:.2f} ms; device time not measured (no device events)"
    busy_ms = sum(us for _n, us in per_name.values()) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]
    top_s = "; ".join(f"{name[:40]} {us / 1e3:.3f} ms x{n}" for name, (n, us) in top)
    return (f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%), {sum(n for n, _u in per_name.values())} "
            f"device ops; top: {top_s}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


# -- the P1 check: the clustered build repeats bit for bit ----------------------

class BuildRecorder:
    """Keeps the clustered build's k-means input and centroids and its
    permutation (index/builder.py calls both through module globals)."""

    def __init__(self):
        from hybridsearch_tpu_torch.index import builder

        self.builder = builder
        self.real_fit, self.real_perm = builder.kmeans_fit, builder._cluster_permutation
        self.fit = self.perm = None
        builder.kmeans_fit, builder._cluster_permutation = self._fit, self._perm

    def _fit(self, vectors, k, seed=0):
        cent = self.real_fit(vectors, k, seed=seed)
        self.fit = (vectors, k, seed, cent)
        return cent

    def _perm(self, vectors, *a, **kw):
        self.perm = self.real_perm(vectors, *a, **kw)
        return self.perm

    def restore(self) -> None:
        self.builder.kmeans_fit = self.real_fit
        self.builder._cluster_permutation = self.real_perm


def check_p1(rec: BuildRecorder) -> str:
    """Re-run k-means on the build's own embeddings: the centroids must be
    equal bit for bit and the permutation equal."""
    from hybridsearch_tpu_torch.index.ivf import kmeans_assign, kmeans_fit

    if rec.fit is None or rec.perm is None:
        raise AssertionError("the clustered build ran no k-means")
    vectors, k, seed, cent = rec.fit
    t = time.perf_counter()
    again = kmeans_fit(vectors, k, seed=seed)
    perm = np.argsort(kmeans_assign(vectors, again).cpu().numpy(), kind="stable")
    secs = time.perf_counter() - t
    if not torch.equal(cent, again):
        diff = int((cent != again).any(dim=1).sum())
        raise AssertionError(f"k-means re-run differs in {diff} of {k} centroids")
    if not np.array_equal(perm, rec.perm):
        raise AssertionError("k-means re-run gives another permutation")
    return (f"{k} centroids equal bit for bit, permutation of {len(perm)} docs "
            f"equal ({secs:.1f} s)")


def p1_stages(sz: dict, dev: torch.device, seed: int, clock: Clock) -> dict:
    """Where the clustered build stops repeating: build the small-topic index
    twice from one seed and compare each stage (embeddings, k-means
    centroids, permutation, dense snapshot, BM25 CSR, super postings), serve
    one batch twice on the first build and once on the second, and re-run
    k-means twice on the same embeddings with the centroid update summed by
    float atomics (``index_add_``, the update before the fix)."""
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.index import ivf
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    docs, make_queries = make_corpus(sz, "small-topic", seed)
    queries = make_queries(sz["batch"])
    clock.phase("corpus", f"small-topic: {len(docs)} docs")
    builds = []
    for run in ("A", "B"):
        rec = BuildRecorder()
        try:
            cfg = EngineConfig()
            cfg.index.layout = "clustered"
            cfg.index.dim = sz["dim"]
            searcher = Searcher(config=cfg, use_query_memory=False, device=dev)
            searcher.indexer.index_documents(docs)
        finally:
            rec.restore()
        bm = searcher.indexer.bm25
        sp = bm.super_postings()
        po = bm._state.postings
        vectors, k, _seed, cent = rec.fit
        stages = {"embeddings": vectors, "centroids": cent,
                  "permutation": torch.from_numpy(np.asarray(rec.perm)),
                  "dense snapshot": searcher.indexer.dense._snap.docs,
                  "bm25 csr": torch.cat([po.doc_ids.float(), po.weights]),
                  "super postings": torch.cat([sp.sup_max.reshape(-1),
                                               sp.ids_rows.reshape(-1).float(),
                                               sp.ws_rows.reshape(-1)])}
        builds.append((searcher, stages))
        clock.phase("build", f"run {run}")
    out = {"stages": {name: bool(torch.equal(a, builds[1][1][name]))
                      for name, a in builds[0][1].items()}}
    out["first_differing_stage"] = next(
        (name for name, same in out["stages"].items() if not same), None)

    def serve(searcher):
        return [(v, i) for row in searcher.search_batch(queries, top_k=TOP_K,
                                                        log=False)
                for v, _c, i in row]

    a1, a2, b1 = serve(builds[0][0]), serve(builds[0][0]), serve(builds[1][0])
    out["same_batch_twice_on_one_build"] = a1 == a2
    out["same_batch_on_both_builds"] = a1 == b1
    clock.phase("serve", json.dumps(out))

    vectors, k = builds[0][1]["embeddings"], int(builds[0][1]["centroids"].shape[0])
    del builds
    real = ivf._cluster_sums
    ivf._cluster_sums = lambda vb, assign, counts: torch.zeros(
        (counts.shape[0], vb.shape[1]), device=vb.device).index_add_(0, assign, vb)
    try:
        fits = [ivf.kmeans_fit(vectors, k, seed=seed) for _ in range(2)]
    finally:
        ivf._cluster_sums = real
    perms = [np.argsort(ivf.kmeans_assign(vectors, c).cpu().numpy(), kind="stable")
             for c in fits]
    out["atomic_update"] = {
        "centroids_equal": bool(torch.equal(*fits)),
        "centroids_differing": int((fits[0] != fits[1]).any(dim=1).sum()),
        "permutation_equal": bool(np.array_equal(*perms)),
        "docs_placed_differently": int((perms[0] != perms[1]).sum())}
    clock.phase("atomic k-means update", json.dumps(out["atomic_update"]))
    return out


# -- main ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at tiny sizes")
    ap.add_argument("--p1-stages", action="store_true",
                    help="only compare two clustered builds stage by stage "
                         "(where the build stops repeating) and exit")
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    clock = Clock(BUDGET_S if not rehearsal else 1e9)

    # -- 1. device
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import hybridsearch_tpu_torch  # noqa: F401  (pins full float32 matmuls)
    from hybridsearch_tpu_torch.ops import cuda_build
    from hybridsearch_tpu_torch.ops import dense as dense_mod
    from hybridsearch_tpu_torch.ops import supertile as supertile_mod
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    sz = SIZES["cpu" if rehearsal else "card"]
    if rehearsal:
        dev = torch.device("cpu")
        kind, count, smi = "cpu", 0, "nvidia-smi: not run (cpu rehearsal)"
        # take the kernel routes, with the plain versions behind the wrappers
        dense_mod._on_card = supertile_mod._on_card = lambda t: True
        searcher_mod.SPARSE_HYBRID_MIN_DOCS = 0
    else:
        dev = torch.device("cuda")
        kind, count, smi = (torch.cuda.get_device_name(0),
                            torch.cuda.device_count(), nvidia_smi_line())
    clock.phase("device", f"{kind} x{count}; {smi}; torch {torch.__version__}")

    # -- 2. build
    if not rehearsal:
        cuda_build.library()
        info = cuda_build.last_build
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line:
                print("    " + line.strip(), flush=True)
        clock.phase("build", f"nvcc {info['seconds']:.1f} s "
                    f"({'cached' if info['cached'] else 'fresh'}) -> {info['path']}")
    else:
        clock.phase("build", "skipped (cpu rehearsal: plain versions)")

    if args.p1_stages:
        print(json.dumps({"p1_stages": p1_stages(sz, dev, args.seed, clock)}),
              flush=True)
        return 0

    # -- 3. kernels
    check_kernels(sz, dev, args.seed)
    check_gated_kernels(sz, dev, args.seed)
    check_impact_kernels(sz, dev, args.seed,
                         IMPACT_SHAPES["cpu" if rehearsal else "card"])
    clock.phase("kernels", "K1-K7 match their plain versions at the slice's "
                "shapes; K4 equals K2 and K5 equals window gather + K3 bit for bit"
                + ("" if rehearsal else "; K1-K7 equal their first designs"))

    # -- 4. end to end: the clustered path on the small-topic corpus, then
    # -- 5. its kernels on their own inputs; the same index again with the two
    # -- perf levers (K4, K5) and their kernels; the P1 check; then the
    # -- default (source) layout's path on the same corpus and its kernels;
    # -- regime 1 (below the at-scale threshold); last the large-topic corpus
    # -- on the clustered path
    detail = {"device": smi, "corpora": {}}
    rec = BuildRecorder()
    try:
        run = serve_corpus("small-topic", "clustered", sz, dev, args.seed, clock,
                           kind, smi, main_path=True)
    finally:
        rec.restore()
    detail["corpora"]["small-topic"] = run["stats"]
    numbers = kernel_numbers(run["captures"], run["launches"], dev)
    k1_rows = tile_stats_by_batch({"small-topic": run["captures"]["tile_stats"]}, dev)
    k3_rows = place_windows_by_rung(run["captures"]["place_windows"], sz["batch"], dev)
    if rehearsal:
        clock.phase("kernel timing", f"{len(numbers)} wrappers checked on "
                    "main-path inputs; times not reported (cpu rehearsal)")
    else:
        detail["super_scores_by_probe"] = super_scores_by_probe(
            run["captures"]["super_scores"], dev)
        clock.phase("kernel timing", "main-path inputs")

    lev = serve_levers(run, sz, dev, clock, kind, smi)
    detail["corpora"]["small-topic/levers"] = lev["stats"]
    caps = {name: lev["captures"][name] for name in ("super_scores_dedup", "place_fused")}
    numbers += kernel_numbers(caps, lev["launches"], dev)
    rows4, rows5 = levers_by_probe(lev["captures"], dev, show=not rehearsal)
    if rehearsal:
        clock.phase("levers kernel timing", f"{len(rows4)} + {len(rows5)} rungs "
                    "checked on main-path inputs; times not reported (cpu rehearsal)")
    else:
        detail["levers_by_probe"] = {"super_scores_dedup": rows4, "place_fused": rows5}
        clock.phase("levers kernel timing", "small-topic/levers main-path inputs")
    del run, lev, caps
    clock.phase("P1 check", "small-topic: " + check_p1(rec))
    del rec

    run = serve_corpus("small-topic", "source", sz, dev, args.seed, clock, kind,
                       smi, main_path=True)
    detail["corpora"]["small-topic/source"] = run["stats"]
    caps = {name: run["captures"][name] for name in ("slice_runs", "rescore")}
    numbers += kernel_numbers(caps, run["launches"], dev)
    k1_rows += tile_stats_by_batch({"small-topic/source": run["captures"]["tile_stats"]},
                                   dev)
    by_rung = impact_by_rung(caps, dev, show=not rehearsal)
    pass3 = tile_scores_by_rung(run["captures"]["tile_scores"], dev, show=not rehearsal)
    k4_row = next(r for r in numbers if r["name"] == "super_scores_dedup")
    k4_row["tile_grain"] = pass3  # pass 3 of the source path's dense top-k
    k4_row["tile_grain_launches"] = run["launches"]["super_scores_dedup"]
    if rehearsal:
        clock.phase("impact kernel timing", f"{len(by_rung)} shapes and pass 3 at "
                    f"{len(pass3)} rungs checked on main-path inputs; times not "
                    "reported (cpu rehearsal)")
    else:
        detail["impact_by_rung"] = by_rung
        detail["pass3_by_rung"] = pass3
        clock.phase("impact kernel timing", "small-topic/source main-path inputs, "
                    f"pass 3 at kd = {[r['tiles_per_query'] for r in pass3]}")
    del run, caps

    detail["tile_stats_by_batch"] = k1_rows
    detail["place_windows_by_rung"] = k3_rows
    clock.phase("redesigned kernels", (
        f"tile_stats at B = {sorted({r['B'] for r in k1_rows})} and place_windows at "
        f"B*S = {[r['BS'] for r in k3_rows]} on main-path inputs" +
        ("; times not reported (cpu rehearsal)" if rehearsal else
         ", each bit-equal to its first design")))

    detail["regime_1"] = serve_regime_one(sz, dev, args.seed + 2, clock, kind, smi)

    detail["corpora"]["large-topic"] = serve_corpus(
        "large-topic", "clustered", sz, dev, args.seed + 1, clock, kind, smi,
        main_path=False)["stats"]
    order = list(KERNEL_META)
    numbers.sort(key=lambda row: order.index(row["name"]))

    if rehearsal:
        # plain versions on the host: no device numbers to report
        print(json.dumps({"ok": True, "rehearsal": "cpu"}), flush=True)
        return 0
    detail["kernels"] = numbers
    detail["nvcc_log"] = cuda_build.last_build["log"]
    os.makedirs(os.path.dirname(DETAIL_PATH), exist_ok=True)
    with open(DETAIL_PATH, "w") as f:
        json.dump(detail, f, indent=1)
    clock.phase("done", f"details in {DETAIL_PATH}")
    print(smi, flush=True)
    print(json.dumps({"kernels": numbers}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def _path_captures(layout: str) -> dict:
    """Capture wrappers over the kernels of a path, keyed by the shape that
    varies between its rungs (K1 by batch size, K3 by rows B*S)."""
    from hybridsearch_tpu_torch.ops import dense as dense_mod
    from hybridsearch_tpu_torch.ops import impact as impact_mod
    from hybridsearch_tpu_torch.ops import supertile as supertile_mod

    by_batch = lambda a: int(a[0].shape[0])  # noqa: E731  (K1: B; K3: B*S)
    if layout == "clustered":
        return {"tile_stats": Capture(dense_mod, "tile_stats", key=by_batch),
                "super_scores": Capture(supertile_mod, "super_scores",
                                        key=lambda a: int(a[2].shape[1])),
                "place_windows": Capture(supertile_mod, "place_windows",
                                         key=by_batch)}
    if layout == "clustered/levers":
        # keyed by the call's rung in the warm-up batch (each rung launches
        # each kernel once; pair and row counts repeat across rungs)
        rung4, rung5 = itertools.count(), itertools.count()
        return {"tile_stats": Capture(dense_mod, "tile_stats"),
                "super_scores_dedup": Capture(supertile_mod, "super_scores_dedup",
                                              key=lambda a: next(rung4)),
                "place_fused": Capture(supertile_mod, "place_fused",
                                       key=lambda a: next(rung5))}
    return {"tile_stats": Capture(dense_mod, "tile_stats", key=by_batch),
            "slice_runs": Capture(impact_mod, "slice_runs", key=lambda a: int(a[4])),
            "rescore": Capture(impact_mod, "rescore",
                               key=lambda a: (int(a[0].shape[1]), int(a[3]))),
            # pass 3 of the dense top-k by tiles a query, counting the
            # launches of K4 (at tile grain) its calls make
            "tile_scores": Capture(dense_mod, "tile_scores",
                                   key=lambda a: int(a[2].shape[1]),
                                   kernel=kernel_fns("super_scores_dedup")[0])}


def index_corpus(corpus: str, layout: str, sz: dict, dev: torch.device, seed: int,
                 clock: Clock, label: str, at_scale: bool = True):
    """Index one corpus under ``layout`` through ``Indexer.index_documents``
    and, ``at_scale``, build its ladder's lexical structures. Returns
    (searcher, make_queries, index timings)."""
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    docs, make_queries = make_corpus(sz, corpus, seed)
    clock.phase("corpus", f"{label}: {len(docs)} docs, "
                f"{sum(len(d) for d in docs)} chars")
    cfg = EngineConfig()
    cfg.index.layout = layout
    cfg.index.dim = sz["dim"]
    searcher = Searcher(config=cfg, use_query_memory=False, device=dev)
    built = searcher.indexer.index_documents(docs)
    del docs
    stages = ", ".join(f"{k} {v:.1f}" for k, v in built["timings_s"].items())
    clock.phase("index_documents", f"{label}: {stages}")
    t = time.perf_counter()
    bm25 = searcher.indexer.bm25
    if not at_scale:
        pass  # regime 1 scores BM25 from the CSR itself
    elif layout == "clustered":
        sp = bm25.super_postings()
        sync(dev)
        clock.phase("super_postings", f"{label}: {time.perf_counter() - t:.1f} s, "
                    f"{sp.n_super} supertiles, {sp.ids_rows.shape[0] * 128} CSR slots")
    else:
        imp = bm25.impact_postings()
        sync(dev)
        n_trunc = int((imp.df_host > imp.p_max).sum())
        clock.phase("impact tier", f"{label}: {time.perf_counter() - t:.1f} s, "
                    f"{len(imp.weights_host)} pruned postings (p_max "
                    f"{imp.p_max}; {n_trunc} of {len(imp.df_host)} terms "
                    "truncated)")
    return searcher, make_queries, built["timings_s"]


def serve_corpus(corpus: str, layout: str, sz: dict, dev: torch.device, seed: int,
                 clock: Clock, kind: str, smi: str, main_path: bool) -> dict:
    """Index one corpus (``index_corpus``) and serve it (``serve_batches``):
    one warm-up and ``n_batches`` timed batches. Returns serve_batches'
    dict plus "searcher", "warm" and "batches"."""
    label = corpus if layout == "clustered" else f"{corpus}/{layout}"
    searcher, make_queries, timings = index_corpus(corpus, layout, sz, dev, seed,
                                                   clock, label)
    warm = make_queries(sz["batch"])
    batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]
    run = serve_batches(searcher, label, layout, warm, batches, sz, dev, clock,
                        kind, smi, main_path)
    run["stats"]["index_timings_s"] = timings
    run.update(searcher=searcher, warm=warm, batches=batches)
    return run


def serve_batches(searcher, label: str, path: str, warm, batches, sz: dict,
                  dev: torch.device, clock: Clock, kind: str, smi: str,
                  main_path: bool) -> dict:
    """Serve ``warm`` and then the timed ``batches`` through ``search_batch``
    on the route ``path`` (``PATHS``), and hold every certified row against
    the plain exact reference. The path's kernels' counts are set to 0 just
    before the timed batches and read just after; on a main path, the
    kernel calls of the warm-up and the timed batches (the levers route:
    the warm-up only) are captured. Returns {"stats", "launches", "captures",
    "results", "exact"}."""
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    on_card = dev.type == "cuda"
    clustered = path.startswith("clustered")
    ladder_name, kernel_names = PATHS[path]
    ladders = []
    real_ladder = getattr(searcher_mod, ladder_name)

    def recording_ladder(*a, **kw):
        st, rungs = real_ladder(*a, **kw)
        ladders.append((st.exact.copy(), rungs))
        return st, rungs

    setattr(searcher_mod, ladder_name, recording_ladder)
    captures = _path_captures(path) if main_path else {}
    try:
        searcher.search_batch(warm, top_k=TOP_K, log=False)
        if path == "clustered/levers":  # keyed by call: capture the warm-up only
            for cap in captures.values():
                cap.restore()
        clock.phase("warm-up batch", f"{label}: {len(warm)} queries")

        ladders.clear()
        kernels = {name: kernel_fns(name)[0] for name in kernel_names}
        for fn in kernels.values():
            fn.launches = 0
        for cap in captures.values():
            cap.counts.clear()
        v1_before = [fn.launches for fn in first_designs()]
        lat, results = [], []
        for qs in batches:
            t = time.perf_counter()
            results.append(searcher.search_batch(qs, top_k=TOP_K, log=False))
            lat.append(time.perf_counter() - t)
        launches = {name: fn.launches for name, fn in kernels.items()}
        if [fn.launches for fn in first_designs()] != v1_before:
            raise AssertionError(f"{label}: a first design (_v1) launched on the "
                                 "served path")
    finally:
        setattr(searcher_mod, ladder_name, real_ladder)
        for cap in captures.values():
            cap.restore()
    if len(ladders) != len(batches):
        raise AssertionError(f"search_batch did not take the {ladder_name}")
    if on_card and min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    rungs = [r for _e, r in ladders]
    if (on_card and main_path and clustered
            and max(rungs) < len(searcher_mod._SUPER_LADDER)):
        raise AssertionError(f"the main path never reached the ladder's last "
                             f"rung: rungs {rungs}")
    n_q = sum(len(qs) for qs in batches)
    qps = n_q / sum(lat)
    p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
    exact = np.concatenate([e for e, _r in ladders])
    clock.phase("search_batch", f"{label}: {len(batches)} x {sz['batch']} "
                f"queries, rungs {rungs}, launches {json.dumps(launches)}")

    if on_card and main_path:
        clock.phase("profile", f"{label}: " + profile_batch(searcher, batches[0]))

    fu = searcher.config.fusion
    checked, best_effort_ok, jaccards = check_batches(
        searcher, batches, results, [e for e, _r in ladders], fu.semantic_weight,
        fu.lexical_weight)
    jac_mean = float(np.mean(jaccards)) if jaccards else None
    clock.phase("reference", f"{label}: {checked} certified rows match the "
                f"plain exact fused reference; {best_effort_ok} of "
                f"{n_q - checked} uncertified rows match it too, their "
                f"jaccard@{TOP_K} mean {jac_mean}")
    print(f"    {label}: certified {exact.mean():.4f} ({int(exact.sum())}/"
          f"{exact.size}), rungs mean {np.mean(rungs):.2f}, qps {qps:.1f}, batch "
          f"latency p50 {p50:.2f} ms p99 {p99:.2f} ms (B={sz['batch']}, {kind}; "
          f"{smi}; unsourced synthetic corpus)", flush=True)
    if not exact.any():
        raise AssertionError("no query was certified")
    stats = {"path": path, "certified": float(exact.mean()),
             "n_certified": int(exact.sum()), "n_queries": int(exact.size),
             "best_effort_match": best_effort_ok,
             "uncertified_jaccard_mean": jac_mean, "rungs": rungs, "qps": qps,
             "p50_ms": float(p50), "p99_ms": float(p99),
             "batch_ms": [x * 1e3 for x in lat], "launches": launches}
    return {"stats": stats, "launches": launches, "captures": captures,
            "results": results, "exact": exact}


def serve_levers(run: dict, sz: dict, dev: torch.device, clock: Clock, kind: str,
                 smi: str) -> dict:
    """The small-topic clustered index of ``run``, not re-indexed, served
    again with ``perf.scores_dedup = perf.place_fused = True``: the same
    warm-up and timed batches. Its certified flags, ids and values must
    equal the default run's bit for bit (and serve_batches holds every
    certified row against the exact reference)."""
    perf = run["searcher"].config.perf
    perf.scores_dedup = perf.place_fused = True
    try:
        lev = serve_batches(run["searcher"], "small-topic/levers", "clustered/levers",
                            run["warm"], run["batches"], sz, dev, clock, kind, smi,
                            main_path=True)
    finally:
        perf.scores_dedup = perf.place_fused = None
    if not np.array_equal(lev["exact"], run["exact"]):
        raise AssertionError("the levers run certifies other rows than the default")
    if lev["results"] != run["results"]:
        raise AssertionError("the levers run serves other ids or values than the "
                             "default")
    d, v = run["stats"], lev["stats"]
    clock.phase("small-topic/levers", (
        f"certified flags, ids and values equal the default run's bit for bit; "
        f"levers vs default: certified {v['n_certified']}/{v['n_queries']} vs "
        f"{d['n_certified']}/{d['n_queries']}, qps {v['qps']:.1f} vs {d['qps']:.1f}, "
        f"p50 {v['p50_ms']:.2f} vs {d['p50_ms']:.2f} ms, p99 {v['p99_ms']:.2f} vs "
        f"{d['p99_ms']:.2f} ms ({kind}; {smi}; unsourced synthetic corpus)"))
    return lev


def serve_regime_one(sz: dict, dev: torch.device, seed: int, clock: Clock,
                     kind: str, smi: str) -> dict:
    """Regime 1: small-topic's generator at a quarter of the size, under the
    default ``layout="source"``, below ``SPARSE_HYBRID_MIN_DOCS``, so
    ``search_batch`` takes ``_hybrid_one_program`` (full [B, n] cosine,
    bucketed BM25 summed run column by run column, exact fusion). One
    warm-up and the timed batches; the first batch is served again and
    must be equal bit for bit, and every row must equal the exact
    reference."""
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    small = dict(sz, n_docs=sz["n_docs"] // 4)
    saved_min, real = searcher_mod.SPARSE_HYBRID_MIN_DOCS, searcher_mod._hybrid_one_program
    calls = []
    searcher_mod.SPARSE_HYBRID_MIN_DOCS = max(saved_min, small["n_docs"] + 1)
    searcher_mod._hybrid_one_program = (
        lambda *a, **k: calls.append(1) or real(*a, **k))
    try:
        searcher, make_queries, timings = index_corpus(
            "small-topic", "source", small, dev, seed, clock, "regime 1", at_scale=False)
        searcher.search_batch(make_queries(sz["batch"]), top_k=TOP_K, log=False)
        batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]
        calls.clear()
        lat, results = [], []
        for qs in batches:
            t = time.perf_counter()
            results.append(searcher.search_batch(qs, top_k=TOP_K, log=False))
            lat.append(time.perf_counter() - t)
        again = searcher.search_batch(batches[0], top_k=TOP_K, log=False)
    finally:
        searcher_mod.SPARSE_HYBRID_MIN_DOCS = saved_min
        searcher_mod._hybrid_one_program = real
    if len(calls) != len(batches) + 1:
        raise AssertionError("regime 1 did not take _hybrid_one_program")
    if again != results[0]:
        raise AssertionError("regime 1: two servings of one batch differ")
    fu = searcher.config.fusion
    checked, _b, _j = check_batches(searcher, batches, results,
                                    [np.ones(len(qs), bool) for qs in batches],
                                    fu.semantic_weight, fu.lexical_weight)
    n_q = sum(len(qs) for qs in batches)
    qps = n_q / sum(lat)
    p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
    clock.phase("regime 1", (
        f"{small['n_docs']} docs: the same batch served twice is equal bit for "
        f"bit; all {checked} rows match the plain exact fused reference; qps "
        f"{qps:.1f}, batch latency p50 {p50:.2f} ms p99 {p99:.2f} ms (B={sz['batch']}, "
        f"{kind}; {smi}; unsourced synthetic corpus)"))
    return {"n_docs": small["n_docs"], "qps": qps, "p50_ms": float(p50),
            "p99_ms": float(p99), "batch_ms": [x * 1e3 for x in lat],
            "rows_checked": checked, "repeat_equal": True, "index_timings_s": timings}


def check_batches(searcher, batches, results, exact_rows, sw: float, lw: float):
    """check_against_reference over every batch: (certified rows checked,
    uncertified rows that match anyway, jaccard@k of the uncertified)."""
    checked = best_effort_ok = 0
    jaccards = []
    for qs, res, ex in zip(batches, results, exact_rows):
        rv, ri, fused = reference_topk(searcher, qs, TOP_K, sw, lw)
        c, b, jac = check_against_reference(res, ex, rv, ri, fused)
        checked, best_effort_ok = checked + c, best_effort_ok + b
        jaccards += jac
        del fused
    return checked, best_effort_ok, jaccards


if __name__ == "__main__":
    sys.exit(main())
