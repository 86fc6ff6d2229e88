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
scores (K2, super_scores) and resident placement, here on its yardstick
route (``cfg.perf.place_fused = False``: staged windows, then K3,
place_windows; the default places with K5 on the card). The
run fails unless each kernel launched during the timed batches, the batches
reached the ladder's last rung, and every certified query matches a plain
exact fused reference computed on the card. Each kernel is then timed on
the main path's own inputs (K2 at every probe count the ladder gave it).
The P1 check re-runs the clustered build's k-means on the same embeddings
and requires the same centroids, bit for bit, and the same permutation.

The same index is then served again, not re-indexed, with both perf
levers set True (``cfg.perf.scores_dedup`` and ``cfg.perf.place_fused``): the
rungs score pairs sorted by supertile (K4, super_scores_dedup) and place
the lexical windows straight from the CSR (K5, place_fused). Its certified
flags, ids and values must equal the first run's bit for bit; K4 and K5
are timed at every rung beside K2 and the window gather + K3 on the same
work; K4 is held bit-equal to K2 and its whole route (pair sort, group
table, kernel) is timed against K2 at every rung.

The same index then serves the clustered index's other routes, not
re-indexed: "small-topic/tile" under ``HST_SUPER_HYBRID=0`` (the tile
ladder: K1, K4 at tile grain, K6) and "small-topic/impact" with
``HST_TILE_HYBRID=0`` as well (the impact ladder: K1, K4, K6, K7), each
through ``search_batch`` on the same batches, every certified row against
the exact reference and the first batch served twice bit for bit; one
batch of ``hybrid_impact_topk(kd_tiles=128)`` (the first rung the searcher
takes at 1M docs) beside the same rung without the budget; and one batch
of the one-call ``hybrid_supertile_topk`` at s_probe 2 and 16 (K1-K3,
``place_fused=False``),
equal bit for bit to ``super_prefix`` + one rung. The route kernels'
launches of each run are counted, all seven of them.

On the same index, "dense/int8_swept" takes the first batch through
``quantize_corpus_int8`` and ``int8_swept_topk`` (pass 1 an int8 product,
``torch._int_mm``; pass 3 K4 at tile grain) at probe_tiles 4k, then 16k and
every tile on the rows left uncertified: each certified row must equal the
exact ``tiled_dense_topk`` bit for bit, ``dense_topk`` must equal
``tiled_dense_topk``, ``cosine_scores`` and ``pairwise_cosine`` must match
float64 numpy, and K1 and K4 must launch. ``QueryTracer`` then profiles
one batch; its trace must name K1's kernel.

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
On its index, not re-indexed, "small-topic/source/sparse" serves the
batches through ``hybrid_sparse_topk`` over ``BM25.encode_queries_sparse``
(K1, K4): queries whose Zipf word has a run past 65,536 postings take its
per-tile weight-sum row; the rows' count, bytes and build seconds (inside
the ``bm25_s`` stage) are printed. "Regime 1" serves a corpus a quarter of the size, below
``SPARSE_HYBRID_MIN_DOCS``, through the full [B, n] fused program; one
batch is served twice and must be equal bit for bit. A corpus with larger topics is served on the
clustered path; its index is built in a process of its own beside the
lifecycle run, saved, and loaded (``Indexer.load``) to be served. "small-topic/ivf" is the one other new build, built
and served in a process of its own beside the lifecycle run: the
small-topic corpus with ``ann="ivf"`` on the clustered layout (the IVF
adopts the dense buffer and the layout's k-means), served in scatter mode:
every row against a plain scatter reference over the same IVF top 2k, the
IVF at full probe against ``DenseIndex.search``, recall@10 at nprobe 8
printed as a reading; "ivf bf16" builds a float32 and a bfloat16
``IVFIndex`` of the same rows, seed and cluster count and serves the
run's batches through both: equal ids but at 2^-8 near-ties, half the
bytes, recall@10 of each. Each of those runs is given the hashing encoder.
The mesh run's ranks also drive the "mesh routes": ``DenseIndex.add`` past
the sharded capacity and ``compact`` (rows moving between ranks), a small
sharded ``Indexer`` grown past its capacity and exported to JSON, imported
on one device, and ``HybridBM25Pipeline.search``, each held to one device.

Last, "small-topic/source/minilm" runs the default configuration as a user
keeps it: small-topic under ``layout="source"`` with no encoder given, so
the Indexer's ``default_encoder`` serves the bi-encoder that
``models/PROMOTED.json`` promotes (``models/hst-bi-v3``: 4 layers, hidden
384, bf16 activations); the run fails on any other encoder or weights. Its
index build splits the embed stage into tokenize and trunk, its served
batches must launch K1, K4 (pass 3), K6 and K7 and match the exact
reference on every certified row, and the encode span is set beside the
batch wall time. The trunk is then timed alone at a query batch (256, 8)
and an index batch (2048, 64) against the card's bf16 peak, its float32
forward and ``scaled_dot_product_attention`` (a yardstick only), and the
cross-encoder (``models/hst-ms-marco-MiniLM-L-6-v2-synth``) scores the
served top-20 of one batch through ``predict`` and
``CrossEncoderReranker.rerank``; the rehearsal writes tiny seeded
checkpoints in their place.

Then "small-topic/source/pipelines" serves the pipelines of
``create_pipeline`` on that run's index, not re-indexed: each pipeline is
built with the run's encoder (and a ``CrossEncoderReranker`` over its
cross-encoder) and handed the run's ``indexer`` and ``searcher``.
``MultiStagePipeline.search_batch`` (100 -> 20 -> 5) serves 8 batches:
stage 1 is held to an exact dense top-100 on the card, stage 2 to
``BM25.candidate_scores``, each row to its stage-2 docs sorted by
cross-encoder score (logits recomputed within 1e-4), and 16 queries served
alone to their batched rows (logits within 1e-3).
``DiversityPipeline.search_batch`` serves 8 batches, its MMR held to the
plain version on the host, and at least 8 of 16 queries served alone to
their batched rows; ``HybridBM25Pipeline.search`` serves 32 queries on its
impact path, every exact row (at least 8) held to a plain divide-by-max
fusion and the others to a mean jaccard@10 of 0.9;
Basic, Reranked (both fusion settings), BM25 and RAG (a stand-in LLM)
serve a few queries each; ChunkedPipeline indexes 16,384 corpus docs
joined four at a time into 4,096 parents and must restore its chunk map by
``reload``; the semantic cache must hit every query vector set in it. K1,
K4, K6 and K7 must launch while the pipelines serve; all seven kernels'
launches there are counted and printed. No corpus's topic
structure comes from a published source, so their qps describe these
corpora only.

Last come the trainers (``training/``) on those two trunks, on pairs from
the small-topic corpus (a doc and a query of its topic; the cross pairs
alternate relevant and of another topic): "train contrastive"
(``ContrastiveTrainer`` from hst-bi-v3, 96 pairs at seq 48) and "train
cross" (``CrossEncoderTrainer`` from the cross-encoder checkpoint, 64
pairs at seq 128) each hold the first step's loss and gradients to the
port on the CPU (same params and batch), then time 20 steps (every loss
finite; ms, tokens/s, TFLOP/s against the bf16 peak, peak bytes) and
profile one more; "train checkpoint" requires a restored train state to
take the uninterrupted trainer's next step, and the saved encoder to
encode 256 queries as the trainer's model, bit for bit; "train mesh"
holds the step the mesh run's four ranks took as data 2 x model 2 (a
tensor-parallel trunk; ``mesh_rank``) to the one-device step. No kernel
of K1-K7 may launch while they train.

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
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

BUDGET_S = 600.0  # the whole card run, build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

REHEARSAL_THREADS = 2  # torch's intra-op threads in the CPU rehearsal
REHEARSAL_HOT_DF = 1024  # the hot-term threshold of the rehearsal's tiny corpora
# (main-path shapes, rehearsal shapes)
SIZES = {
    "card": dict(n_docs=524_288, dim=384, batch=256, n_batches=8,
                 n_background=30_000, s_max=16, probes=(2, 4, 8, 16),
                 chunk_docs=16_384),
    "cpu": dict(n_docs=9_216, dim=128, batch=32, n_batches=2,
                n_background=2_000, s_max=1, probes=(2, 4), chunk_docs=1_024),
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
    # the clustered index with HST_SUPER_HYBRID=0: the tile ladder (K1, K4 at
    # tile grain, K6)
    "clustered/tile": ("tile_ladder", ("tile_stats", "super_scores_dedup",
                                       "slice_runs")),
    # and with HST_TILE_HYBRID=0 too: the impact ladder on the clustered index
    "clustered/impact": ("impact_ladder", ("tile_stats", "slice_runs", "rescore",
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


class LineClock(Clock):
    """A Clock that keeps its phase lines for the parent to print (a
    process of the smoke's own prints nothing), with no budget of its own."""

    def __init__(self):
        super().__init__(float("inf"))
        self.lines = []

    def phase(self, name: str, detail: str = "") -> None:
        self.lines.append((name, detail))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev: torch.device, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls on the
    card, the host clock after a synchronize elsewhere. Off the card (the
    CPU rehearsal, which reports no device time) one call, no warm-up:
    enough to drive the path."""
    if dev.type != "cuda":
        reps, warmup = 1, 0
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


def check_shard_kernels(sz: dict, dev: torch.device, seed: int) -> None:
    """K1 and K4 at tile grain on one mesh rank's inputs: K1's stats sweep
    over a shard's N / MESH_RANKS rows (a few dead) at the served batch,
    with and without the alive min, and K4 at tile grain
    (``tile_scores``) over that shard's tiles at each rung of the sharded
    ladder (``_SUPER_LADDER`` capped at a shard's supertiles, every
    supertile's tiles in a row, as the sharded program asks), each within
    1e-5 of its plain version, float32."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import tile_scores, tile_scores_plain
    from hybridsearch_tpu_torch.ops.cuda_topk import tile_stats, tile_stats_plain
    from hybridsearch_tpu_torch.retrieval.searcher import _SUPER_LADDER

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    per, D, B = sz["n_docs"] // MESH_RANKS, sz["dim"], sz["batch"]
    docs = unit_rows(gen, per, D, dev)
    q = unit_rows(gen, B, D, dev)
    bias = torch.zeros(per, device=dev)
    bias[torch.randperm(per, generator=gen, device=dev)[: per // 100]] = float("-inf")
    errs = [max_err(tile_stats(q, docs, bias, per, with_min),
                    tile_stats_plain(q, docs, bias, per, with_min))
            for with_min in (False, True)]
    n_tiles = per // 128
    super_tiles = min(128, n_tiles)  # 16,384-doc supertiles, or the whole shard
    ns = n_tiles // super_tiles
    for S in sorted({min(s, ns) for s in _SUPER_LADDER}):
        sup = torch.sort(torch.stack([torch.randperm(ns, generator=gen, device=dev)[:S]
                                      for _ in range(B)]), dim=1).values
        tiles = (sup[:, :, None] * super_tiles
                 + torch.arange(super_tiles, device=dev)).reshape(B, -1).int()
        errs.append(max_err(tile_scores(q, docs, tiles), tile_scores_plain(q, docs, tiles)))
        print(f"    shard of {per} rows: tile_scores at {S} of {ns} supertiles "
              f"({tiles.shape[1]} tiles a query) err {errs[-1]:.3g} (tol 1e-5)",
              flush=True)
    print(f"    shard of {per} rows: tile_stats at B={B} err {max(errs[:2]):.3g} "
          "(tol 1e-5)", flush=True)
    if max(errs) > 1e-5:
        raise AssertionError("a kernel disagrees with its plain version on a "
                             "shard's rows")
    del docs
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

# (corpus, seed, n_docs, n_background) -> (docs, the generator's state after
# them): small-topic at one seed is indexed by five runs, and drawing its
# 524,288 docs takes about 8 s on the card's host. Callers do not mutate docs.
_CORPUS_CACHE: dict = {}


def make_corpus(sz: dict, corpus: str, seed: int):
    """Topic-correlated synthetic corpus (``CORPORA``): each doc draws its
    topic words from its topic's vocabulary and its other words from a
    Zipf(1.1) background of ``n_background`` words, shuffled. Queries: 2-4
    words of one topic plus one background word. A repeated call returns
    the same docs and a query maker that draws the same queries."""
    topic_docs, n_tw, n_bw, tv = CORPORA[corpus]
    n, V = sz["n_docs"], sz["n_background"]
    T = max(1, n // topic_docs)
    key = (corpus, seed, n, V)
    if key not in _CORPUS_CACHE:
        rng = np.random.default_rng(seed)
        words = [f"t{t}x{j}" for t in range(T) for j in range(tv)]
        words += [f"w{r}" for r in range(V)]
        topic = rng.integers(0, T, n)
        tw = topic[:, None] * tv + rng.integers(0, tv, (n, n_tw))
        bw = T * tv + rng.choice(V, size=(n, n_bw), p=_zipf(V))
        mat = rng.permuted(np.concatenate([tw, bw], axis=1), axis=1)
        docs = list(map(" ".join, np.array(words, dtype=object)[mat].tolist()))
        _CORPUS_CACHE[key] = (docs, rng.bit_generator.state)
    docs, state = _CORPUS_CACHE[key]
    return docs, query_maker(sz, corpus, state)


def _zipf(V: int) -> np.ndarray:
    z = 1.0 / np.arange(1, V + 1) ** 1.1
    return z / z.sum()


def query_maker(sz: dict, corpus: str, state: dict):
    """``make_corpus``'s query maker from its generator's state after the
    draw (a process that did not draw the corpus can make its queries)."""
    topic_docs, _n_tw, _n_bw, tv = CORPORA[corpus]
    V = sz["n_background"]
    T = max(1, sz["n_docs"] // topic_docs)
    zipf = _zipf(V)
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = state

    def queries(count: int):
        out = []
        qt = rng.integers(0, T, count)
        nw = rng.integers(2, 5, count)
        bg = rng.choice(V, size=count, p=zipf)
        for t, m, b in zip(qt.tolist(), nw.tolist(), bg.tolist()):
            js = rng.choice(tv, size=m, replace=False)
            out.append(" ".join([f"t{t}x{j}" for j in js] + [f"w{b}"]))
        return out

    return queries


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
    """One more batch under torch.profiler (``profile_call``)."""
    return profile_call(lambda: searcher.search_batch(queries, top_k=TOP_K, log=False))


def profile_call(fn) -> str:
    """``fn()`` under torch.profiler: the summed time of the device's
    kernels and copies against the call's wall time (taken inside the
    profiled region, so profiler start-up is not counted), and the kernels
    that took the most device time. ``trace_span`` ranges also show up on
    the device timeline; they overlap the kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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
        out = self.real_perm(vectors, *a, **kw)  # (perm, centroids, assignment)
        self.perm = out[0]
        return out

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
            searcher = Searcher(config=cfg, encoder=hashing_encoder(sz, dev),
                                use_query_memory=False, device=dev)
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
    from hybridsearch_tpu_torch import pipelines as pipelines_mod
    from hybridsearch_tpu_torch.ops import bm25 as bm25_mod
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    sz = SIZES["cpu" if rehearsal else "card"]
    if rehearsal:
        dev = torch.device("cpu")
        kind, count, smi = "cpu", 0, "nvidia-smi: not run (cpu rehearsal)"
        # take the kernel routes, with the plain versions behind the wrappers
        dense_mod._on_card = supertile_mod._on_card = lambda t: True
        searcher_mod.SPARSE_HYBRID_MIN_DOCS = 0
        pipelines_mod.HYBRID_BM25_SPARSE_MIN = 0
        # a tiny corpus has hot terms only under a lower threshold
        bm25_mod.HOT_DF_THRESHOLD = REHEARSAL_HOT_DF
        # tiny shapes gain little from threads, and a full set of them
        # oversubscribes a host shared with other processes
        torch.set_num_threads(min(REHEARSAL_THREADS, torch.get_num_threads()))
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
    check_shard_kernels(sz, dev, args.seed)
    check_impact_kernels(sz, dev, args.seed,
                         IMPACT_SHAPES["cpu" if rehearsal else "card"])
    clock.phase("kernels", "K1-K7 match their plain versions at the slice's "
                "shapes (K1 and K4 at tile grain also on a mesh shard's rows); K4 "
                "equals K2 and K5 equals window gather + K3 bit for bit"
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
    # the same index, not re-indexed, through the other clustered routes
    routes = {}  # each new run's launches, for the kernel line
    for label, path, env in (
            ("small-topic/tile", "clustered/tile", {"HST_SUPER_HYBRID": "0"}),
            ("small-topic/impact", "clustered/impact",
             {"HST_SUPER_HYBRID": "0", "HST_TILE_HYBRID": "0"})):
        gated = serve_gated(run, label, path, env, sz, dev, clock, kind, smi)
        detail["corpora"][label] = gated["stats"]
        routes[label] = gated["launches"]
    kd = serve_kd_tiles(run, sz, dev, clock, kind, smi)
    detail["corpora"]["small-topic/impact/kd_tiles"] = kd
    routes["small-topic/impact/kd_tiles"] = kd["launches"]
    one_call = serve_one_call(run, sz, dev, clock, kind, smi)
    detail["corpora"]["small-topic/one-call"] = one_call
    for s_probe, row in one_call.items():
        routes[f"small-topic/one-call s_probe={s_probe}"] = row["launches"]
    int8 = serve_int8_swept(run, sz, dev, clock, kind, smi)
    detail["corpora"][INT8_LABEL] = int8
    routes[INT8_LABEL] = int8["launches"]
    routes[DENSE_TOPK_LABEL] = int8["dense_topk_launches"]
    detail["query_tracer"] = trace_batch(run, dev, clock)
    del lev, caps, gated
    clock.phase("P1 check", "small-topic: " + check_p1(rec))
    del rec
    # the mesh's four ranks build and serve beside the next build; the
    # small-topic index (run) is their reference until they are collected
    mesh_world = start_mesh(sz, dev, args.seed, rehearsal)

    mesh_train = {}  # the mesh's training step, held to the one-device step later
    minilm = {}  # the minilm run's index, built beside the ranks, served later

    def collect_mesh():
        # the minilm run's build, a set-up stage, also runs beside the ranks
        nonlocal run
        bm25_mod._hot_tables = real_hot
        try:
            minilm.update(build_minilm(sz, dev, args.seed, clock, rehearsal))
        finally:
            bm25_mod._hot_tables = timed_hot
        mesh = finish_mesh(mesh_world, run, sz, dev, clock, kind, smi)
        mesh_train.update(mesh.pop("train"))
        detail["corpora"]["small-topic/mesh4"] = mesh
        for rank, counts in mesh["launches"].items():
            routes[f"small-topic/mesh4 rank {rank}"] = counts
        run = None

    hot_s = []  # seconds of the hot-term tables inside the source build's bm25_s
    real_hot = bm25_mod._hot_tables

    def timed_hot(*a, **kw):
        t = time.perf_counter()
        out = real_hot(*a, **kw)
        sync(dev)
        hot_s.append(time.perf_counter() - t)
        return out

    bm25_mod._hot_tables = timed_hot
    try:
        run = serve_corpus("small-topic", "source", sz, dev, args.seed, clock, kind,
                           smi, main_path=True, before_serve=collect_mesh)
    except BaseException:
        mesh_world[0].stop()
        raise
    finally:
        bm25_mod._hot_tables = real_hot
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
    sparse = serve_sparse(run, sz, dev, clock, kind, smi, sum(hot_s))
    detail["corpora"]["small-topic/source/sparse"] = sparse
    routes["small-topic/source/sparse"] = sparse["launches"]
    oneshot = oneshot_record(run)
    del run, caps

    detail["tile_stats_by_batch"] = k1_rows
    detail["place_windows_by_rung"] = k3_rows
    clock.phase("redesigned kernels", (
        f"tile_stats at B = {sorted({r['B'] for r in k1_rows})} and place_windows at "
        f"B*S = {[r['BS'] for r in k3_rows]} on main-path inputs" +
        ("; times not reported (cpu rehearsal)" if rehearsal else
         ", each bit-equal to its first design")))

    # large-topic's index build (a process of its own), one batch on a
    # world of one NCCL rank, the IVF run (a process of its own) and the API
    # run's CLI chain (``index`` + ``serve`` of a small corpus of its own,
    # each a process that starts torch and the card) run beside the
    # lifecycle run's build, set-up stages; the chain is healthy before the
    # minilm run's timed batches
    large_world = start_large(sz, dev, args.seed + 1, rehearsal)
    world1 = start_nccl_batch(sz, dev, args.seed + 2, rehearsal)
    ivf_world = start_ivf(sz, dev, args.seed, kind, smi, rehearsal)
    chain = CliChain(make_corpus(dict(sz, n_docs=API_SIZES[
        "cpu" if rehearsal else "card"]["cli_docs"]), "small-topic", args.seed + 3)[0],
        rehearsal)
    try:
        detail["corpora"]["small-topic/source/lifecycle"] = serve_lifecycle(
            sz, dev, args.seed, clock, kind, smi, oneshot)
        del oneshot
        regime = serve_regime_one(sz, dev, args.seed + 2, clock, kind, smi)
        detail["regime_1"] = {k: v for k, v in regime.items() if k != "searcher"}

        def collect_world1():
            detail["mesh_world1"] = finish_nccl_batch(world1, regime, clock)

        large: dict = {}
        run = serve_corpus("large-topic", "clustered", sz, dev, args.seed + 1, clock, kind,
                           smi, False, before_serve=collect_world1,
                           load=load_large(large_world, sz, dev, clock, large))
        run["searcher"].indexer.close()
        detail["corpora"]["large-topic"] = dict(run["stats"], **large)
        del run, regime
        ivf = finish_ivf(ivf_world, clock)
        chain.wait_healthy()
        detail["corpora"]["small-topic/source/minilm"], handoff = serve_minilm(
            minilm, sz, dev, clock, kind, smi)
        pipelines = serve_pipelines(handoff, sz, dev, clock, kind, smi)
    except BaseException:
        for world in (large_world, world1, ivf_world):
            world[0].stop()
        chain.stop()
        raise
    finally:
        shutil.rmtree(LARGE_DIR, ignore_errors=True)
    detail["corpora"]["small-topic/ivf"] = ivf
    routes["small-topic/ivf"] = ivf["launches"]
    order = list(KERNEL_META)
    numbers.sort(key=lambda row: order.index(row["name"]))
    for row in numbers:
        row["launches_routes"] = {label: counts[row["name"]]
                                  for label, counts in routes.items()}
    detail["corpora"]["small-topic/source/pipelines"] = pipelines
    for row in numbers:
        if row["name"] in pipelines["launches"]:
            row["launches_pipelines"] = pipelines["launches"][row["name"]]
    # the trainers read the minilm run's corpus as it was before the API
    # run's add (the source layout keeps the corpus order)
    contents, make_queries = list(handoff["searcher"].indexer.contents), handoff["make_queries"]
    try:
        api = serve_api(handoff, chain, sz, dev, clock, kind, smi, rehearsal)
    finally:
        chain.stop()
    detail["corpora"]["small-topic/source/api"] = api
    for row in numbers:
        row["launches_api"] = api["launches"][row["name"]]
    del handoff
    training = serve_training(contents, make_queries, mesh_train, sz, dev, args.seed,
                              clock, kind, smi, rehearsal)
    del contents, mesh_train
    detail["training"] = training
    for row in numbers:
        row["launches_training"] = training["launches"][row["name"]]

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


def hashing_encoder(sz: dict, dev: torch.device):
    """The hashing encoder every run but the minilm phase serves, pinned so
    that the Indexer's default (the in-repo transformer, where a checkpoint
    is found) does not change what those runs measure."""
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    return HashingEncoder(dim=sz["dim"], device=dev)


def index_corpus(corpus: str, layout: str, sz: dict, dev: torch.device, seed: int,
                 clock: Clock, label: str, at_scale: bool = True, prepare=None,
                 ann: str = "flat", load=None):
    """Index one corpus under ``layout`` (and ``config.index.ann``) through
    ``Indexer.index_documents`` and, ``at_scale``, build its ladder's
    lexical structures. The searcher
    serves the hashing encoder unless ``prepare`` is given: then the
    Indexer resolves its own default encoder, and ``prepare(searcher)``
    runs before indexing and returns a function that adds stages to the
    index timings. ``load()``, if given, stands for the draw and the build:
    it prints their phases and returns what this returns, for an index
    built elsewhere. Returns (searcher, make_queries, index timings)."""
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    if load is not None:
        searcher, make_queries, timings = load()
        return searcher, make_queries, _lexical_tier(searcher, layout, label, at_scale,
                                                     dev, clock, timings)
    docs, make_queries = make_corpus(sz, corpus, seed)
    clock.phase("corpus", f"{label}: {len(docs)} docs, "
                f"{sum(len(d) for d in docs)} chars")
    cfg = EngineConfig()
    cfg.index.layout = layout
    cfg.index.ann = ann
    cfg.index.dim = sz["dim"]
    searcher = Searcher(config=cfg, use_query_memory=False, device=dev,
                        encoder=None if prepare else hashing_encoder(sz, dev))
    finish = prepare(searcher) if prepare else None
    built = searcher.indexer.index_documents(docs)
    del docs
    if finish:
        finish(built["timings_s"])
    stages = ", ".join(f"{k} {v:.1f}" for k, v in built["timings_s"].items())
    clock.phase("index_documents", f"{label}: {stages}")
    return searcher, make_queries, _lexical_tier(searcher, layout, label, at_scale, dev,
                                                 clock, built["timings_s"])


def _lexical_tier(searcher, layout: str, label: str, at_scale: bool, dev: torch.device,
                  clock: Clock, timings: dict) -> dict:
    """``index_corpus``'s last step: the ladder's lexical structures of the
    indexed corpus, at scale. Returns ``timings``."""
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
    return timings


def serve_corpus(corpus: str, layout: str, sz: dict, dev: torch.device, seed: int,
                 clock: Clock, kind: str, smi: str, main_path: bool,
                 before_serve=None, load=None) -> dict:
    """Index one corpus (``index_corpus``; ``load`` as there), run
    ``before_serve()`` if given (collecting a world of ranks that ran beside
    the build), and serve it (``serve_batches``): one warm-up and
    ``n_batches`` timed batches. Returns serve_batches' dict plus
    "searcher", "warm" and "batches"."""
    label = corpus if layout == "clustered" else f"{corpus}/{layout}"
    searcher, make_queries, timings = index_corpus(corpus, layout, sz, dev, seed,
                                                   clock, label, load=load)
    if layout == "clustered":  # the staged windows + K3: PATHS["clustered"]
        searcher.config.perf.place_fused = False
    if before_serve is not None:
        before_serve()
    warm = make_queries(sz["batch"])
    batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]
    run = serve_batches(searcher, label, layout, warm, batches, sz, dev, clock,
                        kind, smi, main_path)
    run["stats"]["index_timings_s"] = timings
    run.update(searcher=searcher, warm=warm, batches=batches)
    return run


@contextlib.contextmanager
def gc_pauses(sink: list, batch: list):
    """Append (generation, seconds, batch[0]) for every collection of
    Python's garbage collector while the block runs: a full (generation 2)
    collection walks every container object of the process, and host pauses
    show up in a batch's wall time."""
    t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            sink.append((info["generation"], time.perf_counter() - t0[0], batch[0]))

    gc.callbacks.append(on_gc)
    try:
        yield sink
    finally:
        gc.callbacks.remove(on_gc)


def serve_batches(searcher, label: str, path: str, warm, batches, sz: dict,
                  dev: torch.device, clock: Clock, kind: str, smi: str,
                  main_path: bool) -> dict:
    """Serve ``warm`` and then the timed ``batches`` through ``search_batch``
    on the route ``path`` (``PATHS``), and hold every certified row against
    the plain exact reference. Every kernel's count is set to 0 just before
    the timed batches and read just after (the path's kernels must have
    launched); on a main path, the
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
        kernels = {name: kernel_fns(name)[0] for name in KERNEL_META}
        for fn in kernels.values():
            fn.launches = 0
        for cap in captures.values():
            cap.counts.clear()
        v1_before = [fn.launches for fn in first_designs()]
        lat, results, pauses, current = [], [], [], [0]
        with gc_pauses(pauses, current):
            for i, qs in enumerate(batches):
                current[0] = i
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
    if on_card and min(launches[name] for name in kernel_names) == 0:
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
    full = [(sec, i) for gen, sec, i in pauses if gen == 2]
    gc_text = (f"{len(full)} full collections, {1e3 * sum(t for t, _i in full):.1f} ms"
               + (f", the longest {1e3 * max(full)[0]:.1f} ms in batch {max(full)[1]}"
                  if full else ""))
    print(f"    {label}: certified {exact.mean():.4f} ({int(exact.sum())}/"
          f"{exact.size}), rungs mean {np.mean(rungs):.2f}, qps {qps:.1f}, batch "
          f"latency p50 {p50:.2f} ms p99 {p99:.2f} ms (B={sz['batch']}, {kind}; "
          f"{smi}; unsourced synthetic corpus); host GC in the timed batches: "
          f"{gc_text}", flush=True)
    if not exact.any():
        raise AssertionError("no query was certified")
    stats = {"path": path, "certified": float(exact.mean()),
             "n_certified": int(exact.sum()), "n_queries": int(exact.size),
             "best_effort_match": best_effort_ok,
             "uncertified_jaccard_mean": jac_mean, "rungs": rungs, "qps": qps,
             "p50_ms": float(p50), "p99_ms": float(p99),
             "batch_ms": [x * 1e3 for x in lat], "launches": launches,
             "gc_pauses_s": [[g, sec, i] for g, sec, i in pauses]}
    return {"stats": stats, "launches": launches, "captures": captures,
            "results": results, "exact": exact}


def serve_levers(run: dict, sz: dict, dev: torch.device, clock: Clock, kind: str,
                 smi: str) -> dict:
    """The small-topic clustered index of ``run``, not re-indexed, served
    again with ``perf.scores_dedup = perf.place_fused = True``: the same
    warm-up and timed batches. Its certified flags, ids and values must
    equal the first run's (K2, staged windows + K3) bit for bit (and
    serve_batches holds every
    certified row against the exact reference)."""
    perf = run["searcher"].config.perf
    saved = perf.scores_dedup, perf.place_fused
    perf.scores_dedup = perf.place_fused = True
    try:
        lev = serve_batches(run["searcher"], "small-topic/levers", "clustered/levers",
                            run["warm"], run["batches"], sz, dev, clock, kind, smi,
                            main_path=True)
    finally:
        perf.scores_dedup, perf.place_fused = saved
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
            "rows_checked": checked, "repeat_equal": True, "index_timings_s": timings,
            "searcher": searcher}


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


# -- the other single-device routes: tile, clustered impact, one-call
# -- supertile, sparse hybrid, IVF ------------------------------------------------

KD_TILES = 128  # the impact ladder's first-rung dense budget at 1M docs or more
ONE_CALL_PROBES = (2, 16)  # s_probe of the one-call supertile entry's batches


@contextlib.contextmanager
def counting(sink: dict):
    """Set every kernel's count to 0, run the block, read the counts into
    ``sink``."""
    fns = {name: kernel_fns(name)[0] for name in KERNEL_META}
    for fn in fns.values():
        fn.launches = 0
    yield sink
    sink.update({name: fn.launches for name, fn in fns.items()})


def _require_launched(label: str, launches: dict, names, dev: torch.device) -> None:
    if dev.type == "cuda" and min(launches[n] for n in names) == 0:
        raise AssertionError(f"{label}: a kernel of the route never launched: "
                             f"{launches}")


def result_rows(res, contents):
    """A HybridTopK as ``search_batch``'s rows: (value, content, doc id) of
    each finite slot with a doc id inside the corpus."""
    vals, ids = res.values.cpu().numpy(), res.indices.cpu().numpy()
    return [[(float(v), contents[int(i)], int(i)) for v, i in zip(vr, ir)
             if 0 <= int(i) < len(contents) and np.isfinite(v)]
            for vr, ir in zip(vals, ids)]


def _same_tensors(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _latency_text(lat, n_q: int, sz: dict, kind: str, smi: str) -> tuple:
    p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
    qps = n_q / sum(lat)
    return qps, float(p50), float(p99), (
        f"qps {qps:.1f}, batch latency p50 {p50:.2f} ms p99 {p99:.2f} ms "
        f"(B={sz['batch']}, {kind}; {smi}; unsourced synthetic corpus)")


def serve_gated(run: dict, label: str, path: str, env: dict, sz: dict,
                dev: torch.device, clock: Clock, kind: str, smi: str) -> dict:
    """The index of ``run``, not re-indexed, served through ``search_batch``
    under the route gates ``env`` (serve_batches: its warm-up and timed
    batches, every certified row against the exact reference); then the
    first batch is served again and must be equal bit for bit, and one
    batch is profiled. Returns serve_batches' dict."""
    searcher = run["searcher"]
    with _environ(**env):
        out = serve_batches(searcher, label, path, run["warm"], run["batches"], sz,
                            dev, clock, kind, smi, main_path=False)
        if searcher.search_batch(run["batches"][0], top_k=TOP_K,
                                 log=False) != out["results"][0]:
            raise AssertionError(f"{label}: two servings of one batch differ")
        if dev.type == "cuda":
            out["stats"]["profile"] = profile_batch(searcher, run["batches"][0])
            clock.phase("profile", f"{label}: " + out["stats"]["profile"])
    out["stats"]["repeat_equal"] = True
    out["stats"]["gates"] = env
    clock.phase(label, f"{json.dumps(env)}: the first batch served twice is equal "
                "bit for bit")
    return out


def serve_kd_tiles(run: dict, sz: dict, dev: torch.device, clock: Clock, kind: str,
                   smi: str) -> dict:
    """One batch of the clustered index through ``hybrid_impact_topk`` at the
    impact ladder's first rung with ``kd_tiles=128`` (the rung the searcher
    takes on a clustered index of 1M docs or more): kernels counted, served
    twice bit for bit, certified rows against the exact reference, beside
    the same rung without the budget."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize, tiled_dense_topk
    from hybridsearch_tpu_torch.ops.hybrid import hybrid_impact_topk
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    label = "small-topic/impact/kd_tiles"
    s, qs = run["searcher"], run["batches"][0]
    idx, fu = s.indexer, s.config.fusion
    snap = idx.dense._snap
    kd, cp, pd = searcher_mod._IMPACT_LADDER[0]
    q = l2_normalize(idx.encoder.encode(qs).float())
    imp, enc = idx.bm25.encode_queries_impact(qs, p_depth=pd)

    def call(kd_tiles):
        return hybrid_impact_topk(q, snap.docs, imp, enc, TOP_K, fu.semantic_weight,
                                  fu.lexical_weight, bias=snap.bias, k_dense=kd,
                                  c_per_term=cp, p_depth=pd,
                                  n_alive=snap.n - idx.dense.deleted_count,
                                  kd_tiles=kd_tiles)

    launches: dict = {}
    with counting(launches):
        res = call(KD_TILES)
    _require_launched(label, launches, PATHS["clustered/impact"][1], dev)
    if not _same_tensors(call(KD_TILES), res):
        raise AssertionError(f"{label}: two calls on one batch differ")
    covered = tiled_dense_topk(q, snap.docs, kd, bias=snap.bias, with_stats=True,
                               probe_tiles=KD_TILES)[-1]
    rv, ri, fused = reference_topk(s, qs, TOP_K, fu.semantic_weight, fu.lexical_weight)
    exact = res.exact.cpu().numpy()
    checked, best_ok, jac = check_against_reference(result_rows(res, idx.contents),
                                                    exact, rv, ri, fused)
    del fused
    full = call(None)
    ms = time_ms(lambda: call(KD_TILES), dev, reps=3)
    full_ms = time_ms(lambda: call(None), dev, reps=3)
    stats = {"kd_tiles": KD_TILES, "rung": [kd, cp, pd], "launches": launches,
             "dense_covered": int(covered.sum()), "n_certified": int(exact.sum()),
             "n_certified_without_budget": int(full.exact.sum()),
             "rows_checked": checked, "uncertified_match": best_ok,
             "uncertified_jaccard_mean": float(np.mean(jac)) if jac else None,
             "ms": ms, "ms_without_budget": full_ms, "repeat_equal": True}
    clock.phase(label, (
        f"hybrid_impact_topk(kd_tiles={KD_TILES}) at rung (k_dense, c_per_term, "
        f"p_depth) = {(kd, cp, pd)} on {len(qs)} queries: launches "
        f"{json.dumps(launches)}; served twice bit for bit; dense arm covered "
        f"{stats['dense_covered']}/{len(qs)}; certified {stats['n_certified']} "
        f"(without the budget {stats['n_certified_without_budget']}), all {checked} "
        f"match the plain exact fused reference, {best_ok} uncertified match too "
        f"(jaccard@{TOP_K} mean {stats['uncertified_jaccard_mean']}); {ms:.2f} ms "
        f"vs {full_ms:.2f} ms without the budget ({kind}; {smi})"))
    return stats


def serve_one_call(run: dict, sz: dict, dev: torch.device, clock: Clock, kind: str,
                   smi: str) -> dict:
    """One batch of the clustered index through the one-call
    ``hybrid_supertile_topk`` at each s_probe of ONE_CALL_PROBES on the
    staged windows (``place_fused=False``): K1-K3 counted, equal bit for
    bit to ``super_prefix(s_max=s_probe)`` + one
    ``hybrid_supertile_topk_rung``, served twice bit for bit, certified
    rows against the exact reference."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.ops import supertile as st

    label = "small-topic/one-call"
    s, qs = run["searcher"], run["batches"][0]
    idx, fu = s.indexer, s.config.fusion
    snap = idx.dense._snap
    sw, lw = fu.semantic_weight, fu.lexical_weight
    sp, enc = idx.bm25.encode_queries_super(qs)
    q = l2_normalize(idx.encoder.encode(qs).float())
    n_alive = snap.n - idx.dense.deleted_count
    rv, ri, fused = reference_topk(s, qs, TOP_K, sw, lw)
    out = {}
    for s_probe in ONE_CALL_PROBES:
        def call():
            return st.hybrid_supertile_topk(q, snap.docs, sp, enc, TOP_K, sw, lw,
                                            bias=snap.bias, s_probe=s_probe,
                                            n_alive=n_alive, return_probes=True,
                                            place_fused=False)

        launches: dict = {}
        with counting(launches):
            res, probes = call()
        _require_launched(f"{label} s_probe={s_probe}", launches,
                          PATHS["clustered"][1], dev)
        pfx = st.super_prefix(q, snap.docs, sp, enc, bias=snap.bias, w_s=sw, w_l=lw,
                              s_max=s_probe)
        rung = st.hybrid_supertile_topk_rung(q, snap.docs, sp, enc, pfx, TOP_K, sw, lw,
                                             bias=snap.bias, s_probe=s_probe,
                                             n_alive=n_alive, place_fused=False)
        if not _same_tensors(res, rung):
            raise AssertionError(f"{label} s_probe={s_probe}: not equal to prefix + "
                                 "rung bit for bit")
        again, again_probes = call()
        if not (_same_tensors(again, res) and torch.equal(again_probes, probes)):
            raise AssertionError(f"{label} s_probe={s_probe}: two calls differ")
        exact = res.exact.cpu().numpy()
        checked, best_ok, jac = check_against_reference(
            result_rows(res, idx.contents), exact, rv, ri, fused)
        ms = time_ms(call, dev, reps=3)
        out[s_probe] = {"launches": launches, "n_certified": int(exact.sum()),
                        "rows_checked": checked, "uncertified_match": best_ok,
                        "uncertified_jaccard_mean": float(np.mean(jac)) if jac else None,
                        "probes": list(probes.shape), "ms": ms,
                        "equal_to_prefix_and_rung": True, "repeat_equal": True}
        clock.phase(label, (
            f"hybrid_supertile_topk(s_probe={s_probe}) on {len(qs)} queries: launches "
            f"{json.dumps(launches)}; equal bit for bit to super_prefix + "
            f"hybrid_supertile_topk_rung and to a second call; certified "
            f"{int(exact.sum())}, all {checked} match the plain exact fused reference, "
            f"{best_ok} uncertified match too; {ms:.2f} ms a batch ({kind}; {smi})"))
    del fused
    return out


INT8_LABEL = "dense/int8_swept"
DENSE_TOPK_LABEL = "dense/dense_topk"
INT8_PROBES = (4, 16)  # probe_tiles = m * TOP_K at the first rungs; then every tile
INT8_CHECK_ROWS = 8  # a rung with no uncertified row left runs on this many rows
COSINE_ROWS = 2048  # rows of the cosine_scores / pairwise_cosine check
COSINE_TOL = 1e-5  # against float64 numpy


def serve_int8_swept(run: dict, sz: dict, dev: torch.device, clock: Clock, kind: str,
                     smi: str) -> dict:
    """"dense/int8_swept": the small-topic index's dense rows (the clustered
    run's snapshot, not re-indexed) through ``quantize_corpus_int8`` and
    ``int8_swept_topk`` on the first batch's queries (B = 256, k = TOP_K)
    at probe_tiles = 4k, the uncertified rows escalated to 16k and then to
    every tile (a rung with none left runs on INT8_CHECK_ROWS rows, so each
    rung is checked and timed). Every certified row must equal the exact
    ``tiled_dense_topk``
    (K1, then K4 at tile grain; the sweep's pass 3 is K4 at tile grain too)
    in ids and, bit for bit, in values, and every row must be certified
    after the last rung; ``dense_topk`` must equal ``tiled_dense_topk``;
    ``cosine_scores`` and ``pairwise_cosine`` on COSINE_ROWS rows must
    match float64 numpy within COSINE_TOL. The references run outside any
    count; the rungs are counted on their own and must launch K4, and
    ``dense_topk`` on its own and must launch K1 and K4. The
    quantization, each rung and pass 1 alone are timed; the certified
    share at each rung and the int8 copy's bytes are printed."""
    from hybridsearch_tpu_torch.ops import dense as dm

    label = INT8_LABEL
    idx = run["searcher"].indexer
    snap = idx.dense._snap
    n = snap.n
    docs, bias = snap.docs[:n], snap.bias[:n]
    q = dm.l2_normalize(idx.encoder.encode(run["batches"][0]).float())
    B = q.shape[0]
    sync(dev)
    t = time.perf_counter()
    d8, scale, resid = dm.quantize_corpus_int8(docs)
    sync(dev)
    quantize_s = time.perf_counter() - t
    int8_bytes = d8.numel() * d8.element_size() + 4 * (scale.numel() + resid.numel())
    n_tiles = int(resid.shape[0])
    # the exact references, outside any count
    ev, ei = dm.tiled_dense_topk(q, docs, TOP_K, bias=bias)
    tv, ti = dm.tiled_dense_topk(q, docs, TOP_K)
    launches: dict = {}
    rungs = []
    with counting(launches):
        pending = torch.arange(B, device=dev)
        for probe in [m * TOP_K for m in INT8_PROBES] + [n_tiles]:
            escalated = bool(pending.numel())
            if not escalated:  # every row certified: the rung on a few rows
                pending = torch.arange(min(INT8_CHECK_ROWS, B), device=dev)
            qp = q[pending]
            v, i, c = dm.int8_swept_topk(qp, d8, scale, docs, resid, TOP_K,
                                         probe_tiles=probe, bias=bias)
            why = _topk_within(v[c], i[c], ev[pending][c], ei[pending][c], 0.0)
            if why:
                raise AssertionError(f"{label}: a certified row at probe_tiles "
                                     f"{probe} differs from tiled_dense_topk: {why}")
            rungs.append({"probe_tiles": probe, "rows": int(pending.numel()),
                          "certified": int(c.sum()), "escalated": escalated,
                          "queries": qp})
            pending = pending[~c] if escalated else pending[:0]
    if rungs[-1]["certified"] != rungs[-1]["rows"]:
        raise AssertionError(f"{label}: {rungs[-1]['rows'] - rungs[-1]['certified']} "
                             "rows uncertified with every tile probed")
    _require_launched(label, launches, ("super_scores_dedup",), dev)
    # dense_topk's tiled route (the card's size takes it at the default
    # block_n; the rehearsal's needs a smaller one), counted on its own
    topk_launches: dict = {}
    with counting(topk_launches):
        dv, di = dm.dense_topk(q, docs, TOP_K, block_n=min(4096, n // 4))
    why = _topk_within(dv, di, tv, ti, 0.0)
    if why:
        raise AssertionError(f"{label}: dense_topk differs from tiled_dense_topk: {why}")
    _require_launched(DENSE_TOPK_LABEL, topk_launches, ("tile_stats", "super_scores_dedup"),
                      dev)
    for r in rungs:  # timed apart from the counted run
        qp, probe = r.pop("queries"), r["probe_tiles"]
        r["ms"] = time_ms(lambda: dm.int8_swept_topk(qp, d8, scale, docs, resid, TOP_K,
                                                     probe_tiles=probe, bias=bias),
                          dev, reps=3)
    q8, inv, _rq = dm._quantize_queries(q)
    pass1_ms = time_ms(lambda: dm._int8_tile_maxima(q8, inv, d8, scale, bias, n,
                                                    262144, 128), dev, reps=3)
    exact_ms = time_ms(lambda: dm.tiled_dense_topk(q, docs, TOP_K, bias=bias), dev,
                       reps=3)
    rows = docs[:COSINE_ROWS]
    q64, d64 = q.double().cpu().numpy(), rows.double().cpu().numpy()
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    d64 /= np.linalg.norm(d64, axis=1, keepdims=True)
    cos_err = float(np.abs(dm.cosine_scores(q, rows).cpu().numpy() - q64 @ d64.T).max())
    pair_err = float(np.abs(dm.pairwise_cosine(rows).cpu().numpy() - d64 @ d64.T).max())
    if max(cos_err, pair_err) > COSINE_TOL:
        raise AssertionError(f"{label}: cosine_scores / pairwise_cosine off float64 "
                             f"by {cos_err} / {pair_err}")
    stats = {"n_docs": n, "queries": B, "k": TOP_K, "n_tiles": n_tiles,
             "quantize_s": quantize_s, "int8_bytes": int8_bytes,
             "float32_bytes": docs.numel() * 4, "rungs": rungs,
             "pass1_ms": pass1_ms, "exact_tiled_ms": exact_ms,
             "certified_first_rung": rungs[0]["certified"], "launches": launches,
             "dense_topk_launches": topk_launches,
             "cosine_max_err": cos_err, "pairwise_max_err": pair_err}
    rung_text = "; ".join(f"probe_tiles {r['probe_tiles']}: {r['certified']} of "
                          f"{r['rows']} {'' if r['escalated'] else 'check '}rows "
                          f"certified, {r['ms']:.3f} ms" for r in rungs)
    clock.phase(label, (
        f"{n} docs x {docs.shape[1]} (small-topic's clustered snapshot), B={B}, "
        f"k={TOP_K}: quantize_corpus_int8 {quantize_s * 1e3:.1f} ms, int8 copy "
        f"{int8_bytes} bytes (float32 {docs.numel() * 4}); {rung_text}; every "
        f"certified row equals tiled_dense_topk (ids; values bit for bit); pass 1 "
        f"alone {pass1_ms:.3f} ms, exact tiled_dense_topk {exact_ms:.3f} ms; "
        f"dense_topk = tiled_dense_topk; cosine_scores / pairwise_cosine on "
        f"{COSINE_ROWS} rows within {cos_err:.2e} / {pair_err:.2e} of float64; "
        f"the rungs' launches {json.dumps(launches)}, dense_topk's "
        f"{json.dumps(topk_launches)} ({kind}; {smi})"))
    return stats


TRACE_DIR = "chiprun_out/trace"  # QueryTracer's output; removed after the check
K1_TRACE_NAME = "tile_stats_kernel<"  # K1's kernel as the trace names it


def trace_batch(run: dict, dev: torch.device, clock: Clock) -> dict:
    """``QueryTracer.profile`` around one small-topic batch (the clustered
    run's ``search_batch``): one trace file must appear under TRACE_DIR and,
    on the card, name K1's kernel. The file is removed after the check."""
    import shutil

    from hybridsearch_tpu_torch.utils.tracing import QueryTracer

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    t = time.perf_counter()
    with QueryTracer(TRACE_DIR).profile() as log_dir:
        run["searcher"].search_batch(run["batches"][0], top_k=TOP_K, log=False)
        sync(dev)
    seconds = time.perf_counter() - t
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"QueryTracer: {len(files)} trace files in {log_dir}")
    path = os.path.join(log_dir, files[0])
    size = os.path.getsize(path)
    with open(path) as f:
        names_k1 = K1_TRACE_NAME in f.read()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    if dev.type == "cuda" and not names_k1:
        raise AssertionError(f"QueryTracer: the trace does not name K1 "
                             f"({K1_TRACE_NAME!r})")
    clock.phase("query tracer", (
        f"one small-topic batch profiled into {log_dir} in {seconds:.2f} s: "
        f"{files[0]}, {size} bytes, names K1's kernel: {names_k1} (removed)"))
    return {"seconds": seconds, "bytes": size, "names_k1": names_k1}


def serve_sparse(run: dict, sz: dict, dev: torch.device, clock: Clock, kind: str,
                 smi: str, hot_build_s: float) -> dict:
    """The source index of ``run``, not re-indexed, served through
    ``hybrid_sparse_topk`` (its default budgets) over
    ``BM25.encode_queries_sparse``: hot terms through their tile-bound table
    rows and bisection. The warm-up and the timed batches; K1 and K4 (pass
    3 of the dense top-k) must launch; the first batch again equal bit for
    bit; every certified row against the exact reference."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.ops.hybrid import hybrid_sparse_topk

    label = "small-topic/source/sparse"
    s = run["searcher"]
    idx, fu = s.indexer, s.config.fusion
    snap = idx.dense._snap
    po = idx.bm25._compacted_state().postings
    H = int((po.hot_rows_of >= 0).sum())
    table_bytes = (0 if po.hot_tile_bounds is None
                   else po.hot_tile_bounds.numel() * po.hot_tile_bounds.element_size())
    hot_queries = []

    def serve(qs):
        groups, hot = idx.bm25.encode_queries_sparse(qs)
        hot_queries.append(0 if hot is None else int((hot[2] > 0).any(axis=1).sum()))
        q = l2_normalize(idx.encoder.encode(qs).float())
        return hybrid_sparse_topk(q, snap.docs, po, groups, TOP_K, fu.semantic_weight,
                                  fu.lexical_weight, bias=snap.bias,
                                  n_alive=snap.n - idx.dense.deleted_count, hot=hot)

    serve(run["warm"])
    hot_queries.clear()
    launches: dict = {}
    lat, outs = [], []
    with counting(launches):
        for qs in run["batches"]:
            t = time.perf_counter()
            res = serve(qs)
            rows = result_rows(res, idx.contents)
            lat.append(time.perf_counter() - t)
            outs.append((res, rows))
    _require_launched(label, launches, ("tile_stats", "super_scores_dedup"), dev)
    if not _same_tensors(serve(run["batches"][0]), outs[0][0]):
        raise AssertionError(f"{label}: two servings of one batch differ")
    n_q = sum(len(qs) for qs in run["batches"])
    exact = [r.exact.cpu().numpy() for r, _rows in outs]
    checked, best_ok, jac = check_batches(s, run["batches"], [rw for _r, rw in outs],
                                          exact, fu.semantic_weight, fu.lexical_weight)
    cert = np.concatenate(exact)
    qps, p50, p99, text = _latency_text(lat, n_q, sz, kind, smi)
    stats = {"hot_terms": H, "hot_table_bytes": table_bytes,
             "hot_tables_build_s": hot_build_s,
             "queries_with_hot_terms": int(sum(hot_queries[:len(run["batches"])])),
             "launches": launches, "certified": float(cert.mean()),
             "n_certified": int(cert.sum()), "n_queries": int(cert.size),
             "best_effort_match": best_ok,
             "uncertified_jaccard_mean": float(np.mean(jac)) if jac else None,
             "qps": qps, "p50_ms": p50, "p99_ms": p99,
             "batch_ms": [x * 1e3 for x in lat], "repeat_equal": True}
    if dev.type == "cuda":
        stats["profile"] = profile_call(lambda: serve(run["batches"][0]))
        clock.phase("profile", f"{label}: " + stats["profile"])
    clock.phase(label, (
        f"hybrid_sparse_topk over encode_queries_sparse, {len(lat)} x {sz['batch']} "
        f"queries: {H} hot terms (a [{H + 1}, {po.hot_tile_bounds.shape[1] if H else 0}] "
        f"table, {table_bytes} bytes, built in {hot_build_s:.2f} s of the bm25_s "
        f"stage), {stats['queries_with_hot_terms']} of {n_q} queries hold one; "
        f"launches {json.dumps(launches)}; the first batch served twice is equal bit "
        f"for bit; certified {cert.mean():.4f} ({int(cert.sum())}/{cert.size}), all "
        f"{checked} match the plain exact fused reference, {best_ok} of "
        f"{n_q - checked} uncertified match too, their jaccard@{TOP_K} mean "
        f"{stats['uncertified_jaccard_mean']}; {text}"))
    return stats


def serve_ivf(sz: dict, dev: torch.device, seed: int, clock: Clock, kind: str,
              smi: str) -> dict:
    """"small-topic/ivf": the small-topic corpus indexed with
    ``layout="clustered"`` and ``ann="ivf"`` (sqrt(N) clusters, nprobe 8; the
    layout's k-means is the quantizer and the IVF adopts the dense buffer)
    and served in scatter mode (the IVF's top 2k scattered into zeros, BM25
    ``batch_scores``, [B, n] fusion): the warm-up and the timed batches, the
    first batch again equal bit for bit, every row against a plain scatter
    reference built from the same IVF top 2k. The IVF at full probe must
    equal ``DenseIndex.search``; recall@10 at nprobe 8 against it is a
    reading. The route runs none of the seven kernels (the JAX package's IVF
    has no Pallas kernel); their counts are read all the same. Runs in
    ``ivf_rank``, a process of its own."""
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    label = "small-topic/ivf"
    built, make_queries, timings = index_corpus("small-topic", "clustered", sz, dev,
                                                seed, clock, label, at_scale=False,
                                                ann="ivf")
    idx = built.indexer
    ivf, snap = idx.ivf, idx.dense._snap
    if ivf is None or ivf._docs_perm is not snap.docs:
        raise AssertionError(f"{label}: the IVF does not share the dense buffer")
    n_chunks = int(ivf._chunk_starts.shape[0])
    clock.phase("ivf index", (
        f"{label}: {n_chunks} chunks of at most {ivf._cap} rows (a chunk holds its "
        f"cluster's centroid), nprobe {ivf.nprobe}; the IVF holds the dense "
        f"snapshot's buffer ({snap.capacity} rows, {idx.dense.reserve_rows} "
        f"reserved): one corpus copy"))
    # "ivf bf16" set-up: a float32 and a bfloat16 IVFIndex.build of the same
    # rows (the dense snapshot's), seed and cluster count
    bf16 = build_ivf_pair(snap.docs[:snap.n], built.config, ivf, dev)
    searcher = Searcher(indexer=idx, use_query_memory=False, config=built.config,
                        semantic_mode="scatter")
    warm = make_queries(sz["batch"])
    batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]

    # full probe = exact search (64 queries: a full probe scores every chunk)
    q_full = idx.encoder.encode(batches[0][:64])
    fv, fi = ivf.search(q_full, TOP_K, nprobe=n_chunks)
    ev, ei = idx.dense.search(q_full, TOP_K)
    why = [rows_differ(list(zip(fv[b], [None] * TOP_K, fi[b])),
                       list(zip(ev[b], [None] * TOP_K, ei[b]))) for b in range(len(fv))]
    if any(w is not None for w in why):
        raise AssertionError(f"{label}: full-probe IVF differs from exact search: "
                             f"{next(w for w in why if w)}")

    k2 = min(2 * TOP_K, snap.n)
    peak = "not measured"
    if dev.type == "cuda":
        q_b = idx.encoder.encode(batches[0])
        sync(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ivf.search(q_b, k2)
        peak = int(torch.cuda.max_memory_allocated(dev) - base)
    searcher.search_batch(warm, top_k=TOP_K, log=False)
    launches: dict = {}
    lat, results = [], []
    with counting(launches):
        for qs in batches:
            t = time.perf_counter()
            results.append(searcher.search_batch(qs, top_k=TOP_K, log=False))
            lat.append(time.perf_counter() - t)
    if searcher.search_batch(batches[0], top_k=TOP_K, log=False) != results[0]:
        raise AssertionError(f"{label}: two servings of one batch differ")
    fu = searcher.config.fusion
    checked = 0
    recalls = []
    for qs, res in zip(batches, results):
        qv = idx.encoder.encode(qs)
        tv, ti = ivf.search(qv, k2)
        rv, ri, fused = scatter_reference(searcher, qs, TOP_K, fu.semantic_weight,
                                          fu.lexical_weight, top_ids=ti)
        c, _b, _j = check_against_reference(res, np.ones(len(qs), bool), rv, ri, fused)
        checked += c
        del fused
        _v, got = ivf.search(qv, TOP_K)
        _v, want = idx.dense.search(qv, TOP_K)
        recalls += [len(set(g) & set(w)) / TOP_K for g, w in zip(got, want)]
        serve_ivf_pair(bf16, qv, want, snap.docs, dev)
    n_q = sum(len(qs) for qs in batches)
    qps, p50, p99, text = _latency_text(lat, n_q, sz, kind, smi)
    stats = {"index_timings_s": timings, "chunks": n_chunks, "chunk_cap": ivf._cap,
             "nprobe": ivf.nprobe, "capacity": snap.capacity,
             "reserve_rows": idx.dense.reserve_rows, "one_corpus_copy": True,
             "full_probe_equals_exact": True, "launches": launches,
             "rows_checked": checked, f"recall@{TOP_K}_nprobe_{ivf.nprobe}":
             float(np.mean(recalls)), "qps": qps, "p50_ms": p50, "p99_ms": p99,
             "batch_ms": [x * 1e3 for x in lat], "repeat_equal": True}
    stats["ivf_search_peak_bytes"] = peak
    stats["bf16"] = report_ivf_pair(bf16, float(np.mean(recalls)), clock, kind, smi)
    if dev.type == "cuda":
        stats["profile"] = profile_batch(searcher, batches[0])
        clock.phase("profile", f"{label}: " + stats["profile"])
    clock.phase(label, (
        f"semantic_mode='scatter' through the IVF, {len(lat)} x {sz['batch']} queries, "
        f"launches {json.dumps(launches)} (no kernel on this route); full probe "
        f"equals DenseIndex.search on {len(fv)} queries; the first batch served "
        f"twice is equal bit for bit; all {checked} rows match the plain scatter "
        f"reference over the same IVF top {k2}; recall@{TOP_K} at nprobe "
        f"{ivf.nprobe} against exact search {np.mean(recalls):.4f} (a reading); IVF "
        f"search peak {peak} bytes at B={sz['batch']}, k={k2}; {text}"))
    return stats


BF16_TIE = 2.0 ** -8  # a unit row's bfloat16 rounding moves a score at most 2^-9


def build_ivf_pair(rows: torch.Tensor, config, ivf, dev: torch.device) -> dict:
    """"ivf bf16"'s two indexes: ``IVFIndex.build`` of ``rows`` in float32
    and with ``storage_dtype=torch.bfloat16``, with the IVF run's cluster
    count (the layout k-means'), nprobe and seed; each build timed."""
    from hybridsearch_tpu_torch.index.ivf import IVFIndex

    n = rows.shape[0]
    clusters = config.index.ivf_clusters or max(2, int(np.sqrt(n)))
    pair = {"clusters": clusters, "lat": {"float32": [], "bfloat16": []},
            "recalls": {"float32": [], "bfloat16": []}, "rows": 0, "swaps": 0}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        sync(dev)
        t = time.perf_counter()
        pair[name] = IVFIndex(dim=rows.shape[1], n_clusters=clusters, nprobe=ivf.nprobe,
                              chunk_cap=config.index.ivf_chunk_cap, seed=ivf.seed,
                              device=dev, storage_dtype=dtype).build(rows)
        sync(dev)
        pair[f"{name}_build_s"] = time.perf_counter() - t
    return pair


def serve_ivf_pair(pair: dict, qv: torch.Tensor, exact_ids: np.ndarray,
                   rows: torch.Tensor, dev: torch.device) -> None:
    """One batch through both indexes of ``build_ivf_pair`` (each search
    timed): the bfloat16 index's ids must equal the float32 index's but
    where the float32 scores (over ``rows``) of the two docs at a slot lie
    within BF16_TIE; recall@TOP_K of each against ``exact_ids``."""
    out = {}
    for name in ("float32", "bfloat16"):
        sync(dev)
        t = time.perf_counter()
        out[name] = pair[name].search(qv, TOP_K)
        pair["lat"][name].append(time.perf_counter() - t)
        pair["recalls"][name] += [len(set(g) & set(w)) / TOP_K
                                  for g, w in zip(out[name][1], exact_ids)]
    (fv, fi), (bv, bi) = out["float32"], out["bfloat16"]
    qn = qv.float() / qv.float().norm(dim=1, keepdim=True)
    for b, j in zip(*np.nonzero(bi != fi)):
        score = float(qn[b] @ rows[int(bi[b][j])].float())
        if abs(score - fv[b][j]) > BF16_TIE:
            raise AssertionError(f"ivf bf16: query {b} slot {j}: doc {bi[b][j]} "
                                 f"({score}) vs the float32 index's {fi[b][j]} "
                                 f"({fv[b][j]}): no near-tie")
    pair["rows"] += len(fi)
    pair["swaps"] += int((bi != fi).sum())


def report_ivf_pair(pair: dict, layout_recall: float, clock: Clock, kind: str,
                    smi: str) -> dict:
    """"ivf bf16"'s gate on the bytes and its line: the bfloat16 rows take
    half the float32 rows' bytes; recall@TOP_K, build and batch times."""
    f32, b16 = pair["float32"], pair["bfloat16"]
    if b16._docs_perm.dtype != torch.bfloat16 or (
            2 * b16._docs_perm.nbytes != f32._docs_perm.nbytes):
        raise AssertionError(f"ivf bf16: docs_perm {b16._docs_perm.dtype}, "
                             f"{b16._docs_perm.nbytes} bytes vs {f32._docs_perm.nbytes}")
    stats = {"clusters": pair["clusters"], "nprobe": f32.nprobe,
             "docs_perm_bytes": {"float32": f32._docs_perm.nbytes,
                                 "bfloat16": b16._docs_perm.nbytes},
             "rows_checked": pair["rows"], "id_swaps_within_tie": pair["swaps"]}
    for name in ("float32", "bfloat16"):
        stats[name] = {"build_s": pair[f"{name}_build_s"],
                       f"recall@{TOP_K}": float(np.mean(pair["recalls"][name])),
                       "batch_ms": [x * 1e3 for x in pair["lat"][name]]}
    clock.phase("ivf bf16", (
        f"IVFIndex.build of the small-topic rows, {pair['clusters']} clusters, nprobe "
        f"{f32.nprobe}: float32 built in {stats['float32']['build_s']:.2f} s, bfloat16 "
        f"in {stats['bfloat16']['build_s']:.2f} s (docs_perm "
        f"{stats['docs_perm_bytes']['bfloat16']} bytes, half of "
        f"{stats['docs_perm_bytes']['float32']}); on {pair['rows']} queries the ids "
        f"equal the float32 index's but {pair['swaps']} slots inside 2^-8 "
        f"near-ties; recall@{TOP_K} against exact search: bfloat16 "
        f"{stats['bfloat16'][f'recall@{TOP_K}']:.4f}, float32 "
        f"{stats['float32'][f'recall@{TOP_K}']:.4f} (the layout-adopting IVF "
        f"{layout_recall:.4f}); batch p50 {np.median(stats['bfloat16']['batch_ms']):.2f}"
        f" / {np.median(stats['float32']['batch_ms']):.2f} ms ({kind}; {smi})"))
    return stats


# -- the lifecycle run: a grown, tombstoned, saved and reloaded index ----------

# -- the mesh: four ranks on one card --------------------------------------------

MESH_RANKS = 4
MESH_DIR = "chiprun_out/mesh"  # the ranks' stores, the save and the world's files
# K1 (the shards' stats sweeps), K3 (their resident placement) and K4 at tile
# grain (their resident scores, tile_scores)
MESH_KERNELS = ("tile_stats", "place_windows", "super_scores_dedup")
MESH_CHECK_QUERIES = 32  # queries of the first batch through BM25.search
MESH_IVF_QUERIES = 8  # queries through the sharded IVF at full probe
MESH_SPANS = ("mesh_all_reduce", "mesh_all_gather")


def _rehearse_rank(sz: dict) -> None:
    """A rehearsal rank takes the card's routes as the rehearsal's parent
    does: the kernel routes with their plain versions, the at-scale paths
    at its tiny size."""
    from hybridsearch_tpu_torch.ops import bm25 as bm25_mod
    from hybridsearch_tpu_torch.ops import dense as dense_mod
    from hybridsearch_tpu_torch.ops import supertile as supertile_mod
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    dense_mod._on_card = supertile_mod._on_card = lambda t: True
    searcher_mod.SPARSE_HYBRID_MIN_DOCS = 0
    bm25_mod.HOT_DF_THRESHOLD = REHEARSAL_HOT_DF


def _bare_rows(results):
    """search_batch rows without their contents: [(value, doc id), ...]."""
    return [[(v, i) for v, _c, i in row] for row in results]


# "mesh routes": the four routes the mesh gained in this slice, inside the
# mesh world after its checks: (a) DenseIndex.add past the capacity by
# grow_extra rows, (b) 1% deleted and DenseIndex.compact, (c) a small
# sharded Indexer grown past its capacity, exported to JSON and imported
# on one device, (d) HybridBM25Pipeline.search on the mesh index
MESH_ROUTE_SIZES = {
    "card": dict(grow_extra=4096, small_docs=16384, small_add=1024, hb_queries=16,
                 small_round=4096),
    "cpu": dict(grow_extra=64, small_docs=1024, small_add=128, hb_queries=4,
                small_round=256),
}
MESH_ROUTE_DELETE_SHARE = 0.01
MESH_EXPORT = "small_export.json"  # route (c)'s file, under MESH_DIR
MESH_ROUTE_SAMPLE = 4096  # moved and unmoved rows each read back bit for bit
MESH_ROUTE_TOL = 1e-6  # (c)'s vectors and (d)'s values against one device's


def mesh_grow_rows(n_rows: int, dim: int, seed: int) -> torch.Tensor:
    """The rows route (a) adds, the same on every rank and in the parent."""
    return torch.randn((n_rows, dim), generator=torch.Generator().manual_seed(seed + 11))


def mesh_dead_rows(n: int, seed: int) -> np.ndarray:
    """The rows route (b) tombstones: MESH_ROUTE_DELETE_SHARE of n."""
    return np.random.default_rng(seed + 12).choice(
        n, size=int(n * MESH_ROUTE_DELETE_SHARE), replace=False)


def _rows_read_back(new_idx, old_idx, new_ids: np.ndarray, old_ids: np.ndarray) -> bool:
    """Rows ``new_ids`` of ``new_idx`` equal rows ``old_ids`` of ``old_idx``
    bit for bit (collective reads on a mesh)."""
    return bool(np.array_equal(new_idx.get_vectors(new_ids), old_idx.get_vectors(old_ids)))


def mesh_routes(idx, searcher, encoder, mesh, job: dict, queries, first_rows,
                small_docs) -> dict:
    """The "mesh routes" of one rank (see MESH_ROUTE_SIZES). (a) and (b) run
    on a DenseIndex that adopts the mesh index's snapshot: copy on write
    leaves the served index as it was, and after (a) the served searcher's
    ``search_batch`` of ``queries`` (counted on its own) must give
    ``first_rows`` again through the ladder. The grown index's own
    ``search`` calls are counted too: a mesh DenseIndex searches by the
    collective scan (``sharded_dense_topk``, as the JAX mesh does), which
    launches no kernel. (c)'s export is imported on one device by the
    parent (``mesh_export_single``). Returns what the parent holds to the
    single device, each rank's rows moved, seconds and counts."""
    import hashlib

    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.index.dense_index import DenseIndex
    from hybridsearch_tpu_torch.pipelines import HybridBM25Pipeline

    sizes = MESH_ROUTE_SIZES["cpu" if job["rehearsal"] else "card"]
    dev = mesh.device
    base = idx.dense
    snap0 = base._snap
    q = encoder.encode(queries)
    out = {}
    # (a) growth past the capacity
    grown = DenseIndex(dim=base.dim, capacity_round=base.capacity_round, mesh=mesh,
                       block_n=base.block_n)
    grown._snap, grown.deleted_count = snap0, base.deleted_count
    n0, cap0 = snap0.n, snap0.capacity
    rows = mesh_grow_rows(cap0 - n0 + sizes["grow_extra"], base.dim, job["seed"])
    sync(dev)
    t = time.perf_counter()
    grown.add(rows.to(dev))
    sync(dev)
    out["grow_s"], out["grow_moved"] = time.perf_counter() - t, grown.moved_rows
    out["grow_capacity"] = (cap0, grown.capacity, grown.n_docs)
    per0, per1 = cap0 // MESH_RANKS, grown.capacity // MESH_RANKS
    moved = np.flatnonzero(np.arange(n0) // per0 != np.arange(n0) // per1)
    rng = np.random.default_rng(job["seed"])
    sample = np.union1d(  # rows that changed rank, and rows that did not
        rng.choice(moved, size=min(MESH_ROUTE_SAMPLE, moved.size), replace=False),
        rng.choice(n0, size=min(MESH_ROUTE_SAMPLE, n0), replace=False))
    out["grow_rows_equal"] = _rows_read_back(grown, base, sample, sample)
    out["grow_search_launches"] = {}
    with counting(out["grow_search_launches"]):
        out["grow_search"] = grown.search(q, TOP_K)
    out["after_grow_launches"] = {}
    with counting(out["after_grow_launches"]):
        out["after_grow_equal"] = _bare_rows(searcher.search_batch(
            queries, top_k=TOP_K, log=False)) == first_rows
    # (b) 1% tombstoned, then compaction
    grown.delete(mesh_dead_rows(grown.n_docs, job["seed"]))
    sync(dev)
    t = time.perf_counter()
    mapping = grown.compact()
    sync(dev)
    out["compact_s"], out["compact_moved"] = time.perf_counter() - t, grown.moved_rows
    out["compact_capacity"] = (grown.capacity, grown.n_docs, grown.deleted_count)
    out["compact_mapping_sha"] = hashlib.sha256(mapping.tobytes()).hexdigest()
    kept = sample[mapping[sample] >= 0]
    out["compact_rows_equal"] = _rows_read_back(grown, base, mapping[kept], kept)
    out["compact_search_launches"] = {}
    with counting(out["compact_search_launches"]):
        out["compact_search"] = grown.search(q, TOP_K)
    out["served_index_kept"] = base._snap is snap0
    del grown, rows
    # (d) HybridBM25Pipeline on the mesh index
    hb = HybridBM25Pipeline(encoder=encoder, mesh=mesh)
    hb.indexer.close()
    hb.indexer, hb.searcher = idx, searcher
    hb_queries = list(queries[:sizes["hb_queries"]])
    hb.search(hb_queries[0], top_k=TOP_K)  # warm-up
    t = time.perf_counter()
    out["hybrid_bm25"] = [[(v, i) for v, _c, i in hb.search(text, top_k=TOP_K).results]
                          for text in hb_queries]
    out["hybrid_bm25_s"], out["hybrid_bm25_queries"] = time.perf_counter() - t, hb_queries
    out["hybrid_bm25_weights"] = (hb.semantic_weight, hb.bm25_weight)
    # (c) a small sharded Indexer: an add past its capacity, the JSON export
    # (rank 0 writes it)
    cfg = EngineConfig()
    cfg.index.dim, cfg.index.capacity_round = base.dim, sizes["small_round"]
    first, more = small_docs[:sizes["small_docs"]], small_docs[sizes["small_docs"]:]
    small = Indexer(db_path=":memory:", encoder=encoder, config=cfg, mesh=mesh)
    small.index_documents(first)
    cap_small = small.dense.capacity
    t = time.perf_counter()
    small.add_documents(more)
    sync(dev)
    out["small_add_s"], out["small_moved"] = time.perf_counter() - t, small.dense.moved_rows
    out["small_capacity"] = (cap_small, small.dense.capacity, small.dense.n_docs)
    path = os.path.join(job["dir"], MESH_EXPORT)
    t = time.perf_counter()
    small.export_json(path)
    out["export_s"], out["export_bytes"] = time.perf_counter() - t, os.path.getsize(path)
    out["small_contents_sha"] = hashlib.sha256("\n".join(small.contents).encode()).hexdigest()
    out["small_doc_ids"] = small.doc_ids
    small.close()
    return out


def mesh_export_single(world, sz: dict, dev: torch.device, seed: int,
                       rehearsal: bool) -> dict:
    """Route (c) on one device, in the parent while the ranks run: the same
    steps as the ranks' small Indexer (its docs, config and encoder), then,
    once rank 0's export appears (whole: ``export_json`` renames it into
    place), ``import_json`` of it on one device. Returns the one device's
    contents digest and ids beside what the import holds; {} if a rank
    ended before the file appeared (``join`` then raises)."""
    import hashlib

    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.index.builder import Indexer

    sizes = MESH_ROUTE_SIZES["cpu" if rehearsal else "card"]
    docs = make_corpus(sz, "small-topic", seed)[0][:sizes["small_docs"] + sizes["small_add"]]
    cfg = EngineConfig()
    cfg.index.dim, cfg.index.capacity_round = sz["dim"], sizes["small_round"]
    encoder = hashing_encoder(sz, dev)
    one = Indexer(db_path=":memory:", encoder=encoder, config=cfg, device=dev)
    one.index_documents(docs[:sizes["small_docs"]])
    one.add_documents(docs[sizes["small_docs"]:])
    path = os.path.join(MESH_DIR, MESH_EXPORT)
    while not os.path.exists(path):
        if not all(p.is_alive() for p in world.ctx.processes):
            return {}
        time.sleep(0.1)
    t = time.perf_counter()
    imp = Indexer(db_path=":memory:", encoder=encoder, config=cfg, device=dev)
    imp.import_json(path)
    import_s = time.perf_counter() - t
    want = one.dense.get_vectors(list(range(one.dense.n_docs)))
    got = imp.dense.get_vectors(list(range(imp.dense.n_docs)))
    return {"contents_sha": hashlib.sha256("\n".join(one.contents).encode()).hexdigest(),
            "documents_equal": imp.contents == one.contents, "doc_ids": one.doc_ids,
            "capacity": one.dense.capacity, "import_s": import_s,
            "vectors_max_err": float(np.abs(got - want).max()),
            "vectors_bit_equal": bool(np.array_equal(got, want))}


def mesh_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of "small-topic/mesh4" (prints nothing; its report goes back
    to the parent): the small-topic corpus indexed on the mesh
    (``layout="clustered"``, ``ann="ivf"``; this rank keeps its quarter of
    each index), a warm-up and the timed batches through
    ``Searcher.search_batch`` with every kernel's count set to 0 just
    before and read just after (and the rungs each batch's ladder probed),
    the first batch again, then once more under ``HST_SUPER_HYBRID=0``
    through the exact collective program, ``DenseIndex.search``,
    ``BM25.search`` and the sharded IVF at full probe on the first batch's
    queries, then ``Indexer.save`` and ``Indexer.load`` onto the mesh and
    the first batch from the loaded index. Last, the "train mesh" step
    (``mesh_train_step``) on a data 2 x model 2 mesh of the same ranks."""
    import hashlib

    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.parallel import collectives
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS, GLOBAL_TIMER

    sz, dev = job["sz"], torch.device(job["device"])
    if job["rehearsal"]:
        _rehearse_rank(sz)
    mesh = build_mesh(device=dev)
    out = {"rank": rank}
    t0 = time.perf_counter()
    docs, make_queries = make_corpus(sz, "small-topic", job["seed"])
    # the first batch of the "train contrastive" phase (the parent's)
    train_pairs = train_texts(docs, "contrastive", 1, job["train_B"], job["seed"])[0]
    cfg = EngineConfig()
    cfg.index.layout, cfg.index.ann, cfg.index.dim = "clustered", "ivf", sz["dim"]
    db = os.path.join(job["dir"], f"store_{rank}.db")
    encoder = hashing_encoder(sz, dev)
    searcher = Searcher(config=cfg, use_query_memory=False, encoder=encoder,
                        mesh=mesh, db_path=db)
    idx = searcher.indexer
    out["index_timings_s"] = idx.index_documents(docs)["timings_s"]
    sizes = MESH_ROUTE_SIZES["cpu" if job["rehearsal"] else "card"]
    small_docs = docs[:sizes["small_docs"] + sizes["small_add"]]  # "mesh routes" (c)
    del docs
    t = time.perf_counter()
    ssp = idx.bm25.super_postings_sharded()
    sync(dev)
    out["super_postings_s"] = time.perf_counter() - t
    out["build_s"] = time.perf_counter() - t0
    out["local_supertiles"] = int(ssp.sup_max.shape[1])
    out["local_rows"] = int(idx.dense._snap.docs.shape[0])
    out["contents_sha"] = hashlib.sha256("\n".join(idx.contents).encode()).hexdigest()
    warm = make_queries(sz["batch"])
    batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]
    searcher.search_batch(warm, top_k=TOP_K, log=False)

    # each batch's ladder rungs (s_probe) and calls of the exact program
    rungs, exact_calls = [], []
    real_super, real_exact = (collectives.sharded_supertile_topk,
                              collectives.sharded_hybrid_topk)

    def ladder_rung(*a, **kw):
        rungs[-1].append(kw["s_probe"])
        return real_super(*a, **kw)

    def exact_program(*a, **kw):
        exact_calls[-1] += 1
        return real_exact(*a, **kw)

    GLOBAL_TIMER.reset()
    launches, lat, results, fallbacks = {}, [], [], []
    collectives.sharded_supertile_topk = ladder_rung
    collectives.sharded_hybrid_topk = exact_program
    try:
        with counting(launches):
            for qs in batches:
                rungs.append([])
                exact_calls.append(0)
                before = GLOBAL_COUNTERS.get("hybrid_sharded_uncertified")
                t = time.perf_counter()
                results.append(_bare_rows(searcher.search_batch(qs, top_k=TOP_K,
                                                                log=False)))
                lat.append(time.perf_counter() - t)
                fallbacks.append(GLOBAL_COUNTERS.get("hybrid_sharded_uncertified")
                                 - before)
        spans = {name: row for name, row in GLOBAL_TIMER.stats().items()
                 if name in MESH_SPANS + ("hybrid_sharded", "encode")}
        out.update(launches=launches, batch_ms=[x * 1e3 for x in lat],
                   results=results, fallbacks=fallbacks, spans=spans,
                   rungs=rungs, exact_calls=exact_calls,
                   batches=batches if rank == 0 else None)
        rungs.append([])
        exact_calls.append(0)
        out["repeat_equal"] = _bare_rows(searcher.search_batch(
            batches[0], top_k=TOP_K, log=False)) == results[0]
        # the first batch through the exact collective program on every rank
        rungs.append([])
        exact_calls.append(0)
        os.environ["HST_SUPER_HYBRID"] = "0"
        exact_launches = {}
        t = time.perf_counter()
        with counting(exact_launches):
            out["exact_rows"] = _bare_rows(searcher.search_batch(
                batches[0], top_k=TOP_K, log=False))
        out["exact_ms"] = (time.perf_counter() - t) * 1e3
        out["exact_launches"], out["exact_program_calls"] = exact_launches, exact_calls[-1]
    finally:
        os.environ.pop("HST_SUPER_HYBRID", None)
        collectives.sharded_supertile_topk = real_super
        collectives.sharded_hybrid_topk = real_exact

    q = encoder.encode(batches[0])
    out["dense"] = idx.dense.search(q, TOP_K)
    out["ivf_full"] = idx.ivf.search(q[:MESH_IVF_QUERIES], TOP_K, nprobe=10**9)
    out["ivf_chunks"] = int(idx.ivf._chunk_starts.shape[0])
    out["bm25"] = [idx.bm25.search(text, top_k=TOP_K)
                   for text in batches[0][:MESH_CHECK_QUERIES]]
    if dev.type == "cuda":
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    out["routes"] = mesh_routes(idx, searcher, encoder, mesh, job, batches[0],
                                results[0], small_docs)
    del small_docs

    t = time.perf_counter()
    save_dir = os.path.join(job["dir"], "saved")
    idx.save(save_dir)
    out["save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loaded = Indexer.load(save_dir, encoder=encoder, db_path=db, mesh=mesh)
    out["load_s"] = time.perf_counter() - t
    ls = Searcher(indexer=loaded, use_query_memory=False, config=loaded.config)
    # the ladder's kernels on the saved and loaded index
    out["loaded_launches"] = {}
    with counting(out["loaded_launches"]):
        out["loaded_equal"] = _bare_rows(ls.search_batch(batches[0], top_k=TOP_K,
                                                         log=False)) == results[0]
    del ls, loaded, searcher, idx
    out["train"] = dict(mesh_train_step(dev, job, train_pairs, rank), rank=rank)
    return out


def nccl_rank(rank: int, world: int, job: dict) -> dict:
    """The one rank of the world-1 batch: regime 1's corpus indexed on a
    mesh of one rank over the job's backend and one batch served through
    ``Searcher.search_batch`` (the exact collective program)."""
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    sz, dev = job["sz"], torch.device(job["device"])
    if job["rehearsal"]:
        _rehearse_rank(sz)
    mesh = build_mesh(device=dev)
    docs, make_queries = make_corpus(sz, "small-topic", job["seed"])
    cfg = EngineConfig()
    cfg.index.dim = sz["dim"]
    searcher = Searcher(config=cfg, use_query_memory=False,
                        encoder=hashing_encoder(sz, dev), mesh=mesh)
    searcher.indexer.index_documents(docs)
    make_queries(sz["batch"])  # regime 1's warm-up batch
    qs = make_queries(sz["batch"])
    t = time.perf_counter()
    rows = _bare_rows(searcher.search_batch(qs, top_k=TOP_K, log=False))
    return {"backend": mesh.backend, "queries": qs, "rows": rows,
            "ms": (time.perf_counter() - t) * 1e3}


def _with_contents(rows, contents):
    return [[(v, contents[i], i) for v, i in row] for row in rows]


def _ranks_equal(outs, keys) -> None:
    import pickle

    for key in keys:
        for o in outs[1:]:
            if pickle.dumps(o[key]) != pickle.dumps(outs[0][key]):
                raise AssertionError(f"mesh4: rank {o['rank']}'s {key} differs from "
                                     "rank 0's")


def start_mesh(sz: dict, dev: torch.device, seed: int, rehearsal: bool) -> tuple:
    """Start "small-topic/mesh4"'s four ranks (``mesh_rank``; gloo, sharing
    the one card, since NCCL refuses two ranks on a device) and return at
    once, so the parent indexes its next corpus while the ranks build
    theirs; ``finish_mesh`` collects them. Returns (world, start time)."""
    import shutil

    from hybridsearch_tpu_torch.parallel.dryrun import start

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    B, L = TRAIN_SHAPES["cpu" if rehearsal else "card"]["contrastive"]
    job = {"sz": sz, "seed": seed, "device": dev.type, "rehearsal": rehearsal,
           "dir": os.path.abspath(MESH_DIR), "train_B": B, "train_L": L,
           "train_ckpt": None if rehearsal else MINILM_CKPT}
    return (start(mesh_rank, MESH_RANKS, args=(job,), device=dev.type,
                  threads=REHEARSAL_THREADS if rehearsal else 2,
                  workdir=os.path.join(MESH_DIR, "world"), timeout_s=420),
            time.perf_counter(), seed, rehearsal)


def finish_mesh(started: tuple, run: dict, sz: dict, dev: torch.device,
                clock: Clock, kind: str, smi: str) -> dict:
    """"small-topic/mesh4": four ranks serve small-topic's corpus on a
    mesh, a quarter of it each (``start_mesh``). Every rank's rows, dense,
    BM25 and IVF results must be equal; every row must equal the plain
    exact fused reference over the single-device index of ``run`` (same
    corpus, same clustered permutation, checked by digest): a batch is
    served whole by the certified ladder or by the exact collective
    program; the first batch again, and from the index saved and loaded
    onto the mesh, bit for bit; DenseIndex.search equal to the single
    device's exact top-k, BM25.search to the single device's, the sharded
    IVF at full probe to exact search; K1, K3 and K4 launched on every
    rank."""
    import shutil

    label = "small-topic/mesh4"
    world, t, seed, rehearsal = started
    t_join = time.perf_counter()
    try:
        export = mesh_export_single(world, sz, dev, seed, rehearsal)
        outs = world.join()
    finally:
        saved_bytes = sum(os.path.getsize(os.path.join(r, f))
                          for r, _d, fs in os.walk(MESH_DIR) for f in fs)
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    world_s = time.perf_counter() - t
    wait_s = time.perf_counter() - t_join
    for o in outs:
        stages = ", ".join(f"{k} {v:.1f}" for k, v in o["index_timings_s"].items())
        print(f"    rank {o['rank']}: build {o['build_s']:.1f} s ({stages}; "
              f"super_postings_sharded {o['super_postings_s']:.1f}); {o['local_rows']} "
              f"rows, {o['local_supertiles']} supertiles; save {o['save_s']:.1f} s, "
              f"load {o['load_s']:.1f} s; peak {o.get('peak_bytes', 'not measured')} "
              "bytes", flush=True)
    clock.phase("index_documents", f"{label}: {MESH_RANKS} ranks, "
                f"{sz['n_docs']} docs, the world's wall {world_s:.1f} s (started "
                f"before small-topic/source's build, which ran beside it with the "
                f"minilm run's build; then waited for {wait_s:.1f} s); the save "
                f"{saved_bytes} bytes, removed")
    _ranks_equal(outs, ("results", "fallbacks", "rungs", "exact_calls", "exact_rows",
                        "dense", "ivf_full", "bm25", "contents_sha", "repeat_equal",
                        "loaded_equal"))
    clock.phase(label, "every rank's rows, fallbacks, ladder rungs, exact-program "
                "rows, DenseIndex.search, IVF and BM25.search results are equal "
                "(each rank checked against rank 0)")
    o0 = outs[0]
    if not all(o["repeat_equal"] for o in outs):
        raise AssertionError(f"{label}: two servings of one batch differ")
    if not all(o["loaded_equal"] for o in outs):
        raise AssertionError(f"{label}: the saved and loaded index serves other rows")
    for o in outs:
        _require_launched(f"{label} rank {o['rank']}", o["launches"], MESH_KERNELS, dev)
        # the exact program serves a batch the ladder leaves, and nothing else
        if (o["exact_program_calls"] != 1
                or o["exact_calls"][:len(o["fallbacks"])] != o["fallbacks"]):
            raise AssertionError(f"{label} rank {o['rank']}: the exact collective "
                                 f"program ran {o['exact_calls']} times a batch, "
                                 f"for fallbacks {o['fallbacks']}")

    single = run["searcher"]
    import hashlib

    sha = hashlib.sha256("\n".join(single.indexer.contents).encode()).hexdigest()
    if sha != o0["contents_sha"]:
        raise AssertionError(f"{label}: the mesh's doc order is not the single "
                             "device's clustered order")
    contents = single.indexer.contents
    batches = o0["batches"]
    fu = single.config.fusion
    checked, _b, _j = check_batches(
        single, batches, [_with_contents(r, contents) for r in o0["results"]],
        [np.ones(len(qs), bool) for qs in batches], fu.semantic_weight,
        fu.lexical_weight)
    exact_checked, _b, _j = check_batches(
        single, batches[:1], [_with_contents(o0["exact_rows"], contents)],
        [np.ones(len(batches[0]), bool)], fu.semantic_weight, fu.lexical_weight)
    q = single.indexer.encoder.encode(batches[0])
    want_v, want_i = single.indexer.dense.search(q, TOP_K)
    for name, (gv, gi) in (("DenseIndex.search", o0["dense"]),
                           ("the IVF at full probe", o0["ivf_full"])):
        why = [rows_differ(list(zip(gv[b], [None] * TOP_K, gi[b])),
                           list(zip(want_v[b], [None] * TOP_K, want_i[b])))
               for b in range(len(gv))]
        if any(w is not None for w in why):
            raise AssertionError(f"{label}: {name} differs from the single device's "
                                 f"exact search: {next(w for w in why if w)}")
    for text, got in zip(batches[0], o0["bm25"]):
        want = single.indexer.bm25.search(text, top_k=TOP_K)
        why = rows_differ([(v, None, i) for i, v in got], [(v, None, i) for i, v in want])
        if why is not None:
            raise AssertionError(f"{label}: BM25.search of {text!r}: {why}")
    routes = check_mesh_routes(outs, single, q, export, seed, dev, clock, kind, smi)
    n_q = sum(len(qs) for qs in batches)
    lat = [x / 1e3 for x in o0["batch_ms"]]
    qps, p50, p99, text = _latency_text(lat, n_q, sz, kind, smi)
    whole = sum(f == 0 for f in o0["fallbacks"])
    ns_local = o0["local_supertiles"]
    # the rung (s_probe) at which each certified batch closed
    closed = {}
    for f, r in zip(o0["fallbacks"], o0["rungs"]):
        if f == 0:
            closed[r[-1]] = closed.get(r[-1], 0) + 1
    rungs_text = ", ".join(f"{n} at s_probe {s}" + (" (every supertile of a shard)"
                                                    if s >= ns_local else "")
                           for s, n in sorted(closed.items())) or "none"
    spans = {o["rank"]: o["spans"] for o in outs}
    coll = {r: {n: sp[n]["count"] * sp[n]["mean_ms"] for n in MESH_SPANS if n in sp}
            for r, sp in spans.items()}
    clock.phase(label, (
        f"all {checked} rows match the plain exact fused reference (single-device "
        f"index, same order); the first batch served twice and from the index "
        f"saved and loaded onto the mesh is equal bit for bit; DenseIndex.search "
        f"and the sharded IVF at full probe ({o0['ivf_chunks']} chunks a rank, "
        f"{len(o0['ivf_full'][0])} queries) equal exact search, BM25.search the "
        f"single device's on {len(o0['bm25'])} "
        f"queries; {whole} of {len(batches)} batches certified whole by the "
        f"sharded ladder ({rungs_text}; {ns_local} supertiles a shard), "
        f"{len(batches) - whole} served by the exact collective program; rank 0 "
        f"launches {json.dumps(o0['launches'])}"))
    clock.phase(label, (
        f"the first batch under HST_SUPER_HYBRID=0: the exact collective program "
        f"once on every rank, all {exact_checked} rows match the plain exact fused "
        f"reference, {o0['exact_ms']:.1f} ms; its launches on rank 0 "
        f"{json.dumps(o0['exact_launches'])}"))
    print(f"    {label}: {MESH_RANKS} processes time-sharing one card (not a "
          f"scaling figure): {text}; collectives ms in the timed batches by rank "
          f"{json.dumps({r: {n: round(v, 3) for n, v in c.items()} for r, c in coll.items()})}",
          flush=True)
    return {"ranks": MESH_RANKS, "backend": "gloo", "rows_checked": checked,
            "batches_certified_whole": whole, "batches_exact_program": len(batches) - whole,
            "certified_at_s_probe": closed, "local_supertiles": ns_local,
            "rungs": o0["rungs"][:len(batches)], "exact_batch_rows_checked": exact_checked,
            "exact_batch_ms": o0["exact_ms"], "exact_batch_launches": o0["exact_launches"],
            "qps": qps, "p50_ms": p50, "p99_ms": p99, "batch_ms": o0["batch_ms"],
            "world_s": world_s, "wait_s": wait_s,
            "launches": {o["rank"]: o["launches"] for o in outs},
            "build_s": {o["rank"]: o["build_s"] for o in outs},
            "index_timings_s": {o["rank"]: o["index_timings_s"] for o in outs},
            "peak_bytes": {o["rank"]: o.get("peak_bytes") for o in outs},
            "save_s": {o["rank"]: o["save_s"] for o in outs},
            "load_s": {o["rank"]: o["load_s"] for o in outs},
            "saved_bytes": saved_bytes, "spans": spans, "collectives_ms": coll,
            "repeat_equal": True, "loaded_equal": True, "mesh_routes": routes,
            "train": {"ranks": [o["train"] for o in outs]}}


def _value_gap(got, want) -> float:
    """The largest |got - want| over the slots of two top-k value arrays."""
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def _topk_within(gv, gi, wv, wi, tol: float) -> str:
    """Why top-k arrays or tensors (values [B, k], ids [B, k]) differ from
    others, or "": ``rows_differ`` with ``tol`` on each row (at 0, values
    bit for bit and ids equal except between slots of one value)."""
    gv, gi, wv, wi = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                      for x in (gv, gi, wv, wi))
    for b in range(len(wv)):
        why = rows_differ(list(zip(gv[b], gi[b], gi[b])), list(zip(wv[b], wi[b], wi[b])),
                          tol)
        if why is not None:
            return f"row {b}: {why}"
    return ""


MESH_ROUTE_KEYS = ("grow_capacity", "grow_rows_equal", "grow_search", "compact_capacity",
                   "compact_mapping_sha", "compact_rows_equal", "compact_search",
                   "served_index_kept", "after_grow_equal", "hybrid_bm25",
                   "hybrid_bm25_queries",
                   "small_capacity", "small_contents_sha", "small_doc_ids")


def check_mesh_routes(outs, single, q, export: dict, seed: int, dev: torch.device,
                      clock: Clock, kind: str, smi: str) -> dict:
    """"mesh routes" (``mesh_routes`` on each rank) held to one device: every
    rank's answers equal; (a) the grown index's capacity passed the old
    one, rows that changed rank and rows that did not read back bit for
    bit, and its search of the first batch equals a single-device port
    DenseIndex of the same rows plus the same added rows (ids; values bit
    for bit); (b) after the same 1% tombstoned and compacted,
    the same mapping (by digest), rows read back bit for bit, and search as
    in (a); (c) the small Indexer grew past its capacity and its export
    imported on one device holds the documents, ids and vectors (within
    MESH_ROUTE_TOL) of the same steps on one device; (d) each
    HybridBM25Pipeline row equals ``max_fusion_reference`` over the
    single-device index (ids; values within MESH_ROUTE_TOL); K1, K3 and K4
    launched on each rank in the served batch after (a) (equal to the first
    batch) and in the loaded index's batch. (d)'s largest value gap is
    printed."""
    import hashlib

    from hybridsearch_tpu_torch.index.dense_index import DenseIndex

    label = "mesh routes"
    _ranks_equal([dict({k: o["routes"][k] for k in MESH_ROUTE_KEYS}, rank=o["rank"])
                  for o in outs], MESH_ROUTE_KEYS)
    r0 = outs[0]["routes"]
    for key in ("grow_rows_equal", "compact_rows_equal", "served_index_kept",
                "after_grow_equal"):
        if not r0[key]:
            raise AssertionError(f"{label}: {key} does not hold")
    cap0, cap1, n1 = r0["grow_capacity"]
    if cap1 <= cap0 or r0["small_capacity"][1] <= r0["small_capacity"][0]:
        raise AssertionError(f"{label}: no growth past the capacity: "
                             f"{r0['grow_capacity']}, {r0['small_capacity']}")
    for o in outs:
        _require_launched(f"{label} rank {o['rank']} (the served batch after (a))",
                          o["routes"]["after_grow_launches"], MESH_KERNELS, dev)
        _require_launched(f"{label} rank {o['rank']} (the loaded index's batch)",
                          o["loaded_launches"], MESH_KERNELS, dev)
    ix = single.indexer
    snap = ix.dense._snap
    ref = DenseIndex(dim=ix.dense.dim, capacity_round=ix.dense.capacity_round,
                     device=dev)
    ref.load_snapshot(snap.docs, snap.bias, snap.n)  # shared: adds copy on write
    ref.add(mesh_grow_rows(n1 - snap.n, ix.dense.dim, seed).to(dev))
    why = _topk_within(*r0["grow_search"], *ref.search(q, TOP_K), 0.0)
    if why:
        raise AssertionError(f"{label}: search after the growth: {why}")
    ref.delete(mesh_dead_rows(ref.n_docs, seed))
    mapping = ref.compact()
    if hashlib.sha256(mapping.tobytes()).hexdigest() != r0["compact_mapping_sha"]:
        raise AssertionError(f"{label}: the compaction's mapping differs")
    if r0["compact_capacity"][1:] != (ref.n_docs, 0):
        raise AssertionError(f"{label}: compacted {r0['compact_capacity']}, one device "
                             f"{ref.n_docs} rows")
    why = _topk_within(*r0["compact_search"], *ref.search(q, TOP_K), 0.0)
    if why:
        raise AssertionError(f"{label}: search after the compaction: {why}")
    del ref, mapping
    one = {k: v for k, v in export.items() if k not in ("contents_sha", "doc_ids")}
    if (not export or export["contents_sha"] != r0["small_contents_sha"]
            or not export["documents_equal"] or export["doc_ids"] != r0["small_doc_ids"]
            or export["vectors_max_err"] > MESH_ROUTE_TOL):
        raise AssertionError(f"{label}: the export differs from one device: {one}")
    sw, lw = r0["hybrid_bm25_weights"]
    gap = 0.0  # (d)'s largest value gap to the reference
    for text, row in zip(r0["hybrid_bm25_queries"], r0["hybrid_bm25"]):
        vals, ids, _fused = max_fusion_reference(single, text, TOP_K, sw, lw)
        why = _topk_within([[v for v, _i in row]], [[i for _v, i in row]], [vals], [ids],
                           MESH_ROUTE_TOL)
        if why:
            raise AssertionError(f"{label}: HybridBM25Pipeline.search({text!r}): {why}")
        gap = max(gap, _value_gap([v for v, _i in row], vals))
    per_rank = {o["rank"]: {k: o["routes"][k] for k in (
        "grow_moved", "grow_s", "compact_moved", "compact_s", "small_moved",
        "small_add_s", "export_s", "hybrid_bm25_s")} for o in outs}
    for rank, row in per_rank.items():
        print(f"    rank {rank}: (a) rows received {row['grow_moved']} in "
              f"{row['grow_s']:.3f} s; (b) {row['compact_moved']} in "
              f"{row['compact_s']:.3f} s; (c) add {row['small_moved']} rows received "
              f"in {row['small_add_s']:.3f} s, export {row['export_s']:.3f} s; (d) "
              f"{len(r0['hybrid_bm25'])} queries {row['hybrid_bm25_s']:.3f} s",
              flush=True)
    clock.phase(label, (
        f"(a) DenseIndex.add past the capacity {cap0} -> {cap1} ({n1} rows), moved "
        f"and unmoved rows bit for bit, search = one device's (ids; values bit for "
        f"bit), the served batch after it = the first batch; (b) 1% deleted, compact "
        f"-> {r0['compact_capacity'][0]} capacity, the same mapping, search = one "
        f"device's (the same); (c) a {r0['small_capacity'][2]}-doc Indexer grown "
        f"{r0['small_capacity'][0]} -> {r0['small_capacity'][1]}, exported "
        f"({r0['export_bytes']} bytes) and imported on one device in "
        f"{one['import_s']:.2f} s: documents and ids equal, vectors within "
        f"{one['vectors_max_err']:.2e} (bit for bit: {one['vectors_bit_equal']}); (d) "
        f"{len(r0['hybrid_bm25'])} HybridBM25Pipeline rows = the max-fusion "
        f"reference (values within {gap:.3e}; gate {MESH_ROUTE_TOL}); "
        f"K1, K3, K4 launched on every rank in the served batch after (a) and in the "
        f"loaded index's batch; the grown index's searches (the collective scan) "
        f"launched {json.dumps(r0['grow_search_launches'])} and "
        f"{json.dumps(r0['compact_search_launches'])} ({kind}; {smi})"))
    return {"per_rank": per_rank, "grow_capacity": r0["grow_capacity"],
            "compact_capacity": r0["compact_capacity"],
            "small_capacity": r0["small_capacity"], "export_bytes": r0["export_bytes"],
            "single": one,
            "hybrid_bm25_queries": len(r0["hybrid_bm25"]), "hybrid_bm25_gap": gap,
            "after_grow_launches": {o["rank"]: o["routes"]["after_grow_launches"]
                                    for o in outs},
            "grow_search_launches": {o["rank"]: o["routes"]["grow_search_launches"]
                                     for o in outs},
            "compact_search_launches": {o["rank"]: o["routes"]["compact_search_launches"]
                                        for o in outs},
            "loaded_launches": {o["rank"]: o["loaded_launches"] for o in outs}}


LARGE_DIR = "chiprun_out/large"  # large-topic's store and saved index; removed after its run


def large_rank(rank: int, world: int, job: dict) -> dict:
    """large-topic's index built in a process of its own, beside the
    parent's lifecycle run (prints nothing): the corpus drawn, indexed by
    ``Indexer.index_documents`` as ``index_corpus`` indexes it (clustered
    layout, the hashing encoder; the store a file under the job's dir) and
    saved with ``Indexer.save`` for the parent to load. Returns the index
    timings, the draw's and the save's seconds and the corpus generator's
    state (the parent's query maker)."""
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    sz, dev = job["sz"], torch.device(job["device"])
    if job["rehearsal"]:
        _rehearse_rank(sz)
    t = time.perf_counter()
    docs, _queries = make_corpus(sz, "large-topic", job["seed"])
    state = _CORPUS_CACHE[("large-topic", job["seed"], sz["n_docs"], sz["n_background"])][1]
    draw_s = time.perf_counter() - t
    cfg = EngineConfig()
    cfg.index.layout, cfg.index.dim = "clustered", sz["dim"]
    searcher = Searcher(config=cfg, use_query_memory=False, device=dev,
                        encoder=hashing_encoder(sz, dev),
                        db_path=os.path.join(job["dir"], "store.db"))
    built = searcher.indexer.index_documents(docs)
    t = time.perf_counter()
    searcher.indexer.save(os.path.join(job["dir"], "index"))
    save_s = time.perf_counter() - t
    searcher.indexer.close()
    return {"timings_s": built["timings_s"], "draw_s": draw_s, "save_s": save_s,
            "docs": len(docs), "chars": sum(map(len, docs)), "state": state}


def start_large(sz: dict, dev: torch.device, seed: int, rehearsal: bool) -> tuple:
    """Start ``large_rank`` (a world of one gloo rank) and return at once;
    ``load_large`` collects it. Returns (world, start time)."""
    from hybridsearch_tpu_torch.parallel.dryrun import start

    shutil.rmtree(LARGE_DIR, ignore_errors=True)
    os.makedirs(LARGE_DIR)
    job = {"sz": sz, "seed": seed, "device": dev.type, "rehearsal": rehearsal,
           "dir": os.path.abspath(LARGE_DIR)}
    return (start(large_rank, 1, args=(job,), device=dev.type,
                  threads=REHEARSAL_THREADS if rehearsal else 2,
                  workdir=os.path.join(LARGE_DIR, "world"), timeout_s=420),
            time.perf_counter())


def load_large(started: tuple, sz: dict, dev: torch.device, clock: Clock,
               sink: dict):
    """large-topic's ``load`` for ``serve_corpus``: collect ``large_rank``
    (built beside the lifecycle run), print its corpus and index phases,
    ``Indexer.load`` its index and return (searcher, make_queries, index
    timings). Puts the builder's wall, the parent's wait and the save and
    load seconds in ``sink``."""
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    def load():
        label = "large-topic"
        world, t0 = started
        t_join = time.perf_counter()
        o = world.join()[0]
        wall, wait_s = time.perf_counter() - t0, time.perf_counter() - t_join
        clock.phase("corpus", f"{label}: {o['docs']} docs, {o['chars']} chars (drawn "
                    f"in {o['draw_s']:.1f} s by the builder process)")
        stages = ", ".join(f"{k} {v:.1f}" for k, v in o["timings_s"].items())
        t = time.perf_counter()
        idx = Indexer.load(os.path.join(LARGE_DIR, "index"), encoder=hashing_encoder(sz, dev),
                           db_path=os.path.join(LARGE_DIR, "store.db"), device=dev)
        load_s = time.perf_counter() - t
        clock.phase("index_documents", (
            f"{label}: {stages} (in a process of its own beside the lifecycle run: its "
            f"wall {wall:.1f} s, waited for {wait_s:.1f} s); Indexer.save "
            f"{o['save_s']:.1f} s there, Indexer.load {load_s:.1f} s here"))
        sink.update(builder_wall_s=wall, wait_s=wait_s, save_s=o["save_s"], load_s=load_s)
        return (Searcher(indexer=idx, use_query_memory=False, config=idx.config),
                query_maker(sz, label, o["state"]), o["timings_s"])

    return load


def ivf_rank(rank: int, world: int, job: dict) -> dict:
    """"small-topic/ivf" (``serve_ivf``, "ivf bf16" inside it) in a process
    of its own beside the lifecycle run: returns its stats and the phase
    lines it would have printed, which ``finish_ivf`` prints."""
    sz, dev = job["sz"], torch.device(job["device"])
    if job["rehearsal"]:
        _rehearse_rank(sz)
    clock = LineClock()
    return {"stats": serve_ivf(sz, dev, job["seed"], clock, job["kind"], job["smi"]),
            "lines": clock.lines}


def start_ivf(sz: dict, dev: torch.device, seed: int, kind: str, smi: str,
              rehearsal: bool) -> tuple:
    """Start ``ivf_rank`` (a world of one gloo rank) and return at once;
    ``finish_ivf`` collects it. Returns (world, start time)."""
    from hybridsearch_tpu_torch.parallel.dryrun import start

    job = {"sz": sz, "seed": seed, "device": dev.type, "rehearsal": rehearsal,
           "kind": kind, "smi": smi}
    return (start(ivf_rank, 1, args=(job,), device=dev.type,
                  threads=REHEARSAL_THREADS if rehearsal else 2, timeout_s=420),
            time.perf_counter())


def finish_ivf(started: tuple, clock: Clock) -> dict:
    """Collect ``ivf_rank``: print its phase lines, then the process's wall
    and the parent's wait. Returns ``serve_ivf``'s stats."""
    world, t0 = started
    t = time.perf_counter()
    o = world.join()[0]
    wall, wait_s = time.perf_counter() - t0, time.perf_counter() - t
    for name, detail in o["lines"]:
        clock.phase(name, detail)
    clock.phase("ivf world", f"small-topic/ivf built and served in a process of its "
                f"own beside the lifecycle run: its wall {wall:.1f} s, waited for "
                f"{wait_s:.1f} s")
    return dict(o["stats"], process_wall_s=wall, wait_s=wait_s)


def start_nccl_batch(sz: dict, dev: torch.device, seed: int, rehearsal: bool) -> tuple:
    """Start the world-1 batch (``nccl_rank`` over NCCL; gloo in the
    rehearsal, which has no NCCL) and return at once; ``finish_nccl_batch``
    collects it. Returns (world, start time, backend, its corpus size)."""
    from hybridsearch_tpu_torch.parallel.dryrun import start

    backend = "gloo" if rehearsal else "nccl"
    small = dict(sz, n_docs=sz["n_docs"] // 4)
    job = {"sz": small, "seed": seed, "device": dev.type, "rehearsal": rehearsal}
    return (start(nccl_rank, 1, args=(job,), backend=backend, device=dev.type,
                  threads=REHEARSAL_THREADS if rehearsal else 2, timeout_s=300),
            time.perf_counter(), backend, small["n_docs"])


def finish_nccl_batch(started: tuple, regime: dict, clock: Clock) -> dict:
    """One batch on a mesh of one rank: regime 1's corpus through
    ``Searcher(mesh=)``, its exact collective program, every row against
    the plain exact fused reference over regime 1's single-device index
    (the same corpus). The world starts before the lifecycle run."""
    world, t, _backend, n_docs = started
    o = world.join()[0]
    wall = time.perf_counter() - t
    single = regime["searcher"]
    fu = single.config.fusion
    checked, _b, _j = check_batches(
        single, [o["queries"]], [_with_contents(o["rows"], single.indexer.contents)],
        [np.ones(len(o["queries"]), bool)], fu.semantic_weight, fu.lexical_weight)
    clock.phase("mesh world 1", (
        f"{o['backend']}: one batch of {len(o['queries'])} queries over "
        f"{n_docs} docs through Searcher(mesh=) (the exact collective program; "
        f"the rank's first batch) in {o['ms']:.1f} ms, all {checked} rows match "
        f"the plain exact fused reference; the world's wall {wall:.1f} s (started "
        f"before the lifecycle run, which ran beside it)"))
    return {"backend": o["backend"], "rows_checked": checked, "batch_ms": o["ms"],
            "world_s": wall}


LIFECYCLE_DIR = "chiprun_out/lifecycle"  # removed at the end of the run
LIFECYCLE_DELETE_SHARE = 0.01  # of the docs, tombstoned before the save


def bm25_triples(bm25) -> tuple:
    """The (term hash, doc, weight) triples of the compacted postings,
    sorted: free of the vocabulary's order."""
    st = bm25._compacted_state()
    po = st.postings
    h = np.repeat(np.asarray(st.vocab.id_to_hash, np.uint64), po.lengths_host)
    d = po.doc_ids[:len(h)].cpu().numpy()
    w = po.weights[:len(h)].cpu().numpy()
    order = np.lexsort((d, h))
    return h[order], d[order], w[order]


def triples_digest(triples) -> str:
    import hashlib

    dig = hashlib.sha256()
    for a in triples:
        dig.update(np.ascontiguousarray(a).tobytes())
    return dig.hexdigest()


def oneshot_record(run: dict) -> dict:
    """What the lifecycle run is held to, taken from small-topic/source's
    one-shot index while it is alive: the digest of its BM25 triples, its
    dense rows (on the host), its batches and their served rows."""
    idx = run["searcher"].indexer
    snap = idx.dense._snap
    return {"bm25_digest": triples_digest(bm25_triples(idx.bm25)),
            "dense_rows": snap.docs[:snap.n].cpu(), "warm": run["warm"],
            "batches": run["batches"], "results": run["results"],
            "exact": np.split(run["exact"], len(run["batches"])),
            "stats": run["stats"]}


def rows_differ(got, want, tol: float = EPS_NUM):
    """Why a served row differs from another, or None: values within
    ``tol``, and ids equal except at a slot whose value another slot of the
    wanted row matches within ``tol`` (a near-tie)."""
    gv = np.array([v for v, _c, _i in got])
    wv = np.array([v for v, _c, _i in want])
    if len(gv) != len(wv):
        return f"{len(gv)} vs {len(wv)} results"
    if len(gv) and np.abs(gv - wv).max() > tol:
        return f"values {gv} vs {wv}"
    for j, (g, w) in enumerate(zip(got, want)):
        if g[2] != w[2] and (np.abs(wv - wv[j]) <= tol).sum() < 2:
            return f"slot {j}: doc {g[2]} vs {w[2]}"
    return None


@contextlib.contextmanager
def timed_methods(obj, names: dict, sink: dict, dev: torch.device):
    """Add the seconds of every call of each method ``name`` of ``obj`` to
    ``sink[names[name]]`` (the card synchronized after each call)."""
    for name, key in names.items():
        real = getattr(obj, name)

        def wrapped(*a, _real=real, _key=key, **k):
            t = time.perf_counter()
            out = _real(*a, **k)
            sync(dev)
            sink[_key] = sink.get(_key, 0.0) + time.perf_counter() - t
            return out

        setattr(obj, name, wrapped)
    try:
        yield sink
    finally:
        for name in names:
            delattr(obj, name)


def scatter_reference(searcher, queries, k: int, sw: float, lw: float,
                      top_ids=None):
    """The scatter mode with no kernel: full [B, n] cosine, the top 2k of
    each row (dead rows out; or the given ``top_ids`` [B, 2k], -1 for none,
    such as an IVF's) scattered into zeros as raw scores, BM25 summed from
    the CSR term by term, alive-masked min-max fusion, top-k. Returns
    (values, ids, fused)."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.text.extractor import extract_tokens

    idx = searcher.indexer
    snap = idx.dense._snap
    n = snap.n
    bias = snap.bias[:n]
    q = l2_normalize(idx.encoder.encode(list(queries)).float())
    full = q @ snap.docs[:n].T
    if top_ids is None:
        _v, top = torch.topk(full + bias[None, :], min(2 * k, n), dim=1)
        keep = torch.ones_like(top, dtype=torch.bool)
    else:
        ids = torch.from_numpy(np.asarray(top_ids, np.int64)).to(full.device)
        keep, top = ids >= 0, ids.clamp(0, n - 1)
    sem = torch.zeros_like(full).scatter_add_(
        1, top, torch.where(keep, torch.gather(full, 1, top), 0.0))
    del full
    st = idx.bm25._state
    po = st.postings
    lex = torch.zeros_like(sem)
    indptr = po.indptr.cpu().numpy()
    for b, text in enumerate(queries):
        for t in st.vocab.encode(extract_tokens(text)):
            lo, hi = int(indptr[t]), int(indptr[t + 1])
            lex[b].index_add_(0, po.doc_ids[lo:hi].long(), po.weights[lo:hi])
    alive = (bias >= 0)[None, :]

    def norm(x):
        mn = torch.where(alive, x, float("inf")).amin(1, keepdim=True)
        mx = torch.where(alive, x, float("-inf")).amax(1, keepdim=True)
        r = mx - mn
        return torch.where(r > 1e-12, (x - mn) / r.clamp_min(1e-12), torch.ones_like(x))

    fused = sw * norm(sem) + lw * norm(lex) + bias[None, :]
    vals, ids = torch.topk(fused, k, dim=1)
    return vals, ids, fused


def serve_lifecycle(sz: dict, dev: torch.device, seed: int, clock: Clock, kind: str,
                    smi: str, oneshot: dict) -> dict:
    """small-topic/source/lifecycle: small-topic's corpus at the source run's
    seed, built by parts (``index_documents`` on half, ``add_documents`` on
    all but the last 1/256, past BM25's drift bound, so it merges, then on
    the rest, under it, so it stays a pending delta), served through the
    impact ladder (``search_batch`` compacts on entry), held equal to the
    one-shot build (``oneshot_record``), tombstoned, saved and reloaded
    (``Indexer.save`` / ``Indexer.load``, a file store), served again bit
    for bit, then served in scatter mode, every row held to its plain
    reference."""
    import gc
    import shutil

    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    label = "small-topic/source/lifecycle"
    n = sz["n_docs"]
    tail = n // 256
    docs, _queries = make_corpus(sz, "small-topic", seed)
    shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)
    os.makedirs(LIFECYCLE_DIR)
    stats: dict = {"parts": [n // 2, n - tail - n // 2, tail]}
    try:
        cfg = EngineConfig()
        cfg.index.dim = sz["dim"]
        searcher = Searcher(config=cfg, use_query_memory=False, device=dev,
                            encoder=hashing_encoder(sz, dev),
                            db_path=os.path.join(LIFECYCLE_DIR, "docs.db"))
        idx = searcher.indexer
        bm25 = idx.bm25
        t = time.perf_counter()
        built = idx.index_documents(docs[:n // 2])
        stats["index_documents_s"] = time.perf_counter() - t
        stages = {}
        for part, name in ((docs[n // 2:n - tail], "merge"), (docs[n - tail:], "delta")):
            sink: dict = {}
            t = time.perf_counter()
            with timed_methods(idx, {"embed": "embed_s"}, sink, dev), \
                    timed_methods(idx.dense, {"add": "dense_add_s"}, sink, dev), \
                    timed_methods(bm25, {"add_hashes": "bm25_s"}, sink, dev):
                ids = idx.add_documents(part)
            sync(dev)
            sink["total_s"] = time.perf_counter() - t
            stages[name] = sink
            pending = bm25._state.delta_seg is not None
            if ids[0] != idx.dense.n_docs - len(part) or pending != (name == "delta"):
                raise AssertionError(f"{label}: the {name} add left delta pending "
                                     f"{pending}")
        del docs
        stats["add_s"] = stages
        bound = max(bm25.DELTA_MIN_DOCS, int(bm25._state.postings.n_docs
                                             * bm25.DELTA_MAX_FRAC))
        clock.phase("lifecycle build", (
            f"{label}: index_documents {n // 2} docs {stats['index_documents_s']:.1f} s "
            f"({', '.join(f'{k} {v:.1f}' for k, v in built['timings_s'].items())}); "
            + "; ".join(f"add_documents {len(p)} docs ({name}): " + ", ".join(
                f"{k} {v:.2f}" for k, v in st.items())
                for (p, name), st in zip(((range(n - tail - n // 2), "merge"),
                                          (range(tail), "delta")), stages.values()))
            + f"; the last {tail} docs wait in the delta (bound {bound} docs at "
            f"{bm25._state.postings.n_docs}) ({kind}; {smi})"))

        # serve: the first batch compacts the delta and builds the impact tier
        sink = {}
        with timed_methods(bm25, {"compact": "compact_s",
                                  "impact_postings": "impact_tier_s"}, sink, dev):
            t = time.perf_counter()
            searcher.search_batch(oneshot["warm"], top_k=TOP_K, log=False)
            sink["first_batch_s"] = time.perf_counter() - t
        run = serve_batches(searcher, label, "source", oneshot["warm"],
                            oneshot["batches"], sz, dev, clock, kind, smi,
                            main_path=False)
        stats.update(run["stats"], **sink)
        src = oneshot["stats"]
        clock.phase("lifecycle serve", (
            f"{label}: compaction {stats['compact_s']:.2f} s and the impact tier "
            f"{stats['impact_tier_s']:.2f} s in the first batch "
            f"({stats['first_batch_s']:.2f} s); certified "
            f"{run['stats']['n_certified']}/{run['stats']['n_queries']} (one-shot "
            f"{src['n_certified']}), qps {run['stats']['qps']:.1f} ({src['qps']:.1f}), "
            f"p50 {run['stats']['p50_ms']:.2f} ms ({src['p50_ms']:.2f}), p99 "
            f"{run['stats']['p99_ms']:.2f} ms ({src['p99_ms']:.2f}) ({kind}; {smi})"))

        # equal to the one-shot build
        digest = triples_digest(bm25_triples(bm25))
        if digest != oneshot["bm25_digest"]:
            raise AssertionError(f"{label}: BM25 triples differ from the one-shot build")
        snap = idx.dense._snap
        rows = snap.docs[:snap.n].cpu()
        ref_rows = oneshot["dense_rows"]
        differ = (rows != ref_rows).any(dim=1)
        dense_diff = float((rows - ref_rows).abs().max())
        del rows
        if dense_diff >= 1e-6:
            raise AssertionError(f"{label}: dense rows differ by {dense_diff}")
        both = same = 0
        exact = np.split(run["exact"], len(oneshot["batches"]))
        for res, ex, want, wex in zip(run["results"], exact, oneshot["results"],
                                      oneshot["exact"]):
            for b in np.flatnonzero(ex & wex):
                why = rows_differ(res[b], want[b])
                if why is not None:
                    raise AssertionError(f"{label}: certified row {b} differs from "
                                         f"the one-shot build: {why}")
                both += 1
                same += res[b] == want[b]
        stats.update(bm25_triples_equal=True, dense_rows_differing=int(differ.sum()),
                     dense_max_abs_diff=dense_diff, rows_certified_in_both=both,
                     rows_bit_equal=int(same))
        clock.phase("lifecycle vs one-shot", (
            f"{label}: BM25 (term hash, doc, weight) triples equal bit for bit "
            f"(sha256 {digest[:16]}); dense rows differing {int(differ.sum())} of "
            f"{len(differ)}, largest difference {dense_diff:.3g}; {both} rows "
            f"certified in both runs serve the one-shot ids modulo near-ties "
            f"({same} bit for bit)"))
        del run

        # delete: a seeded share, one batch served
        dead = np.random.default_rng(seed + 3).choice(
            n, int(np.ceil(n * LIFECYCLE_DELETE_SHARE)), replace=False).tolist()
        idx.delete_documents(dead)
        batch = oneshot["batches"][0]
        deleted = serve_batches(searcher, f"{label}/deleted", "source", batch,
                                [batch], sz, dev, clock, kind, smi, main_path=False)
        dead_set = set(dead)
        served = deleted["results"][0]
        if {i for row in served for _v, _c, i in row} & dead_set:
            raise AssertionError(f"{label}: a deleted doc was served")
        t = time.perf_counter()
        for q in batch:
            if {i for i, _s in bm25.search(q, top_k=TOP_K)} & dead_set:
                raise AssertionError(f"{label}: BM25.search returned a deleted doc")
        search_s = time.perf_counter() - t
        clock.phase("lifecycle delete", (
            f"{label}: {len(dead)} docs tombstoned; no deleted doc served in "
            f"{len(batch)} rows of search_batch nor by BM25.search ({search_s:.1f} s "
            f"for {len(batch)} queries)"))

        # save, load into a fresh Indexer, serve the same batch again
        t = time.perf_counter()
        idx.save(os.path.join(LIFECYCLE_DIR, "index"))
        stats["save_s"] = time.perf_counter() - t
        stats["saved_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                                   for r, _d, fs in os.walk(LIFECYCLE_DIR) for f in fs)
        encoder = idx.encoder
        idx.close()
        del searcher, idx, bm25, snap
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        loaded = Indexer.load(os.path.join(LIFECYCLE_DIR, "index"), encoder=encoder,
                              device=dev)
        sync(dev)
        stats["load_s"] = time.perf_counter() - t
        if loaded.bm25._tombstones != dead_set or loaded.dense.deleted_count != len(dead):
            raise AssertionError(f"{label}: the loaded index lost its tombstones")
        again = Searcher(indexer=loaded, use_query_memory=False, config=loaded.config)
        reloaded = serve_batches(again, f"{label}/reloaded", "source", batch, [batch],
                                 sz, dev, clock, kind, smi, main_path=False)
        if reloaded["results"][0] != served or not np.array_equal(reloaded["exact"],
                                                                  deleted["exact"]):
            raise AssertionError(f"{label}: the reloaded index serves other rows")
        clock.phase("lifecycle save/load", (
            f"{label}: Indexer.save {stats['save_s']:.1f} s ({stats['saved_bytes']} "
            f"bytes with the store), Indexer.load {stats['load_s']:.1f} s; the "
            f"reloaded index serves the batch bit for bit as before the save "
            f"({kind}; {smi})"))

        # scatter mode on the reloaded index
        scatter = Searcher(indexer=loaded, use_query_memory=False, config=loaded.config,
                           semantic_mode="scatter")
        scatter.search_batch(oneshot["warm"], top_k=TOP_K, log=False)
        kernels = {name: kernel_fns(name)[0] for name in ("tile_stats",
                                                         "super_scores_dedup")}
        for fn in kernels.values():
            fn.launches = 0
        lat, results = [], []
        for qs in oneshot["batches"]:
            t = time.perf_counter()
            results.append(scatter.search_batch(qs, top_k=TOP_K, log=False))
            lat.append(time.perf_counter() - t)
        launches = {name: fn.launches for name, fn in kernels.items()}
        if dev.type == "cuda" and min(launches.values()) == 0:
            raise AssertionError(f"{label}/scatter: a kernel never launched: {launches}")
        if dev.type == "cuda":
            stats["scatter_profile"] = profile_batch(scatter, oneshot["batches"][0])
            clock.phase("profile", f"{label}/scatter: " + stats["scatter_profile"])
        fu = scatter.config.fusion
        checked = 0
        for qs, res in zip(oneshot["batches"], results):
            rv, ri, fused = scatter_reference(scatter, qs, TOP_K, fu.semantic_weight,
                                              fu.lexical_weight)
            c, _b, _j = check_against_reference(res, np.ones(len(qs), bool), rv, ri,
                                                fused)
            checked += c
            del fused
        n_q = sum(len(qs) for qs in oneshot["batches"])
        p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
        stats["scatter"] = {"qps": n_q / sum(lat), "p50_ms": float(p50),
                            "p99_ms": float(p99), "batch_ms": [x * 1e3 for x in lat],
                            "launches": launches, "rows_checked": checked}
        clock.phase("lifecycle scatter", (
            f"{label}: semantic_mode='scatter', {len(lat)} x {sz['batch']} queries, "
            f"launches {json.dumps(launches)}; all {checked} rows match the plain "
            f"scatter reference; qps {n_q / sum(lat):.1f}, batch latency p50 "
            f"{p50:.2f} ms p99 {p99:.2f} ms (B={sz['batch']}, {kind}; {smi}; "
            f"unsourced synthetic corpus)"))
        loaded.close()
    finally:
        shutil.rmtree(LIFECYCLE_DIR, ignore_errors=True)
    return stats


# -- the minilm phase: the default encoder on the default layout ----------------

# the bi-encoder models/PROMOTED.json promotes, and the cross-encoder
MINILM_CKPT = os.path.join("models", "hst-bi-v3")
CROSS_CKPT = os.path.join("models", "hst-ms-marco-MiniLM-L-6-v2-synth")
# (B, L) of the trunk timings on the card: a query batch and an index batch
TRUNK_SHAPES = ((256, 8), (2048, 64))
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
CE_DEPTH = 20  # served docs a query the cross-encoder scores
# bf16 against the same module's float32 forward on the card (as
# tests/test_torch_gpu_models.py): least cosine between embeddings; largest
# and mean absolute difference between cross-encoder logits (which span
# about -1 to 5 here). Measured on 256 served pairs on an H100: largest
# 0.243, mean 0.010.
EMB_COS_BOUND, LOGIT_MAX_BOUND, LOGIT_MEAN_BOUND = 0.999, 0.5, 0.05


@contextlib.contextmanager
def _environ(**values):
    """Set (or, for None, remove) environment variables, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tiny_checkpoints(root: str, dim: int) -> tuple:
    """The rehearsal's stand-ins for the in-repo checkpoints, written as
    native checkpoints under ``root`` from a seed: a one-layer bi-encoder
    promoted by ``root/PROMOTED.json`` as the repo promotes hst-bi-v3, and a
    one-layer cross-encoder. Returns their directories."""
    from hybridsearch_tpu_torch.models import bert, minilm

    dirs = []
    for name, cls, max_pos in (("hst-bi-tiny", bert.BiEncoder, 16),
                               ("hst-ms-marco-MiniLM-L-6-v2-tiny", bert.CrossEncoder, 32)):
        cfg = bert.BertConfig(vocab_size=1024, hidden_dim=dim, num_layers=1, num_heads=2,
                              mlp_dim=2 * dim, max_position=max_pos)
        model = cls(cfg)
        bert.init_params(model, torch.Generator().manual_seed(0))
        dirs.append(os.path.join(root, name))
        minilm.save_trained_checkpoint(model, cfg, dirs[-1], note="chip_smoke rehearsal")
    with open(os.path.join(root, "PROMOTED.json"), "w") as f:
        json.dump({"all-MiniLM-L6-v2": "hst-bi-tiny"}, f)
    return tuple(dirs)


def _served_from(model, ckpt: str, what: str) -> None:
    """Fail unless ``model`` holds the in-repo trained weights of ``ckpt``."""
    got = getattr(model, "checkpoint", None)
    if (getattr(model, "weights_origin", None) != "in-repo-trained" or not got
            or os.path.normpath(got) != os.path.normpath(ckpt)):
        raise AssertionError(f"{what}: {type(model).__name__} from {got} "
                             f"({getattr(model, 'weights_origin', None)}), not {ckpt}")


def _float32_twin(model):
    """The same module and weights with float32 activations."""
    import dataclasses

    twin = type(model)(dataclasses.replace(model.cfg, dtype=torch.float32))
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device).eval()


def trunk_rows(enc, texts_by_shape: dict, dev: torch.device, smi: str) -> list:
    """The bi-encoder's forward at each (B, L) on real tokens: CUDA-event ms,
    model FLOP/s (8H^2 + 4HF + 4HL a token a layer) against the card's bf16
    peak, the largest cosine gap to the module's float32 forward, and layer
    0's attention against ``scaled_dot_product_attention`` on the same q, k,
    v (the yardstick; the path does not call it)."""
    from hybridsearch_tpu_torch.models.bert import trunk_flops

    model, rows = enc.model, []
    twin = _float32_twin(model)
    att = model.bert.layer_0.attention
    seen = {}
    hook = att.register_forward_hook(lambda mod, inp, out: seen.update(x=inp[0]))
    try:
        for (B, L), texts in texts_by_shape.items():
            ids, mask = enc.tokenizer.batch_encode(texts, L)
            ids = np.pad(ids.astype(np.int64), ((0, 0), (0, L - ids.shape[1])))
            mask = np.pad(mask, ((0, 0), (0, L - mask.shape[1])))
            ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
            with torch.inference_mode():
                ms = time_ms(lambda: model(ids_t, mask_t), dev, reps=10)
                got, want = model(ids_t, mask_t), twin(ids_t, mask_t)
                cos_gap = float((1 - (got * want).sum(1)).max())
                q, k, v = att.heads(seen["x"])
                path = att.context(q, k, v, mask_t)
                keep = mask_t[:, None, None, :] > 0
                sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep)
                sdpa_err = float((path.float() - sdpa.float()).abs().max())
                att_ms = time_ms(lambda: att.context(q, k, v, mask_t), dev, reps=20)
                sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep), dev, reps=20)
            if not torch.isfinite(got).all() or cos_gap > 1 - EMB_COS_BOUND:
                raise AssertionError(f"trunk at B={B} L={L}: bf16 against float32 cosine "
                                     f"gap {cos_gap}")
            flops = trunk_flops(model.cfg, B * L, L)
            row = {"B": B, "L": L, "ms": ms, "flops": flops,
                   "tflop_per_s": flops / ms / 1e9,
                   "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOP_PER_S,
                   "bound_ms": flops / BF16_FLOP_PER_S * 1e3,
                   "cos_gap_vs_float32": cos_gap, "attention_ms": att_ms,
                   "sdpa_ms": sdpa_ms, "sdpa_max_abs_diff": sdpa_err}
            rows.append(row)
            print(f"    trunk B={B} L={L}: {ms:.4f} ms, {row['tflop_per_s']:.2f} TFLOP/s "
                  f"({100 * row['bf16_peak_share']:.2f}% of {BF16_FLOP_PER_S / 1e12:.0f} "
                  f"TFLOP/s bf16), bf16 vs float32 cosine gap {cos_gap:.3g}; layer-0 "
                  f"attention {att_ms:.4f} ms, scaled_dot_product_attention {sdpa_ms:.4f} "
                  f"ms, max diff {sdpa_err:.3g} ({smi})", flush=True)
    finally:
        hook.remove()
    return rows


MINILM_LABEL = "small-topic/source/minilm"


def _minilm_environ(built: dict):
    """The variables under which the Indexer resolves its default encoder
    and the cross-encoder its checkpoint: discovery on, and in the
    rehearsal the tiny checkpoints' directory."""
    return _environ(HST_ENCODER="auto", HST_CKPT_DISCOVERY="1",
                    HST_MODEL_DIR=built["tmp"].name if built["rehearsal"] else None)


def build_minilm(sz: dict, dev: torch.device, seed: int, clock: Clock,
                 rehearsal: bool) -> dict:
    """The index of the default configuration: small-topic under
    ``layout="source"`` with no encoder given, so the Indexer's
    ``default_encoder`` serves the promoted in-repo bi-encoder (the run
    fails on any other encoder or weights). The index build splits its
    embed stage into tokenize and trunk. A set-up stage, so it runs beside
    the mesh's ranks; ``serve_minilm`` serves it. Returns what that takes."""
    import tempfile

    from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder

    label = MINILM_LABEL
    built = {"tmp": tempfile.TemporaryDirectory(), "rehearsal": rehearsal}
    with _minilm_environ(built):
        built["ckpts"] = (tiny_checkpoints(built["tmp"].name, sz["dim"]) if rehearsal
                          else (MINILM_CKPT, CROSS_CKPT))
        bi_ckpt = built["ckpts"][0]
        spent = [0.0]

        def prepare(searcher):
            enc = searcher.indexer.encoder  # the Indexer's default_encoder
            if not isinstance(enc, MiniLMEncoder):
                raise AssertionError(f"{label}: the default encoder is "
                                     f"{type(enc).__name__}, not MiniLMEncoder")
            _served_from(enc, bi_ckpt, label)
            tokenize = enc.tokenizer.batch_encode

            def timed(*a, **k):
                t = time.perf_counter()
                out = tokenize(*a, **k)
                spent[0] += time.perf_counter() - t
                return out

            enc.tokenizer.batch_encode = timed

            def finish(timings):
                del enc.tokenizer.batch_encode
                timings["tokenize_s"] = spent[0]
                timings["trunk_s"] = timings["embed_s"] - spent[0]

            return finish

        built["searcher"], built["make_queries"], built["timings"] = index_corpus(
            "small-topic", "source", sz, dev, seed, clock, label, prepare=prepare)
    return built


def serve_minilm(built: dict, sz: dict, dev: torch.device, clock: Clock, kind: str,
                 smi: str) -> tuple:
    """The default configuration end to end on ``build_minilm``'s index:
    the served batches take the impact ladder (K1, K4 at tile grain, K6,
    K7, each of which must launch) and every certified row is held against
    the exact reference; the encode span is set beside the batch wall time.
    Then the trunk alone at a query and an index batch shape, and the
    cross-encoder on the served top-20 of one batch (``predict``, and
    ``CrossEncoderReranker.rerank`` on one query). Returns (stats, the
    searcher, encoder, cross-encoder and query maker the pipelines run
    serves)."""
    from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder
    from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_TIMER

    label = MINILM_LABEL
    searcher, make_queries, timings = (built.pop(k) for k in
                                       ("searcher", "make_queries", "timings"))
    ce_ckpt = built["ckpts"][1]
    with built["tmp"], _minilm_environ(built):
        enc = searcher.indexer.encoder
        warm = make_queries(sz["batch"])
        batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]
        before = len(GLOBAL_TIMER._samples.get("encode", ()))
        run = serve_batches(searcher, label, "source", warm, batches, sz, dev, clock,
                            kind, smi, main_path=False)
        encode_ms = [x * 1e3 for x in list(GLOBAL_TIMER._samples["encode"])[before:]]
        # the warm-up batch's span comes first
        encode_ms = encode_ms[-len(batches):]
        stats = run["stats"]
        stats.update(index_timings_s=timings, encoder=enc.checkpoint,
                     weights_origin=enc.weights_origin, encode_span_ms=encode_ms)
        wall = np.mean(stats["batch_ms"])
        clock.phase(label, (
            f"{enc.checkpoint} ({enc.weights_origin}, {enc.cfg.num_layers} layers, hidden "
            f"{enc.cfg.hidden_dim}, bf16); index_documents tokenize "
            f"{timings['tokenize_s']:.1f} s + trunk {timings['trunk_s']:.1f} s of embed "
            f"{timings['embed_s']:.1f} s; encode span {np.mean(encode_ms):.2f} ms a batch "
            f"(host) of {wall:.2f} ms wall; launches {json.dumps(run['launches'])} "
            f"({kind}; {smi})"))

        queries = batches[0]
        if dev.type == "cuda":
            stats["profile"] = profile_batch(searcher, queries)
            clock.phase("profile", f"{label}: " + stats["profile"])
            stats["encode_profile"] = profile_call(lambda: enc.encode(queries))
            clock.phase("encode profile", f"{label}: {len(queries)} queries: "
                        + stats["encode_profile"])
            docs = searcher.indexer.contents
            texts = {(B, L): (queries if L <= 8 else docs)[:B] for B, L in TRUNK_SHAPES}
            stats["trunk"] = trunk_rows(enc, texts, dev, smi)
            clock.phase("trunk timing", f"{label}: (B, L) = {list(TRUNK_SHAPES)}")

        top = searcher.search_batch(queries, top_k=CE_DEPTH, log=False)
        pairs = [(q, content) for q, row in zip(queries, top) for _s, content, _i in row]
        ce = MiniLMCrossEncoder(device=dev)
        _served_from(ce, ce_ckpt, "cross-encoder")
        ce_stats: dict = {}
        t = time.perf_counter()
        scores = ce.predict(pairs, stats=ce_stats)
        sync(dev)
        cold_ms = (time.perf_counter() - t) * 1e3
        warm_ms = time_ms(lambda: ce.predict(pairs), dev, reps=3)
        if scores.shape != (len(pairs),) or not torch.isfinite(scores).all():
            raise AssertionError("cross-encoder scores are not finite")
        sub = pairs[:256]
        ids, types, mask = ce.tokenizer.batch_encode_pairs(sub, ce.max_seq_len)
        with torch.inference_mode():
            f32 = _float32_twin(ce.model)(*(torch.from_numpy(a.astype(np.int64)).to(dev)
                                            for a in (ids, mask, types)))
        diff = (ce.predict(sub) - f32).abs()
        ce_err, ce_mean = float(diff.max()), float(diff.mean())
        if ce_err > LOGIT_MAX_BOUND or ce_mean > LOGIT_MEAN_BOUND:
            raise AssertionError(f"cross-encoder bf16 against float32: largest {ce_err}, "
                                 f"mean {ce_mean}")
        reranker = CrossEncoderReranker(model=ce)
        t = time.perf_counter()
        reranked = reranker.rerank(queries[0], top[0])
        rerank_ms = (time.perf_counter() - t) * 1e3
        got = [s for s, _c, _i in reranked]
        if sorted(i for *_x, i in reranked) != sorted(i for *_x, i in top[0]) or \
                got != sorted(got, reverse=True):
            raise AssertionError("rerank is not the served rows sorted by score")
        stats["cross_encoder"] = {
            "pairs": len(pairs), "cold_ms": cold_ms, "ms": warm_ms,
            "pairs_per_s": len(pairs) / (warm_ms / 1e3), "stats": ce_stats,
            "bf16_vs_float32_max_abs": ce_err, "bf16_vs_float32_mean_abs": ce_mean,
            "float32_logit_range": [float(f32.min()), float(f32.max())],
            "rerank_ms": rerank_ms,
            "rerank_docs": len(top[0]), "checkpoint": ce.checkpoint}
        clock.phase("cross-encoder", (
            f"{ce.checkpoint}: predict on {len(pairs)} (query, top-{CE_DEPTH} doc) pairs "
            f"{warm_ms:.2f} ms ({len(pairs) / (warm_ms / 1e3):.0f} pairs/s; first call "
            f"with tokenization {cold_ms:.2f} ms), {ce_stats['tokens_padded']} tokens "
            f"padded in {ce_stats['dispatches']} dispatches, bf16 vs float32 on "
            f"{len(sub)} pairs: largest diff {ce_err:.3g}, mean {ce_mean:.3g} (logits "
            f"{float(f32.min()):.2f} to {float(f32.max()):.2f}); CrossEncoderReranker.rerank of {len(top[0])} docs "
            f"{rerank_ms:.2f} ms ({kind}; {smi})"))
    handoff = {"searcher": searcher, "encoder": enc, "cross_encoder": ce,
               "make_queries": make_queries}
    return stats, handoff


# -- the pipelines on the minilm run's index ----------------------------------------

PIPELINES_DIR = "chiprun_out/pipelines"  # the chunked pipeline's store; removed at the end
# the kernels the served pipelines reach (DenseIndex.search: K1, K4 at tile
# grain; the impact hybrid: K1, K4, K6, K7)
PIPELINE_KERNELS = ("tile_stats", "super_scores_dedup", "slice_runs", "rescore")
CHECK_SINGLES = 16  # queries served one at a time against their batched rows
HYBRID_BM25_QUERIES = 32
# Stage 1's dense scores within this of the 100th may swap between the
# kernels and a plain product (float32 sums in another order).
STAGE1_TIE = 1e-6
# One (query, doc) pair's cross-encoder logit, the same bf16 model both
# times: recomputed over the batch's pairs in the funnel's own chunks it
# should agree almost bit for bit (CE_RECOMPUTE_TIE); a query served
# alone runs its 20 pairs in another batch shape (CE_SINGLE_TIE; the
# largest gap read on the H100 was 4.77e-07). Logits within the limit
# are a near-tie.
CE_RECOMPUTE_TIE = 1e-4
CE_SINGLE_TIE = 1e-3
MMR_TIE = 1e-6  # MMR values of two candidates within this are a near-tie
PROJ_EPS = 1e-5  # an LSH projection nearer 0 may flip its sign bit
CHUNK_JOIN = 4  # corpus docs joined with ". " into one chunked parent
# HybridBM25 at scale: at least this many of HYBRID_BM25_QUERIES rows must
# be certified exact (13 of 32 on the H100, 14 of 32 in the CPU
# rehearsal), so the exact-row check always holds something; the
# uncertified rows' mean jaccard@TOP_K against the plain fusion must reach
# UNCERTIFIED_JACCARD_FLOOR (1.0 in both runs).
HYBRID_BM25_MIN_EXACT = 8
UNCERTIFIED_JACCARD_FLOOR = 0.9


@contextlib.contextmanager
def _pipeline_launches(sink: dict):
    """Every kernel's count set to 0 on entry and added to ``sink`` on
    exit; fails if a first design (_v1) launched in between."""
    fns = {name: kernel_fns(name)[0] for name in KERNEL_META}
    for fn in fns.values():
        fn.launches = 0
    v1_before = [fn.launches for fn in first_designs()]
    yield
    for name, fn in fns.items():
        sink[name] = sink.get(name, 0) + fn.launches
    if [fn.launches for fn in first_designs()] != v1_before:
        raise AssertionError("a first design (_v1) launched in a served pipeline")


@contextlib.contextmanager
def _recording(obj, name: str, sink: list):
    """``obj.name`` replaced by a wrapper appending (args, kwargs, result)
    of each call to ``sink``."""
    had = name in vars(obj)
    real = getattr(obj, name)

    def record(*a, **k):
        out = real(*a, **k)
        sink.append((a, k, out))
        return out

    setattr(obj, name, record)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, real)
        else:
            delattr(obj, name)


@contextlib.contextmanager
def _timing(obj, name: str, spent: list):
    """``obj.name`` replaced by a wrapper adding the seconds of each call to
    ``spent[0]``."""
    real = getattr(obj, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t

    setattr(obj, name, timed)
    try:
        yield
    finally:
        delattr(obj, name)


def _adopt(pipe, searcher):
    """The smoke's own arrangement (not an API): a pipeline built with the
    minilm run's encoder serves that run's index instead of re-indexing."""
    pipe.indexer.close()
    pipe.indexer, pipe.searcher = searcher.indexer, searcher
    if hasattr(pipe, "answerer"):
        pipe.answerer.searcher = searcher
    return pipe


def _timed_batches(fn, batches) -> tuple:
    """(results, per-batch seconds) of ``fn`` over ``batches``."""
    results, lat = [], []
    for qs in batches:
        t = time.perf_counter()
        results.append(fn(qs))
        lat.append(time.perf_counter() - t)
    return results, lat


def _latency(lat, n_queries: int) -> dict:
    p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
    return {"qps": n_queries / sum(lat), "p50_ms": float(p50), "p99_ms": float(p99),
            "batch_ms": [x * 1e3 for x in lat]}


def check_stage1(dense_calls, docs, bias, k1: int, dev) -> dict:
    """Each batch's stage-1 ids against a plain exact dense top-k1 on the
    card (full product, ``torch.topk``): every served id is a true top-k1
    doc or lies within STAGE1_TIE of the k1-th score, every true top-k1 doc
    missing from it too; values within 1e-5."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize

    n_swaps, err = 0, 0.0
    for args, _kw, (vals, idxs) in dense_calls:
        q = l2_normalize(torch.as_tensor(args[0]).float().to(dev))
        plain = q @ docs.T + bias[None, :]
        ref_vals, ref_ids = torch.topk(plain, k1, dim=1)
        got = torch.from_numpy(idxs).to(dev)
        if (got < 0).any():
            raise AssertionError("stage 1 served a padding id")
        true = plain.gather(1, got)
        kth = ref_vals[:, -1:]
        in_ref = (got[:, :, None] == ref_ids[:, None, :]).any(-1)
        in_got = (ref_ids[:, :, None] == got[:, None, :]).any(-1)
        if ((~in_ref) & (kth - true > STAGE1_TIE)).any() or \
                ((~in_got) & (ref_vals - kth > STAGE1_TIE)).any():
            raise AssertionError("stage 1 differs from the exact dense top-k "
                                 "outside a near-tie")
        n_swaps += int((~in_ref).sum())
        err = max(err, float((torch.from_numpy(vals).to(dev) - true).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"stage 1 values off the plain product by {err}")
    return {"rows": sum(len(a[0]) for a, _k, _o in dense_calls), "near_tie_swaps": n_swaps,
            "max_abs_err": err}


def _stage2(call, k2: int) -> tuple:
    """(candidates [B, k1], their BM25 scores, stage-2 ids [B, k2]) of one
    recorded ``bm25_candidate_scores_runs`` call, ordered as the funnel
    orders them."""
    cand = call[0][2].cpu().numpy()
    scores = call[2].cpu().numpy()
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k2]
    return cand, scores, np.take_along_axis(cand, order, axis=1)


def _ce_rows_agree(got, want, tie: float) -> bool:
    """Two rows of (score, content, id) sorted by cross-encoder score:
    logits within ``tie``, ids equal except inside such a near-tie."""
    if len(got) != len(want):
        return False
    gv = np.array([v for v, _c, _i in got])
    wv = np.array([v for v, _c, _i in want])
    if len(gv) and np.abs(gv - wv).max() > tie:
        return False
    return all(g[2] == w[2] or (np.abs(wv - wv[j]) <= tie).sum() > 1
               for j, (g, w) in enumerate(zip(got, want)))


def serve_funnel(pipe, searcher, ce, make_queries, sz: dict, dev, clock: Clock,
                 label: str, where: str, sink: dict) -> dict:
    """``MultiStagePipeline.search_batch`` (100 -> 20 -> 5) on 8 batches,
    then the checks: stage 1 against the exact dense top-100 (every batch),
    stage 2 against ``BM25.candidate_scores`` of each query (rtol 1e-5; the
    first batch), each row its stage-2 docs sorted by cross-encoder score
    (every batch; the first batch's scores recomputed in the funnel's
    chunks, within CE_RECOMPUTE_TIE), and CHECK_SINGLES queries served by
    ``search`` against their batched rows (within CE_SINGLE_TIE)."""
    from hybridsearch_tpu_torch.ops import bm25 as bm25_mod

    ix = searcher.indexer
    n = ix.dense._snap.n
    warm = make_queries(sz["batch"])
    batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]
    pipe.search_batch(warm)
    dense_calls, stage2_calls, tokenize = [], [], [0.0]
    with _pipeline_launches(sink), _recording(ix.dense, "search", dense_calls), \
            _recording(bm25_mod, "bm25_candidate_scores_runs", stage2_calls), \
            _timing(ce.tokenizer, "encode_pair", tokenize):
        results, lat = _timed_batches(pipe.search_batch, batches)
    if len(dense_calls) != len(batches) or len(stage2_calls) != len(batches):
        raise AssertionError("the funnel did not take one dense search and one "
                             "candidate BM25 call a batch")
    stats = _latency(lat, sum(len(b) for b in batches))
    metas = [rows[0].metadata for rows in results]
    stats["stage_s"] = {k: float(np.mean([m[k] for m in metas]))
                        for k in ("t_encode_s", "t_dense_s", "t_bm25_s", "t_ce_s")}
    stats["ce_pairs"] = metas[0].get("ce_pairs")
    # the cross-encoder tokenizes every (query, doc) pair on the host first
    stats["ce_tokenize_s"] = tokenize[0] / len(batches)
    k1, k2 = pipe.stage1_k, pipe.stage2_k
    snap = ix.dense._snap
    stats["stage1"] = check_stage1(dense_calls, snap.docs[:n], snap.bias[:n], k1, dev)

    cand, scores, s2 = _stage2(stage2_calls[0], k2)
    for b, q in enumerate(batches[0]):
        np.testing.assert_allclose(scores[b], ix.bm25.candidate_scores(q, cand[b]),
                                   rtol=1e-5, atol=0, err_msg=f"stage 2, query {b}")
    for rows, call in zip(results, stage2_calls):
        _c, _s, ids2 = _stage2(call, k2)
        for b, res in enumerate(rows):
            got = [v for v, _c2, _i in res.results]
            if got != sorted(got, reverse=True) or len(got) != min(pipe.final_k, k2) or \
                    not {i for *_x, i in res.results} <= set(ids2[b].tolist()):
                raise AssertionError(f"funnel row {b} is not its stage-2 docs sorted "
                                     "by cross-encoder score")
    pairs = [(q, ix.contents[int(d)]) for q, row in zip(batches[0], s2) for d in row]
    ce_bs = int(os.environ.get("HST_CE_BATCH", "128"))  # the funnel's chunks
    again = ce.predict(pairs, batch_size=ce_bs).cpu().numpy().reshape(len(batches[0]), k2)
    recompute_gap = 0.0
    for b, res in enumerate(results[0]):
        order = np.argsort(-again[b], kind="stable")[:pipe.final_k]
        want = [(float(again[b, j]), None, int(s2[b, j])) for j in order]
        if not _ce_rows_agree(res.results, want, CE_RECOMPUTE_TIE):
            raise AssertionError(f"funnel row {b}: not the top of its recomputed "
                                 "cross-encoder scores")
        recompute_gap = max(recompute_gap, max((abs(x[0] - y[0]) for x, y in zip(
            res.results, want)), default=0.0))
    stats["ce_recompute_gap"] = recompute_gap
    same, boundary, ce_gap = 0, 0, 0.0
    for b, q in enumerate(batches[0][:CHECK_SINGLES]):
        single = pipe.search(q)
        mine = set(single.metadata["stage2_ids"])
        if mine == set(s2[b].tolist()):
            if not _ce_rows_agree(single.results, results[0][b].results, CE_SINGLE_TIE):
                raise AssertionError(f"query {b}: search differs from its batched row")
            ce_gap = max(ce_gap, max((abs(x[0] - y[0]) for x, y in zip(
                single.results, results[0][b].results)), default=0.0))
            same += 1
        else:  # only a near-tie at the stage-1 or stage-2 boundary may move a doc
            moved = np.array(sorted(mine ^ set(s2[b].tolist())), np.int64)
            kth2 = np.sort(scores[b])[::-1][k2 - 1]
            bm = ix.bm25.candidate_scores(q, moved)
            q1 = dense_calls[0][0][0][b:b + 1].float()
            cos = (q1 / q1.norm().clamp_min(1e-12)) @ snap.docs[
                torch.from_numpy(moved).to(dev)].T
            kth1 = float(dense_calls[0][2][0][b, -1])
            tied = (np.abs(bm - kth2) <= 1e-5 * max(abs(kth2), 1e-30)) | \
                (np.abs(cos[0].cpu().numpy() - kth1) <= STAGE1_TIE)
            if not tied.all():
                raise AssertionError(f"query {b}: stage 2 of search differs from the "
                                     "batch's outside a boundary near-tie")
            boundary += 1
    stats["singles"] = {"checked": CHECK_SINGLES, "same_stage2": same,
                        "stage2_boundary_ties": boundary, "max_ce_gap": ce_gap}
    clock.phase("pipelines funnel", (
        f"{label}: MultiStagePipeline.search_batch {len(batches)} x {sz['batch']} "
        f"queries ({k1} -> {k2} -> {pipe.final_k}), qps {stats['qps']:.1f}, p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms; stages (s a batch) "
        + ", ".join(f"{k[2:-2]} {v:.4f}" for k, v in stats["stage_s"].items())
        + f" (of which the pairs' tokenization {stats['ce_tokenize_s']:.4f})"
        + f"; stage 1 equals the exact dense top-{k1} on {stats['stage1']['rows']} "
        f"rows ({stats['stage1']['near_tie_swaps']} near-tie swaps); stage 2 equals "
        f"BM25.candidate_scores on {len(batches[0])} queries; rows sorted by "
        f"cross-encoder score (recomputed: largest logit gap {recompute_gap:.3g}); "
        f"{CHECK_SINGLES} queries by search equal their batched "
        f"rows ({same} with the same stage 2, {boundary} with a boundary tie; "
        f"largest logit gap {ce_gap:.3g}) {where}"))
    return stats


def _mmr_near_tie(got, want, rel, emb, lam, valid) -> bool:
    """True when two MMR orders part at a round whose two picks lie within
    MMR_TIE in float64 MMR value (over ``want``'s picks so far)."""
    rel = np.asarray(rel, np.float64)
    e = np.asarray(emb, np.float64)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    sim = e @ e.T
    max_sim = np.zeros(len(rel))
    for g, w in zip(got, want):
        if g != w:
            score = lam * rel - (1 - lam) * max_sim
            return bool(valid[g]) and abs(score[g] - score[w]) <= MMR_TIE
        max_sim = np.maximum(max_sim, sim[:, w])
    return True


def serve_diversity(pipe, searcher, make_queries, sz: dict, dev, clock: Clock,
                    label: str, where: str, sink: dict) -> dict:
    """``DiversityPipeline.search_batch`` on 8 batches at top_k = TOP_K, then
    the checks: MMR on the card against its plain version on the host
    (orders equal outside MMR_TIE near-ties), and CHECK_SINGLES queries
    served by ``search`` against their batched rows: where the candidates
    alone are the batch's, the rows equal outside MMR near-ties; where not,
    candidates certified alone and in the batch equal outside EPS_NUM
    near-ties (the impact ladder escalates a batch as a whole, so a
    best-effort row may differ with its batch, and is counted)."""
    from hybridsearch_tpu_torch import pipelines as pipelines_mod
    from hybridsearch_tpu_torch.ops.mmr import mmr_select_batch
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    warm = make_queries(sz["batch"])
    batches = [make_queries(sz["batch"]) for _ in range(sz["n_batches"])]
    search_batch = lambda qs: pipe.search_batch(qs, top_k=TOP_K)  # noqa: E731
    search_batch(warm)
    mmr_calls, ladders, cands = [], [], []
    with _pipeline_launches(sink), \
            _recording(pipelines_mod, "mmr_select_batch", mmr_calls), \
            _recording(searcher_mod, "impact_ladder", ladders), \
            _recording(searcher, "search_batch", cands):
        results, lat = _timed_batches(search_batch, batches)
    if len(mmr_calls) != len(batches) or len(ladders) != len(batches):
        raise AssertionError("the diversity batch did not take one impact ladder and "
                             "one mmr_select_batch a batch")
    stats = _latency(lat, sum(len(b) for b in batches))
    swaps = rows = 0
    for (rel, emb, k, lam), kw, (order, _scores) in mmr_calls:
        valid = kw["valid"]
        plain, _ = mmr_select_batch(rel.cpu(), emb.cpu(), k, lam, valid=valid.cpu())
        got, want = order.cpu().numpy(), plain.numpy()
        for r in range(len(got)):
            rows += 1
            if (got[r] == want[r]).all():
                continue
            if not _mmr_near_tie(got[r], want[r], rel[r].cpu().numpy(),
                                 emb[r].cpu().numpy(), lam, valid[r].cpu().numpy()):
                raise AssertionError(f"MMR row {r}: the card and the host differ "
                                     "outside a near-tie")
            swaps += 1
    stats["mmr"] = {"rows": rows, "near_tie_swaps": swaps}
    exact0 = ladders[0][2][0].exact
    equal = compared = cand_ties = best_effort = 0
    for b, q in enumerate(batches[0][:CHECK_SINGLES]):
        alone, alone_cands = [], []
        with _recording(searcher_mod, "impact_ladder", alone), \
                _recording(searcher, "search_batch", alone_cands):
            single = pipe.search(q, top_k=TOP_K)
        cand_b, cand_s = cands[0][2][b], alone_cands[0][2][0]
        ids = [i for *_x, i in cand_b]
        if [i for *_x, i in cand_s] != ids:
            if not (exact0[b] and alone[0][2][0].exact[0]):
                best_effort += 1  # a best-effort row may differ with its batch
                continue
            why = _row_mismatch(cand_s, np.array([v for v, _c, _i in cand_b]), ids,
                                {i: v for v, _c, i in cand_s})
            if why is not None:
                raise AssertionError(f"diversity query {b}: certified candidates alone "
                                     f"differ from the batch's: {why}")
            cand_ties += 1  # near-tied candidates in another order: other MMR inputs
            continue
        compared += 1  # the same candidates in the same order: the same MMR inputs
        got = [i for *_x, i in single.results]
        want = [i for *_x, i in results[0][b].results]
        pos = {i: j for j, i in enumerate(ids)}
        emb = searcher.indexer.dense.get_vectors(ids)
        if got != want and not _mmr_near_tie(
                [pos[i] for i in got], [pos[i] for i in want],
                [v for v, _c, _i in cand_b], emb, pipe.lambda_param,
                np.ones(len(ids), bool)):
            raise AssertionError(f"diversity query {b}: search differs from its "
                                 "batched row outside an MMR near-tie")
        equal += got == want
    if compared < CHECK_SINGLES // 2:
        raise AssertionError(f"diversity: only {compared} of {CHECK_SINGLES} queries by "
                             "search had the batch's candidates to compare")
    stats["singles"] = {"checked": CHECK_SINGLES, "same_candidates": compared,
                        "equal": equal, "certified_candidate_near_ties": cand_ties,
                        "best_effort_candidates_differ": best_effort}
    clock.phase("pipelines diversity", (
        f"{label}: DiversityPipeline.search_batch {len(batches)} x {sz['batch']} "
        f"queries, top_k {TOP_K} of {TOP_K * pipe.candidate_multiplier} (lambda "
        f"{pipe.lambda_param}), qps {stats['qps']:.1f}, p50 {stats['p50_ms']:.2f} ms, "
        f"p99 {stats['p99_ms']:.2f} ms; MMR on the card equals its plain version on "
        f"the host on {rows} rows ({swaps} near-tie swaps); of {CHECK_SINGLES} "
        f"queries by search, {compared} had the batch's candidates and {equal} of "
        f"them its rows ({compared - equal} apart at an MMR near-tie), {cand_ties} "
        f"certified ones near-tied candidates, {best_effort} best-effort ones other "
        f"candidates {where}"))
    return stats


def max_fusion_reference(searcher, query: str, k: int, sw: float, lw: float):
    """HybridBM25's at-scale contract with no kernel: the [1, n] cosine and
    BM25 arms, each divided by its max over the alive docs, weighted and
    summed, dead docs at -inf, top-k. Returns (values, ids, fused row) on
    the host."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize

    ix = searcher.indexer
    snap = ix.dense._snap
    n = snap.n
    q = l2_normalize(ix.encoder.encode([query]).float())
    sem = (q @ snap.docs[:n].T)[0]
    lex = ix.bm25.batch_scores([query])[0]
    alive = snap.bias[:n] == 0

    def norm(x):
        mx = x[alive].max()
        return x / mx if float(mx) > 1e-12 else x

    fused = torch.where(alive, sw * norm(sem) + lw * norm(lex), float("-inf"))
    vals, ids = torch.topk(fused, k)
    return vals.cpu().numpy(), ids.cpu().numpy(), fused.cpu().numpy()


def serve_hybrid_bm25(pipe, searcher, make_queries, dev, clock: Clock, label: str,
                      where: str, sink: dict) -> dict:
    """``HybridBM25Pipeline.search`` on HYBRID_BM25_QUERIES queries one at a
    time through the impact path (divide-by-max, ``n_alive``); every row
    marked exact against ``max_fusion_reference`` (ids equal outside EPS_NUM
    near-ties, values within EPS_NUM), at least HYBRID_BM25_MIN_EXACT of
    them; the others' mean jaccard@TOP_K at least UNCERTIFIED_JACCARD_FLOOR."""
    from hybridsearch_tpu_torch import pipelines as pipelines_mod

    n = searcher.indexer.dense._snap.n
    if n <= pipelines_mod.HYBRID_BM25_SPARSE_MIN:
        raise AssertionError("the index is below HYBRID_BM25_SPARSE_MIN")
    queries = make_queries(HYBRID_BM25_QUERIES)
    pipe.search(queries[0], top_k=TOP_K)
    with _pipeline_launches(sink):
        results, lat = _timed_batches(lambda q: pipe.search(q, top_k=TOP_K), queries)
    exact = [r.metadata["exact"] for r in results]
    jaccards = []
    for q, res, ex in zip(queries, results, exact):
        vals, ids, fused = max_fusion_reference(searcher, q, TOP_K, pipe.semantic_weight,
                                                pipe.bm25_weight)
        why = _row_mismatch(res.results, vals, ids.tolist(), fused)
        if ex and why is not None:
            raise AssertionError(f"hybrid_bm25 exact row of {q!r}: {why}")
        if not ex:
            got = {i for *_x, i in res.results}
            jaccards.append(len(got & set(ids.tolist())) / max(1, len(got | set(ids.tolist()))))
    p50 = float(np.percentile(np.array(lat) * 1e3, 50))
    stats = {"queries": len(queries), "p50_ms": p50, "query_ms": [x * 1e3 for x in lat],
             "exact_share": float(np.mean(exact)), "n_exact": int(sum(exact)),
             "uncertified_jaccard_mean": float(np.mean(jaccards)) if jaccards else None}
    if stats["n_exact"] < HYBRID_BM25_MIN_EXACT:
        raise AssertionError(f"hybrid_bm25: {stats['n_exact']} of {len(queries)} rows "
                             f"exact, under {HYBRID_BM25_MIN_EXACT}")
    if jaccards and stats["uncertified_jaccard_mean"] < UNCERTIFIED_JACCARD_FLOOR:
        raise AssertionError(f"hybrid_bm25: the uncertified rows' jaccard@{TOP_K} mean "
                             f"{stats['uncertified_jaccard_mean']} is under "
                             f"{UNCERTIFIED_JACCARD_FLOOR}")
    clock.phase("pipelines hybrid_bm25", (
        f"{label}: HybridBM25Pipeline.search on {len(queries)} queries (impact path, "
        f"divide-by-max), p50 {p50:.2f} ms a query; {stats['n_exact']} rows exact "
        f"({stats['exact_share']:.4f}), each equal to the plain [1, n] divide-by-max "
        f"fusion over alive docs; the others' jaccard@{TOP_K} mean "
        f"{stats['uncertified_jaccard_mean']} (floor {UNCERTIFIED_JACCARD_FLOOR}) {where}"))
    return stats


def serve_other_pipelines(pipes: dict, searcher, make_queries, clock: Clock,
                          label: str, where: str) -> dict:
    """A few queries through BasicPipeline, RerankedPipeline (without and
    with fusion), BM25Pipeline (rows equal to ``BM25.search``) and
    RAGPipeline with a stand-in LLM (sources equal to ``Searcher.search``)."""
    ix = searcher.indexer
    queries = make_queries(4)
    out = {}
    for name, pipe in pipes.items():
        t = time.perf_counter()
        rows = [pipe.search(q, top_k=5) for q in queries]
        out[name] = {"ms_a_query": (time.perf_counter() - t) * 1e3 / len(queries)}
        for q, res in zip(queries, rows):
            ids = [i for *_x, i in res.results]
            vals = [v for v, *_x in res.results]
            if not res.results or len(set(ids)) != len(ids) or not np.isfinite(vals).all():
                raise AssertionError(f"{name}: row of {q!r} is empty, repeats a doc or "
                                     "is not finite")
            if name == "bm25":
                want = [(s, ix.contents[i], i) for i, s in ix.bm25.search(q, top_k=5)]
                if res.results != want:
                    raise AssertionError(f"bm25: row of {q!r} is not BM25.search's")
            elif name == "rag":
                want = [(s, c[:200], i) for s, c, i in searcher.search(q, top_k=5,
                                                                       log=False)]
                if res.results != want or res.answer != "stand-in answer":
                    raise AssertionError(f"rag: sources of {q!r} are not "
                                         "Searcher.search's rows")
            elif name.startswith("reranked"):
                cand = {i for *_x, i in searcher.search(q, top_k=15, log=False)}
                if res.metadata["candidates"] != 15 or not set(ids) <= cand or \
                        vals != sorted(vals, reverse=True):
                    raise AssertionError(f"{name}: row of {q!r} is not its candidates "
                                         "reranked")
    clock.phase("pipelines others", f"{label}: " + ", ".join(
        f"{k} {v['ms_a_query']:.2f} ms a query" for k, v in out.items())
        + f" ({len(queries)} queries each; bm25 rows equal BM25.search, rag sources "
        f"equal Searcher.search) {where}")
    return out


def serve_chunked(encoder, contents, make_queries, sz: dict, dev, clock: Clock,
                  label: str, where: str) -> dict:
    """ChunkedPipeline on its own index: ``chunk_docs`` corpus docs joined
    CHUNK_JOIN at a time with ". " into parents the sentence chunker splits;
    parents deduped in every row; a fresh pipeline on the same store file
    restores the chunk map by ``reload`` and serves the same rows."""
    import shutil

    from hybridsearch_tpu_torch.pipelines import create_pipeline

    docs = contents[:sz["chunk_docs"]]
    parents = [". ".join(docs[i:i + CHUNK_JOIN]) for i in range(0, len(docs), CHUNK_JOIN)]
    shutil.rmtree(PIPELINES_DIR, ignore_errors=True)
    os.makedirs(PIPELINES_DIR)
    db = os.path.join(PIPELINES_DIR, "chunked.db")
    try:
        pipe = create_pipeline("chunked", encoder=encoder, device=dev, db_path=db)
        t = time.perf_counter()
        built = pipe.index(parents)
        sync(dev)
        index_s = time.perf_counter() - t
        if built["chunks"] <= built["parents"]:
            raise AssertionError("the sentence chunker did not split the parents")
        queries = make_queries(CHECK_SINGLES)
        rows = [pipe.search(q, top_k=5).results for q in queries]
        for q, row in zip(queries, rows):
            ids = [i for *_x, i in row]
            best = pipe.searcher.search(q, top_k=1, log=False)[0][2]
            if len(set(ids)) != len(ids) or any(c != parents[i] for _v, c, i in row) or \
                    ids[0] != pipe.chunk_to_parent[best]:
                raise AssertionError(f"chunked: row of {q!r} does not map its chunks "
                                     "to distinct parents")
        fresh = create_pipeline("chunked", encoder=encoder, device=dev, db_path=db)
        t = time.perf_counter()
        fresh.reload()
        sync(dev)
        reload_s = time.perf_counter() - t
        if fresh.parents != pipe.parents or fresh.chunk_to_parent != pipe.chunk_to_parent:
            raise AssertionError("chunked: reload did not restore the chunk map")
        for q, want in zip(queries, rows):
            got = fresh.search(q, top_k=5).results
            why = _row_mismatch(got, np.array([v for v, *_x in want]),
                                [i for *_x, i in want], {i: v for v, _c, i in got})
            if why is not None:
                raise AssertionError(f"chunked: after reload, row of {q!r}: {why}")
        pipe.indexer.close()
        fresh.indexer.close()
    finally:
        shutil.rmtree(PIPELINES_DIR, ignore_errors=True)
    stats = {"cut": {"corpus_docs": len(docs), "joined": CHUNK_JOIN, "separator": ". ",
                     "parents": built["parents"], "chunks": built["chunks"],
                     "chunker": "sentence (max_chars 500, overlap 1)"},
             "index_s": index_s, "index_timings_s": built["timings_s"],
             "reload_s": reload_s}
    clock.phase("pipelines chunked", (
        f"{label}: ChunkedPipeline on {len(docs)} corpus docs joined {CHUNK_JOIN} at a "
        f"time into {built['parents']} parents, {built['chunks']} chunks, indexed in "
        f"{index_s:.1f} s; {len(queries)} rows map chunks to distinct parents; reload "
        f"on the same store ({reload_s:.1f} s) restores the chunk map and serves the "
        f"same rows {where}"))
    return stats


def serve_semantic_cache(encoder, make_queries, sz: dict, dev, clock: Clock,
                         label: str, where: str) -> dict:
    """SemanticCache on the card: a batch of the encoder's query vectors set
    and got back (every one must hit), a second batch's hits, and the card's
    LSH signatures against the plain ones on the host (equal wherever every
    |projection| > PROJ_EPS)."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.ops.lsh import lsh_signatures
    from hybridsearch_tpu_torch.services.semantic_cache import SemanticCache

    cache = SemanticCache(dim=encoder.dim, device=dev)
    first = encoder.encode(make_queries(sz["batch"]))
    second = encoder.encode(make_queries(sz["batch"]))
    t = time.perf_counter()
    for i, v in enumerate(first):
        cache.set(v, i)
    set_ms = (time.perf_counter() - t) * 1e3 / len(first)
    t = time.perf_counter()
    hits = sum(cache.get(v) is not None for v in first)
    get_ms = (time.perf_counter() - t) * 1e3 / len(first)
    if hits != len(first):
        raise AssertionError(f"semantic cache: {hits} of {len(first)} vectors set were "
                             "got back")
    hits2 = sum(cache.get(v) is not None for v in second)
    unit = l2_normalize(first.float())
    T, K = cache.n_tables, cache.n_bits
    card = lsh_signatures(cache.planes, unit, T, K).cpu()
    host = lsh_signatures(cache.planes.cpu(), unit.cpu(), T, K)
    proj = unit.double().cpu() @ cache.planes.double().cpu().T
    clear = (proj.abs() > PROJ_EPS).all(dim=1)
    differ = (card != host).any(dim=1)
    if (differ & clear).any():
        raise AssertionError("LSH signatures on the card differ from the host's "
                             "away from a zero projection")
    stats = {"set": len(first), "hits": hits, "second_batch_hits": hits2,
             "set_ms": set_ms, "get_ms": get_ms, "rows_near_zero": int((~clear).sum()),
             "rows_differing": int(differ.sum())}
    clock.phase("pipelines semantic cache", (
        f"{label}: SemanticCache ({T} tables x {K} bits) set {len(first)} query vectors "
        f"({set_ms:.3f} ms each) and got all back ({get_ms:.3f} ms each); a second "
        f"batch hit {hits2} of {len(second)}; signatures on the card equal the host's "
        f"({int((~clear).sum())} rows with a projection within {PROJ_EPS} of 0, "
        f"{int(differ.sum())} differing) {where}"))
    return stats


def serve_pipelines(handoff: dict, sz: dict, dev: torch.device, clock: Clock,
                    kind: str, smi: str) -> dict:
    """"small-topic/source/pipelines": the pipelines of ``create_pipeline``
    on the minilm run's index, not re-indexed (``_adopt``): the funnel,
    diversity, HybridBM25 on its impact path, the other four, then
    ChunkedPipeline on an index of its own and the semantic cache. K1, K4,
    K6 and K7 must launch while the pipelines serve."""
    from hybridsearch_tpu_torch.pipelines import create_pipeline
    from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker

    label = "small-topic/source/pipelines"
    where = f"({kind}; {smi})"
    searcher, enc, ce = handoff["searcher"], handoff["encoder"], handoff["cross_encoder"]
    make_queries = handoff["make_queries"]

    def build(name, **kw):
        return _adopt(create_pipeline(name, encoder=enc, device=dev, **kw), searcher)

    reranker = CrossEncoderReranker(model=ce)
    launches: dict = {}
    stats = {"launches_by_pipeline": {}}
    needs = {"multi_stage": ("tile_stats", "super_scores_dedup"),
             "diversity": PIPELINE_KERNELS, "hybrid_bm25": PIPELINE_KERNELS}
    for name, run in (
            ("multi_stage", lambda s: serve_funnel(
                build("multi_stage", reranker=reranker), searcher, ce, make_queries, sz,
                dev, clock, label, where, s)),
            ("diversity", lambda s: serve_diversity(
                build("diversity"), searcher, make_queries, sz, dev, clock, label, where,
                s)),
            ("hybrid_bm25", lambda s: serve_hybrid_bm25(
                build("hybrid_bm25"), searcher, make_queries, dev, clock, label, where,
                s))):
        sink: dict = {}
        stats[name] = run(sink)
        stats["launches_by_pipeline"][name] = sink
        if dev.type == "cuda" and min(sink.get(k, 0) for k in needs[name]) == 0:
            raise AssertionError(f"{name}: a kernel of its path never launched: {sink}")
        for k, v in sink.items():
            launches[k] = launches.get(k, 0) + v
    stats["others"] = serve_other_pipelines({
        "basic": build("basic"),
        "reranked": build("reranked", reranker=reranker),
        "reranked/fusion": build("reranked", reranker=reranker, use_fusion=True),
        "bm25": build("bm25"),
        "rag": build("rag", llm_fn=lambda prompt: ("stand-in answer", None)),
    }, searcher, make_queries, clock, label, where)
    stats["chunked"] = serve_chunked(enc, searcher.indexer.contents, make_queries, sz,
                                     dev, clock, label, where)
    stats["semantic_cache"] = serve_semantic_cache(enc, make_queries, sz, dev, clock,
                                                   label, where)
    stats["launches"] = launches
    clock.phase(label, f"launches {json.dumps(launches)} {where}")
    return stats


# -- the API (api/) on the minilm run's index, served over HTTP -----------------------

API_DIR = "chiprun_out/api"  # the CLI's store and docs; removed at the end
API_LABEL = "small-topic/source/api"
# the load and each step's size: the card's, the rehearsal's
API_SIZES = {
    "card": dict(threads=64, per_thread=8, cached=64, batch_queries=256, filtered=16,
                 funnel=64, added=64, cli_docs=256),
    "cpu": dict(threads=16, per_thread=4, cached=16, batch_queries=32, filtered=4,
                funnel=16, added=8, cli_docs=32),
}
API_KERNELS = ("tile_stats", "super_scores_dedup", "slice_runs", "rescore")
API_TIE = 1e-4  # /search rows against search_batch: values and near-ties
API_QUERY_MARGIN = 0.01  # below the cache's threshold between two load queries
API_FILTER_EVERY = 16  # every 16th doc carries {"group": (doc_id // 16) % 8}
API_HEALTH_S = 300.0  # the CLI chain's index + serve must be healthy by then
API_CLIENT_TIMEOUT_S = 300.0


def _post(conn, path: str, body, method: str = "POST") -> tuple:
    """(status, parsed payload, seconds) of one request on a kept-alive
    ``http.client`` connection."""
    t = time.perf_counter()
    raw = None if body is None else json.dumps(body).encode()
    conn.request(method, path, body=raw, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, json.loads(data) if data else None, time.perf_counter() - t


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CliChain:
    """``python -m hybridsearch_tpu_torch --db <db> index <docs>``, then
    ``... search <probe> --json`` on that store, then ``... serve`` on a
    free port, in the background: the package's real entry point, on its
    own small store. ``wait_healthy`` blocks until the server's /health
    reports every doc; ``stop`` kills the server."""

    def __init__(self, texts, rehearsal: bool):
        from hybridsearch_tpu_torch.text.extractor import preprocess_text

        self.texts = [preprocess_text(t) for t in texts]  # as the store keeps them
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.docs_dir = os.path.join(API_DIR, "docs")
        os.makedirs(self.docs_dir, exist_ok=True)
        for i, text in enumerate(texts):
            with open(os.path.join(self.docs_dir, f"doc_{i:04d}.txt"), "w") as f:
                f.write(text)
        self.n = len(texts)
        self.db = os.path.join(API_DIR, "cli.db")
        self.port = _free_port()
        self.env = dict(os.environ, PYTHONPATH=self.root)
        if rehearsal:
            self.device = ["--device", "cpu"]
            self.env.update(HST_ENCODER="hashing", OMP_NUM_THREADS=str(REHEARSAL_THREADS))
        else:  # the default encoder, as a user runs the CLI
            self.device = []
            self.env.update(HST_ENCODER="auto", HST_CKPT_DISCOVERY="1")
        self.server = None
        self.error = None
        self.index_s = self.start_to_healthy_s = self.search_json_s = None
        self.index_out = ""
        self.probe = " ".join(self.texts[0].split()[:6])
        self.search_rows = None
        self._thread = threading.Thread(target=self._run, name="cli-chain", daemon=True)
        self._thread.start()

    def _cmd(self, *args):
        return [sys.executable, "-m", "hybridsearch_tpu_torch", "--db", self.db,
                *self.device, *args]

    def _run(self) -> None:
        try:
            t = time.perf_counter()
            out = subprocess.run(self._cmd("index", self.docs_dir), cwd=self.root,
                                 env=self.env, capture_output=True, text=True,
                                 timeout=API_HEALTH_S)
            self.index_s = time.perf_counter() - t
            self.index_out = out.stdout.strip()
            if out.returncode != 0:
                raise RuntimeError(f"cli index exited {out.returncode}: {out.stderr[-2000:]}")
            t = time.perf_counter()
            out = subprocess.run(self._cmd("search", self.probe, "--json", "-k", "5"),
                                 cwd=self.root, env=self.env, capture_output=True,
                                 text=True, timeout=API_HEALTH_S)
            self.search_json_s = time.perf_counter() - t
            if out.returncode != 0:
                raise RuntimeError(f"cli search exited {out.returncode}: "
                                   f"{out.stderr[-2000:]}")
            self.search_rows = json.loads(out.stdout)
            t = time.perf_counter()
            self.server = subprocess.Popen(
                self._cmd("serve", "--host", "127.0.0.1", "--port", str(self.port)),
                cwd=self.root, env=self.env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            while True:
                if self.server.poll() is not None:
                    raise RuntimeError("cli serve exited " + str(self.server.returncode)
                                       + ": " + self.server.stdout.read()[-2000:])
                try:
                    import http.client

                    conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=5)
                    status, health, _s = _post(conn, "/health", None, "GET")
                    conn.close()
                    if status == 200 and health["documents"] == self.n:
                        self.start_to_healthy_s = time.perf_counter() - t
                        return
                except (OSError, ValueError):
                    pass
                time.sleep(0.2)
        except BaseException as e:  # noqa: BLE001  (reported by wait_healthy)
            self.error = e

    def wait_healthy(self) -> None:
        self._thread.join(API_HEALTH_S)
        if self.error is not None:
            raise AssertionError(f"{API_LABEL}: the CLI chain failed: {self.error}")
        if self.start_to_healthy_s is None:
            raise AssertionError(f"{API_LABEL}: the CLI server was not healthy within "
                                 f"{API_HEALTH_S:.0f} s")

    def stop(self) -> None:
        import shutil

        self._thread.join(API_HEALTH_S)
        if self.server is not None and self.server.poll() is None:
            self.server.kill()
            self.server.wait(30)
        shutil.rmtree(API_DIR, ignore_errors=True)


def _engine_over(searcher, enc, ce, dev):
    """The smoke's own arrangement (not an API), as ``_adopt`` is for the
    pipelines: an ``EngineState`` built with the minilm run's encoder and
    config whose indexer, searcher, metadata engine, job queue and batcher
    are pointed at that run's ``Indexer`` and ``Searcher`` instead of
    re-indexing 524,288 docs; its funnel serves the run's cross-encoder."""
    from hybridsearch_tpu_torch.api.app import EngineState
    from hybridsearch_tpu_torch.api.batching import SearchBatcher
    from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker
    from hybridsearch_tpu_torch.services.jobs import JobQueue
    from hybridsearch_tpu_torch.services.metadata_filter import MetadataFilterEngine

    ix = searcher.indexer
    st = EngineState(encoder=enc, config=ix.config, device=dev)
    st.batcher.close()
    st.jobs.shutdown(wait=False)
    st.indexer.close()
    st.indexer, st.searcher = ix, searcher
    st.metadata = MetadataFilterEngine(store=ix.store)
    st.jobs = JobQueue(n_workers=3, docstore=ix.store)
    st.jobs.register_handler("index", st._index_job)
    serving = ix.config.serving
    st.batcher = SearchBatcher(searcher, query_memory=searcher.query_memory,
                               max_batch=serving.max_batch,
                               queue_timeout_s=serving.queue_timeout_s)
    st._funnel_reranker = CrossEncoderReranker(model=ce)
    return st


def distinct_queries(enc, make_queries, count: int, threshold: float) -> list:
    """``count`` queries of the run's generator, distinct strings whose
    encoded vectors lie below ``threshold`` in cosine from one another, so
    no load query can hit another's entry in the semantic cache."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize

    cands = list(dict.fromkeys(make_queries(8 * count)))
    unit = l2_normalize(enc.encode(cands).float())
    sim = (unit @ unit.T).cpu().numpy()
    blocked = np.zeros(len(cands), bool)
    out = []
    for i in range(len(cands)):
        if not blocked[i]:
            out.append(cands[i])
            blocked |= sim[i] >= threshold
            if len(out) == count:
                return out
    raise AssertionError(f"{API_LABEL}: only {len(out)} of {count} distinct queries")


def _rows_of(payload) -> list:
    return [(r["score"], r["content"], r["doc_id"]) for r in payload["results"]]


def api_load(base_port: int, queries, threads: int, body_of) -> tuple:
    """A closed loop: ``threads`` client threads, each with its own kept-alive
    connection, sending its share of ``queries`` one after another. Returns
    ({query: (status, payload)}, [seconds of each request], wall seconds)."""
    import http.client

    per = len(queries) // threads
    out, lat, errs = {}, [], []
    start = threading.Barrier(threads + 1)

    def client(w):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", base_port,
                                              timeout=API_CLIENT_TIMEOUT_S)
            start.wait()
            for q in queries[w * per:(w + 1) * per]:
                status, payload, s = _post(conn, "/search", body_of(q))
                out[q] = (status, payload)
                lat.append(s)
            conn.close()
        except BaseException as e:  # noqa: BLE001  (reported below)
            errs.append(e)

    workers = [threading.Thread(target=client, args=(w,)) for w in range(threads)]
    for t in workers:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in workers:
        t.join(API_CLIENT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if errs:
        raise AssertionError(f"{API_LABEL}: a client failed: {errs[0]!r}")
    return out, lat, wall


def serve_api(handoff: dict, chain: CliChain, sz: dict, dev: torch.device,
              clock: Clock, kind: str, smi: str, rehearsal: bool) -> dict:
    """"small-topic/source/api": the minilm run's index served over HTTP by
    the port's API (``EngineState`` pointed at the run's indexer and
    searcher, ``APIServer`` on a free port, the continuous batcher), with
    the CLI's ``index`` + ``serve`` chain (``chain``, started beside the
    minilm run's index build) on a small store of its own in the
    background. Steps: ``warmup``; a closed loop of client threads of
    ``POST /search`` (every status 200, uncached, rows against a direct
    ``search_batch``; K1, K4, K6 and K7 must launch); the first queries
    again from the semantic cache; ``/search/batch`` bit for bit;
    ``/search/filtered`` on a metadata pre-filter against a plain masked
    top-10; ``/search/funnel`` against ``run_funnel_batch``; ``/index/add``,
    ``/search`` of a new doc and ``DELETE /documents/{id}``; last the CLI
    server's ``/search`` and ``search --json``."""
    import http.client

    from hybridsearch_tpu_torch.api.httpd import APIServer
    from hybridsearch_tpu_torch.pipelines import run_funnel_batch

    where = f"({kind}; {smi})"
    a = API_SIZES["cpu" if rehearsal else "card"]
    searcher, enc, ce = handoff["searcher"], handoff["encoder"], handoff["cross_encoder"]
    ix = searcher.indexer
    n0 = ix.dense.n_docs
    stats: dict = {"sizes": a}
    st = None
    try:
        st = _engine_over(searcher, enc, ce, dev)
        t = time.perf_counter()
        warm = st.warmup()
        sync(dev)
        stats["warmup"] = {"dispatches": warm, "s": time.perf_counter() - t}
        if warm != int(np.log2(st.batcher.max_batch)) + 1:
            raise AssertionError(f"{API_LABEL}: warmup ran {warm} dispatches")
        n_load = a["threads"] * a["per_thread"]
        queries = distinct_queries(enc, handoff["make_queries"], n_load,
                                   st.semantic_cache.similarity_threshold
                                   - API_QUERY_MARGIN)
        clock.phase("api warmup", (
            f"{API_LABEL}: EngineState over the minilm run's {n0} docs; warmup "
            f"{warm} dispatches (buckets 1-{st.batcher.max_batch}) in "
            f"{stats['warmup']['s']:.2f} s; {n_load} load queries apart by cosine "
            f"< {st.semantic_cache.similarity_threshold - API_QUERY_MARGIN:.2f} {where}"))
        # the cache-key encode alone: one query at a time on one thread
        alone = []
        for q in queries[:a["cached"]]:
            t = time.perf_counter()
            enc.encode([q])
            sync(dev)
            alone.append(time.perf_counter() - t)
        chain.wait_healthy()
        stats["cli"] = {"index_s": chain.index_s,
                        "start_to_healthy_s": chain.start_to_healthy_s,
                        "index_out": chain.index_out}

        def body(q):
            return {"query": q, "top_k": TOP_K, "semantic_weight": 0.7,
                    "lexical_weight": 0.3}

        key_s = [0.0]  # the per-request cache-key encode, outside the batcher
        key_calls = [0]
        real_encode = enc.encode

        def encode(texts, *args, **kw):
            if len(texts) != 1 or threading.current_thread().name == "search-batcher":
                return real_encode(texts, *args, **kw)
            t = time.perf_counter()
            try:
                return real_encode(texts, *args, **kw)
            finally:
                key_s[0] += time.perf_counter() - t
                key_calls[0] += 1

        with APIServer(st, host="127.0.0.1", port=0) as server:
            port = server.port
            b = st.batcher
            before = (b.dispatches, b.batched_requests)
            b.max_seen_batch = 0
            launches: dict = {}
            enc.encode = encode
            try:
                with _pipeline_launches(launches):
                    got, lat, wall = api_load(port, queries, a["threads"], body)
            finally:
                del enc.encode
            dispatches = b.dispatches - before[0]
            coalesced = b.batched_requests - before[1]
            bad = [(q, s) for q, (s, p) in got.items() if s != 200 or p["cached"]]
            if len(got) != n_load or bad:
                raise AssertionError(f"{API_LABEL}: {len(bad)} responses not 200 and "
                                     f"uncached, e.g. {bad[:2]}")
            _require_launched(API_LABEL, launches, API_KERNELS, dev)
            direct = []
            for i in range(0, n_load, a["batch_queries"]):
                direct += searcher.search_batch(queries[i:i + a["batch_queries"]],
                                                top_k=TOP_K, semantic_weight=0.7,
                                                lexical_weight=0.3, log=False)
            differ = [q for q, row in zip(queries, direct)
                      if not _ce_rows_agree(_rows_of(got[q][1]), row, API_TIE)]
            if differ:
                raise AssertionError(f"{API_LABEL}: {len(differ)} /search responses "
                                     f"differ from search_batch, e.g. {differ[0]!r}")
            p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
            stats["load"] = {
                "requests": n_load, "threads": a["threads"], "wall_s": wall,
                "requests_per_s": n_load / wall, "p50_ms": float(p50),
                "p99_ms": float(p99), "dispatches": dispatches,
                "mean_batch": coalesced / max(dispatches, 1),
                "max_batch": b.max_seen_batch, "launches": launches,
                "cache_key_encode_ms": key_s[0] * 1e3 / max(key_calls[0], 1),
                "cache_key_encodes": key_calls[0],
                "cache_key_encode_share": key_s[0] / sum(lat),
                "cache_key_encode_alone_ms": float(np.mean(alone)) * 1e3}
            ld = stats["load"]
            clock.phase("api load", (
                f"{API_LABEL}: {a['threads']} client threads x {a['per_thread']} POST "
                f"/search (top_k {TOP_K}, 0.7/0.3): {ld['requests_per_s']:.1f} "
                f"requests/s, p50 {ld['p50_ms']:.2f} ms, p99 {ld['p99_ms']:.2f} ms "
                f"(client clock); {dispatches} dispatches, coalesced batch mean "
                f"{ld['mean_batch']:.1f}, largest {ld['max_batch']}; cache-key encode "
                f"{ld['cache_key_encode_ms']:.2f} ms a request ({key_calls[0]} calls, "
                f"{100 * ld['cache_key_encode_share']:.1f}% of request time; "
                f"{ld['cache_key_encode_alone_ms']:.2f} ms alone on one thread); launches "
                f"{json.dumps(launches)}; all {n_load} 200 and uncached, every row "
                f"equals search_batch {where}"))

            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=API_CLIENT_TIMEOUT_S)
            first = queries[:a["cached"]]
            for q in first:
                status, payload, _s = _post(conn, "/search", body(q))
                keep = lambda p: {k: v for k, v in p.items()  # noqa: E731
                                  if k not in ("latency_ms", "cached")}
                if status != 200 or payload["cached"] is not True or \
                        keep(payload) != keep(got[q][1]):
                    raise AssertionError(f"{API_LABEL}: {q!r} again is not its cached "
                                         "first response")
            stats["cached"] = len(first)

            for i in range(2):
                qs = queries[i * a["batch_queries"]:(i + 1) * a["batch_queries"]]
                status, payload, s = _post(conn, "/search/batch", {
                    "queries": qs, "top_k": TOP_K, "semantic_weight": 0.7,
                    "lexical_weight": 0.3})
                want = direct[i * a["batch_queries"]:(i + 1) * a["batch_queries"]]
                if status != 200 or [_rows_of(r) for r in payload["results"]] != want:
                    raise AssertionError(f"{API_LABEL}: /search/batch {i} is not the "
                                         "direct search_batch bit for bit")
                stats.setdefault("batch_ms", []).append(s * 1e3)
            clock.phase("api cache and batch", (
                f"{API_LABEL}: the first {len(first)} queries again all cached and equal "
                f"to their first responses; 2 x POST /search/batch of "
                f"{a['batch_queries']} equal the direct search_batch bit for bit "
                f"({', '.join(f'{x:.1f}' for x in stats['batch_ms'])} ms) {where}"))

            stats["filtered"] = api_filtered(conn, st, enc, queries[:a["filtered"]], dev,
                                             clock, where)
            stats["funnel"] = api_funnel(conn, st, queries[:a["funnel"]], clock, where,
                                         run_funnel_batch)
            stats["mutations"] = api_mutations(conn, st, queries[0], n0, a["added"],
                                               body, clock, where)
            conn.close()

        # the CLI's own server, idle since it became healthy
        cli_conn = http.client.HTTPConnection("127.0.0.1", chain.port,
                                              timeout=API_CLIENT_TIMEOUT_S)
        status, payload, s = _post(cli_conn, "/search", {"query": chain.probe,
                                                         "top_k": 5})
        cli_conn.close()
        cli_texts = set(chain.texts)
        if status != 200 or not payload["results"] or not all(
                r["content"] in cli_texts for r in payload["results"]):
            raise AssertionError(f"{API_LABEL}: the CLI server's /search: {status}")
        rows = chain.search_rows
        if not rows or set(rows[0]) != {"score", "content", "doc_id"} or not all(
                r["content"] in cli_texts for r in rows):
            raise AssertionError(f"{API_LABEL}: search --json returned {rows[:1]}")
        stats["cli"].update(search_ms=s * 1e3, search_json_s=chain.search_json_s)
        clock.phase("api cli", (
            f"{API_LABEL}: python -m hybridsearch_tpu_torch index of "
            f"{chain.n} .txt docs {chain.index_s:.1f} s, serve start to healthy "
            f"{chain.start_to_healthy_s:.1f} s; its /search answered in {s * 1e3:.1f} ms "
            f"and search --json (a process of its own, before serve) in "
            f"{chain.search_json_s:.1f} s {where}"))
    finally:
        chain.stop()
        if st is not None:
            st.batcher.close()
            st.jobs.shutdown(wait=False)
    stats["launches"] = stats["load"]["launches"]
    return stats


def api_filtered(conn, st, enc, queries, dev, clock: Clock, where: str) -> dict:
    """``POST /search/filtered`` with ``group:3`` over metadata written for
    every API_FILTER_EVERY-th doc in one transaction: every row's doc
    carries group 3, the rows equal a plain masked exact dense top-10 on the
    card (each query encoded alone, as the handler does), and K1 and K4
    launch. The metadata table's read (``all_metadata``) is timed."""
    from hybridsearch_tpu_torch.ops.dense import l2_normalize

    ix = st.indexer
    n = ix.dense.n_docs
    tagged = list(range(0, n, API_FILTER_EVERY))
    store = ix.store
    with store._lock:
        store._conn.executemany(
            "INSERT OR REPLACE INTO doc_metadata (doc_id, meta_json) VALUES (?,?)",
            [(i, json.dumps({"group": (i // API_FILTER_EVERY) % 8})) for i in tagged])
        store._conn.commit()
    group3 = [i for i in tagged if (i // API_FILTER_EVERY) % 8 == 3]
    read_s, bias_s = [0.0], [0.0]
    launches: dict = {}
    lat, rows = [], []
    with _timing(store, "all_metadata", read_s), _timing(st.metadata, "bias_for", bias_s), \
            _pipeline_launches(launches):
        for q in queries:
            status, payload, s = _post(conn, "/search/filtered",
                                       {"query": q, "filter": "group:3", "top_k": TOP_K})
            if status != 200:
                raise AssertionError(f"{API_LABEL}: /search/filtered {status}: {payload}")
            rows.append(_rows_of(payload))
            lat.append(s)
    _require_launched(API_LABEL + " filtered", launches, ("tile_stats", "super_scores_dedup"),
                      dev)
    allowed = set(group3)
    snap = ix.dense._snap
    keep = torch.full((n,), float("-inf"), device=snap.docs.device)
    keep[torch.tensor(group3, device=snap.docs.device)] = 0.0
    for q, row in zip(queries, rows):
        if not row or not {i for *_x, i in row} <= allowed:
            raise AssertionError(f"{API_LABEL}: a filtered row outside group 3: {q!r}")
        qv = l2_normalize(enc.encode([q]).float())
        vals, idx = torch.topk(qv @ snap.docs[:n].T + snap.bias[:n] + keep, TOP_K)
        want = [(float(v), ix.contents[int(i)], int(i))
                for v, i in zip(vals[0].tolist(), idx[0].tolist())]
        if not _ce_rows_agree(row, want, API_TIE):
            raise AssertionError(f"{API_LABEL}: filtered {q!r} differs from the plain "
                                 "masked top-10")
    out = {"requests": len(queries), "tagged": len(tagged), "group3": len(group3),
           "ms": [x * 1e3 for x in lat], "all_metadata_ms": read_s[0] * 1e3 / len(queries),
           "bias_for_ms": bias_s[0] * 1e3 / len(queries), "launches": launches}
    clock.phase("api filtered", (
        f"{API_LABEL}: {len(queries)} x POST /search/filtered 'group:3' ({len(tagged)} "
        f"docs tagged in one transaction, {len(group3)} in group 3): "
        f"{np.mean(out['ms']):.1f} ms a request, of which bias_for "
        f"{out['bias_for_ms']:.1f} ms (all_metadata {out['all_metadata_ms']:.1f} ms); "
        f"every row in group 3 and equal to the plain masked exact top-{TOP_K}; "
        f"launches {json.dumps(launches)} {where}"))
    return out


def api_funnel(conn, st, queries, clock: Clock, where: str, run_funnel_batch) -> dict:
    """One ``POST /search/funnel`` of the queries (100 -> 20 -> 5) against a
    direct ``run_funnel_batch`` of the same queries (CE_SINGLE_TIE)."""
    status, payload, s = _post(conn, "/search/funnel", {
        "queries": queries, "stage1_k": 100, "stage2_k": 20, "top_k": 5})
    if status != 200:
        raise AssertionError(f"{API_LABEL}: /search/funnel {status}: {payload}")
    want, _meta = run_funnel_batch(st.indexer, st._funnel_reranker, queries,
                                   stage1_k=100, stage2_k=20, final_k=5)
    got = [_rows_of(r) for r in payload["results"]]
    if len(got) != len(queries) or not all(
            _ce_rows_agree(g, w, CE_SINGLE_TIE) for g, w in zip(got, want)):
        raise AssertionError(f"{API_LABEL}: /search/funnel differs from run_funnel_batch")
    gap = max((abs(x[0] - y[0]) for g, w in zip(got, want) for x, y in zip(g, w)),
              default=0.0)
    clock.phase("api funnel", (
        f"{API_LABEL}: POST /search/funnel of {len(queries)} queries (100 -> 20 -> 5) "
        f"in {s * 1e3:.1f} ms equals run_funnel_batch (largest logit gap {gap:.3g}) "
        f"{where}"))
    return {"queries": len(queries), "ms": s * 1e3, "max_logit_gap": gap}


def api_mutations(conn, st, cached_query: str, n0: int, n_add: int, body,
                  clock: Clock, where: str) -> dict:
    """``POST /index/add`` of new docs with inline metadata (ids from n0
    on), then ``/search`` of one new doc's text (the first batch after the
    add: it compacts BM25's delta and rebuilds the impact tier; timed
    apart), which must return it; a query cached before the add is a miss
    now; ``DELETE /documents/{id}`` of that doc, after which neither
    ``/search`` nor ``GET /documents`` returns it."""
    ix = st.indexer
    new = [f"{ix.contents[i]} apinew{i}" for i in range(n_add)]
    status, payload, add_s = _post(conn, "/index/add", {"documents": [
        {"content": d, "metadata": {"group": 9, "api": i}} for i, d in enumerate(new)]})
    if status != 200 or payload["doc_ids"] != list(range(n0, n0 + n_add)):
        raise AssertionError(f"{API_LABEL}: /index/add {status}: {payload}")
    target = n0 + 3
    probe = body(new[3])
    status, payload, first_s = _post(conn, "/search", probe)
    if status != 200 or target not in [r["doc_id"] for r in payload["results"]]:
        raise AssertionError(f"{API_LABEL}: /search of a new doc's text did not return it")
    status, again, _s = _post(conn, "/search", body(cached_query))
    if status != 200 or again["cached"] is not False:
        raise AssertionError(f"{API_LABEL}: a query cached before the add is still cached")
    status, payload, del_s = _post(conn, f"/documents/{target}", None, "DELETE")
    if status != 200 or payload["doc_id"] != target:
        raise AssertionError(f"{API_LABEL}: DELETE /documents/{target}: {status}")
    status, payload, _s = _post(conn, "/search", probe)
    if status != 200 or target in [r["doc_id"] for r in payload["results"]]:
        raise AssertionError(f"{API_LABEL}: the deleted doc still surfaces in /search")
    status, listed, list_s = _post(conn, f"/documents?offset={n0 - 8}&limit=100", None,
                                   "GET")
    ids = [d["doc_id"] for d in listed["documents"]]
    if status != 200 or target in ids or not set(range(n0, n0 + n_add)) - {target} <= set(
            ids) or listed["total"] != n0 + n_add - 1:
        raise AssertionError(f"{API_LABEL}: GET /documents after the delete: {status}")
    out = {"added": n_add, "add_ms": add_s * 1e3, "first_batch_ms": first_s * 1e3,
           "delete_ms": del_s * 1e3, "list_ms": list_s * 1e3}
    clock.phase("api mutations", (
        f"{API_LABEL}: POST /index/add of {n_add} docs with metadata (ids {n0}-"
        f"{n0 + n_add - 1}) {add_s * 1e3:.1f} ms; the first /search after it (BM25 "
        f"compaction and impact tier rebuild) {first_s * 1e3:.1f} ms and returns the new "
        f"doc; an earlier cached query is a miss; DELETE /documents/{target} "
        f"{del_s * 1e3:.1f} ms, after which /search and GET /documents "
        f"({list_s * 1e3:.1f} ms) no longer return it {where}"))
    return out


# -- the trainers (training/) on the trunks the minilm run serves --------------------

TRAIN_DIR = "chiprun_out/train"  # the train state and encoder checkpoint; removed at the end
# (pairs a batch, sequence length) of each trainer: the card's, the rehearsal's
TRAIN_SHAPES = {"card": {"contrastive": (96, 48), "cross": (64, 128)},
                "cpu": {"contrastive": (8, 16), "cross": (8, 32)}}
TRAIN_STEPS = {"card": 20, "cpu": 2}  # timed steps after the warm-up step
TRAIN_QUERIES = 256  # queries encoded through the saved and loaded encoder
# The first step's loss and gradients against the same step elsewhere (the
# port on the card's CPU; the data 2 x model 2 mesh): bf16 sums in other
# orders, as tests/test_torch_training.py bounds them against JAX: the loss
# within TRAIN_LOSS_TOL of it, each gradient tensor's relative Frobenius
# error (against the larger of its norm and TRAIN_GRAD_FLOOR of the whole
# gradient's) within TRAIN_GRAD_TOL
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_GRAD_FLOOR = 5e-3, 0.15, 1e-2
TRAIN_MESH = (2, 2)  # (data, model) of the mesh step on the four ranks
TOPIC_WORD = re.compile(r"\bt(\d+)x\d+\b")  # a small-topic doc's topic words


def train_texts(docs, trainer: str, n_batches: int, B: int, seed: int) -> list:
    """``n_batches`` batches of (query, doc) text pairs from the small-topic
    corpus: each doc's topic read from its topic words (t<T>x<j>), each
    query 2-4 distinct words of a topic plus one background word. A
    contrastive batch pairs every doc with a query of its topic; a cross
    batch alternates a relevant pair (label 1) and one whose query is of
    another topic (label 0). Returns [(queries, docs, labels)]."""
    tv = CORPORA["small-topic"][3]
    rng = np.random.default_rng(seed + 17)
    n_topics = max(int(m) for m in TOPIC_WORD.findall(" ".join(docs[:4096]))) + 1

    def query(t):
        m = int(rng.integers(2, 5))
        js = rng.choice(tv, size=m, replace=False)
        return " ".join([f"t{t}x{j}" for j in js] + [f"w{int(rng.integers(0, 1000))}"])

    out = []
    for _ in range(n_batches):
        picks = rng.choice(len(docs), size=B, replace=False)
        qs, ds, labels = [], [], []
        for r, i in enumerate(picks.tolist()):
            topic = int(TOPIC_WORD.search(docs[i]).group(1))
            relevant = trainer == "contrastive" or r % 2 == 0
            if not relevant:
                topic = (topic + 1 + int(rng.integers(0, n_topics - 1))) % n_topics
            qs.append(query(topic))
            ds.append(docs[i])
            labels.append(1.0 if relevant else 0.0)
        out.append((qs, ds, labels))
    return out


def _padded(arrs, L: int, pad_id: int):
    ids = np.full((len(arrs[0]), L), pad_id, np.int32)
    ids[:, :arrs[0].shape[1]] = arrs[0][:, :L]
    rest = []
    for a in arrs[1:]:
        b = np.zeros((len(a), L), np.int32)
        b[:, :a.shape[1]] = a[:, :L]
        rest.append(b)
    return (ids, *rest)


def train_batch(tokenizer, trainer: str, texts, L: int) -> tuple:
    """The trainer's numpy batch of one ``train_texts`` entry, every array
    padded to L: (q_ids, q_mask, d_ids, d_mask) or (ids, mask, types,
    labels)."""
    qs, ds, labels = texts
    pad = tokenizer.vocab.pad_id
    if trainer == "contrastive":
        q_ids, q_mask = _padded(tokenizer.batch_encode(qs, L), L, pad)
        d_ids, d_mask = _padded(tokenizer.batch_encode(ds, L), L, pad)
        return q_ids, q_mask, d_ids, d_mask
    ids, types, mask = _padded(tokenizer.batch_encode_pairs(list(zip(qs, ds)), L), L, pad)
    return ids, mask, types, np.asarray(labels, np.float32)


def train_start(ckpt: str):
    """(cfg, flat params, tokenizer) of a native checkpoint."""
    from hybridsearch_tpu_torch.models.minilm import load_trained_checkpoint
    from hybridsearch_tpu_torch.models.tokenizer import BertTokenizer

    flat, cfg = load_trained_checkpoint(ckpt)
    vocab = os.path.join(ckpt, "vocab.txt")
    return cfg, flat, BertTokenizer(vocab_path=vocab if os.path.exists(vocab) else None,
                                    vocab_size=cfg.vocab_size)


def make_trainer(trainer: str, cfg, flat, device=None, mesh=None):
    """A trainer of the port from a checkpoint's params."""
    from hybridsearch_tpu_torch.convert import bert_state
    from hybridsearch_tpu_torch.training import ContrastiveTrainer, CrossEncoderTrainer

    cls = ContrastiveTrainer if trainer == "contrastive" else CrossEncoderTrainer
    tr = cls(cfg=cfg, mesh=mesh, device=device)
    tr.params = bert_state(flat)
    return tr


def _host_grads(tr) -> dict:
    return {n: g.float().cpu().numpy() for n, g in tr.grads().items()}


def grad_errors(got: dict, want: dict) -> dict:
    """Each gradient tensor's relative Frobenius error against ``want``, the
    denominator at least TRAIN_GRAD_FLOOR of the whole gradient's norm."""
    total = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    return {n: float(np.linalg.norm(got[n].astype(np.float64) - w)
                     / max(np.linalg.norm(w.astype(np.float64)), TRAIN_GRAD_FLOOR * total))
            for n, w in want.items()}


def _same_step(label: str, loss, grads, want_loss, want_grads) -> dict:
    """Fail unless a first step's loss and gradients agree with another
    run of it within the training bounds; returns the errors."""
    errs = grad_errors(grads, want_grads)
    worst = max(errs, key=errs.get)
    loss_err = abs(loss - want_loss) / max(abs(want_loss), 1e-12)
    if not (np.isfinite(loss) and loss_err <= TRAIN_LOSS_TOL
            and errs[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"{label}: loss {loss} against {want_loss} (relative "
                             f"{loss_err:.3g}), worst gradient {worst} {errs[worst]:.3g}")
    return {"loss_rel_err": loss_err, "worst_grad": worst, "worst_grad_err": errs[worst]}


def mesh_train_step(mesh_dev: torch.device, job: dict, texts, rank: int) -> dict:
    """The "train mesh" step on one rank: a ContrastiveTrainer over a data 2
    x model 2 mesh of the four ranks, from the bi-encoder checkpoint, on the
    contrastive phase's first batch, its loss and gradients computed twice
    (the first a warm-up of the process's first backward pass); the loss
    and the gathered gradients (rank 0's), the second's collectives' spans
    and wall time."""
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_TIMER

    mesh = build_mesh(*TRAIN_MESH, device=mesh_dev)
    ckpt = job["train_ckpt"] or tiny_checkpoints(
        os.path.join(job["dir"], f"train_ckpt_{rank}"), job["sz"]["dim"])[0]
    cfg, flat, tok = train_start(ckpt)
    L = job["train_L"]
    batch = train_batch(tok, "contrastive", texts, L)
    tr = make_trainer("contrastive", cfg, flat, mesh=mesh)
    t = time.perf_counter()
    tr.loss_and_grads(batch)
    sync(mesh_dev)
    warm_ms = (time.perf_counter() - t) * 1e3
    GLOBAL_TIMER.reset()
    sync(mesh_dev)
    t = time.perf_counter()
    loss = float(tr.loss_and_grads(batch))
    sync(mesh_dev)
    step_ms = (time.perf_counter() - t) * 1e3
    spans = {n: row for n, row in GLOBAL_TIMER.stats().items() if n in MESH_SPANS}
    grads = _host_grads(tr)  # collective: every rank gathers
    return {"loss": loss, "grads": grads if rank == 0 else None, "spans": spans,
            "step_ms": step_ms, "warm_ms": warm_ms,
            "coords": (mesh.data_index, mesh.model_index),
            "texts": texts if rank == 0 else None,
            "local_query_weight": tuple(tr.model.bert.layer_0.attention.query.weight.shape)}


def _train_readings(trainer: str, cfg, B: int, L: int, ms: float) -> dict:
    """Tokens a second and model FLOP/s of one step: 3 x ``trunk_flops``
    (forward and backward) for each tower the step runs."""
    from hybridsearch_tpu_torch.models.bert import trunk_flops

    towers = 2 if trainer == "contrastive" else 1
    flops = 3 * towers * trunk_flops(cfg, B * L, L)
    return {"tokens_per_s": towers * B * L / (ms / 1e3), "flops": flops,
            "tflop_per_s": flops / ms / 1e9,
            "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOP_PER_S}


def train_phase(trainer: str, ckpt: str, docs, sz_key: str, dev: torch.device,
                seed: int, clock: Clock, where: str) -> tuple:
    """"train contrastive" / "train cross": the trainer from the checkpoint's
    params; the first step's loss and gradients against the port on the
    CPU (same params and batch); then that step's update (the warm-up) and
    the timed steps, every loss finite; on the card one more step under
    the profiler. Returns (stats, the trainer, cfg,
    tokenizer, first batch's gradients on the card)."""
    B, L = TRAIN_SHAPES[sz_key][trainer]
    steps = TRAIN_STEPS[sz_key]
    cfg, flat, tok = train_start(ckpt)
    texts = train_texts(docs, trainer, steps + 2, B, seed)
    batches = [train_batch(tok, trainer, t, L) for t in texts]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tr = make_trainer(trainer, cfg, flat, device=dev)
    loss = float(tr.loss_and_grads(batches[0]))
    grads = _host_grads(tr)
    t = time.perf_counter()
    cpu = make_trainer(trainer, cfg, flat, device="cpu")
    cpu_loss = float(cpu.loss_and_grads(batches[0]))
    vs_cpu = _same_step(f"train {trainer}: the card against the CPU", loss, grads,
                        cpu_loss, _host_grads(cpu))
    cpu_s = time.perf_counter() - t
    del cpu
    tr.optimizer.step()
    losses, step_ms = [loss], []
    for b in batches[1:steps + 1]:
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            losses.append(tr.train_step(b))  # float(): waits for the step
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            losses.append(tr.train_step(b))
            step_ms.append((time.perf_counter() - t) * 1e3)
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"train {trainer}: a loss is not finite: {losses}")
    ms = float(np.mean(step_ms))
    stats = {"checkpoint": ckpt, "B": B, "L": L, "steps": steps, "losses": losses,
             "step_ms": step_ms, "ms": ms, "cpu_loss": cpu_loss, "vs_cpu": vs_cpu,
             "cpu_check_s": cpu_s, **_train_readings(trainer, cfg, B, L, ms)}
    if dev.type == "cuda":
        stats["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        # one more step (on the last timed batch) under the profiler
        stats["profile"] = profile_call(lambda: tr.train_step(batches[steps]))
        clock.phase("profile", f"train {trainer}: one step: {stats['profile']}")
    clock.phase(f"train {trainer}", (
        f"{ckpt} ({cfg.num_layers} layers, hidden {cfg.hidden_dim}), batches of {B} "
        f"pairs at seq {L}: the first step's loss {loss:.6f} against {cpu_loss:.6f} on "
        f"the CPU (relative {vs_cpu['loss_rel_err']:.3g}), worst gradient "
        f"{vs_cpu['worst_grad']} {vs_cpu['worst_grad_err']:.3g} (bounds "
        f"{TRAIN_LOSS_TOL}, {TRAIN_GRAD_TOL}; CPU check {cpu_s:.1f} s); {steps} timed "
        f"steps after the warm-up, every loss finite ({losses[0]:.4f} -> "
        f"{losses[-1]:.4f}): {ms:.3f} ms a step, {stats['tokens_per_s']:.0f} tokens/s, "
        f"{stats['tflop_per_s']:.2f} TFLOP/s ({100 * stats['bf16_peak_share']:.2f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16); peak "
        f"{stats.get('peak_bytes', 'not measured')} bytes {where}"))
    return stats, tr, cfg, tok, (loss, grads), texts[steps + 1]


def train_checkpoint(tr, cfg, tok, ckpt: str, next_texts, L: int, make_queries,
                     dev: torch.device, clock: Clock, where: str) -> dict:
    """"train checkpoint": the contrastive trainer's state through
    ``save_train_state`` and ``restore_train_state`` into a fresh trainer
    (another seed): its next step must equal the uninterrupted trainer's bit
    for bit (loss, every parameter, both moments); then
    ``save_encoder_params`` and ``load_encoder``: TRAIN_QUERIES queries
    encoded by the loaded encoder must equal the trainer's model in eval
    mode (served through the same MiniLMEncoder batching) bit for bit."""
    import shutil

    from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder
    from hybridsearch_tpu_torch.training import ContrastiveTrainer
    from hybridsearch_tpu_torch.training.checkpoint import (
        load_encoder,
        restore_train_state,
        save_encoder_params,
        save_train_state,
    )

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    try:
        t = time.perf_counter()
        save_train_state(TRAIN_DIR, tr.params, tr.opt_state, step=tr.opt_state["count"])
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        params, opt_state, step = restore_train_state(TRAIN_DIR)
        fresh = ContrastiveTrainer(cfg=cfg, seed=1, device=dev)
        fresh.params, fresh.opt_state = params, opt_state
        restore_s = time.perf_counter() - t
        batch = train_batch(tok, "contrastive", next_texts, L)
        want, got = tr.train_step(batch), fresh.train_step(batch)
        same = want == got and all(torch.equal(a, b) for a, b in zip(
            tr.params.values(), fresh.params.values()))
        for key in ("mu", "nu"):
            a, b = tr.opt_state[key], fresh.opt_state[key]
            same = same and all(torch.equal(a[n], b[n]) for n in a)
        if not same:
            raise AssertionError("train checkpoint: the restored trainer's next step "
                                 f"differs (loss {got} against {want})")
        save_encoder_params(TRAIN_DIR, tr.params, cfg)
        enc = load_encoder(TRAIN_DIR, cfg=cfg, device=dev)
        ref = MiniLMEncoder(checkpoint=ckpt, device=dev)
        ref.model = tr.model.eval()
        queries = make_queries(TRAIN_QUERIES)
        encode_equal = torch.equal(enc.encode(queries), ref.encode(queries))
        if not encode_equal:
            raise AssertionError("train checkpoint: the loaded encoder's embeddings "
                                 "differ from the trainer's model")
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _d, fs in os.walk(TRAIN_DIR) for f in fs)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    clock.phase("train checkpoint", (
        f"save_train_state ({save_s:.2f} s) -> restore_train_state into a fresh "
        f"trainer ({restore_s:.2f} s): step {step + 1} equals the uninterrupted step "
        f"bit for bit (loss {got:.6f}, every parameter and moment); "
        f"save_encoder_params -> load_encoder: {len(queries)} queries encoded equal "
        f"the trainer's model in eval mode bit for bit; {nbytes} bytes written, "
        f"removed {where}"))
    return {"save_s": save_s, "restore_s": restore_s, "next_step_equal": True,
            "encode_equal": True, "queries": len(queries), "bytes": nbytes}


def check_train_mesh(mesh_train: dict, first: tuple, clock: Clock, where: str) -> dict:
    """"train mesh": the four ranks' contrastive step on a data 2 x model 2
    mesh (``mesh_rank``) against the one-device card step on the same batch
    and params: every rank's loss equal, the loss and gathered gradients
    within the training bounds; the collectives' spans."""
    outs = mesh_train["ranks"]
    losses = [o["loss"] for o in outs]
    if len(set(losses)) != 1:
        raise AssertionError(f"train mesh: the ranks' losses differ: {losses}")
    if [o["coords"] for o in outs] != [(r // TRAIN_MESH[1], r % TRAIN_MESH[1])
                                      for r in range(len(outs))]:
        raise AssertionError("train mesh: the ranks are not laid out on the grid")
    loss, grads = first
    errs = _same_step("train mesh: the mesh against the one-device step",
                      losses[0], outs[0]["grads"], loss, grads)
    spans = {o["rank"]: {n: {"count": sp["count"], "mean_ms": sp["mean_ms"]}
                         for n, sp in o["spans"].items()} for o in outs}
    coll = {r: round(sum(sp["count"] * sp["mean_ms"] for sp in s.values()), 3)
            for r, s in spans.items()}
    clock.phase("train mesh", (
        f"{len(outs)} gloo ranks sharing the card as data {TRAIN_MESH[0]} x model "
        f"{TRAIN_MESH[1]} (layer 0's query weight {outs[0]['local_query_weight']} a "
        f"rank): every rank's loss {losses[0]:.6f}, against {loss:.6f} on one device "
        f"(relative {errs['loss_rel_err']:.3g}), worst gathered gradient "
        f"{errs['worst_grad']} {errs['worst_grad_err']:.3g}; the step (after a "
        f"warm-up of {[round(o['warm_ms'], 1) for o in outs]} ms) "
        f"{[round(o['step_ms'], 1) for o in outs]} ms by rank, of which collectives "
        f"{coll} ms ({json.dumps(spans[0])} on rank 0) {where}"))
    return {"losses": losses, "vs_one_device": errs, "spans": spans,
            "collectives_ms": coll, "step_ms": [o["step_ms"] for o in outs],
            "warm_ms": [o["warm_ms"] for o in outs]}


def serve_training(docs, make_queries, mesh_train: dict, sz: dict, dev: torch.device,
                   seed: int, clock: Clock, kind: str, smi: str, rehearsal: bool) -> dict:
    """The four training phases: "train contrastive" (hst-bi-v3),
    "train cross" (the cross-encoder checkpoint), "train checkpoint", and
    the gate of "train mesh" (the step ran on the mesh's ranks). No kernel
    of K1-K7 may launch."""
    import tempfile

    where = f"({kind}; {smi})"
    sz_key = "cpu" if rehearsal else "card"
    stats = {}
    with tempfile.TemporaryDirectory() as tmp, counting({}) as launches:
        bi_ckpt, ce_ckpt = (tiny_checkpoints(tmp, sz["dim"]) if rehearsal
                            else (MINILM_CKPT, CROSS_CKPT))
        stats["contrastive"], tr, cfg, tok, first, next_texts = train_phase(
            "contrastive", bi_ckpt, docs, sz_key, dev, seed, clock, where)
        if mesh_train["ranks"][0]["texts"] != train_texts(
                docs, "contrastive", 1, TRAIN_SHAPES[sz_key]["contrastive"][0], seed)[0]:
            raise AssertionError("train mesh: the ranks trained on another batch")
        stats["mesh"] = check_train_mesh(mesh_train, first, clock, where)
        stats["checkpoint"] = train_checkpoint(
            tr, cfg, tok, bi_ckpt, next_texts, TRAIN_SHAPES[sz_key]["contrastive"][1],
            make_queries, dev, clock, where)
        del tr
        stats["cross"] = train_phase("cross", ce_ckpt, docs, sz_key, dev, seed + 1,
                                     clock, where)[0]
    if any(launches.values()):
        raise AssertionError(f"training launched a kernel of K1-K7: {launches}")
    stats["launches"] = launches
    return stats


if __name__ == "__main__":
    sys.exit(main())
