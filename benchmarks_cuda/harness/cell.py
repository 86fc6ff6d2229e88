"""One run of one cell: set-up, the measured (or traced) window, the check.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; everything about them is read from their
files, found by name (``harness/kinds.py`` finds the Python ones):

- ``configs/<file>``, as ``BENCHMARK.json`` gives it: the deployment (the
  corpus the generator draws, the index layout, the encoder, BM25, fusion);
- ``encoders/<encoder.kind>.py``: the configuration's encoder kind:
  ``draw(cfg, dev)``, its weights, drawn once on the device from the
  configuration's own seed; ``program(cfg, weights, dev)``, the port's
  encoder over them, for ``Searcher(encoder=)``; ``Embedder(cfg, weights,
  precision)``, the plain reference's ``embed(texts)``;
- ``traffic/<traffic>.json``: the queries and the batch (one closed-loop
  caller; a key the harness does not read is refused);
- ``queries/<queries.kind>.py``: the mix's query kind, ``draw(corpus,
  spec, rng, B)``, one batch;
- ``limits/<workload>.json``: each number the check compares, with its
  limit as ``{"max": x}`` or ``{"min": x}``;
- ``metrics/<metric>.py``: a reader a metric, ``read(run)`` returning the
  value or None, with the program functions it taps in ``TAPS``.

A kind that has no file is refused before anything is drawn.

Set-up: draw the corpus and the encoder's weights, build the index with
``Indexer.index_documents``, serve the warm-up batches, then freeze the
set-up's objects out of the garbage collector's scans. The window: one
caller, each batch of queries through ``Searcher.search_batch`` as soon as
the last returned, until ``seconds`` have passed (or, traced,
``trace_batches`` batches under ``torch.profiler``). After it: the peak
device memory, the import check, the program freed (the weights are what
the program and the reference share), then the plain reference on every
batch of the window (each kept as arrays when it returned), and the import
check again, since the encoder kind's reference embedder and the readers
run after the window. Every served row is held to its band (``judge``);
the rows that the program's own certificate marks exact are held to the
reference's scores and ranks as well; the certified and the exact share of
the rows have floors; every row counts toward ``exact_share``.

``control="tf32"`` puts the reference with TF32 dense products in the
program's place: the program still serves each batch (its certificate
decides which rows are held), and its rows are replaced by the control's
before they are kept. No measured run does this.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import kinds
from harness import trace as trace_mod
from harness.corpus import QueryStream, make_corpus
from harness.reference import Params, Reference, judge, served_arrays

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "hybridsearch_tpu")
TRAFFIC_KEYS = {"batch", "top_k", "warmup_batches", "pool_batches", "trace_batches",
                "why", "queries"}
LADDERS = ("supertile_ladder", "tile_ladder", "impact_ladder")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules, compared whole, that a run may
    not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    """Ends the run, with no result, where a module it may not load is
    loaded."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that may not load were loaded {when}: {found}")


class Bench:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, path: Optional[Path] = None, bench_dir: Path = BENCH_DIR):
        self.path = Path(path) if path else bench_dir.parent / "BENCHMARK.json"
        self.root = self.path.parent
        self.dir = bench_dir
        self.spec = json.loads(self.path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        t = json.loads((self.dir / "traffic" / f"{name}.json").read_text())
        if set(t) != TRAFFIC_KEYS:
            raise ValueError(f"traffic {name!r}: keys {sorted(set(t) ^ TRAFFIC_KEYS)} "
                             f"are not the harness's {sorted(TRAFFIC_KEYS)}")
        return t

    def limits(self, workload: str) -> dict:
        return json.loads((self.dir / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload: str, kind: str) -> List[dict]:
        """The ``kind`` ("end_to_end" or "per_layer") metrics the cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, name: str):
        return kinds.load(self.dir / "metrics", name)

    def kind(self, family: str, name: str):
        """``encoders/<name>.py`` or ``queries/<name>.py``."""
        return kinds.load(self.dir / family, name)


class Run:
    """What a reader sees of one run."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.queries = 0
        self.latencies_s: List[float] = []
        self.rungs: List[int] = []
        self.spans: Dict[str, List[float]] = {}
        self.checked_rows = 0
        self.exact_rows = 0
        self.certified_rows = 0
        self.profile: Optional[trace_mod.Profile] = None
        self.calls: Dict[str, list] = {}


class _Ladders:
    """Records each ladder call's certificate (``st.exact``) and rungs,
    under the index of the batch being served."""

    def __init__(self, module):
        self.mod, self.batch = module, -1
        self.exact: Dict[int, np.ndarray] = {}
        self.rungs: List[int] = []
        self._saved = []

    def __enter__(self):
        for name in LADDERS:
            real = getattr(self.mod, name)
            self._saved.append((name, real))
            setattr(self.mod, name, self._recording(real))
        return self

    def _recording(self, real):
        def recording(*args, **kwargs):
            st, rungs = real(*args, **kwargs)
            self.exact[self.batch] = np.asarray(st.exact, dtype=bool).copy()
            self.rungs.append(int(rungs))
            return st, rungs
        return recording

    def __exit__(self, *exc):
        for name, real in self._saved:
            setattr(self.mod, name, real)


class _Spans:
    """Tees every span the program records into its stage timer."""

    def __init__(self, timer):
        self.timer, self.spans = timer, {}

    def __enter__(self):
        real = self.timer.record

        def record(stage, seconds):
            self.spans.setdefault(stage, []).append(seconds)
            real(stage, seconds)

        self.timer.record = record
        return self

    def __exit__(self, *exc):
        del self.timer.record


def _program(cfg: dict, encoder, dev: torch.device):
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    ec = EngineConfig()
    ec.index.layout = cfg["index"]["layout"]
    ec.index.dim = cfg["index"]["dim"]
    ec.index.dtype = cfg["index"]["dtype"]
    ec.bm25.k1, ec.bm25.b = cfg["bm25"]["k1"], cfg["bm25"]["b"]
    ec.fusion.semantic_weight = cfg["fusion"]["semantic_weight"]
    ec.fusion.lexical_weight = cfg["fusion"]["lexical_weight"]
    return Searcher(config=ec, encoder=encoder, use_query_memory=False, device=dev)


def reference_params(cfg: dict) -> Params:
    b, f = cfg["bm25"], cfg["fusion"]
    return Params(b["k1"], b["b"], f["semantic_weight"], f["lexical_weight"])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, traced: bool,
             dev: torch.device, t0: float, log=sys.stderr,
             control: Optional[str] = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    seed %= 1 << 64  # any whole number, negative ones too
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_TIMER

    w = bench.workload(workload)
    cfg, tr, limits = bench.config(w["config"]), bench.traffic(w["traffic"]), \
        bench.limits(workload)
    kind = "per_layer" if traced else "end_to_end"
    readers = {m["name"]: (m, bench.reader(m["name"])) for m in bench.metrics(workload, kind)}
    encoder = bench.kind("encoders", cfg["encoder"]["kind"])
    queries = bench.kind("queries", tr["queries"]["kind"])
    B, k = tr["batch"], tr["top_k"]

    marks = {"imports": time.perf_counter() - t0}
    corpus = make_corpus(cfg["corpus"])
    index_of: Dict[str, int] = {}
    for i, text in enumerate(corpus.texts):
        index_of.setdefault(text, i)
    weights = encoder.draw(cfg, dev)
    marks["draw"] = time.perf_counter() - t0
    searcher = _program(cfg, encoder.program(cfg, weights, dev), dev)
    built = searcher.indexer.index_documents(corpus.texts)
    marks["index"] = time.perf_counter() - t0
    stream = QueryStream(corpus, tr["queries"], B, seed, tr["pool_batches"], queries.draw)
    for _ in range(tr["warmup_batches"]):
        searcher.search_batch(stream.warmup().texts, top_k=k, log=False)
    _sync(dev)
    marks["warm-up"] = time.perf_counter() - t0
    gc.collect()
    gc.freeze()
    run = Run()
    run.setup_s = time.perf_counter() - t0
    print(f"set-up {run.setup_s:.3f} s; ends of its steps (s): {json.dumps(marks)}; "
          f"index stages (s): {json.dumps(built['timings_s'])}", file=log, flush=True)

    ctl = None if control is None else Reference(
        corpus.texts, encoder.Embedder(cfg, weights, control), reference_params(cfg),
        precision=control)
    served: List = []
    tap = trace_mod.Tap()
    prof = None
    with _Ladders(searcher_mod) as ladders, _Spans(GLOBAL_TIMER) as spans:
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            for _m, reader in readers.values():
                for key, (module, attr) in getattr(reader, "TAPS", {}).items():
                    tap.wrap(key, module, attr)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if dev.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            window = record_function(trace_mod.WINDOW)
            window.__enter__()
        i = 0
        t_start = time.perf_counter()
        try:
            while True:
                texts = stream.batch(i).texts
                ladders.batch = i
                t = time.perf_counter()
                rows = searcher.search_batch(texts, top_k=k, log=False)
                done = time.perf_counter()
                run.latencies_s.append(done - t)
                if ctl is not None:
                    rows = ctl.topk_rows(texts, k, corpus.texts)
                served.append(served_arrays(rows, B, k, index_of))
                i += 1
                if (i >= tr["trace_batches"]) if traced else (done - t_start >= seconds):
                    break
            _sync(dev)
            run.window_s = time.perf_counter() - t_start
        finally:
            if traced:
                window.__exit__(None, None, None)
                prof.__exit__(None, None, None)
            tap.restore()
    run.queries = i * B
    run.rungs, run.spans, run.calls = ladders.rungs, spans.spans, tap.calls
    certified = np.concatenate(list(ladders.exact.values())) if ladders.exact else np.zeros(0)
    lat_ms = np.asarray(run.latencies_s) * 1e3
    print(f"window: batch ms p50 {np.median(lat_ms):.2f} mean {lat_ms.mean():.2f} max "
          f"{lat_ms.max():.2f}, by tenths of the window "
          f"{[round(float(x.mean()), 2) for x in np.array_split(lat_ms, min(10, lat_ms.size))]}",
          file=log, flush=True)
    print(f"window: {i} batches in {run.window_s:.3f} s; certified {certified.mean():.4f} "
          f"of {certified.size} rows; rungs mean {np.mean(ladders.rungs or [0]):.3f}, "
          f"counts {np.bincount(ladders.rungs or [0]).tolist()}", file=log, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    refuse_forbidden("by the window's close")
    if traced:
        run.profile = trace_mod.read_profile(prof)
        p = run.profile
        print(f"trace: window {run.window_s:.4f} s, busy {p.busy_s if p else 0:.4f} s, "
              f"{p.linked if p else 0} of {p.device_ops_total if p else 0} device "
              f"operations linked to their launch; device s by tap "
              f"{json.dumps(p.device_s if p else {})}", file=log, flush=True)
    # per-layer readers may look at the tapped calls' tensors: read them first
    values = {}
    if traced:
        values = {name: reader.read(run) for name, (_m, reader) in readers.items()}
    run.calls = {}
    del searcher, tap, prof, ctl
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = Reference(corpus.texts, encoder.Embedder(cfg, weights), reference_params(cfg))
    gap_s = gap_r = gap_b = 0.0
    failed = no_cert = 0
    for i, batch in enumerate(served):
        j = judge(ref, stream.batch(i).texts, batch, k)
        exact = ladders.exact.get(i)
        if exact is None:
            no_cert += 1
            exact = np.zeros(B, dtype=bool)
        held = exact & ~j.bad
        gap_s = max(gap_s, float(j.score_gap[held].max(initial=0.0)))
        gap_r = max(gap_r, float(j.rank_gap[held].max(initial=0.0)))
        gap_b = max(gap_b, float(j.band_gap.max()))
        failed += int(j.bad.sum())
        run.checked_rows += B
        run.certified_rows += int(held.sum())
        run.exact_rows += int((~j.bad & (j.score_gap <= limits["score_gap"]["max"])
                               & (j.rank_gap <= limits["rank_gap"]["max"])).sum())
    print(f"reference: {len(served)} batches checked in "
          f"{time.perf_counter() - t_ref:.3f} s", file=log, flush=True)
    if not traced:
        values = {name: reader.read(run) for name, (_m, reader) in readers.items()}
    rows = max(run.checked_rows, 1)
    checks = {"score_gap": gap_s, "rank_gap": gap_r, "band_gap": gap_b,
              "bad_rows": failed, "batches_without_certificate": no_cert,
              "certified_share": 100.0 * run.certified_rows / rows,
              "exact_share": 100.0 * run.exact_rows / rows}
    if set(checks) != set(limits):
        raise ValueError(f"limits of {workload!r} name {sorted(limits)}, "
                         f"the check {sorted(checks)}")
    correct = bool(served) and all(within(v, limits[name]) for name, v in checks.items())
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": w["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.queries, "failed": int(failed),
           "metrics": {name: {"value": v, "unit": readers[name][0]["unit"]}
                       for name, v in values.items() if v is not None},
           "device": device}
    if traced and run.profile is not None:
        device.update(busy_s=run.profile.busy_s, window_s=run.window_s)
        out["breakdown"] = {"device_ops": run.profile.device_ops,
                            "idle_gaps": run.profile.idle_gaps}
    out["checks"] = {name: {"value": v, "limit": x, "bound": kind}
                     for name, v in checks.items() for kind, x in limits[name].items()}
    refuse_forbidden("by the reference or the metric readers")
    return out


def within(value: float, limit: dict) -> bool:
    """A limit is ``{"max": x}`` or ``{"min": x}``."""
    (kind, x), = limit.items()
    return value <= x if kind == "max" else value >= x
