"""Shared fixtures of the benchmark's CPU tests.

Run from the repository root:

    python -m pytest -q benchmarks_cuda/tests

``tiny_bench`` copies ``BENCHMARK.json`` and ``benchmarks_cuda/`` into a
temporary directory with every configuration cut to a few thousand
documents and every traffic mix to batches of 32, so a whole run fits on
the CPU. The program serves a corpus that small with its full [B, n]
program; the tests lower ``retrieval/searcher.py``
``SPARSE_HYBRID_MIN_DOCS`` so the ladders serve it, as at full size.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DOCS = 6000
TINY_BATCH = 32


def shrink(root: Path, n_docs: int = TINY_DOCS, batch: int = TINY_BATCH) -> None:
    """Cut the copy under ``root`` to the tiny size."""
    for f in (root / "benchmarks_cuda" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["corpus"]["n_docs"] = n_docs
        f.write_text(json.dumps(c))
    for f in (root / "benchmarks_cuda" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(batch=batch, trace_batches=2, warmup_batches=1, pool_batches=4)
        f.write_text(json.dumps(t))


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A tiny copy of the benchmark and its ``Bench``; the ladders serve it."""
    from harness.cell import Bench
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    monkeypatch.setattr(searcher_mod, "SPARSE_HYBRID_MIN_DOCS", 0)
    shutil.copytree(BENCH, tmp_path / "benchmarks_cuda",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shrink(tmp_path)
    return Bench(tmp_path / "BENCHMARK.json", tmp_path / "benchmarks_cuda")
