"""Whole runs of the harness on the CPU at a tiny size (``tiny_bench``),
and what a run must refuse.

- ``BENCHMARK.json`` holds exactly the contract's keys, and every cell
  finds its configuration, traffic, limits and metric readers by name;
- a run's last line has exactly the contract's keys, ``checks`` last;
- a traffic mix added as one new file in a copy, with one new workload
  entry, runs with no other edit;
- a traffic file with a key the harness does not read is refused;
- the check comes out false with the served path broken underneath: half
  of each batch's rows left out, an answer altered where it is produced, a
  certificate that never closes;
- ``run.py`` without a card exits non-zero and prints no result;
- the harness's modules load nothing of JAX or the JAX package;
- on a card (marker ``gpu``; it skips inside the test without one): one
  short run of the first cell is correct.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_benchmark_json_keys_and_files_resolve():
    from harness.cell import Bench

    bench = Bench()
    spec = bench.spec
    assert set(spec) == TOP_KEYS
    assert spec["paths"] == ["benchmarks_cuda"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmarks_cuda/")
    names = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        bench.config(w["config"])
        limits = bench.limits(w["name"])
        assert set(limits) == {"score_gap", "rank_gap", "band_gap", "bad_rows",
                               "batches_without_certificate", "certified_share",
                               "exact_share"}
        assert all(len(x) == 1 and set(x) <= {"max", "min"} for x in limits.values())
        assert bench.traffic(w["traffic"])["batch"] > 0
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert set(m["workloads"]) <= names if "workloads" in m else True
            assert callable(bench.reader(m["name"]).read)
    assert [m["name"] for m in spec["end_to_end"]] == [
        "qps", "latency_p95_ms", "exact_share", "setup_s"]


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_has_the_contract_keys(tiny_bench, traced):
    from harness.cell import run_cell

    for w in tiny_bench.spec["workloads"]:
        out = run_cell(tiny_bench, w["name"], 2**32 + 3, 0.5, traced,
                       torch.device("cpu"), 0.0)
        line = json.loads(json.dumps(out))
        assert list(line) == RESULT_KEYS[:-1] + (["breakdown"] if traced else []) + ["checks"]
        assert line["correct"] is True, (w["name"], line["checks"])
        assert line["failed"] == 0 and line["attempted"] > 0
        kind = "per_layer" if traced else "end_to_end"
        want = {m["name"] for m in tiny_bench.metrics(w["name"], kind)}
        assert set(line["metrics"]) <= want
        if not traced:
            assert set(line["metrics"]) == want
        for c in line["checks"].values():
            assert set(c) == {"value", "limit", "bound"}


def test_a_new_traffic_file_is_picked_up(tiny_bench):
    from harness.cell import Bench, run_cell

    root = tiny_bench.root
    mix = json.loads((tiny_bench.dir / "traffic" / "dup.json").read_text())
    mix["queries"].update(words_mean=6.0)
    (tiny_bench.dir / "traffic" / "dup-short.json").write_text(json.dumps(mix))
    (tiny_bench.dir / "limits" / "quora-source.dup-short.json").write_text(
        (tiny_bench.dir / "limits" / "quora-source.dup-b256.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "quora-source.dup-short", "config": "beir-quora.source",
                              "traffic": "dup-short", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root / "BENCHMARK.json", tiny_bench.dir)
    out = run_cell(bench, "quora-source.dup-short", 5, 0.2, False, torch.device("cpu"), 0.0)
    assert out["correct"] is True and out["attempted"] > 0


@pytest.mark.parametrize("extra", [{"loop": "open"}, {"clients": 4}])
def test_a_traffic_key_the_harness_does_not_read_is_refused(tiny_bench, extra):
    mix = json.loads((tiny_bench.dir / "traffic" / "dup.json").read_text())
    (tiny_bench.dir / "traffic" / "dup.json").write_text(json.dumps(dict(mix, **extra)))
    with pytest.raises(ValueError):
        tiny_bench.traffic("dup")


def _broken(monkeypatch, fault):
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    real = Searcher.search_batch

    def search_batch(self, queries, *args, **kwargs):
        return fault(real(self, queries, *args, **kwargs))

    monkeypatch.setattr(Searcher, "search_batch", search_batch)


def _half_left_out(rows):
    return rows[: len(rows) // 2]


def _answer_altered(rows):
    # each row's first document replaced by its last, score kept
    return [[(r[0][0],) + r[-1][1:]] + r[1:] if r else r for r in rows]


def _certificate_never_closes(monkeypatch):
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    for name in ("supertile_ladder", "impact_ladder"):
        real = getattr(searcher_mod, name)

        def never(*args, _real=real, **kwargs):
            st, rungs = _real(*args, **kwargs)
            st.exact[:] = False
            return st, rungs

        monkeypatch.setattr(searcher_mod, name, never)


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered, _certificate_never_closes])
def test_a_broken_path_is_not_correct(tiny_bench, monkeypatch, fault):
    from harness.cell import run_cell

    if fault is _certificate_never_closes:
        fault(monkeypatch)
    else:
        _broken(monkeypatch, fault)
    out = run_cell(tiny_bench, tiny_bench.spec["workloads"][0]["name"], 13, 0.2, False,
                   torch.device("cpu"), 0.0)
    assert out["correct"] is False


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmarks_cuda/run.py", "--workload",
                        "quora-clustered.dup-b256", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=str(REPO), capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness.cell, harness.trace; "
            "import hybridsearch_tpu_torch.retrieval.searcher; "
            "from harness.cell import forbidden_modules; print(forbidden_modules())"
            % (str(BENCH), str(REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(REPO)).stdout.strip()
    assert out == "[]"


@pytest.mark.gpu
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    p = subprocess.run([sys.executable, "benchmarks_cuda/run.py", "--workload",
                        "quora-clustered.dup-b256", "--seed", "2", "--seconds", "2",
                        "--trace", "0"], cwd=str(REPO), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
