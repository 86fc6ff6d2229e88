"""Whole runs of the harness on the CPU at a tiny size (``tiny_bench``),
and what a run must refuse.

- ``BENCHMARK.json`` holds exactly the contract's keys, and every cell
  finds its configuration, traffic, limits and metric readers by name;
- a run's last line has exactly the contract's keys, ``checks`` last;
- a traffic mix added as one new file in a copy, with one new workload
  entry, runs with no other edit; so do an encoder kind and a query kind,
  each one new file, with a configuration or a traffic file and a cell;
- a traffic file with a key the harness does not read is refused; so is an
  encoder or query kind with no file, before anything is drawn;
- the check comes out false with the served path broken underneath: half
  of each batch's rows left out, an answer altered where it is produced, a
  certificate that never closes, an encoder kind whose program serves
  other weights than its reference embeds with;
- ``run.py`` without a card exits non-zero and prints no result;
- the harness's modules load nothing of JAX or the JAX package, and a run
  whose encoder kind's reference embedder loads JAX after the window ends
  with no result;
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


def _with_cell(bench, name, config, traffic, limits_of):
    """The copy with one more cell (and configuration, if new), added as
    files and entries only; its ``Bench``."""
    from harness.cell import Bench

    root = bench.root
    spec = json.loads((root / "BENCHMARK.json").read_text())
    if config["name"] not in {c["name"] for c in spec["configs"]}:
        (bench.dir / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
        spec["configs"].append({"name": config["name"], "source": "a test",
                                "file": f"benchmarks_cuda/configs/{config['name']}.json",
                                "reduced": [], "why": "a test"})
    (bench.dir / "limits" / f"{name}.json").write_text(
        (bench.dir / "limits" / f"{limits_of}.json").read_text())
    spec["workloads"].append({"name": name, "config": config["name"], "traffic": traffic,
                              "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root / "BENCHMARK.json", bench.dir)


RECORDING = '''

import pathlib as _pathlib


def _recorded(name, real):
    def recorded(*args, **kwargs):
        with _pathlib.Path(%r).open("a") as f:
            f.write(name + "\\n")
        return real(*args, **kwargs)
    return recorded


draw, program, Embedder = (_recorded(n, f) for n, f in (
    ("draw", draw), ("program", program), ("Embedder", Embedder)))
'''


def test_a_new_encoder_kind_is_picked_up(tiny_bench, tmp_path):
    """The hashing encoder under another name and table seed, as one new
    file that records its calls, with a configuration and a cell that use
    it."""
    from harness.cell import run_cell

    calls = tmp_path / "calls.txt"
    (tiny_bench.dir / "encoders" / "hashing_b.py").write_text(
        (tiny_bench.dir / "encoders" / "hashing.py").read_text() + RECORDING % str(calls))
    cfg = tiny_bench.config("beir-quora.source")
    cfg["name"] = "beir-quora.source-b"
    cfg["encoder"].update(kind="hashing_b", table_seed=7)
    bench = _with_cell(tiny_bench, "quora-source-b.dup-b256", cfg, "dup",
                       "quora-source.dup-b256")
    out = run_cell(bench, "quora-source-b.dup-b256", 5, 0.2, False, torch.device("cpu"), 0.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0
    # weights drawn once, the program built once, the reference's embedder once
    assert calls.read_text().split() == ["draw", "program", "Embedder"]


LOADS_JAX = '''

import sys as _sys
import types as _types

_Embedder = Embedder


class Embedder(_Embedder):
    def embed(self, texts):
        _sys.modules.setdefault("jax", _types.ModuleType("jax"))
        return super().embed(texts)
'''


def test_a_reference_embedder_that_loads_jax_gives_no_result(tiny_bench):
    """An encoder kind whose reference embedder loads JAX (a stand-in
    module of that name) after the window has closed: the run ends with no
    result, naming it."""
    from harness.cell import run_cell

    (tiny_bench.dir / "encoders" / "hashing_jax.py").write_text(
        (tiny_bench.dir / "encoders" / "hashing.py").read_text() + LOADS_JAX)
    cfg = tiny_bench.config("beir-quora.source")
    cfg["name"] = "beir-quora.source-jax"
    cfg["encoder"].update(kind="hashing_jax")
    bench = _with_cell(tiny_bench, "quora-source-jax.dup-b256", cfg, "dup",
                       "quora-source.dup-b256")
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit) as e:
            run_cell(bench, "quora-source-jax.dup-b256", 5, 0.2, False,
                     torch.device("cpu"), 0.0)
    finally:
        sys.modules.pop("jax", None)
    assert "['jax']" in str(e.value)


VERBATIM = '''"""Query kind of a test: a document of the corpus, verbatim."""

from harness.corpus import QueryBatch


def draw(corpus, spec, rng, B):
    docs = rng.integers(0, len(corpus.texts), B)
    return QueryBatch([corpus.texts[d] for d in docs.tolist()], corpus.doc_cluster[docs])
'''


def test_a_new_query_kind_is_picked_up(tiny_bench):
    """A query kind of its own code, as one new file, with a traffic file
    and a cell that use it."""
    from harness.cell import run_cell

    (tiny_bench.dir / "queries" / "verbatim.py").write_text(VERBATIM)
    mix = tiny_bench.traffic("dup")
    mix["queries"] = {"kind": "verbatim"}
    (tiny_bench.dir / "traffic" / "verbatim.json").write_text(json.dumps(mix))
    bench = _with_cell(tiny_bench, "quora-source.verbatim", tiny_bench.config(
        "beir-quora.source"), "verbatim", "quora-source.dup-b256")
    out = run_cell(bench, "quora-source.verbatim", 5, 0.2, False, torch.device("cpu"), 0.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("family", ["encoders", "queries"])
def test_an_unknown_kind_is_refused_before_anything_is_drawn(tiny_bench, monkeypatch, family):
    from harness import cell

    w = tiny_bench.spec["workloads"][0]
    if family == "encoders":
        c = next(c for c in tiny_bench.spec["configs"] if c["name"] == w["config"])
        path = tiny_bench.root / c["file"]
        block = "encoder"
    else:
        path = tiny_bench.dir / "traffic" / f"{w['traffic']}.json"
        block = "queries"
    spec = json.loads(path.read_text())
    known = spec[block]["kind"]
    spec[block]["kind"] = "no_such_kind"
    path.write_text(json.dumps(spec))

    def drawn(*args, **kwargs):
        raise AssertionError("a corpus was drawn before the refusal")

    monkeypatch.setattr(cell, "make_corpus", drawn)
    with pytest.raises(ValueError) as e:
        cell.run_cell(tiny_bench, w["name"], 3, 0.2, False, torch.device("cpu"), 0.0)
    msg = str(e.value)
    assert "no_such_kind" in msg and str(tiny_bench.dir / family) in msg and known in msg


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


def _program_off_its_reference(bench):
    """The first cell's configuration on an encoder kind whose program
    serves a table of another seed than the one its reference embeds with."""
    src = (bench.dir / "encoders" / "hashing.py").read_text()
    (bench.dir / "encoders" / "hashing_off.py").write_text(src + '''

_program = program


def program(cfg, weights, dev):
    e = dict(cfg["encoder"], table_seed=cfg["encoder"]["table_seed"] + 1)
    return _program(cfg, draw(dict(cfg, encoder=e), dev), dev)
''')
    name = bench.workload(bench.spec["workloads"][0]["name"])["config"]
    c = next(c for c in bench.spec["configs"] if c["name"] == name)
    cfg = json.loads((bench.root / c["file"]).read_text())
    cfg["encoder"]["kind"] = "hashing_off"
    (bench.root / c["file"]).write_text(json.dumps(cfg))


def _certificate_never_closes(monkeypatch):
    from hybridsearch_tpu_torch.retrieval import searcher as searcher_mod

    for name in ("supertile_ladder", "impact_ladder"):
        real = getattr(searcher_mod, name)

        def never(*args, _real=real, **kwargs):
            st, rungs = _real(*args, **kwargs)
            st.exact[:] = False
            return st, rungs

        monkeypatch.setattr(searcher_mod, name, never)


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered, _certificate_never_closes,
                                   _program_off_its_reference])
def test_a_broken_path_is_not_correct(tiny_bench, monkeypatch, fault):
    from harness.cell import run_cell

    if fault is _certificate_never_closes:
        fault(monkeypatch)
    elif fault is _program_off_its_reference:
        fault(tiny_bench)
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
