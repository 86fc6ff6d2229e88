"""The plain reference and its frozen text rules.

- ``textops`` agrees with the program's tokenizer, token hash and hashing
  encoder features on sample text (the only place the two meet);
- the reference's fused scores equal a float64 NumPy brute force written
  from the formulas, within 2e-6 (float32 sums of a few hundred terms);
- the control (TF32 inputs) in the program's place, judged by a run's own
  check, comes out not correct; the float32 reference in its place, correct;
- a served document swapped for another leaves its band, and a row that
  names a document twice or is not sorted is bad;
- the reference modules and every encoder and query kind file load
  nothing of the program and nothing of JAX, nor does each configuration's
  reference embedder when it draws and embeds.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
SAMPLE = [
    "How do I learn Python quickly, and what's the BEST book?",
    "What is the difference between a DOG and a wolf? a_b c9 x",
    "",
    "the of and",  # stopwords only
    "word word word repeated repeated",
    "Why does my code_base fail at 3am on Mondays?",
]


def _hashing():
    from harness import kinds

    return kinds.load(BENCH / "encoders", "hashing")


def _paraphrases(corpus, B, seed):
    """The first batch of ``traffic/dup.json``'s queries over ``corpus``."""
    from harness import kinds
    from harness.corpus import QueryStream

    tr = json.loads((BENCH / "traffic" / "dup.json").read_text())
    draw = kinds.load(BENCH / "queries", tr["queries"]["kind"]).draw
    return QueryStream(corpus, tr["queries"], B, seed, 1, draw).batch(0).texts


def _encoder(n_buckets):
    """A configuration's ``encoder`` block of the hashing kind."""
    return {"encoder": {"kind": "hashing", "dim": 384, "n_buckets": n_buckets,
                        "bigram_weight": 0.5, "max_tokens": 256, "table_seed": 0}}


def test_frozen_text_rules_agree_with_the_program():
    from harness import textops
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder
    from hybridsearch_tpu_torch.text.extractor import (
        extract_tokens,
        hash_docs,
        stable_token_hash,
    )

    for text in SAMPLE:
        assert textops.tokens(text) == extract_tokens(text)
        assert [textops.fnv1a(t) for t in textops.tokens(text)] == [
            stable_token_hash(t) for t in extract_tokens(text)]
    mine, theirs = textops.hash_texts(SAMPLE), hash_docs(SAMPLE, bigrams=True)
    assert np.array_equal(mine.hashes, theirs.hashes)
    assert np.array_equal(mine.counts, theirs.counts)
    assert np.array_equal(mine.bigrams, theirs.bigrams)
    enc = HashingEncoder(dim=8, n_buckets=97, bigram_weight=0.5, max_tokens=5, device="cpu")
    ids, w = enc.features(SAMPLE)
    f = _hashing().encoder_features(mine, 97, 0.5, 5)
    for i in range(len(SAMPLE)):
        keep = w[i] > 0
        at = f.text_of == i
        assert ids[i][keep].tolist() == f.bucket[at].tolist()
        assert w[i][keep].tolist() == f.weight[at].tolist()


def _brute(texts, queries, table, e, p):
    """float64 NumPy from the formulas, token by token; ``e`` the hashing
    encoder's block."""
    from harness import textops

    table = table.double().numpy()

    def embed(text):
        toks = textops.tokens(text)
        feats = [(textops.fnv1a(t) % e["n_buckets"], 1.0) for t in toks]
        feats += [(textops.fnv1a(a + "_" + b) % e["n_buckets"], e["bigram_weight"])
                  for a, b in zip(toks, toks[1:])]
        feats = feats[:e["max_tokens"]]
        if not feats:
            return np.zeros(table.shape[1])
        v = sum(w * table[b] for b, w in feats) / sum(w for _b, w in feats)
        return v / max(np.linalg.norm(v), 1e-12)

    docs = np.stack([embed(t) for t in texts])
    toks = [textops.tokens(t) for t in texts]
    n = len(texts)
    lens = np.array([len(t) for t in toks], dtype=np.float64)
    avg = lens.mean()
    df = {}
    for t in toks:
        for w in set(t):
            df[w] = df.get(w, 0) + 1
    out = []
    for q in queries:
        sem = docs @ embed(q)
        lex = np.zeros(n)
        for w in textops.tokens(q):
            if w not in df:
                continue
            idf = np.log((n - df[w] + 0.5) / (df[w] + 0.5) + 1.0)
            for d in range(n):
                tf = toks[d].count(w)
                if tf:
                    lex[d] += idf * tf * (p.k1 + 1) / (tf + p.k1 * (1 - p.b + p.b * lens[d] / avg))

        def norm(x):
            r = x.max() - x.min()
            return (x - x.min()) / r if r > 1e-12 else np.ones_like(x)

        out.append(p.w_s * norm(sem) + p.w_l * norm(lex))
    return np.stack(out)


def test_reference_matches_a_float64_brute_force():
    from harness.corpus import make_corpus
    from harness.reference import Params, Reference

    cfg = json.loads((BENCH / "configs" / "beir-quora.clustered.json").read_text())
    corpus = make_corpus(dict(cfg["corpus"], n_docs=300))
    queries = _paraphrases(corpus, 12, 3) + SAMPLE[:2]
    texts = corpus.texts + SAMPLE
    g = torch.Generator().manual_seed(9)
    table = torch.randn((512, 384), generator=g) / np.sqrt(384)
    p = Params(1.5, 0.75, 0.7, 0.3)
    enc = _encoder(512)
    got = Reference(texts, _hashing().Embedder(enc, table), p).fused(queries).double().numpy()
    want = _brute(texts, queries, table, enc["encoder"], p)
    assert np.abs(got - want).max() < 2e-6


@pytest.mark.parametrize("precision, correct", [("tf32", False), ("fp32", True)])
def test_control_through_the_runs_own_check(tiny_bench, precision, correct):
    """The TF32 control in the program's place, held by the run's own
    comparison with the program's certificate deciding which rows are held,
    comes out not correct; the float32 reference itself in its place comes
    out correct and exact."""
    from harness.cell import run_cell

    for w in tiny_bench.spec["workloads"]:
        out = run_cell(tiny_bench, w["name"], 21, 0.3, False, torch.device("cpu"), 0.0,
                       control=precision)
        checks = {name: c["value"] for name, c in out["checks"].items()}
        assert out["correct"] is correct, (w["name"], checks)
        if correct:
            assert checks["score_gap"] == 0.0 and checks["exact_share"] == 100.0
        else:
            assert checks["score_gap"] > out["checks"]["score_gap"]["limit"]


def test_a_document_swapped_leaves_its_band():
    """Served rows whose documents are swapped for others (scores kept)
    leave the band that holds on every row, certified or not."""
    from harness.corpus import make_corpus
    from harness.reference import Params, Reference, judge, served_arrays

    cfg = json.loads((BENCH / "configs" / "beir-quora.clustered.json").read_text())
    corpus = make_corpus(dict(cfg["corpus"], n_docs=2000))
    queries = _paraphrases(corpus, 16, 5)
    g = torch.Generator().manual_seed(3)
    table = torch.randn((4096, 384), generator=g) / np.sqrt(384)
    ref = Reference(corpus.texts, _hashing().Embedder(_encoder(4096), table),
                    Params(1.5, 0.75, 0.7, 0.3))
    index_of = {t: i for i, t in reversed(list(enumerate(corpus.texts)))}
    rows = ref.topk_rows(queries, 10, corpus.texts)
    good = judge(ref, queries, served_arrays(rows, 16, 10, index_of), 10)
    assert good.band_gap.max() < 1e-6 and not good.bad.any()
    n = len(corpus.texts)
    swapped = [[(v, corpus.texts[(i + n // 2) % n], (i + n // 2) % n) for v, _t, i in r]
               for r in rows]
    bad = judge(ref, queries, served_arrays(swapped, 16, 10, index_of), 10)
    assert (bad.band_gap > 1e-5).mean() > 0.9


def test_a_repeated_or_unsorted_row_is_bad():
    from harness.reference import served_arrays

    texts = {f"d{i}": i for i in range(12)}
    rows = [[(1.0 - 0.01 * j, f"d{j}", j) for j in range(10)] for _ in range(3)]
    rows[1][4] = (rows[1][4][0], "d3", 3)  # a document twice
    rows[2][6] = (2.0, "d6", 6)  # a score above the one before it
    s = served_arrays(rows, 3, 10, texts)
    assert s.malformed.tolist() == [False, True, True]


LOADS = """
import json, sys
from pathlib import Path

bench = Path(sys.argv[1])
sys.path.insert(0, str(bench))
import torch
import harness.corpus, harness.kernel_bounds, harness.kinds, harness.reference, harness.textops

load = harness.kinds.load
kinds = [load(p.parent, p.stem) for d in ("encoders", "queries")
         for p in sorted((bench / d).glob("*.py"))]
spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
shapes = []
for c in spec["configs"]:
    cfg = json.loads((bench.parent / c["file"]).read_text())
    kind = load(bench / "encoders", cfg["encoder"]["kind"])
    weights = kind.draw(cfg, torch.device("cpu"))
    shapes.append(list(kind.Embedder(cfg, weights).embed(json.loads(sys.argv[2])).shape))
print(json.dumps({"kinds": len(kinds), "shapes": shapes,
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_reference_loads_nothing_of_the_program_or_jax():
    """Every encoder and query kind file is loaded whole, ``program``
    uncalled (it imports the program inside itself); every configuration's
    encoder kind draws its weights and its reference embedder embeds."""
    out = subprocess.run([sys.executable, "-c", LOADS, str(BENCH), json.dumps(SAMPLE)],
                         capture_output=True, text=True, check=True,
                         cwd=str(BENCH.parent)).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["kinds"] == len(list(BENCH.glob("encoders/*.py"))) + len(
        list(BENCH.glob("queries/*.py"))) >= 2
    configs = json.loads((BENCH.parent / "BENCHMARK.json").read_text())["configs"]
    assert len(got["shapes"]) == len(configs)
    assert all(n == len(SAMPLE) for n, _dim in got["shapes"])
    assert not set(got["modules"]) & {"jax", "jaxlib", "flax", "hybridsearch_tpu",
                                      "hybridsearch_tpu_torch"}
