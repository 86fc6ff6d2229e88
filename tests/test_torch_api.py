"""The port's REST API (hybridsearch_tpu_torch/api/: EngineState, the
router and its 32 routes, the stdlib server, the CLI, auth) against the
JAX package's, on the CPU.

Every case of tests/test_api.py runs through both packages: the same
calls on two engine states built alike (the hashing encoder's table and
the tiny cross-encoder's weights carried across with ``convert``), and
the same status codes and payloads must come back. Payloads are compared
leaving out clock readings (``latency_ms``, ``uptime_s``, the jobs' and
documents' timestamps) and the jobs' random ids; scores within rtol 1e-4
/ atol 1e-5, ids equal except among near-ties within 1e-4 (the searcher
parity tests' bounds). One case is the port's alone: ``/search`` from 8
threads while a ``/jobs/index`` job adds documents.
"""

import copy
import json
import re
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import hybridsearch_tpu_torch
from hybridsearch_tpu.api import cli as jcli
from hybridsearch_tpu.api.app import EngineState as JState
from hybridsearch_tpu.api.app import build_router as j_build
from hybridsearch_tpu.api.httpd import APIServer as JServer
from hybridsearch_tpu.models import encoder as jenc_mod
from hybridsearch_tpu.models.bert import BertConfig as JBertConfig
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu.models.minilm import MiniLMCrossEncoder as JCE
from hybridsearch_tpu.retrieval import reranker as jrr_mod
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.api import cli as tcli
from hybridsearch_tpu_torch.api.app import EngineState as TState
from hybridsearch_tpu_torch.api.app import build_router as t_build
from hybridsearch_tpu_torch.api.httpd import APIServer as TServer
from hybridsearch_tpu_torch.models import encoder as tenc_mod
from hybridsearch_tpu_torch.models.bert import BertConfig as TBertConfig
from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder as TCE
from hybridsearch_tpu_torch.retrieval import reranker as trr_mod

CPU = torch.device("cpu")
RTOL, ATOL, TIE = 1e-4, 1e-5, 1e-4
# clock readings and random ids: never equal between two runs
UNCOMPARED = {"latency_ms", "uptime_s", "created_at", "updated_at", "job_id"}
_STAGE_SECONDS = re.compile(r"^t_\w+_s$")


# -- two engines built alike ------------------------------------------------------------

_ENCODERS = {}


def encoders(dim: int):
    """(the JAX hashing encoder, the port's with the same table)."""
    if dim not in _ENCODERS:
        jenc = JEnc(dim=dim)
        _ENCODERS[dim] = (jenc, convert.hashing_encoder(np.asarray(jenc.table),
                                                        device=CPU))
    return _ENCODERS[dim]


@pytest.fixture(scope="module")
def cross_encoders():
    """A tiny random float32 cross-encoder, its weights carried across."""
    spec = dict(vocab_size=2000, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128)
    jce = JCE(cfg=JBertConfig(dtype=jnp.float32, **spec), dim=64, max_seq_len=64)
    tce = TCE(cfg=TBertConfig(dtype=torch.float32, **spec), dim=64, max_seq_len=64,
              device=CPU)
    import flax

    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(flax.core.meta.unbox(jce.params)).items()}
    tce.model.load_state_dict(convert.bert_state(flat), strict=True)
    return jce, tce


@pytest.fixture()
def tiny_rerankers(cross_encoders, monkeypatch):
    """Each package's ``CrossEncoderReranker()`` (built inside /rerank)
    serves the tiny carried cross-encoder."""
    jce, tce = cross_encoders
    real_j, real_t = jrr_mod.CrossEncoderReranker, trr_mod.CrossEncoderReranker
    monkeypatch.setattr(jrr_mod, "CrossEncoderReranker",
                        lambda *a, **k: real_j(model=jce))
    monkeypatch.setattr(trr_mod, "CrossEncoderReranker",
                        lambda *a, **k: real_t(model=tce))


def _is_rows(x) -> bool:
    return (isinstance(x, list) and x and all(isinstance(r, dict) for r in x)
            and all("doc_id" in r and "score" in r for r in x))


def same_rows(jr, tr, where):
    assert len(jr) == len(tr), where
    js = np.array([r["score"] for r in jr], np.float64)
    ts = np.array([r["score"] for r in tr], np.float64)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL, err_msg=where)
    for j, (a, b) in enumerate(zip(jr, tr)):
        if a["doc_id"] != b["doc_id"]:
            assert (np.abs(js - js[j]) <= TIE).sum() > 1 or (
                j == len(jr) - 1), f"{where}: slot {j} ids differ outside a near-tie"
        else:
            rest = {k: v for k, v in a.items() if k != "score"}
            assert rest == {k: v for k, v in b.items() if k != "score"}, where


def assert_same(j, t, where="payload"):
    """Two JSON payloads equal outside the uncompared keys; result rows by
    ``same_rows``; other floats within rtol 1e-4 / atol 1e-5."""
    if isinstance(j, dict):
        assert isinstance(t, dict), where
        keys = {k for k in j if k not in UNCOMPARED and not _STAGE_SECONDS.match(k)}
        assert keys == {k for k in t if k not in UNCOMPARED
                        and not _STAGE_SECONDS.match(k)}, where
        for k in keys:
            if k in ("stages", "stats"):  # process-wide stage timers / CE stats
                continue
            assert_same(j[k], t[k], f"{where}.{k}")
    elif _is_rows(j):
        same_rows(j, t, where)
    elif isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), where
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(j, float) and not isinstance(j, bool):
        assert isinstance(t, (int, float)), where
        assert abs(t - j) <= ATOL + RTOL * abs(j), f"{where}: {t} vs {j}"
    else:
        assert j == t, f"{where}: {t!r} vs {j!r}"


class Pair:
    """The JAX engine and the port's, each with its own router."""

    def __init__(self, dim: int = 128, **kw):
        jenc, tenc = encoders(dim)
        self.j = JState(encoder=jenc, **kw)
        self.t = TState(encoder=tenc, device=CPU, **kw)
        self.routers = (j_build(self.j), t_build(self.t))

    def call(self, method, path, body=None, query=None, **kw):
        """Dispatch on both; the codes, payloads and headers must agree.
        Returns the port's (code, payload, headers)."""
        (jc, jp, jh), (tc, tp, th) = (
            r.dispatch(method, path, body=copy.deepcopy(body),
                       query=copy.deepcopy(query), **kw) for r in self.routers)
        assert tc == jc, (method, path, jp, tp)
        if isinstance(jp, dict) and "_text" in jp:
            assert isinstance(tp, dict) and "_text" in tp
        else:
            assert_same(jp, tp, f"{method} {path}")
        assert set(th) == set(jh)
        return tc, tp, th

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture(scope="module")
def pair(demo_docs):
    p = Pair()
    code, _, _ = p.call("POST", "/index", {"documents": demo_docs})
    assert code == 200
    yield p
    p.close()


# -- core routes -------------------------------------------------------------------


def test_routes_are_the_jax_routes(pair):
    assert pair.routers[1].routes() == pair.routers[0].routes()
    assert len(pair.routers[1].routes()) == 32


def test_health(pair):
    code, payload, _ = pair.call("GET", "/health")
    assert code == 200 and payload["status"] == "healthy"
    assert payload["documents"] == 12


def test_search_route_and_semantic_cache(pair):
    code, p1, _ = pair.call("POST", "/search", {"query": "machine learning", "top_k": 3})
    assert code == 200 and len(p1["results"]) == 3
    assert p1["cached"] is False
    code, p2, _ = pair.call("POST", "/search", {"query": "machine learning", "top_k": 3})
    assert p2["cached"] is True
    assert [r["doc_id"] for r in p2["results"]] == [r["doc_id"] for r in p1["results"]]


@pytest.mark.parametrize("body", [
    {},
    {"query": "x", "semantic_weight": 0.9, "lexical_weight": 0.9},
], ids=["missing_query", "invalid_weights"])
def test_search_rejects(pair, body):
    code, _, _ = pair.call("POST", "/search", body)
    assert code == 400


def test_search_batch(pair):
    code, payload, _ = pair.call("POST", "/search/batch",
                                 {"queries": ["machine learning", "pasta"], "top_k": 2})
    assert code == 200 and len(payload["results"]) == 2


def test_search_funnel_batched(pair, cross_encoders):
    jce, tce = cross_encoders
    pair.j._funnel_reranker = jrr_mod.CrossEncoderReranker(model=jce)
    pair.t._funnel_reranker = trr_mod.CrossEncoderReranker(model=tce)
    code, payload, _ = pair.call("POST", "/search/funnel",
                                 {"queries": ["machine learning", "cooking pasta"],
                                  "stage1_k": 8, "stage2_k": 4, "top_k": 3})
    assert code == 200
    assert payload["stage1_k"] == 8 and payload["stage2_k"] == 4
    assert len(payload["results"]) == 2
    for row in payload["results"]:
        scores = [r["score"] for r in row["results"]]
        assert scores == sorted(scores, reverse=True)
        assert len(row["results"]) <= 3
    code, _, _ = pair.call("POST", "/search/funnel", {})
    assert code == 400


def test_search_highlighted(pair):
    code, payload, _ = pair.call("POST", "/search/highlighted",
                                 {"query": "machine learning", "style": "html"})
    assert code == 200
    assert any("<mark>" in r["highlighted"] for r in payload["results"])


def test_search_filtered_prefilter(pair):
    for st in (pair.j, pair.t):
        for i in range(12):
            st.metadata.set_metadata(i, {"topic": "tech" if i in (0, 1, 3) else "other"})
    code, payload, _ = pair.call("POST", "/search/filtered",
                                 {"query": "machine learning", "filter": "topic:tech",
                                  "top_k": 5})
    assert code == 200
    ids = {r["doc_id"] for r in payload["results"]}
    assert ids <= {0, 1, 3} and ids
    code, _, _ = pair.call("POST", "/search/filtered", {"query": "x", "filter": "((("})
    assert code == 400


def test_index_inline_metadata_arms_prefilter():
    p = Pair()
    try:
        docs = [
            {"content": "jax compiles to tpu", "metadata": {"year": 2024}},
            {"content": "bm25 lexical ranking", "metadata": {"year": 2019}},
            {"content": "hybrid dense sparse fusion", "metadata": {"year": 2023}},
        ]
        code, _, _ = p.call("POST", "/index", {"documents": docs})
        assert code == 200
        code, payload, _ = p.call("POST", "/search/filtered",
                                  {"query": "ranking fusion", "filter": "year:>2021",
                                   "top_k": 3})
        assert code == 200
        ids = {r["doc_id"] for r in payload["results"]}
        assert ids and ids <= {0, 2}
        code, p2, _ = p.call("POST", "/index/add", {"documents": [
            {"content": "mosaic pallas kernels", "metadata": {"year": 2025}}]})
        assert code == 200
        assert p.t.metadata.get_metadata(p2["doc_ids"][0]) == {"year": 2025}
    finally:
        p.close()


def test_rerank_route(pair, tiny_rerankers):
    code, payload, _ = pair.call("POST", "/rerank",
                                 {"query": "ml", "documents": ["a doc", "b doc"]})
    assert code == 200 and len(payload["results"]) == 2


def test_ask_route(pair):
    """An unknown LLM provider is a 400 in both; no LLM is reached."""
    code, _, _ = pair.call("POST", "/ask", {"question": "what is ml",
                                            "llm_provider": "no-such-provider"})
    assert code == 400
    code, _, _ = pair.call("POST", "/ask", {})
    assert code == 400


def test_feedback_and_stats(pair):
    code, _, _ = pair.call("POST", "/feedback",
                           {"query": "machine learning", "doc_id": 1, "rating": 1})
    assert code == 200
    code, payload, _ = pair.call("GET", "/stats")
    assert code == 200 and payload["total_documents"] == 12
    assert payload["total_feedback"] >= 1
    assert "encode" in payload["stages"]


def test_documents_pagination(pair):
    code, payload, _ = pair.call("GET", "/documents", query={"limit": "5", "offset": "10"})
    assert code == 200 and payload["total"] == 12
    assert len(payload["documents"]) == 2


def test_autocomplete_routes(pair):
    pair.call("POST", "/search", {"query": "machine learning"})
    code, payload, _ = pair.call("GET", "/autocomplete", query={"prefix": "mach"})
    assert code == 200
    assert any(s["suggestion"].startswith("machine") for s in payload["suggestions"])
    code, _, _ = pair.call("POST", "/autocomplete/record",
                           {"suggestion": "machine learning"})
    assert code == 200


def test_cache_stats_and_invalidate(pair):
    code, payload, _ = pair.call("GET", "/cache/stats")
    assert code == 200 and payload["enabled"] is True
    code, _, _ = pair.call("POST", "/cache/invalidate")
    assert code == 200


def test_duplicates_and_mark(pair):
    code, _, _ = pair.call("GET", "/documents/duplicates")
    assert code == 200
    code, _, _ = pair.call("POST", "/documents/3/mark-duplicate", {"duplicate_of": 1})
    assert code == 200
    assert pair.t.indexer.store.get_document(3)["is_duplicate_of"] == 1


def test_metadata_routes(pair):
    code, _, _ = pair.call("POST", "/documents/5/metadata",
                           {"metadata": {"lang": "en", "year": 2024}})
    assert code == 200
    code, payload, _ = pair.call("GET", "/documents/5/metadata")
    assert code == 200 and payload["metadata"]["year"] == 2024
    code, _, _ = pair.call("GET", "/documents/999/metadata")
    assert code == 404


def test_language_detect_route(pair):
    code, payload, _ = pair.call("POST", "/language/detect",
                                 {"text": "the cat sat on the mat and it was happy"})
    assert code == 200 and payload["language"] == "en"


def _wait_job(router, jid):
    for _ in range(500):
        code, job, _ = router.dispatch("GET", f"/jobs/{jid}")
        if job["state"] in ("completed", "failed"):
            return job
        time.sleep(0.02)
    return job


def test_jobs_flow(pair):
    jobs = []
    for r in pair.routers:
        code, payload, _ = r.dispatch("POST", "/jobs/index",
                                      {"documents": ["new doc about tennis rackets"]})
        assert code == 202 and payload["state"] == "pending"
        jobs.append(_wait_job(r, payload["job_id"]))
    assert_same(jobs[0], jobs[1], "job")
    assert jobs[1]["state"] == "completed" and jobs[1]["result"]["added"] == 1
    for r, job in zip(pair.routers, jobs):
        code, payload, _ = r.dispatch("GET", "/jobs")
        assert code == 200 and any(j["job_id"] == job["job_id"] for j in payload["jobs"])
    code, _, _ = pair.call("GET", "/jobs/nonexistent")
    assert code == 404
    code, _, _ = pair.call("DELETE", "/jobs/nonexistent")
    assert code == 400


def test_index_add_with_dedup(pair):
    existing = pair.t.indexer.contents[0]
    assert existing == pair.j.indexer.contents[0]
    code, payload, _ = pair.call("POST", "/index/add",
                                 {"documents": [existing], "dedup": "skip"})
    assert code == 200
    assert payload["added"] == 0 and len(payload["skipped"]) == 1


def test_unknown_route(pair):
    code, _, _ = pair.call("GET", "/nope")
    assert code == 404


def test_metrics_endpoint(pair):
    pair.call("POST", "/search", {"query": "machine learning", "top_k": 2})
    texts = [r.dispatch("GET", "/metrics")[1]["_text"] for r in pair.routers]
    text = texts[1]
    assert "hst_documents_total 1" in text
    assert "hst_queries_total" in text
    assert 'hst_stage_latency_ms{stage="encode"' in text
    assert "hst_cache_hits_total" in text
    # the engine's own gauges and counters read alike (stage timers and
    # process-wide counters are per package)
    keep = ("hst_documents_total", "hst_queries_total", "hst_feedback_total",
            "hst_cache_", "hst_batch_")

    def lines(t):
        return [ln for ln in t.splitlines() if ln.startswith(keep)]

    assert lines(texts[1]) == lines(texts[0])


# -- auth enforcement ------------------------------------------------------------------


def test_auth_enforced_when_enabled():
    p = Pair(dim=64, auth_enabled=True, use_semantic_cache=False)
    try:
        code, _, _ = p.call("GET", "/health")
        assert code == 401
        keys = [st.auth.keys.create_key("reader", scopes={"read"}).key
                for st in (p.j, p.t)]
        wkeys = [st.auth.keys.create_key("writer", scopes={"read", "write"}).key
                 for st in (p.j, p.t)]
        for r, key, wkey in zip(p.routers, keys, wkeys):
            code, _, headers = r.dispatch("GET", "/health", api_key=key)
            assert code == 200 and "X-RateLimit-Remaining" in headers
            code, _, _ = r.dispatch("POST", "/index", {"documents": ["x"]}, api_key=key)
            assert code == 403
            code, _, _ = r.dispatch("POST", "/index", {"documents": ["x"]},
                                    api_key=wkey)
            assert code == 200
    finally:
        p.close()


# -- live HTTP server -----------------------------------------------------------------------


def _http(base, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method or (
        "GET" if body is None else "POST"), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers, resp.read()


def test_httpd_end_to_end(pair):
    out = []
    for st, server_cls in ((pair.j, JServer), (pair.t, TServer)):
        with server_cls(st, host="127.0.0.1", port=0) as server:
            base = f"http://127.0.0.1:{server.port}"
            code, _, raw = _http(base, "/health")
            assert code == 200 and json.loads(raw)["status"] == "healthy"
            code, _, raw = _http(base, "/search",
                                 {"query": "machine learning", "top_k": 2})
            out.append(json.loads(raw))
            code, headers, raw = _http(base, "/metrics")
            assert code == 200 and headers["Content-Type"].startswith("text/plain")
            assert "hst_documents_total" in raw.decode()
            code, headers, raw = _http(base, "/")
            assert code == 200 and b"doSearch" in raw
    assert len(out[1]["results"]) == 2
    assert_same(out[0], out[1], "http /search")


def test_httpd_answers_a_burst_of_connections(pair):
    """128 clients connecting at once, 3 requests each on a kept-alive
    connection: every one is answered. (The JAX server keeps
    socketserver's listen backlog of 5 and drops or resets part of such a
    burst, R13 in ROADMAP.md; the port's backlog is 1,024.)"""
    import http.client

    n = 128
    with TServer(pair.t, host="127.0.0.1", port=0) as server:
        start = threading.Barrier(n)
        codes, errs = [], []

        def client():
            try:
                conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
                start.wait()
                for _ in range(3):
                    conn.request("GET", "/health")
                    resp = conn.getresponse()
                    resp.read()
                    codes.append(resp.status)
                conn.close()
            except Exception as e:  # noqa: BLE001  (counted below)
                errs.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not errs, errs[:3]
    assert codes == [200] * (3 * n)


# -- CLI -----------------------------------------------------------------------------------------


@pytest.fixture()
def cli_encoders(monkeypatch):
    """Each CLI's default encoder is the pair of carried hashing encoders."""
    jenc, tenc = encoders(384)
    monkeypatch.setattr(jenc_mod, "default_encoder", lambda *a, **k: jenc)
    monkeypatch.setattr(tenc_mod, "default_encoder", lambda *a, **k: tenc)


def _cli_both(tmp_path, capsys, name, *argv):
    """Run each CLI on its own db; returns (jax stdout, port stdout)."""
    outs = []
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("torch", tcli.main, ["--device", "cpu"])):
        db = str(tmp_path / f"{pkg}_{name}.db")
        args = [a.replace("{pkg}", pkg) for a in argv]
        assert main(["--db", db, *extra, *args]) == 0
        outs.append(capsys.readouterr().out)
    return outs


def test_cli_index_search_stats(tmp_path, capsys, cli_encoders):
    docs_dir = tmp_path / "docs"
    docs_dir.mkdir()
    (docs_dir / "ml.txt").write_text("machine learning models learn from data")
    (docs_dir / "cook.txt").write_text("boil pasta with salt and olive oil")
    j, t = _cli_both(tmp_path, capsys, "cli", "index", str(docs_dir))
    assert "indexed 2 documents" in t and t == j
    j, t = _cli_both(tmp_path, capsys, "cli", "search", "machine learning", "--top-k", "1")
    assert "machine learning" in t
    assert t.split("]")[1:] == j.split("]")[1:]  # rank, doc and text; score aside
    j, t = _cli_both(tmp_path, capsys, "cli", "stats")
    assert "Documents indexed: 2" in t and '"total_documents"' not in t and t == j
    j, t = _cli_both(tmp_path, capsys, "cli", "stats", "--json")
    assert '"total_documents": 2' in t
    js, ts = (json.loads(x[x.index("{"):]) for x in (j, t))
    js.pop("stages"), ts.pop("stages")
    assert_same(js, ts, "stats --json")
    j, t = _cli_both(tmp_path, capsys, "cli", "search", "machine learning", "-k", "1",
                     "-w", "0.8", "--json", "--learned")
    rows = json.loads(t)
    assert rows and set(rows[0]) == {"score", "content", "doc_id"}
    assert_same(json.loads(j), rows, "search --json")


def test_cli_export_import(tmp_path, capsys, cli_encoders):
    docs_dir = tmp_path / "docs"
    docs_dir.mkdir()
    (docs_dir / "a.txt").write_text("alpha document content")
    _cli_both(tmp_path, capsys, "a", "index", str(docs_dir))
    dump = str(tmp_path / "{pkg}_dump.json")
    _cli_both(tmp_path, capsys, "a", "export", dump)
    dumps = [json.load(open(tmp_path / f"{pkg}_dump.json")) for pkg in ("jax", "torch")]
    assert_same(dumps[0], dumps[1], "export")
    j, t = _cli_both(tmp_path, capsys, "b", "import", dump)
    assert "imported 1 documents" in t and t.replace("torch", "jax") == j


def test_cli_has_no_bench_and_takes_a_device(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["bench"])
    capsys.readouterr()
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    text = capsys.readouterr().out
    assert "--device" in text and "bench" not in text


def test_module_entry_point_runs_the_cli(tmp_path):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "hybridsearch_tpu_torch", "--help"],
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(__import__("pathlib").Path(
                                  hybridsearch_tpu_torch.__file__).parents[1])})
    assert out.returncode == 0, out.stderr
    for cmd in ("search", "index", "add", "stats", "export", "import", "serve", "demo"):
        assert cmd in out.stdout


# -- more reference-parity cases -----------------------------------------------------------


def test_autocomplete_warm_start(tmp_path, demo_docs):
    outs = []
    for pkg in ("jax", "torch"):
        jenc, tenc = encoders(64)
        db = str(tmp_path / f"{pkg}_warm.db")
        mk = ((lambda: JState(db_path=db, encoder=jenc, use_semantic_cache=False))
              if pkg == "jax" else
              (lambda: TState(db_path=db, encoder=tenc, use_semantic_cache=False,
                              device=CPU)))
        build = j_build if pkg == "jax" else t_build
        st = mk()
        r = build(st)
        r.dispatch("POST", "/index", {"documents": demo_docs})
        r.dispatch("POST", "/search", {"query": "machine learning"})
        st.close()
        st2 = mk()
        code, payload, _ = build(st2).dispatch("GET", "/autocomplete",
                                               query={"prefix": "mach"})
        st2.close()
        outs.append(payload)
    assert_same(outs[0], outs[1], "autocomplete")
    assert any(s["suggestion"] == "machine learning" for s in outs[1]["suggestions"])


def test_delete_document_route(demo_docs):
    p = Pair(dim=64, use_semantic_cache=False)
    try:
        p.call("POST", "/index", {"documents": demo_docs})
        code, before, _ = p.call("POST", "/search",
                                 {"query": "machine learning", "top_k": 1})
        target = before["results"][0]["doc_id"]
        code, payload, _ = p.call("DELETE", f"/documents/{target}")
        assert code == 200 and payload["doc_id"] == target
        code, after, _ = p.call("POST", "/search",
                                {"query": "machine learning", "top_k": 11})
        assert target not in [x["doc_id"] for x in after["results"]]
        code, _, _ = p.call("DELETE", "/documents/999")
        assert code == 404
        code, docs, _ = p.call("GET", "/documents")
        assert target not in [d["doc_id"] for d in docs["documents"]]
    finally:
        p.close()


def test_index_accepts_reference_document_objects():
    p = Pair(dim=64, use_semantic_cache=False)
    try:
        code, payload, _ = p.call("POST", "/index", {"documents": [
            {"content": "JAX compiles programs for TPU hardware",
             "source_path": "/data/a.txt"},
            {"content": "BM25 ranks documents by term frequency"},
            "plain string document about cats and dogs",
        ]})
        assert code == 200 and payload["indexed"] == 3
        code, res, _ = p.call("POST", "/search", {"query": "TPU hardware", "top_k": 1})
        assert code == 200 and res["results"]
        code, payload, _ = p.call("POST", "/index/add", {"documents": [
            {"content": "incremental object add"}]})
        assert code == 200 and payload["added"] == 1
        code, _, _ = p.call("POST", "/index", {"documents": [{"text": "no content key"}]})
        assert code == 400
        code, _, _ = p.call("POST", "/jobs/index", {"documents": [123]})
        assert code == 400
    finally:
        p.close()


def test_search_response_reference_fields_and_feedback_by_query_id(demo_docs):
    p = Pair(dim=64, use_semantic_cache=False)
    try:
        p.call("POST", "/index", {"documents": demo_docs})
        code, res, _ = p.call("POST", "/search",
                              {"query": "machine learning", "top_k": 3,
                               "semantic_weight": 0.6, "lexical_weight": 0.4})
        assert code == 200 and isinstance(res["query_id"], int)
        assert res["weights_used"] == {"semantic": 0.6, "lexical": 0.4, "learned": False}
        code, payload, _ = p.call("POST", "/feedback",
                                  {"query_id": res["query_id"],
                                   "doc_id": res["results"][0]["doc_id"],
                                   "relevance_score": 4, "clicked": True})
        assert code == 200 and payload["status"] == "success"
        code, _, _ = p.call("POST", "/feedback",
                            {"query_id": 10**9, "doc_id": 0, "relevance_score": 1})
        assert code == 404
        for _ in range(9):
            code, res, _ = p.call("POST", "/search",
                                  {"query": "machine learning", "top_k": 1,
                                   "semantic_weight": 0.6, "lexical_weight": 0.4})
            p.call("POST", "/feedback", {"query_id": res["query_id"],
                                         "doc_id": res["results"][0]["doc_id"],
                                         "clicked": True})
        assert p.t.searcher.query_memory.get_optimal_weights() is not None
        assert p.t.searcher.resolve_weights(None, None) == (0.7, 0.3)
        sw, lw = p.t.searcher.resolve_weights(None, None, use_learned_weights=True)
        assert abs(sw - 0.6) < 1e-6 and abs(lw - 0.4) < 1e-6
        code, res, _ = p.call("POST", "/search", {"query": "machine learning",
                                                  "top_k": 1,
                                                  "use_learned_weights": True})
        assert res["weights_used"]["learned"] is True
        assert abs(res["weights_used"]["semantic"] - 0.6) < 1e-6
    finally:
        p.close()


def test_rerank_by_doc_ids_and_autocomplete_post(demo_docs, tiny_rerankers):
    p = Pair(dim=64, use_semantic_cache=False)
    try:
        p.call("POST", "/index", {"documents": demo_docs})
        code, payload, _ = p.call("POST", "/rerank", {"query": "machine learning",
                                                      "doc_ids": [0, 1, 2], "top_k": 2})
        assert code == 200 and len(payload["results"]) == 2
        assert {row["doc_id"] for row in payload["results"]} <= {0, 1, 2}
        code, _, _ = p.call("POST", "/rerank", {"query": "x", "doc_ids": [99999]})
        assert code == 404
        code, payload, _ = p.call("POST", "/rerank", {},
                                  query={"query": "machine learning",
                                         "doc_ids": ["0", "1"], "top_k": "1"})
        assert code == 200 and len(payload["results"]) == 1
        p.call("POST", "/search", {"query": "machine learning", "top_k": 1})
        code, payload, _ = p.call("POST", "/autocomplete",
                                  {"partial_query": "mach", "limit": 5})
        assert code == 200 and isinstance(payload, list) and payload
        assert set(payload[0]) == {"text", "score", "source", "frequency"}
        code, _, _ = p.call("POST", "/autocomplete/record", {},
                            query={"partial_query": "mach",
                                   "selected": "machine learning"})
        assert code == 200
    finally:
        p.close()


def test_index_directory_and_watcher_routes(tmp_path):
    """/index/directory indexes a directory's files; the watcher starts,
    refuses a second start and stops (the port's and JAX's alike)."""
    d = tmp_path / "corpus"
    d.mkdir()
    (d / "a.txt").write_text("alpha document about gardens")
    (d / "b.txt").write_text("beta document about pasta")
    p = Pair(dim=64, use_semantic_cache=False)
    try:
        code, payload, _ = p.call("POST", "/index/directory", {"directory": str(d)})
        assert code == 200 and payload["indexed"] == 2
        code, _, _ = p.call("POST", "/index/directory", {})
        assert code == 400
        code, _, _ = p.call("POST", "/watcher/stop")
        assert code == 400
        code, payload, _ = p.call("POST", "/watcher/start", {"directory": str(d)})
        assert code == 200 and payload["status"] == "watching"
        code, _, _ = p.call("POST", "/watcher/start", {"directory": str(d)})
        assert code == 400
        code, _, _ = p.call("POST", "/watcher/stop")
        assert code == 200
    finally:
        p.close()


# -- the port's own: searches while a job adds documents ---------------------------------------


def test_searches_during_an_index_job(demo_docs):
    """8 threads of /search (through the batcher) while a /jobs/index job
    adds documents: every response is 200 and names only docs that exist
    when it is answered."""
    tenc = encoders(64)[1]
    st = TState(encoder=tenc, device=CPU, use_semantic_cache=False)
    r = t_build(st)
    try:
        r.dispatch("POST", "/index", {"documents": demo_docs})
        new = [f"added document {i} about topic {i % 5} and learning" for i in range(96)]
        code, job, _ = r.dispatch("POST", "/jobs/index", {"documents": new})
        assert code == 202
        bad, seen = [], []

        def worker(w):
            for i in range(6):
                q = ["machine learning", "topic 3 learning", "pasta salt",
                     "added document"][(w + i) % 4]
                code, payload, _ = r.dispatch("POST", "/search", {"query": q, "top_k": 5})
                n = len(st.indexer.contents)
                ids = [x["doc_id"] for x in payload.get("results", [])]
                seen.append(len(ids))
                if code != 200 or any(i >= n for i in ids):
                    bad.append((code, payload, n))

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        job = _wait_job(r, job["job_id"])
        assert job["state"] == "completed" and job["result"]["added"] == 96
        assert not bad, bad[:3]
        assert len(seen) == 48 and min(seen) > 0
        code, payload, _ = r.dispatch("POST", "/search", {"query": "added document 7",
                                                          "top_k": 3})
        assert code == 200 and len(st.indexer.contents) == 108
    finally:
        st.close()
