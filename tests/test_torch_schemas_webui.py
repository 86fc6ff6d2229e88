"""The port's schema registry and web UIs (hybridsearch_tpu_torch/api/
schemas.py, webui.py, fastapi_app.py) against the JAX package's, on the
CPU: the OpenAPI document it renders equals docs/openapi.json (unedited),
its route table equals JAX's, the pydantic models keep the reference's
constraints, the HTML page's endpoints all exist, and ``streamlit_app``
drives a live port server through the stub ``streamlit`` module of
tests/test_webui.py. The FastAPI adapter runs only where fastapi is
installed, as in tests/test_schemas.py.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from hybridsearch_tpu.api import schemas as jschemas
from hybridsearch_tpu.api.app import EngineState as JState
from hybridsearch_tpu.api.app import build_router as j_build
from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.api import schemas as tschemas
from hybridsearch_tpu_torch.api.app import EngineState as TState
from hybridsearch_tpu_torch.api.app import build_router as t_build
from hybridsearch_tpu_torch.api.httpd import APIServer
from hybridsearch_tpu_torch.api.webui import HTML_PAGE

from test_webui import _StubStreamlit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _paths(router):
    return [(m, re.sub(r"\(\?P<(\w+)>\[\^/\]\+\)", r"{\1}",
                       p.pattern.lstrip("^").rstrip("$")))
            for m, p, _n, _h, _s in router._routes]


@pytest.fixture(scope="module")
def live(demo_docs):
    """A port engine over the demo docs, behind a live stdlib server."""
    jenc = JEnc(dim=128)
    state = TState(encoder=convert.hashing_encoder(np.asarray(jenc.table), device=CPU),
                   device=CPU)
    router = t_build(state)
    code, _, _ = router.dispatch("POST", "/index", {"documents": demo_docs})
    assert code == 200
    with APIServer(state, host="127.0.0.1", port=0) as server:
        yield state, router, f"http://127.0.0.1:{server.port}"
    state.close()


def test_route_table_equals_the_jax_one(live):
    _state, router, _base = live
    st = JState(encoder=JEnc(dim=64))
    try:
        jax_routes = [(m, p.pattern, s) for m, p, _n, _h, s in j_build(st)._routes]
    finally:
        st.close()
    assert [(m, p.pattern, s) for m, p, _n, _h, s in router._routes] == jax_routes
    assert len(jax_routes) == 32
    # every live route documented, every spec a live route
    assert set(_paths(router)) == set(tschemas.ROUTE_SPECS)


def test_specs_equal_the_jax_specs():
    assert tschemas.ROUTE_SPECS == jschemas.ROUTE_SPECS
    assert tschemas.build_openapi() == jschemas.build_openapi()


def test_static_openapi_export_is_current():
    with open(os.path.join(REPO, "docs", "openapi.json"), encoding="utf-8") as fh:
        on_disk = json.load(fh)
    assert on_disk == json.loads(json.dumps(tschemas.build_openapi(), sort_keys=True))


def test_openapi_document_structure():
    doc = tschemas.build_openapi()
    assert doc["openapi"].startswith("3.1")
    assert len(doc["paths"]) == len({p for _m, p in tschemas.ROUTE_SPECS})
    body = doc["paths"]["/search"]["post"]["requestBody"]["content"][
        "application/json"]["schema"]
    assert body["required"] == ["query"]
    assert body["properties"]["top_k"]["minimum"] == 1
    assert body["properties"]["top_k"]["maximum"] == 100
    assert any(p["in"] == "path" and p["name"] == "doc_id"
               for p in doc["paths"]["/documents/{doc_id}"]["delete"]["parameters"])
    assert "text/plain" in doc["paths"]["/metrics"]["get"]["responses"]["200"]["content"]


def test_export_openapi_writes_the_document(tmp_path):
    path = str(tmp_path / "openapi.json")
    tschemas.export_openapi(path)
    with open(path) as fh:
        assert json.load(fh) == json.loads(json.dumps(tschemas.build_openapi()))


def test_pydantic_models_enforce_reference_constraints():
    pytest.importorskip("pydantic")
    from pydantic import ValidationError

    models = tschemas.pydantic_request_models()
    assert set(models) == set(jschemas.pydantic_request_models())
    search = models[("POST", "/search")]
    ok = search(query="hello", top_k=10)
    assert ok.query == "hello" and ok.top_k == 10
    for bad in ({"top_k": 10}, {"query": "x", "top_k": 500},
                {"query": "x", "semantic_weight": 1.5}):
        with pytest.raises(ValidationError):
            search(**bad)
    with pytest.raises(ValidationError):
        models[("POST", "/feedback")](query="x", doc_id=1, rating=99)
    with pytest.raises(ValidationError):
        models[("POST", "/ask")](question="q", top_k=50)


def test_fastapi_adapter_end_to_end():
    pytest.importorskip("fastapi")
    from fastapi.testclient import TestClient

    from hybridsearch_tpu_torch.api.fastapi_app import create_app
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    cfg = EngineConfig()
    cfg.index.dim = 64
    client = TestClient(create_app(encoder=HashingEncoder(dim=64, device=CPU),
                                   config=cfg, device=CPU))
    assert client.get("/health").status_code == 200
    r = client.post("/index", json={"documents": ["alpha beta", "gamma"]})
    assert r.status_code == 200 and r.json()["indexed"] == 2
    assert client.post("/search", json={"query": "alpha", "top_k": 1}).json()["results"]
    assert client.post("/search", json={"top_k": 5}).status_code == 422
    assert "/search/filtered" in client.get("/openapi.json").json()["paths"]
    assert client.get("/metrics").headers["content-type"].startswith("text/plain")


def test_html_ui_served_and_endpoints_exist(live):
    _state, router, base = live
    import urllib.request

    with urllib.request.urlopen(base + "/", timeout=10) as resp:
        page = resp.read().decode()
    assert "hybridsearch_tpu_torch" in page and "doSearch" in page
    called = set(re.findall(r"post\('(/[\w/]+)'", HTML_PAGE))
    called |= set(re.findall(r"fetch\(api\+'(/[\w/]+)'", HTML_PAGE))
    from hybridsearch_tpu.api.webui import HTML_PAGE as JAX_PAGE

    assert called == (set(re.findall(r"post\('(/[\w/]+)'", JAX_PAGE))
                      | set(re.findall(r"fetch\(api\+'(/[\w/]+)'", JAX_PAGE)))
    routes = " ".join(router.routes())
    for path in called:
        assert path in routes, f"UI calls {path} but no route exists"


def test_streamlit_app_drives_live_api(live, monkeypatch):
    pytest.importorskip("requests")
    _state, _router, base = live
    stub = _StubStreamlit()
    monkeypatch.setitem(sys.modules, "streamlit", stub)
    monkeypatch.setenv("API_URL", base)
    from hybridsearch_tpu_torch.api.webui import streamlit_app

    streamlit_app()
    assert any("—" in w or "-" in w for w in stub.written)
    keys = set()
    for payload in stub.jsons:
        keys |= set(payload)
    assert "total_documents" in keys
    assert {"hits", "misses"} & keys or "hit_rate" in keys
