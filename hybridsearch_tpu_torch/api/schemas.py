"""Request/response schemas for every API route (a copy of
``hybridsearch_tpu/api/schemas.py``: the port serves the same routes, so
``build_openapi()`` renders the same document, ``docs/openapi.json``).

The reference validates at the API edge with Pydantic models + Field
constraints (reference api.py:26-73, :401-423, :567-576, :709-716,
:806-815, :937-941) and gets OpenAPI docs for free from FastAPI. This
framework keeps the router dependency-free, so the schemas live here as
plain data:

  - `ROUTE_SPECS` is the single source of truth: one entry per route with
    the request-body fields (types + the reference's ge/le/min_length
    constraints), query params, and response shapes;
  - `build_openapi()` renders a static OpenAPI 3.1 document from it (works
    with zero dependencies — exported to docs/openapi.json so the schema
    exists even where fastapi/pydantic are not installed);
  - `pydantic_request_models()` materializes real Pydantic models from the
    same specs when pydantic IS installed (used by api/fastapi_app.py for
    per-route registration: automatic 422s, typed docs).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

JSON = Dict[str, Any]


def f(
    type: str,
    required: bool = False,
    default: Any = None,
    ge: Optional[float] = None,
    le: Optional[float] = None,
    min_length: Optional[int] = None,
    items: Optional[JSON] = None,
    description: str = "",
    enum: Optional[list] = None,
) -> JSON:
    """Field spec shorthand."""
    out: JSON = {"type": type, "required": required}
    if default is not None or not required:
        out["default"] = default
    for k, v in (("ge", ge), ("le", le), ("min_length", min_length),
                 ("items", items), ("description", description),
                 ("enum", enum)):
        if v not in (None, ""):
            out[k] = v
    return out


STR_ARRAY = {"type": "string"}

_SEARCH_FIELDS = {
    "query": f("string", required=True, min_length=1,
               description="Search query"),
    "top_k": f("integer", default=5, ge=1, le=100,
               description="Number of results"),
    "semantic_weight": f("number", ge=0, le=1,
                         description="Semantic arm weight (sums to 1 with "
                                     "lexical_weight)"),
    "lexical_weight": f("number", ge=0, le=1,
                        description="Lexical arm weight"),
    "use_learned_weights": f("boolean", default=False,
                             description="Use weights learned from "
                                         "feedback (reference parity)"),
}

_RESULT_ROW = {
    "type": "object",
    "properties": {
        "score": {"type": "number"},
        "content": {"type": "string"},
        "doc_id": {"type": "integer"},
    },
}

# (method, path) -> spec. `request` fields mirror the reference's Pydantic
# models; `query_params` are URL params; `responses` document the shapes the
# handlers in api/app.py actually return.
ROUTE_SPECS: Dict[Tuple[str, str], JSON] = {
    ("GET", "/health"): {
        "summary": "Liveness + corpus size",
        "responses": {200: {"status": "string", "documents": "integer",
                            "uptime_s": "number"}},
    },
    ("POST", "/search"): {
        "summary": "Hybrid search (semantic-cache aware)",
        "request": dict(_SEARCH_FIELDS),
        "responses": {200: {"query": "string", "query_id": "integer",
                            "results": [_RESULT_ROW],
                            "weights_used": "object",
                            "latency_ms": "number", "cached": "boolean"},
                      400: "detail"},
    },
    ("POST", "/search/batch"): {
        "summary": "Batched hybrid search (one device program)",
        "request": {
            "queries": f("array", required=True, items=STR_ARRAY,
                         description="Search queries"),
            "top_k": _SEARCH_FIELDS["top_k"],
            "semantic_weight": _SEARCH_FIELDS["semantic_weight"],
            "lexical_weight": _SEARCH_FIELDS["lexical_weight"],
        },
        "responses": {200: {"results": "array"}, 400: "detail"},
    },
    ("POST", "/search/funnel"): {
        "summary": "Batched multi-stage funnel "
                   "(dense -> candidate BM25 -> cross-encoder)",
        "request": {
            "queries": f("array", required=True, items=STR_ARRAY,
                         description="Search queries"),
            "stage1_k": f("integer", default=100, ge=1, le=4096,
                          description="Dense candidates per query"),
            "stage2_k": f("integer", default=20, ge=1, le=512,
                          description="BM25-kept candidates per query"),
            "top_k": _SEARCH_FIELDS["top_k"],
        },
        "responses": {200: {"stage1_k": "integer", "stage2_k": "integer",
                            "results": "array"}, 400: "detail"},
    },
    ("POST", "/search/highlighted"): {
        "summary": "Search with highlighted snippets",
        "request": {
            **_SEARCH_FIELDS,
            "style": f("string", default="html",
                       enum=["html", "terminal", "markdown"],
                       description="Highlight tag style"),
        },
        "responses": {200: {"query": "string", "results": "array"},
                      400: "detail"},
    },
    ("POST", "/search/filtered"): {
        "summary": "Search with a metadata pre-filter (in-kernel bias mask)",
        "request": {
            **_SEARCH_FIELDS,
            "filter": f("string", required=True, min_length=1,
                        description="Filter expression: field:value, "
                                    "field:>n, AND/OR/NOT, parens"),
        },
        "responses": {200: {"query": "string", "filter": "string",
                            "results": [_RESULT_ROW]}, 400: "detail"},
    },
    ("POST", "/ask"): {
        "summary": "RAG question answering",
        "request": {
            "question": f("string", required=True, min_length=1,
                          description="Question to answer"),
            "top_k": f("integer", default=5, ge=1, le=10,
                       description="Documents to retrieve"),
            "provider": f("string", default="local",
                          enum=["openai", "anthropic", "local"],
                          description="LLM provider"),
        },
        "responses": {200: {"question": "string", "answer": "string",
                            "sources": "array", "provider": "string",
                            "tokens_used": "integer"}, 400: "detail"},
    },
    ("POST", "/rerank"): {
        "summary": "Cross-encoder rerank of (query, doc_ids or documents)",
        "request": {
            "query": f("string", required=True, min_length=1),
            "doc_ids": f("array",
                         description="Document ids resolved from the store "
                                     "(reference form; also accepted as "
                                     "repeated query params)"),
            "documents": f("array", items=STR_ARRAY,
                           description="Raw documents to rerank (extension)"),
            "top_k": f("integer", ge=1, le=100),
        },
        "responses": {200: {"query": "string", "results": [_RESULT_ROW]},
                      400: "detail"},
    },
    ("POST", "/index"): {
        "summary": "Destructive full reindex",
        "request": {
            "documents": f("array", required=True, items=STR_ARRAY,
                           description="Documents to index"),
        },
        "responses": {200: {"indexed": "integer"}, 400: "detail"},
    },
    ("POST", "/index/directory"): {
        "summary": "Index every document file under a directory",
        "request": {
            "directory": f("string", required=True, min_length=1),
        },
        "responses": {200: {"indexed": "integer", "files": "array"},
                      400: "detail"},
    },
    ("POST", "/index/add"): {
        "summary": "Incremental add (dense + BM25 stay consistent)",
        "request": {
            "documents": f("array", required=True, items=STR_ARRAY),
            "dedup": f("string", enum=["skip", "merge", "flag"],
                       description="Duplicate handling on ingest"),
        },
        "responses": {200: {"added": "integer", "doc_ids": "array",
                            "skipped": "array"}, 400: "detail"},
    },
    ("POST", "/feedback"): {
        "summary": "Record relevance feedback",
        "request": {
            "query_id": f("integer",
                          description="Query id from a search response "
                                      "(reference form; or pass query)"),
            "query": f("string", min_length=1,
                       description="Query text (alternative to query_id)"),
            "doc_id": f("integer", required=True),
            "rating": f("integer", ge=-1, le=5,
                        description="Relevance rating"),
            "relevance_score": f("integer", ge=0, le=5,
                                 description="Reference-form rating alias"),
            "clicked": f("boolean", default=False),
        },
        "responses": {200: {"status": "string"}, 400: "detail",
                      404: "detail"},
    },
    ("GET", "/stats"): {
        "summary": "Query/feedback statistics + per-stage latencies",
        "responses": {200: {"total_documents": "integer",
                            "total_queries": "integer", "stages": "object"}},
    },
    ("GET", "/metrics"): {
        "summary": "Prometheus text exposition",
        "responses": {200: "text/plain exposition"},
        "content_type": "text/plain",
    },
    ("GET", "/documents"): {
        "summary": "List documents (paginated)",
        "query_params": {
            "limit": f("integer", default=100, ge=1, le=10_000),
            "offset": f("integer", default=0, ge=0),
        },
        "responses": {200: {"total": "integer", "documents": "array"}},
    },
    ("POST", "/watcher/start"): {
        "summary": "Watch a directory and auto-reindex on change",
        "request": {
            "directory": f("string", required=True, min_length=1),
        },
        "responses": {200: {"status": "string", "directory": "string"},
                      400: "detail"},
    },
    ("POST", "/watcher/stop"): {
        "summary": "Stop the directory watcher",
        "responses": {200: {"status": "string"}, 400: "detail"},
    },
    ("GET", "/autocomplete"): {
        "summary": "Prefix suggestions (history + fuzzy + content)",
        "query_params": {
            "prefix": f("string", required=True, min_length=1,
                        description="Partial query to complete"),
            "limit": f("integer", default=10, ge=1, le=50),
        },
        "responses": {200: {"prefix": "string", "suggestions": "array"}},
    },
    ("POST", "/autocomplete"): {
        "summary": "Prefix suggestions (reference form: partial_query)",
        "request": {
            "partial_query": f("string", required=True, min_length=1,
                               description="Partial query to complete"),
            "limit": f("integer", default=10, ge=1, le=50),
        },
        "responses": {200: [{"text": "string", "score": "number",
                             "source": "string", "frequency": "integer"}]},
    },
    ("POST", "/autocomplete/record"): {
        "summary": "Record a selected suggestion (learning signal)",
        "request": {
            "suggestion": f("string", required=True, min_length=1),
        },
        "responses": {200: {"status": "string"}, 400: "detail"},
    },
    ("GET", "/cache/stats"): {
        "summary": "Semantic-cache hit/miss statistics",
        "responses": {200: {"enabled": "boolean", "hits": "integer",
                            "misses": "integer", "entries": "integer"}},
    },
    ("POST", "/cache/invalidate"): {
        "summary": "Invalidate the semantic cache",
        "responses": {200: {"invalidated": "integer"}},
    },
    ("GET", "/documents/duplicates"): {
        "summary": "MinHash-LSH duplicate groups",
        "responses": {200: {"groups": "array"}},
    },
    ("POST", "/documents/{doc_id}/mark-duplicate"): {
        "summary": "Mark a document as a duplicate of another",
        "request": {
            "duplicate_of": f("integer", required=True),
        },
        "responses": {200: {"status": "string"}, 400: "detail"},
    },
    ("DELETE", "/documents/{doc_id}"): {
        "summary": "Tombstone a document in every index",
        "responses": {200: {"status": "string", "doc_id": "integer",
                            "tombstoned": "integer"}, 404: "detail"},
    },
    ("GET", "/documents/{doc_id}/metadata"): {
        "summary": "Get document metadata",
        "responses": {200: {"doc_id": "integer", "metadata": "object"},
                      404: "detail"},
    },
    ("POST", "/documents/{doc_id}/metadata"): {
        "summary": "Set document metadata",
        "request": {
            "metadata": f("object", required=True,
                          description="Metadata key/value pairs"),
        },
        "responses": {200: {"status": "string", "doc_id": "integer"}},
    },
    ("POST", "/language/detect"): {
        "summary": "Detect the language of a text",
        "request": {
            "text": f("string", required=True, min_length=1),
        },
        "responses": {200: {"language": "string", "confidence": "number",
                            "script": "string"}, 400: "detail"},
    },
    ("POST", "/jobs/index"): {
        "summary": "Async indexing job (returns 202 + job id)",
        "request": {
            "documents": f("array", required=True, items=STR_ARRAY),
            "webhook_url": f("string",
                             description="URL notified on completion"),
        },
        "responses": {202: {"job_id": "string", "state": "string"},
                      400: "detail"},
    },
    ("GET", "/jobs/{job_id}"): {
        "summary": "Job status",
        "responses": {200: {"job_id": "string", "state": "string",
                            "progress": "number"}, 404: "detail"},
    },
    ("DELETE", "/jobs/{job_id}"): {
        "summary": "Cancel a job",
        "responses": {200: {"status": "string"}, 400: "detail"},
    },
    ("GET", "/jobs"): {
        "summary": "List jobs",
        "query_params": {
            "limit": f("integer", default=100, ge=1, le=10_000),
        },
        "responses": {200: {"jobs": "array"}},
    },
}


# -- OpenAPI rendering --------------------------------------------------------------


def _field_schema(spec: JSON) -> JSON:
    out: JSON = {"type": spec["type"]}
    if spec.get("items"):
        out["items"] = spec["items"]
    if spec.get("ge") is not None:
        out["minimum"] = spec["ge"]
    if spec.get("le") is not None:
        out["maximum"] = spec["le"]
    if spec.get("min_length") is not None:
        out["minLength"] = spec["min_length"]
    if spec.get("enum") is not None:
        out["enum"] = spec["enum"]
    if spec.get("description"):
        out["description"] = spec["description"]
    if spec.get("default") is not None:
        out["default"] = spec["default"]
    return out


def _response_schema(shape: Any) -> JSON:
    if isinstance(shape, dict):
        props: JSON = {}
        for k, v in shape.items():
            if isinstance(v, list):
                props[k] = {"type": "array", "items": v[0]}
            elif isinstance(v, dict):
                props[k] = v
            else:
                props[k] = {"type": v}
        return {"type": "object", "properties": props}
    return {"type": "object", "description": str(shape)}


def build_openapi(title: str = "hybridsearch_tpu",
                  version: str = "0.2.0") -> JSON:
    """Render the full OpenAPI 3.1 document from ROUTE_SPECS (no deps)."""
    paths: JSON = {}
    for (method, path), spec in sorted(ROUTE_SPECS.items()):
        op: JSON = {
            "summary": spec.get("summary", ""),
            "operationId": (
                method.lower()
                + path.replace("/", "_").replace("{", "").replace("}", "")
            ),
            "responses": {},
        }
        params = []
        for name in _path_params(path):
            params.append({
                "name": name, "in": "path", "required": True,
                "schema": {"type": "string"},
            })
        for name, fs in (spec.get("query_params") or {}).items():
            params.append({
                "name": name, "in": "query",
                "required": bool(fs.get("required")),
                "schema": _field_schema(fs),
            })
        if params:
            op["parameters"] = params
        req = spec.get("request")
        if req:
            required = [k for k, v in req.items() if v.get("required")]
            body_schema: JSON = {
                "type": "object",
                "properties": {k: _field_schema(v) for k, v in req.items()},
            }
            if required:
                body_schema["required"] = required
            op["requestBody"] = {
                "required": bool(required),
                "content": {"application/json": {"schema": body_schema}},
            }
        content_type = spec.get("content_type", "application/json")
        for status, shape in spec.get("responses", {}).items():
            if shape == "detail":
                schema = {"type": "object",
                          "properties": {"detail": {"type": "string"}}}
            elif content_type == "text/plain":
                schema = {"type": "string"}
            else:
                schema = _response_schema(shape)
            op["responses"][str(status)] = {
                "description": "error" if shape == "detail" else "success",
                "content": {content_type: {"schema": schema}},
            }
        paths.setdefault(path, {})[method.lower()] = op
    return {
        "openapi": "3.1.0",
        "info": {
            "title": title,
            "version": version,
            "description": "TPU-native hybrid search engine REST API",
        },
        "paths": paths,
        "components": {
            "securitySchemes": {
                "ApiKeyHeader": {"type": "apiKey", "in": "header",
                                 "name": "X-API-Key"},
                "BearerToken": {"type": "http", "scheme": "bearer"},
            }
        },
    }


def _path_params(path: str) -> list:
    import re

    return re.findall(r"\{(\w+)\}", path)


# -- Pydantic materialization ---------------------------------------------------------


def pydantic_request_models() -> Dict[Tuple[str, str], Any]:
    """(method, path) -> Pydantic request model, built from ROUTE_SPECS.
    Requires pydantic (raises ImportError otherwise)."""
    from pydantic import Field, create_model

    _PY_TYPES = {"string": str, "integer": int, "number": float,
                 "boolean": bool, "array": list, "object": dict}
    models: Dict[Tuple[str, str], Any] = {}
    for (method, path), spec in ROUTE_SPECS.items():
        req = spec.get("request")
        if not req:
            continue
        fields: JSON = {}
        for name, fs in req.items():
            py = _PY_TYPES[fs["type"]]
            kwargs: JSON = {"description": fs.get("description", "")}
            if fs.get("ge") is not None:
                kwargs["ge"] = fs["ge"]
            if fs.get("le") is not None:
                kwargs["le"] = fs["le"]
            if fs.get("min_length") is not None and py is str:
                kwargs["min_length"] = fs["min_length"]
            if fs.get("required"):
                fields[name] = (py, Field(..., **kwargs))
            else:
                fields[name] = (Optional[py],
                                Field(fs.get("default"), **kwargs))
        model_name = (
            method.title()
            + "".join(p.title() for p in _path_params(path))
            + "".join(
                seg.title() for seg in path.split("/")
                if seg and "{" not in seg
            )
            + "Request"
        )
        models[(method, path)] = create_model(model_name, **fields)
    return models


def export_openapi(path: str) -> None:
    """Write the static OpenAPI JSON (used by scripts and tests)."""
    import json

    with open(path, "w", encoding="utf-8") as fh:
        json.dump(build_openapi(), fh, indent=2, sort_keys=True)
        fh.write("\n")
