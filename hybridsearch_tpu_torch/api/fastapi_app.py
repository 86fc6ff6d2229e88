"""FastAPI adapter: real per-route registration with Pydantic schemas
(the port of ``hybridsearch_tpu/api/fastapi_app.py``).

Serves the same route table as api/httpd.py for deployments where
fastapi/uvicorn are installed (the reference's serving stack, reference
api.py + Dockerfile:36). Routes are generated from the framework-agnostic
router table (api/app.py build_router) and the schema registry
(api/schemas.py), so FastAPI provides what the reference got from Pydantic:
per-route request models with Field constraints (automatic 422s on
violation, mirroring reference api.py:40-53), typed OpenAPI docs at
/docs + /openapi.json, and plain-text pass-through for /metrics.

Import is gated: this module raises ImportError when fastapi is absent,
and nothing else in the framework depends on it. The equivalent OpenAPI
document is also exported statically (docs/openapi.json, rendered by
schemas.build_openapi) so the schema exists without fastapi.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from fastapi import FastAPI, Request
from fastapi.responses import JSONResponse, PlainTextResponse

from hybridsearch_tpu_torch.api.app import EngineState, build_router
from hybridsearch_tpu_torch.api.schemas import ROUTE_SPECS, pydantic_request_models


def _client_key(request: Request) -> Tuple[Optional[str], str]:
    api_key = request.headers.get("X-API-Key")
    auth = request.headers.get("Authorization", "")
    if api_key is None and auth.startswith("Bearer "):
        api_key = auth[7:]
    ip = request.client.host if request.client else "unknown"
    return api_key, ip


def create_app(state: Optional[EngineState] = None, **state_kwargs) -> FastAPI:
    state = state or EngineState(**state_kwargs)
    router = build_router(state)
    app = FastAPI(
        title="hybridsearch_tpu_torch",
        version="0.2.0",
        description="hybrid search engine REST API on PyTorch and CUDA",
    )
    app.state.engine = state

    @app.on_event("shutdown")
    def _shutdown() -> None:
        state.close()

    models = pydantic_request_models()

    def _respond(status: int, payload: Any,
                 headers: Dict[str, str]):
        if isinstance(payload, dict) and "_text" in payload:
            # /metrics Prometheus exposition
            return PlainTextResponse(payload["_text"], status_code=status,
                                     headers=headers)
        return JSONResponse(payload, status_code=status, headers=headers)

    def _query_dict(request: Request) -> Dict[str, Any]:
        """Repeated query params collect into a list, matching the stdlib
        httpd adapter (the reference's /rerank takes repeated doc_ids,
        api.py:521-524); single values stay scalar."""
        out: Dict[str, Any] = {}
        for k, v in request.query_params.multi_items():
            if k in out:
                if isinstance(out[k], list):
                    out[k].append(v)
                else:
                    out[k] = [out[k], v]
            else:
                out[k] = v
        return out

    def _make_endpoint(method: str, path: str, model):
        """One real FastAPI endpoint per route. The body is validated by
        the Pydantic model (422 on constraint violation, like the
        reference); dispatch then flows through the shared router so both
        adapters behave identically (auth, errors, handlers)."""
        if model is not None:

            async def endpoint(request: Request, body: model):  # type: ignore[valid-type]
                api_key, ip = _client_key(request)
                status, payload, headers = router.dispatch(
                    method,
                    request.url.path,
                    # exclude_unset (not exclude_none): an explicit null in
                    # the request body must reach the handler just like it
                    # does through the plain httpd router; only truly
                    # absent fields fall back to handler defaults
                    body=body.model_dump(exclude_unset=True),
                    query=_query_dict(request),
                    api_key=api_key,
                    client_ip=ip,
                )
                return _respond(status, payload, headers)

        else:

            async def endpoint(request: Request):  # type: ignore[misc]
                body: Dict[str, Any] = {}
                if method in ("POST", "DELETE"):
                    try:
                        body = await request.json()
                    except Exception:
                        body = {}
                api_key, ip = _client_key(request)
                status, payload, headers = router.dispatch(
                    method,
                    request.url.path,
                    body=body,
                    query=_query_dict(request),
                    api_key=api_key,
                    client_ip=ip,
                )
                return _respond(status, payload, headers)

        return endpoint

    for method, pattern, _names, _handler, _scope in router._routes:
        # recover the declared path (the Router stores a compiled regex;
        # ROUTE_SPECS keys carry the original template)
        path = _pattern_to_path(pattern.pattern)
        spec = ROUTE_SPECS.get((method, path), {})
        model = models.get((method, path))
        app.add_api_route(
            path,
            _make_endpoint(method, path, model),
            methods=[method],
            summary=spec.get("summary", ""),
            name=f"{method.lower()} {path}",
        )
    return app


def _pattern_to_path(pattern: str) -> str:
    """'^/documents/(?P<doc_id>[^/]+)$' -> '/documents/{doc_id}'."""
    import re

    path = pattern.lstrip("^").rstrip("$")
    return re.sub(r"\(\?P<(\w+)>\[\^/\]\+\)", r"{\1}", path)
