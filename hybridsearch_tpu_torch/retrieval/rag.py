"""RAG / HyDE / agentic search over the device retrieval core.

Counterpart of ``hybridsearch_tpu/retrieval/rag.py``: host code over the
port's Searcher, in parity with the reference's generation layer
(reference rag.py:155-389):
  - RAGAnswerer.ask: retrieve -> context (<=5 docs, <=4000 chars,
    "[Document i]" headers, rag.py:60-75) -> prompt -> LLM -> answer with
    source previews (200 chars, rag.py:188-200);
  - provider trio: OpenAI / Anthropic / local Ollama (rag.py:88-153),
    reached over HTTPS from the host — generation stays an external-API
    adapter while retrieval runs on device (SURVEY §3.5);
  - HyDE: generate a hypothetical answer, embed IT, search with that
    embedding (rag.py:252-273);
  - agentic loop: <=3 iterations of LLM-driven "DONE | SEARCH:<query>"
    with doc_id dedup (rag.py:347-389).

All classes accept an `llm_fn: (prompt) -> str` override so the logic is
testable without network access; each provider imports ``requests`` only
inside its own body. HyDE embeds with the indexer's encoder on its device
and searches through ``DenseIndex.search``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, List, Optional, Sequence, Tuple

SearchResult = Tuple[float, str, int]

MAX_CONTEXT_DOCS = 5  # reference rag.py:36
MAX_CONTEXT_CHARS = 4000  # reference rag.py:37
MAX_TOKENS = 500  # reference rag.py:100/:124
MAX_AGENT_ITERS = 3  # reference rag.py:355


@dataclasses.dataclass
class RAGResponse:
    answer: str
    sources: List[dict]
    provider: str
    tokens_used: Optional[int] = None


def build_context(results: Sequence[SearchResult]) -> str:
    """<=5 docs, <=4000 chars, numbered headers (reference rag.py:60-75)."""
    parts: List[str] = []
    total = 0
    for i, (_score, content, _id) in enumerate(results[:MAX_CONTEXT_DOCS], start=1):
        piece = f"[Document {i}]\n{content}\n"
        if total + len(piece) > MAX_CONTEXT_CHARS:
            piece = piece[: MAX_CONTEXT_CHARS - total]
            parts.append(piece)
            break
        parts.append(piece)
        total += len(piece)
    return "\n".join(parts)


def build_prompt(question: str, context: str) -> str:
    """Answer-from-context template (reference rag.py:77-86)."""
    return (
        "Answer the question using only the context below. If the context "
        "does not contain the answer, say you don't know.\n\n"
        f"Context:\n{context}\n\n"
        f"Question: {question}\n\nAnswer:"
    )


# -- providers --------------------------------------------------------------------


def call_openai(prompt: str, model: str = "gpt-4o-mini",
                temperature: float = 0.7) -> Tuple[str, Optional[int]]:
    """OpenAI chat completions (reference rag.py:88-109)."""
    import requests

    key = os.environ.get("OPENAI_API_KEY")
    if not key:
        raise RuntimeError("OPENAI_API_KEY not set")
    resp = requests.post(
        "https://api.openai.com/v1/chat/completions",
        headers={"Authorization": f"Bearer {key}"},
        json={
            "model": model,
            "messages": [{"role": "user", "content": prompt}],
            "temperature": temperature,
            "max_tokens": MAX_TOKENS,
        },
        timeout=60,
    )
    resp.raise_for_status()
    data = resp.json()
    return (
        data["choices"][0]["message"]["content"],
        data.get("usage", {}).get("total_tokens"),
    )


def call_anthropic(prompt: str, model: str = "claude-3-5-haiku-latest"
                   ) -> Tuple[str, Optional[int]]:
    """Anthropic messages API (reference rag.py:111-131)."""
    import requests

    key = os.environ.get("ANTHROPIC_API_KEY")
    if not key:
        raise RuntimeError("ANTHROPIC_API_KEY not set")
    resp = requests.post(
        "https://api.anthropic.com/v1/messages",
        headers={"x-api-key": key, "anthropic-version": "2023-06-01"},
        json={
            "model": model,
            "max_tokens": MAX_TOKENS,
            "messages": [{"role": "user", "content": prompt}],
        },
        timeout=60,
    )
    resp.raise_for_status()
    data = resp.json()
    usage = data.get("usage", {})
    tokens = (usage.get("input_tokens") or 0) + (usage.get("output_tokens") or 0)
    return data["content"][0]["text"], tokens or None


def call_local(prompt: str, model: str = "llama3",
               base_url: str = "http://localhost:11434") -> Tuple[str, Optional[int]]:
    """Local Ollama generate endpoint (reference rag.py:133-153)."""
    import requests

    resp = requests.post(
        f"{base_url}/api/generate",
        json={"model": model, "prompt": prompt, "stream": False},
        timeout=120,
    )
    resp.raise_for_status()
    return resp.json().get("response", ""), None


_PROVIDERS = {"openai": call_openai, "anthropic": call_anthropic, "local": call_local}


def provider_fn(provider: str, **kwargs) -> Callable[[str], Tuple[str, Optional[int]]]:
    if provider not in _PROVIDERS:
        raise ValueError(f"unknown LLM provider: {provider!r}")
    fn = _PROVIDERS[provider]
    return lambda prompt: fn(prompt, **kwargs)


# -- RAG ---------------------------------------------------------------------------


class RAGAnswerer:
    """Retrieval-augmented answering over a Searcher (reference rag.py:155-200)."""

    def __init__(
        self,
        searcher,
        provider: str = "local",
        llm_fn: Optional[Callable[[str], Tuple[str, Optional[int]]]] = None,
        **provider_kwargs,
    ) -> None:
        self.searcher = searcher
        self.provider = provider
        self.llm_fn = llm_fn or provider_fn(provider, **provider_kwargs)

    def ask(self, question: str, top_k: int = 5) -> RAGResponse:
        results = self.searcher.search(question, top_k=top_k)
        context = build_context(results)
        prompt = build_prompt(question, context)
        answer, tokens = self.llm_fn(prompt)
        sources = [
            {"doc_id": doc_id, "score": score, "preview": content[:200]}
            for score, content, doc_id in results
        ]  # 200-char previews (reference rag.py:188-200)
        return RAGResponse(answer=answer, sources=sources, provider=self.provider,
                           tokens_used=tokens)


class HyDESearcher:
    """HyDE: embed a hypothetical generated answer and search with that
    embedding (reference rag.py:227-273)."""

    def __init__(self, searcher, llm_fn: Callable[[str], Tuple[str, Optional[int]]],
                 provider: str = "local") -> None:
        self.searcher = searcher
        self.llm_fn = llm_fn
        self.provider = provider

    def search(self, query: str, top_k: int = 5) -> List[SearchResult]:
        hypo_prompt = (
            "Write a short passage that plausibly answers the question below. "
            "Write only the passage.\n\nQuestion: " + query
        )
        hypothetical, _ = self.llm_fn(hypo_prompt)
        q_vec = self.searcher.indexer.encoder.encode([hypothetical or query])
        dense = self.searcher.indexer.dense
        vals, idxs = dense.search(q_vec, top_k)
        contents = self.searcher.indexer.contents
        return [
            (float(vals[0, j]), contents[int(idxs[0, j])], int(idxs[0, j]))
            for j in range(vals.shape[1])
            if 0 <= int(idxs[0, j]) < len(contents)
        ]


class AgenticSearcher:
    """LLM-guided iterative search: the model answers DONE or SEARCH:<query'>
    for up to 3 rounds; results dedup by doc_id (reference rag.py:347-389)."""

    _DIRECTIVE = re.compile(r"^\s*SEARCH\s*:\s*(.+)$", re.IGNORECASE | re.MULTILINE)

    def __init__(self, searcher, llm_fn: Callable[[str], Tuple[str, Optional[int]]]
                 ) -> None:
        self.searcher = searcher
        self.llm_fn = llm_fn

    def search(self, query: str, top_k: int = 5) -> List[SearchResult]:
        seen: dict = {}
        current = query
        for _ in range(MAX_AGENT_ITERS):
            for r in self.searcher.search(current, top_k=top_k):
                seen.setdefault(r[2], r)
            snippet = "\n".join(
                f"- {c[:150]}" for _s, c, _i in list(seen.values())[:top_k]
            )
            decision, _ = self.llm_fn(
                "You are refining a search. Original question: "
                f"{query}\nResults so far:\n{snippet}\n"
                "Reply DONE if these suffice, or SEARCH: <better query> to "
                "search again."
            )
            m = self._DIRECTIVE.search(decision or "")
            if not m:
                break
            current = m.group(1).strip()
        ranked = sorted(seen.values(), key=lambda r: -r[0])
        return ranked[:top_k]
