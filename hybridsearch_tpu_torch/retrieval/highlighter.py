"""Query-term highlighting and snippet extraction.

Counterpart of ``hybridsearch_tpu/retrieval/highlighter.py``: host code
over the port's ``text/extractor.extract_tokens``, in parity with the
reference highlighter (reference highlighter.py:43-225):
word-boundary regex highlighting of query tokens, snippet extraction
(window centered on matches, snapped to word boundaries, ellipses, overlap
suppression), and Terminal/HTML/Markdown tag variants.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from hybridsearch_tpu_torch.text.extractor import extract_tokens


class Highlighter:
    """Base highlighter with configurable open/close tags."""

    open_tag = "**"
    close_tag = "**"

    def __init__(self, open_tag: Optional[str] = None,
                 close_tag: Optional[str] = None) -> None:
        if open_tag is not None:
            self.open_tag = open_tag
        if close_tag is not None:
            self.close_tag = close_tag

    def _pattern(self, query: str) -> Optional[re.Pattern]:
        tokens = sorted(set(extract_tokens(query)), key=len, reverse=True)
        if not tokens:
            return None
        return re.compile(
            r"\b(" + "|".join(re.escape(t) for t in tokens) + r")\b", re.IGNORECASE
        )

    def highlight_text(self, text: str, query: str) -> str:
        """Wrap every query-token occurrence (reference highlighter.py:43-66)."""
        pat = self._pattern(query)
        if pat is None:
            return text
        return pat.sub(lambda m: f"{self.open_tag}{m.group(0)}{self.close_tag}", text)

    def extract_snippets(
        self,
        text: str,
        query: str,
        window: int = 80,
        max_snippets: int = 3,
        highlight: bool = True,
    ) -> List[str]:
        """Snippets centered on matches, word-boundary snapped, overlap
        suppressed, with ellipses (reference highlighter.py:68-145)."""
        pat = self._pattern(query)
        if pat is None:
            return []
        spans: List[Tuple[int, int]] = []
        for m in pat.finditer(text):
            center = (m.start() + m.end()) // 2
            start = max(0, center - window // 2)
            end = min(len(text), center + window // 2)
            # snap to word boundaries
            while start > 0 and not text[start - 1].isspace():
                start -= 1
            while end < len(text) and not text[end - 1].isspace() and end < len(text):
                end += 1
            if spans and start <= spans[-1][1]:
                spans[-1] = (spans[-1][0], max(spans[-1][1], end))  # merge overlap
            else:
                spans.append((start, end))
            if len(spans) >= max_snippets and start > spans[max_snippets - 1][0]:
                break
        snippets = []
        for start, end in spans[:max_snippets]:
            snippet = text[start:end].strip()
            if start > 0:
                snippet = "..." + snippet
            if end < len(text):
                snippet = snippet + "..."
            if highlight:
                snippet = self.highlight_text(snippet, query)
            snippets.append(snippet)
        return snippets

    def highlight_results(
        self, results: Sequence[Tuple[float, str, int]], query: str
    ) -> List[str]:
        return [self.highlight_text(content, query) for _s, content, _i in results]


class TerminalHighlighter(Highlighter):
    """ANSI bold yellow (reference highlighter.py:195-204)."""

    open_tag = "\033[1;33m"
    close_tag = "\033[0m"


class HTMLHighlighter(Highlighter):
    """<mark> tags (reference highlighter.py:206-215)."""

    open_tag = "<mark>"
    close_tag = "</mark>"


class MarkdownHighlighter(Highlighter):
    """**bold** (reference highlighter.py:217-225)."""

    open_tag = "**"
    close_tag = "**"


def get_highlighter(style: str = "markdown") -> Highlighter:
    table = {
        "terminal": TerminalHighlighter,
        "html": HTMLHighlighter,
        "markdown": MarkdownHighlighter,
        "plain": Highlighter,
    }
    if style not in table:
        raise ValueError(f"unknown highlighter style: {style!r}")
    return table[style]()
