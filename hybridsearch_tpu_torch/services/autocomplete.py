"""Autocomplete: frequency-weighted prefix trie + fuzzy + content terms.

Counterpart of ``hybridsearch_tpu/services/autocomplete.py``, host code copied
with the port's imports.

Parity with the reference autocomplete engine (reference
autocomplete.py:46-319): char-level prefix trie with frequencies, typo
tolerance via edit distance (our native C++ textops instead of rapidfuzz),
content-term suggestions, selection learning, and the reference's 3-source
scoring: history 1.0 + f/100, fuzzy 0.7 + f/200, semantic/content 0.5
(reference autocomplete.py:211-283).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from hybridsearch_tpu_torch.text.extractor import extract_tokens
from hybridsearch_tpu_torch.text.fuzzy import levenshtein


class _TrieNode:
    __slots__ = ("children", "freq", "is_end")

    def __init__(self) -> None:
        self.children: Dict[str, "_TrieNode"] = {}
        self.freq = 0
        self.is_end = False


class PrefixTrie:
    """Char-level trie with per-phrase frequency (reference
    autocomplete.py:46-104)."""

    def __init__(self) -> None:
        self.root = _TrieNode()
        self._phrases: Dict[str, int] = {}

    def insert(self, phrase: str, weight: int = 1) -> None:
        phrase = phrase.strip().lower()
        if not phrase:
            return
        node = self.root
        for ch in phrase:
            node = node.children.setdefault(ch, _TrieNode())
        node.is_end = True
        node.freq += weight
        self._phrases[phrase] = self._phrases.get(phrase, 0) + weight

    def search_prefix(self, prefix: str, limit: int = 10) -> List[Tuple[str, int]]:
        """Completions of prefix, by descending frequency (reference
        autocomplete.py:68-104)."""
        prefix = prefix.strip().lower()
        node = self.root
        for ch in prefix:
            node = node.children.get(ch)
            if node is None:
                return []
        out: List[Tuple[str, int]] = []

        def walk(n: _TrieNode, acc: str) -> None:
            if n.is_end:
                out.append((prefix + acc, n.freq))
            for ch, child in n.children.items():
                walk(child, acc + ch)

        walk(node, "")
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:limit]

    def fuzzy_search(self, term: str, max_distance: int = 2,
                     limit: int = 10) -> List[Tuple[str, int, int]]:
        """(phrase, freq, distance) within edit distance (reference
        autocomplete.py:106-140 uses rapidfuzz; here native Levenshtein)."""
        term = term.strip().lower()
        out = []
        for phrase, freq in self._phrases.items():
            if abs(len(phrase) - len(term)) > max_distance:
                continue
            d = levenshtein(term, phrase)
            if d <= max_distance:
                out.append((phrase, freq, d))
        out.sort(key=lambda t: (t[2], -t[1], t[0]))
        return out[:limit]

    def __len__(self) -> int:
        return len(self._phrases)


class AutocompleteEngine:
    """Query suggestions from history + content terms + fuzzy matches
    (reference autocomplete.py:150-319)."""

    def __init__(self, max_distance: int = 2) -> None:
        self.history = PrefixTrie()
        self.content_terms = PrefixTrie()
        self.max_distance = max_distance
        self._selections: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- learning --------------------------------------------------------------

    def record_query(self, query: str) -> None:
        with self._lock:
            self.history.insert(query)

    def record_selection(self, partial: str,
                         selected: Optional[str] = None) -> None:
        """Boost selected suggestions (reference autocomplete.py:299-319:
        record_selection(partial, selected) boosts `selected`). The
        one-argument form treats the argument as the selection."""
        if selected is None:
            selected = partial
        with self._lock:
            self._selections[selected.lower()] = (
                self._selections.get(selected.lower(), 0) + 1
            )
            self.history.insert(selected, weight=2)

    def index_content(self, documents: List[str], min_len: int = 4) -> int:
        """Harvest document terms for content suggestions (reference
        autocomplete.py:178-209)."""
        n = 0
        with self._lock:
            for doc in documents:
                for tok in extract_tokens(doc):
                    if len(tok) >= min_len:
                        self.content_terms.insert(tok)
                        n += 1
        return n

    # -- suggesting ---------------------------------------------------------------

    def suggest(self, prefix: str, limit: int = 10) -> List[Dict]:
        """3-source blended suggestions with the reference's scoring
        (reference autocomplete.py:211-283):
        history 1.0 + freq/100, fuzzy 0.7 + freq/200, content 0.5."""
        t0 = time.perf_counter()
        prefix = prefix.strip().lower()
        if not prefix:
            return []
        scored: Dict[str, Tuple[float, str, int]] = {}

        for phrase, freq in self.history.search_prefix(prefix, limit * 2):
            scored[phrase] = (1.0 + freq / 100.0, "history", int(freq))

        if len(prefix) >= 3:
            for phrase, freq, _d in self.history.fuzzy_search(
                prefix, self.max_distance, limit
            ):
                if phrase not in scored:
                    scored[phrase] = (0.7 + freq / 200.0, "fuzzy", int(freq))

        for term, freq in self.content_terms.search_prefix(prefix, limit):
            if term not in scored:
                scored[term] = (0.5, "content", int(freq))

        for phrase, boost in self._selections.items():
            if phrase in scored:
                s, src, fr = scored[phrase]
                scored[phrase] = (s + boost / 50.0, src, fr)

        ranked = sorted(scored.items(), key=lambda kv: (-kv[1][0], kv[0]))[:limit]
        latency_ms = (time.perf_counter() - t0) * 1e3
        return [
            {"suggestion": p, "score": round(s, 4), "source": src,
             "frequency": fr, "latency_ms": round(latency_ms, 3)}
            for p, (s, src, fr) in ranked
        ]
