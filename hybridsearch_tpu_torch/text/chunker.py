"""Document chunking strategies.

Counterpart of ``hybridsearch_tpu/text/chunker.py`` (capability parity
with the reference's four chunkers, reference chunker.py:28-281): sentence
(regex split + overlap), paragraph (merge small / split large), sliding
window (character-based), and semantic (embed the sentences in one batch,
split where the cosine of consecutive sentences drops below a threshold).
All host code but the semantic chunker's encode, which runs on the
encoder's device; the consecutive-sentence cosines are numpy, as in the
JAX module.

Chunking is the framework's long-document mechanism; there is no sequence
parallelism because the encoder window is short (SURVEY §5.7).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from hybridsearch_tpu_torch.utils.device import DeviceLike

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_PARA_RE = re.compile(r"\n\s*\n")


@dataclass
class Chunk:
    """A chunk of a parent document (reference chunker.py:9-25)."""

    content: str
    doc_id: int = -1  # parent document id
    chunk_index: int = 0
    start_char: int = 0
    end_char: int = 0
    metadata: Dict[str, object] = field(default_factory=dict)


def _split_sentences(text: str) -> List[str]:
    return [s for s in _SENT_RE.split(text.strip()) if s]


class SentenceChunker:
    """Group sentences into chunks of <= max_chars with sentence overlap
    (reference chunker.py:28-72)."""

    def __init__(self, max_chars: int = 500, overlap_sentences: int = 1) -> None:
        self.max_chars = max_chars
        self.overlap = max(0, overlap_sentences)

    def chunk(self, text: str, doc_id: int = -1) -> List[Chunk]:
        sents = _split_sentences(text)
        if not sents:
            return []
        chunks: List[Chunk] = []
        cur: List[str] = []
        cur_len = 0
        i = 0
        while i < len(sents):
            s = sents[i]
            if cur and cur_len + len(s) + 1 > self.max_chars:
                chunks.append(" ".join(cur))
                nxt = cur[-self.overlap :] if self.overlap else []
                # drop the overlap if it alone would still overflow with s —
                # guarantees the loop consumes a sentence every two steps
                if nxt and sum(len(c) + 1 for c in nxt) + len(s) + 1 > self.max_chars:
                    nxt = []
                cur = nxt
                cur_len = sum(len(c) + 1 for c in cur)
                continue
            cur.append(s)
            cur_len += len(s) + 1
            i += 1
        if cur:
            chunks.append(" ".join(cur))
        return _finalize(chunks, text, doc_id)


class ParagraphChunker:
    """Paragraph chunks: merge paragraphs below min_chars into neighbors,
    split those above max_chars on sentences (reference chunker.py:75-162)."""

    def __init__(self, min_chars: int = 100, max_chars: int = 1000) -> None:
        self.min_chars = min_chars
        self.max_chars = max_chars

    def chunk(self, text: str, doc_id: int = -1) -> List[Chunk]:
        paras = [p.strip() for p in _PARA_RE.split(text) if p.strip()]
        merged: List[str] = []
        for p in paras:
            if merged and len(merged[-1]) < self.min_chars:
                merged[-1] = merged[-1] + "\n\n" + p
            else:
                merged.append(p)
        out: List[str] = []
        for p in merged:
            if len(p) <= self.max_chars:
                out.append(p)
                continue
            sents = _split_sentences(p) or [p]
            cur = ""
            for s in sents:
                if cur and len(cur) + len(s) + 1 > self.max_chars:
                    out.append(cur)
                    cur = s
                else:
                    cur = (cur + " " + s).strip()
            if cur:
                out.append(cur)
        return _finalize(out, text, doc_id)


class SlidingWindowChunker:
    """Fixed-size character windows with overlap (reference
    chunker.py:165-221)."""

    def __init__(self, window_chars: int = 500, overlap_chars: int = 100) -> None:
        if overlap_chars >= window_chars:
            raise ValueError("overlap_chars must be < window_chars")
        self.window = window_chars
        self.overlap = overlap_chars

    def chunk(self, text: str, doc_id: int = -1) -> List[Chunk]:
        text = text.strip()
        if not text:
            return []
        step = self.window - self.overlap
        chunks: List[Chunk] = []
        idx = 0
        for start in range(0, len(text), step):
            piece = text[start : start + self.window]
            if not piece.strip():
                continue
            chunks.append(
                Chunk(
                    content=piece,
                    doc_id=doc_id,
                    chunk_index=idx,
                    start_char=start,
                    end_char=start + len(piece),
                )
            )
            idx += 1
            if start + self.window >= len(text):
                break
        return chunks


class SemanticChunker:
    """Split where consecutive-sentence embedding similarity drops below a
    threshold (reference chunker.py:231-281). The similarity profile is one
    batched encode on the encoder's device and one shifted row-dot on the
    host. Given no encoder, it serves ``default_encoder`` on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(
        self,
        encoder=None,
        similarity_threshold: float = 0.5,
        max_chars: int = 1000,
        device: DeviceLike = None,
    ) -> None:
        self._encoder = encoder
        self.similarity_threshold = similarity_threshold
        self.max_chars = max_chars
        self.device = device

    @property
    def encoder(self):
        # Lazy model loading, mirroring the reference's @property model
        # convention (reference chunker.py:224-229).
        if self._encoder is None:
            from hybridsearch_tpu_torch.models.encoder import default_encoder

            self._encoder = default_encoder(device=self.device)
        return self._encoder

    def chunk(self, text: str, doc_id: int = -1) -> List[Chunk]:
        sents = _split_sentences(text)
        if not sents:
            return []
        if len(sents) == 1:
            return _finalize(sents, text, doc_id)
        emb = self.encoder.encode(sents).float().cpu().numpy()
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        sims = (emb[:-1] * emb[1:]).sum(axis=1)  # consecutive-pair cosine
        chunks: List[str] = []
        cur = [sents[0]]
        cur_len = len(sents[0])
        for i, s in enumerate(sents[1:]):
            boundary = sims[i] < self.similarity_threshold
            if boundary or cur_len + len(s) + 1 > self.max_chars:
                chunks.append(" ".join(cur))
                cur, cur_len = [s], len(s)
            else:
                cur.append(s)
                cur_len += len(s) + 1
        if cur:
            chunks.append(" ".join(cur))
        return _finalize(chunks, text, doc_id)


def _finalize(pieces: Sequence[str], source: str, doc_id: int) -> List[Chunk]:
    chunks: List[Chunk] = []
    cursor = 0
    for i, piece in enumerate(pieces):
        start = source.find(piece[:40], cursor)
        if start < 0:
            start = cursor
        end = start + len(piece)
        cursor = start + 1
        chunks.append(
            Chunk(content=piece, doc_id=doc_id, chunk_index=i, start_char=start,
                  end_char=end)
        )
    return chunks


def get_chunker(strategy: str = "sentence", **kwargs):
    """Factory (reference chunker.py:284-305)."""
    table = {
        "sentence": SentenceChunker,
        "paragraph": ParagraphChunker,
        "sliding": SlidingWindowChunker,
        "sliding_window": SlidingWindowChunker,
        "semantic": SemanticChunker,
    }
    if strategy not in table:
        raise ValueError(f"unknown chunking strategy: {strategy!r}")
    return table[strategy](**kwargs)
