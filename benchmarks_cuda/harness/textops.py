"""Frozen copies of the text arithmetic the served path depends on.

The plain reference (``reference.py``) works the embeddings and the BM25
weights out again from the benchmark's own text, so it carries its own
copy of each rule it needs and imports nothing of the program:

- tokens: lowercase ``[a-z0-9_]+`` runs of ASCII text, an English stopword
  set removed;
- a token's identity: the 64-bit FNV-1a hash of its bytes; a bigram's: the
  hash of ``"a_b"`` for two consecutive kept tokens.

These are the rules as the benchmark was written against them; a test
holds them to the program's on sample text, so a change on either side
shows. An encoder kind's own rules sit in its file under ``encoders/``.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Sequence

import numpy as np

TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")
STOPWORDS = frozenset(
    """a an and are as at be been but by for from had has have he her his i if
    in into is it its me my no not of on or our she so that the their them
    then there these they this to was we were what when where which who will
    with you your""".split()
)
FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK64 = 0xFFFFFFFFFFFFFFFF


def tokens(text: str) -> List[str]:
    """Kept tokens of one ASCII text (the plain, one-text form)."""
    return [t for t in TOKEN_RE.findall(text.lower()) if t not in STOPWORDS]


def fnv1a(token: str) -> int:
    h = FNV_OFFSET
    for b in token.encode("utf-8"):
        h = ((h ^ b) * FNV_PRIME) & MASK64
    return h


_WORD = np.zeros(256, dtype=bool)
for _c in b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_":
    _WORD[_c] = True
_LOWER = np.arange(256, dtype=np.uint8)
_LOWER[65:91] += 32
_STOP_HASHES = np.sort(np.array([fnv1a(w) for w in STOPWORDS], dtype=np.uint64))


class Hashed(NamedTuple):
    """Token hashes of a list of texts, text-major."""

    hashes: np.ndarray  # [total] uint64, every kept token
    counts: np.ndarray  # [n_texts] int64 kept tokens a text
    bigrams: np.ndarray  # [total - texts with a token] uint64, "a_b" hashes


def _fnv_continue(h: np.ndarray, data: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    """FNV-1a states ``h`` carried on over data[starts[i]:starts[i]+lens[i]]."""
    h = h.copy()
    prime = np.uint64(FNV_PRIME)
    active = np.arange(len(h))
    j = 0
    while True:
        active = active[lens[active] > j]
        if not len(active):
            return h
        h[active] = (h[active] ^ data[starts[active] + j]) * prime
        j += 1


def hash_texts(texts: Sequence[str]) -> Hashed:
    """Vectorized ``tokens`` + ``fnv1a`` over many ASCII texts, with the
    bigram hashes of consecutive kept tokens of a text."""
    texts = list(texts)
    n = len(texts)
    if not all(t.isascii() for t in texts):
        raise ValueError("the frozen tokenizer reads ASCII text only")
    if n == 0:
        empty = np.zeros(0, dtype=np.uint64)
        return Hashed(empty, np.zeros(0, dtype=np.int64), empty)
    data = np.frombuffer(" ".join(texts).encode("ascii"), dtype=np.uint8)
    lower = _LOWER[data]
    edge = np.diff(_WORD[data].astype(np.int8), prepend=0, append=0)
    starts = np.flatnonzero(edge == 1)
    lens = np.flatnonzero(edge == -1) - starts
    with np.errstate(over="ignore"):
        h = _fnv_continue(np.full(len(starts), FNV_OFFSET, dtype=np.uint64),
                          lower, starts, lens)
        keep = ~np.isin(h, _STOP_HASHES)
        starts, lens, h = starts[keep], lens[keep], h[keep]
        text_starts = np.cumsum([0] + [len(t) + 1 for t in texts[:-1]])
        text_of = np.searchsorted(text_starts, starts, side="right") - 1
        counts = np.bincount(text_of, minlength=n).astype(np.int64)
        a = np.flatnonzero(text_of[:-1] == text_of[1:])
        hb = (h[a] ^ np.uint64(ord("_"))) * np.uint64(FNV_PRIME)
        bi = _fnv_continue(hb, lower, starts[a + 1], lens[a + 1])
    return Hashed(h, counts, bi)
