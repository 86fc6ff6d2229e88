"""Self-contained BERT tokenizer (counterpart of ``hybridsearch_tpu/models/tokenizer.py``).

With a ``vocab.txt`` on disk it does BERT basic tokenization (lowercase,
accent strip, punctuation split) and greedy longest-match WordPiece with
``##`` continuations; without one, ``HashedVocab`` maps whole words into a
fixed id space (FNV-1a mod size), the vocabulary every in-repo checkpoint
was trained with. Ids are equal to the JAX package's.

``BertTokenizer.batch_encode`` of a ``HashedVocab`` tokenizer over an
all-ASCII batch takes a vectorised numpy path (one pass a byte position,
as ``text/extractor.py`` hashes the BM25 tokens) that gives the per-text
path's ids: a 524,288-doc corpus would spend minutes in the per-character
loop otherwise. That path fills no per-text memo.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hybridsearch_tpu_torch.text.extractor import _FNV_OFFSET, _fnv_over, stable_token_hash

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """Whitespace + punctuation split with accent stripping (BERT basic)."""
    if lowercase:
        text = text.lower()
    text = unicodedata.normalize("NFD", text)
    out: List[str] = []
    buf: List[str] = []
    for ch in text:
        if unicodedata.category(ch) == "Mn":
            continue
        if ch.isspace():
            if buf:
                out.append("".join(buf))
                buf = []
        elif _is_punctuation(ch):
            if buf:
                out.append("".join(buf))
                buf = []
            out.append(ch)
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


class WordPieceVocab:
    def __init__(self, vocab: Dict[str, int]) -> None:
        self.vocab = vocab
        self.pad_id = vocab.get(PAD, 0)
        self.unk_id = vocab.get(UNK, 1)
        self.cls_id = vocab.get(CLS, 2)
        self.sep_id = vocab.get(SEP, 3)
        self.size = max(vocab.values()) + 1

    @classmethod
    def from_file(cls, path: str) -> "WordPieceVocab":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    def wordpiece(self, word: str, max_chars: int = 100) -> List[int]:
        if len(word) > max_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids


class HashedVocab:
    """Deterministic whole-word hashing vocab for weightless operation.
    Ids 0-4 are reserved for special tokens. Every word, however long, gets
    its hash id (``max_chars`` is not applied, as in the JAX package)."""

    N_SPECIAL = 5

    def __init__(self, size: int = 30522) -> None:
        self.size = size
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 1, 2, 3

    def wordpiece(self, word: str, max_chars: int = 100) -> List[int]:
        return [self.N_SPECIAL + stable_token_hash(word) % (self.size - self.N_SPECIAL)]


# byte classes of the vectorised ASCII path: what basic_tokenize does with
# each code point below 128 (str.isspace is true for 9-13, 28-31 and 32;
# the four punctuation ranges are each a token of their own; every other
# byte, control bytes included, stays inside a word)
_SPACE, _PUNCT, _WORDCH = 0, 1, 2
_ASCII_CLASS = np.full(256, _WORDCH, dtype=np.int8)
_ASCII_CLASS[[9, 10, 11, 12, 13, 28, 29, 30, 31, 32]] = _SPACE
for _lo, _hi in ((33, 47), (58, 64), (91, 96), (123, 126)):
    _ASCII_CLASS[_lo:_hi + 1] = _PUNCT
_ASCII_LOWER = np.arange(256, dtype=np.uint8)
_ASCII_LOWER[65:91] += 32


class BertTokenizer:
    """BERT-style tokenizer over either vocab backend."""

    # memo bound: ~512k texts x ~60 int ids; cleared wholesale when full
    # (rerank candidate sets are zipfian: the hot texts repopulate within
    # one batch)
    _CACHE_ENTRIES = 1 << 19
    _CACHE_TOK = 512  # tokens memoized per text (>= every max_len used)

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        vocab_size: int = 30522,
        lowercase: bool = True,
    ) -> None:
        if vocab_path and os.path.exists(vocab_path):
            self.vocab = WordPieceVocab.from_file(vocab_path)
        else:
            self.vocab = HashedVocab(vocab_size)
        self.lowercase = lowercase
        self._seq_cache: Dict[str, Tuple[List[int], bool]] = {}

    @property
    def vocab_size(self) -> int:
        return self.vocab.size

    def _text_ids(self, text: str, need: int) -> List[int]:
        """Wordpiece ids for ``text`` (no special tokens), at least ``need``
        tokens unless the text is shorter. Memoized per text: a rerank
        batch tokenizes the same query once per candidate."""
        hit = self._seq_cache.get(text)
        if hit is not None:
            ids, complete = hit
            if complete or len(ids) >= need:
                return ids
        ids = []
        complete = True
        for word in basic_tokenize(text, self.lowercase):
            ids.extend(self.vocab.wordpiece(word))
            if len(ids) >= self._CACHE_TOK:
                complete = False
                break
        if len(self._seq_cache) >= self._CACHE_ENTRIES:
            self._seq_cache.clear()
        self._seq_cache[text] = (ids, complete)
        return ids

    def encode(self, text: str, max_len: int = 256) -> List[int]:
        body = self._text_ids(text, max_len - 2)
        return ([self.vocab.cls_id] + body[: max_len - 2]
                + [self.vocab.sep_id])

    def encode_pair(self, text_a: str, text_b: str, max_len: int = 256) -> Tuple[List[int], List[int]]:
        """(ids, type_ids) for cross-encoder (query, doc) pairs."""
        a = ([self.vocab.cls_id]
             + self._text_ids(text_a, max_len // 2 - 2)[: max_len // 2 - 2]
             + [self.vocab.sep_id])
        b = (self._text_ids(text_b, max_len - 1 - len(a))
             [: max_len - 1 - len(a)] + [self.vocab.sep_id])
        return a + b, [0] * len(a) + [1] * len(b)

    def _ascii_bodies(self, texts: Sequence[str], cut: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids int64 [total], counts int64 [B]): each text's ``HashedVocab``
        ids cut at ``cut``, over ASCII texts, equal to ``_text_ids``."""
        n = len(texts)
        data = np.frombuffer(" ".join(texts).encode("ascii"), dtype=np.uint8)
        if self.lowercase:
            data = _ASCII_LOWER[data]
        cls = _ASCII_CLASS[data]
        edge = np.diff((cls == _WORDCH).astype(np.int8), prepend=0, append=0)
        w_start = np.flatnonzero(edge == 1)
        w_len = np.flatnonzero(edge == -1) - w_start
        p_start = np.flatnonzero(cls == _PUNCT)
        starts = np.concatenate([w_start, p_start])
        order = np.argsort(starts, kind="stable")
        starts = starts[order]
        lens = np.concatenate([w_len, np.ones(len(p_start), np.int64)])[order]
        with np.errstate(over="ignore"):
            h = _fnv_over(np.full(len(starts), _FNV_OFFSET, dtype=np.uint64), data,
                          starts, lens)
        nh = np.uint64(self.vocab.size - HashedVocab.N_SPECIAL)
        ids = (h % nh).astype(np.int64) + HashedVocab.N_SPECIAL
        doc_starts = np.cumsum([0] + [len(t) + 1 for t in texts[:-1]]) if n else []
        doc_of = np.searchsorted(np.asarray(doc_starts, dtype=np.int64), starts,
                                 side="right") - 1
        counts = np.bincount(doc_of, minlength=n).astype(np.int64)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        keep = (np.arange(len(ids)) - first[doc_of]) < cut
        return ids[keep], np.minimum(counts, cut)

    def _bodies(self, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids int64 [total], counts int64 [B]): each text's ids without the
        special tokens, cut at ``max_len - 2``."""
        cut = max(max_len - 2, 0)
        if isinstance(self.vocab, HashedVocab) and all(t.isascii() for t in texts):
            # _text_ids stops a text at _CACHE_TOK ids (one a word here)
            return self._ascii_bodies(texts, min(cut, self._CACHE_TOK))
        bodies = [self._text_ids(t, cut)[:cut] for t in texts]
        counts = np.fromiter((len(b) for b in bodies), dtype=np.int64, count=len(bodies))
        flat = np.fromiter((i for b in bodies for i in b), dtype=np.int64,
                           count=int(counts.sum()))
        return flat, counts

    def batch_encode(
        self,
        texts: Sequence[str],
        max_len: int = 256,
        pad_multiple: int = 8,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [B, L], mask [B, L]) int32, padded to a bucketed length."""
        texts = list(texts)
        flat, counts = self._bodies(texts, max_len)
        B = len(texts)
        longest = int(counts.max()) + 2 if B else 1
        L = min(max_len, _bucket(longest, pad_multiple))
        ids = np.full((B, L), self.vocab.pad_id, dtype=np.int32)
        mask = np.zeros((B, L), dtype=np.int32)
        row = np.repeat(np.arange(B, dtype=np.int64), counts)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        col = np.arange(len(flat), dtype=np.int64) - first[row] + 1
        ids[row, col] = flat
        ids[:, 0] = self.vocab.cls_id
        ids[np.arange(B), counts + 1] = self.vocab.sep_id
        mask[np.arange(L)[None, :] < (counts + 2)[:, None]] = 1
        return ids, mask

    def batch_encode_pairs(
        self,
        pairs: Sequence[Tuple[str, str]],
        max_len: int = 256,
        pad_multiple: int = 8,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        encoded = [self.encode_pair(a, b, max_len) for a, b in pairs]
        longest = max((len(e[0]) for e in encoded), default=1)
        L = min(max_len, _bucket(longest, pad_multiple))
        ids = np.full((len(pairs), L), self.vocab.pad_id, dtype=np.int32)
        types = np.zeros((len(pairs), L), dtype=np.int32)
        mask = np.zeros((len(pairs), L), dtype=np.int32)
        for i, (e, t) in enumerate(encoded):
            e, t = e[:L], t[:L]
            ids[i, : len(e)] = e
            types[i, : len(t)] = t
            mask[i, : len(e)] = 1
        return ids, types, mask


def _bucket(n: int, multiple: int) -> int:
    """Round up to a power-of-two-ish bucket (8, 16, 32, 64, 128, 256...)."""
    b = multiple
    while b < n:
        b *= 2
    return b
