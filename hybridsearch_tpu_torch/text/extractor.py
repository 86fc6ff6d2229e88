"""Tokenization and preprocessing (copy of hybridsearch_tpu/text/extractor.py).

Word tokens are lowercase ``[a-z0-9_]+`` runs with an English stopword set
removed; preprocessing collapses whitespace. Term identity for the bulk
index path is the 64-bit FNV-1a hash of the token (``HashVocabulary``),
hash-identical to the JAX package's native ``textops`` path; the port
computes it in Python and numpy (``token_hashes_docs``), hashing each
distinct token once. The file loaders (``SUPPORTED_EXTENSIONS``,
``extract_metadata``, ``load_file_content``, ``discover_documents``) are
the JAX module's, for .txt/.md/.log/.csv/.json files.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")
# unicode word tokens for non-ASCII text ([^\W_] = letters/digits across
# scripts); CJK runs get split into character bigrams below
_UNI_TOKEN_RE = re.compile(r"[^\W_]+", re.UNICODE)
# scripts written without spaces: CJK unified + extensions, kana, hangul,
# and Thai — token = character bigram (the standard search-engine
# fallback when no segmenter ships)
_NOSPACE_RE = re.compile(
    r"[⺀-⿿぀-ヿ㐀-䶿一-鿿"
    r"가-힯豈-﫿฀-๿]+")

# Standard English function-word stopword set (same role as reference
# extractor.py:6-12; membership kept to very common function words so BM25
# statistics stay meaningful).
STOPWORDS = frozenset(
    """a an and are as at be been but by for from had has have he her his i if
    in into is it its me my no not of on or our she so that the their them
    then there these they this to was we were what when where which who will
    with you your""".split()
)

def extract_tokens(text: str, remove_stopwords: bool = True) -> List[str]:
    """Lowercase word tokens, optionally stopword-filtered
    (reference extractor.py:15-31).

    ASCII text matches the reference's `[A-Za-z0-9_]+` exactly (parity,
    and with the JAX package's native
    C tokenizer). Non-ASCII text is a deliberate
    extension the reference lacks (its regex drops accented Latin,
    Cyrillic, and every CJK character entirely, extractor.py:28):
    unicode word tokens, with runs in space-less scripts (CJK, kana,
    hangul, Thai) split into character bigrams so BM25 has postings to
    match on."""
    if text.isascii():
        toks = _TOKEN_RE.findall(text.lower())
    else:
        toks = []
        for tok in _UNI_TOKEN_RE.findall(text.lower()):
            pos = 0
            for m in _NOSPACE_RE.finditer(tok):
                if m.start() > pos:
                    toks.append(tok[pos:m.start()])
                run = m.group()
                if len(run) == 1:
                    toks.append(run)
                else:
                    toks.extend(run[i:i + 2] for i in range(len(run) - 1))
                pos = m.end()
            if pos < len(tok):
                toks.append(tok[pos:])
    if remove_stopwords:
        toks = [t for t in toks if t not in STOPWORDS]
    return toks


def preprocess_text(text: str) -> str:
    """Collapse whitespace and strip (reference extractor.py:34-52).
    ``str.split`` splits on exactly the characters ``\\s`` matches."""
    return " ".join(text.split())


SUPPORTED_EXTENSIONS = (".txt", ".md", ".log", ".csv", ".json")


def extract_metadata(path: str) -> Dict[str, object]:
    """Basic file metadata (reference extractor.py:55-71)."""
    st = os.stat(path)
    return {
        "path": os.path.abspath(path),
        "filename": os.path.basename(path),
        "extension": os.path.splitext(path)[1].lower(),
        "size_bytes": st.st_size,
        "modified_at": st.st_mtime,
    }


def load_file_content(path: str) -> Optional[str]:
    """Text of a supported file, or None (an unsupported extension, an
    unreadable file); a JSON file's string values, depth first, one a line
    (its raw text when it does not parse)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in SUPPORTED_EXTENSIONS:
        return None
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            raw = f.read()
    except OSError:
        return None
    if ext != ".json":
        return raw
    try:
        data = json.loads(raw)
    except json.JSONDecodeError:
        return raw
    parts: List[str] = []

    def walk(v):
        if isinstance(v, str):
            parts.append(v)
        elif isinstance(v, dict):
            for vv in v.values():
                walk(vv)
        elif isinstance(v, list):
            for vv in v:
                walk(vv)

    walk(data)
    return "\n".join(parts)


def discover_documents(
    directory: str, extensions: Optional[Iterable[str]] = None
) -> List[Tuple[str, str]]:
    """Every supported file under ``directory`` (recursively; the files of
    each directory by name) with non-empty content, as [(path,
    preprocessed content)]."""
    exts = tuple(extensions) if extensions else SUPPORTED_EXTENSIONS
    out: List[Tuple[str, str]] = []
    for root, _dirs, files in os.walk(directory):
        for name in sorted(files):
            if os.path.splitext(name)[1].lower() not in exts:
                continue
            path = os.path.join(root, name)
            content = load_file_content(path)
            if content:
                out.append((path, preprocess_text(content)))
    return out


class Vocabulary:
    """Mutable token -> id mapping used to feed the device BM25 postings.

    id `len(vocab)` (== vocab_size) is reserved as the padding/no-op term in
    ops/bm25.py query vectors.
    """

    def __init__(self) -> None:
        self.token_to_id: Dict[str, int] = {}
        self.id_to_token: List[str] = []

    def __len__(self) -> int:
        return len(self.id_to_token)

    def add(self, token: str) -> int:
        tid = self.token_to_id.get(token)
        if tid is None:
            tid = len(self.id_to_token)
            self.token_to_id[token] = tid
            self.id_to_token.append(token)
        return tid

    def get(self, token: str, default: int = -1) -> int:
        return self.token_to_id.get(token, default)

    def copy(self) -> "Vocabulary":
        """Copy-on-write support for incremental index adds: the new state
        extends a COPY so readers of the old snapshot never see term ids
        beyond their postings' vocab_size."""
        v = Vocabulary()
        v.token_to_id = dict(self.token_to_id)
        v.id_to_token = list(self.id_to_token)
        return v

    def encode(self, tokens: Iterable[str], add: bool = False) -> List[int]:
        if add:
            return [self.add(t) for t in tokens]
        return [tid for t in tokens if (tid := self.token_to_id.get(t)) is not None]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def stable_token_hash(token: str) -> int:
    """Deterministic 64-bit FNV-1a over the UTF-8 token bytes — identical
    to the native hst_token_hashes contract (native/textops.cc), so hash
    vocabularies built by the C bulk path and Python queries agree."""
    h = _FNV_OFFSET
    for b in token.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


STOP_HASHES = tuple(sorted(stable_token_hash(w) for w in STOPWORDS))


class HashVocabulary:
    """Drop-in Vocabulary keyed on stable 64-bit token hashes.

    Built by the native bulk-index path (BM25.fit_hashes): term identity is
    the FNV-1a hash of the lowercase token, so fitting never materializes
    token strings. The string-facing API (add/get/encode over tokens) hashes
    on the way in, which keeps query encoding, incremental add_tokens, and
    every sparse-index consumer working unchanged. 64-bit FNV collisions
    over real vocabularies (<10^7 terms) are ~10^-5-probability events and
    at worst merge two terms' postings."""

    def __init__(self) -> None:
        self.hash_to_id: Dict[int, int] = {}
        self.id_to_hash: List[int] = []

    @classmethod
    def from_hashes(cls, unique_hashes) -> "HashVocabulary":
        v = cls()
        v.id_to_hash = [int(h) for h in unique_hashes]
        v.hash_to_id = {h: i for i, h in enumerate(v.id_to_hash)}
        return v

    def __len__(self) -> int:
        return len(self.id_to_hash)

    def add(self, token: str) -> int:
        h = stable_token_hash(token)
        tid = self.hash_to_id.get(h)
        if tid is None:
            tid = len(self.id_to_hash)
            self.hash_to_id[h] = tid
            self.id_to_hash.append(h)
        return tid

    def get(self, token: str, default: int = -1) -> int:
        return self.hash_to_id.get(stable_token_hash(token), default)

    def copy(self) -> "HashVocabulary":
        v = HashVocabulary()
        v.hash_to_id = dict(self.hash_to_id)
        v.id_to_hash = list(self.id_to_hash)
        return v

    def add_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """int64 ids of a stream of token hashes, unseen hashes added in
        first-seen order: the ids ``add`` gives token by token, found by
        sorting instead of one dict lookup a token."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        known = np.asarray(self.id_to_hash, dtype=np.uint64)
        order = np.argsort(known, kind="stable")
        srt = known[order]
        at = np.minimum(np.searchsorted(srt, hashes), max(len(srt) - 1, 0))
        found = (srt[at] == hashes) if len(srt) else np.zeros(len(hashes), bool)
        ids = np.empty(len(hashes), dtype=np.int64)
        ids[found] = order[at[found]]
        fresh, first, inv = np.unique(hashes[~found], return_index=True,
                                      return_inverse=True)
        rank = np.empty(len(fresh), dtype=np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(fresh))
        ids[~found] = len(known) + rank[inv.reshape(-1)]
        start = len(self.id_to_hash)
        for i, h in enumerate(fresh[np.argsort(first, kind="stable")].tolist()):
            self.hash_to_id[h] = start + i
            self.id_to_hash.append(h)
        return ids

    def encode(self, tokens: Iterable[str], add: bool = False) -> List[int]:
        if add:
            return [self.add(t) for t in tokens]
        out = []
        for t in tokens:
            tid = self.hash_to_id.get(stable_token_hash(t))
            if tid is not None:
                out.append(tid)
        return out



class HashedDocs(NamedTuple):
    """Token hashes of a corpus, doc-major."""

    hashes: np.ndarray  # [total] uint64 FNV-1a of each kept token
    counts: np.ndarray  # [n_docs] int64 kept tokens per doc
    bigrams: Optional[np.ndarray]  # [total - nonempty docs] uint64
    #   FNV-1a of "a_b" for each pair of consecutive kept tokens


_WORD = np.zeros(256, dtype=bool)
for _c in b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_":
    _WORD[_c] = True
_LOWER = np.arange(256, dtype=np.uint8)
_LOWER[65:91] += 32
_STOP_SORTED = np.sort(np.asarray(STOP_HASHES, dtype=np.uint64))


def _fnv_over(h: np.ndarray, data: np.ndarray, starts: np.ndarray,
              lens: np.ndarray) -> np.ndarray:
    """Continue FNV-1a states ``h`` over data[starts[i] : starts[i]+lens[i]],
    one numpy pass per byte position over the tokens still that long."""
    h = h.copy()
    prime = np.uint64(_FNV_PRIME)
    active = np.arange(len(h))
    j = 0
    while len(active):
        active = active[lens[active] > j]
        if not len(active):
            break
        h[active] = (h[active] ^ data[starts[active] + j]) * prime
        j += 1
    return h


def _hash_ascii(texts: Sequence[str], bigrams: bool) -> HashedDocs:
    """Vectorized tokenize + hash of ASCII texts: word-char runs of the
    concatenated bytes, lowercased, FNV-1a, stop hashes dropped -- the
    same tokens and hashes as ``extract_tokens`` + ``stable_token_hash``."""
    n = len(texts)
    raw = " ".join(texts).encode("ascii")
    data = np.frombuffer(raw, dtype=np.uint8)
    lower = _LOWER[data]
    edge = np.diff(_WORD[data].astype(np.int8), prepend=0, append=0)
    starts = np.flatnonzero(edge == 1)
    lens = np.flatnonzero(edge == -1) - starts
    h = _fnv_over(np.full(len(starts), _FNV_OFFSET, dtype=np.uint64), lower,
                  starts, lens)
    keep = ~np.isin(h, _STOP_SORTED)
    starts, lens, h = starts[keep], lens[keep], h[keep]
    doc_starts = np.cumsum([0] + [len(t) + 1 for t in texts[:-1]]) if n else []
    doc_of = np.searchsorted(np.asarray(doc_starts, dtype=np.int64), starts,
                             side="right") - 1
    counts = np.bincount(doc_of, minlength=n).astype(np.int64)
    bi = None
    if bigrams:
        a = np.flatnonzero(doc_of[:-1] == doc_of[1:])
        hb = (h[a] ^ np.uint64(ord("_"))) * np.uint64(_FNV_PRIME)
        bi = _fnv_over(hb, lower, starts[a + 1], lens[a + 1])
    return HashedDocs(h, counts, bi)


def _hash_python(texts: Sequence[str], bigrams: bool) -> HashedDocs:
    """Per-text ``extract_tokens`` (any script), hashing each distinct token
    once."""
    table: Dict[str, int] = {}
    flat: List[int] = []
    counts = np.empty(len(texts), dtype=np.int64)
    for i, text in enumerate(texts):
        toks = extract_tokens(text)
        counts[i] = len(toks)
        flat.extend([table.setdefault(t, len(table)) for t in toks])
    ids = np.asarray(flat, dtype=np.int64)
    tokens = list(table)
    h_tok = np.fromiter((stable_token_hash(t) for t in tokens), dtype=np.uint64,
                        count=len(tokens))
    bi = None
    if bigrams:
        raw = [t.encode("utf-8") for t in tokens]
        tlen = np.fromiter((len(r) for r in raw), dtype=np.int64, count=len(raw))
        tstart = np.concatenate([[0], np.cumsum(tlen)[:-1]]).astype(np.int64)
        tdata = np.frombuffer(b"".join(raw), dtype=np.uint8)
        doc_of = np.repeat(np.arange(len(texts), dtype=np.int64), counts)
        a = np.flatnonzero(doc_of[:-1] == doc_of[1:])
        hb = (h_tok[ids[a]] ^ np.uint64(ord("_"))) * np.uint64(_FNV_PRIME)
        bi = _fnv_over(hb, tdata, tstart[ids[a + 1]], tlen[ids[a + 1]])
    return HashedDocs(h_tok[ids], counts, bi)


def hash_docs(texts: Sequence[str], bigrams: bool = False) -> HashedDocs:
    """Token (and optionally bigram) hashes of a corpus: the vectorized
    byte path when every text is ASCII, else per-text ``extract_tokens``."""
    texts = list(texts)
    with np.errstate(over="ignore"):
        if all(t.isascii() for t in texts):
            return _hash_ascii(texts, bigrams)
        return _hash_python(texts, bigrams)


def token_hashes_docs(texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(hashes uint64 [total], counts int64 [n_docs]): stopword-filtered
    token hashes of a whole corpus, hash-identical to the JAX package's
    native ``token_hashes_docs`` on ASCII text."""
    out = hash_docs(texts)
    return out.hashes, out.counts
