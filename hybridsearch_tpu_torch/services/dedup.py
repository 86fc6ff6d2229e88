"""Near-duplicate detection: MinHash + banded LSH + exact SHA-256.

Counterpart of ``hybridsearch_tpu/services/dedup.py``, host code copied
with the port's imports.

Parity with the reference dedup engine (reference deduplication.py:21-252):
128-permutation MinHash over 3-char shingles, LSH at threshold 0.9,
SKIP/MERGE/FLAG actions, SHA-256 exact matching.

First-party implementation (the reference leans on the `datasketch` C
extension): shingle hashing runs in native C++ (textops FNV-1a), and the
128 permutations are applied as ONE vectorized (a*h + b) % p min-reduction
in NumPy over all shingles — no per-permutation Python loops. Banded LSH
(16 bands x 8 rows) indexes signatures for candidate lookup.
"""

from __future__ import annotations

import enum
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from hybridsearch_tpu_torch.text.native import minhash_shingle_hashes

_PRIME = np.uint64((1 << 61) - 1)


class DedupeAction(str, enum.Enum):
    """What to do with a detected duplicate (reference deduplication.py:21-27)."""

    SKIP = "skip"
    MERGE = "merge"
    FLAG = "flag"


class MinHasher:
    """128-perm MinHash with vectorized permutations."""

    def __init__(self, num_perm: int = 128, shingle_len: int = 3,
                 seed: int = 1) -> None:
        rng = np.random.default_rng(seed)
        self.num_perm = num_perm
        self.shingle_len = shingle_len
        self.a = rng.integers(1, int(_PRIME), num_perm, dtype=np.uint64)
        self.b = rng.integers(0, int(_PRIME), num_perm, dtype=np.uint64)

    def signature(self, text: str) -> np.ndarray:
        """[num_perm] uint64 MinHash signature (reference
        deduplication.py:84-124)."""
        hashes = minhash_shingle_hashes(text.lower(), self.shingle_len)
        if not hashes:
            return np.full(self.num_perm, np.iinfo(np.uint64).max, dtype=np.uint64)
        h = np.asarray(hashes, dtype=np.uint64)[:, None]  # [S, 1]
        # (a*h + b) mod p for all perms at once: [S, P] -> min over shingles
        perms = (h * self.a[None, :] + self.b[None, :]) % _PRIME
        return perms.min(axis=0)

    @staticmethod
    def similarity(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
        """Estimated Jaccard = fraction of matching signature slots."""
        return float(np.mean(sig_a == sig_b))


class MinHashLSH:
    """Banded LSH over MinHash signatures for candidate retrieval."""

    def __init__(self, num_perm: int = 128, bands: int = 16) -> None:
        assert num_perm % bands == 0
        self.bands = bands
        self.rows = num_perm // bands
        self._tables: List[Dict[bytes, List[str]]] = [{} for _ in range(bands)]
        self._sigs: Dict[str, np.ndarray] = {}

    def add(self, key: str, sig: np.ndarray) -> None:
        self._sigs[key] = sig
        for b in range(self.bands):
            band = sig[b * self.rows : (b + 1) * self.rows].tobytes()
            self._tables[b].setdefault(band, []).append(key)

    def query(self, sig: np.ndarray) -> List[str]:
        out: List[str] = []
        seen = set()
        for b in range(self.bands):
            band = sig[b * self.rows : (b + 1) * self.rows].tobytes()
            for key in self._tables[b].get(band, ()):
                if key not in seen:
                    seen.add(key)
                    out.append(key)
        return out

    def get(self, key: str) -> Optional[np.ndarray]:
        return self._sigs.get(key)

    def __len__(self) -> int:
        return len(self._sigs)


class DeduplicationEngine:
    """Detect and handle near/exact duplicates (reference
    deduplication.py:54-252)."""

    def __init__(
        self,
        threshold: float = 0.9,
        num_perm: int = 128,
        shingle_len: int = 3,
        action: DedupeAction = DedupeAction.FLAG,
    ) -> None:
        self.threshold = threshold
        self.action = action
        self.hasher = MinHasher(num_perm=num_perm, shingle_len=shingle_len)
        self.lsh = MinHashLSH(num_perm=num_perm)
        self._exact: Dict[str, str] = {}  # sha256 -> doc key
        self._lock = threading.Lock()

    @staticmethod
    def exact_hash(text: str) -> str:
        """SHA-256 content hash (reference deduplication.py:84-102)."""
        return hashlib.sha256(text.encode("utf-8", "replace")).hexdigest()

    def compute_fingerprint(self, text: str) -> np.ndarray:
        return self.hasher.signature(text)

    def add_document(self, key: str, text: str) -> None:
        with self._lock:
            self._exact[self.exact_hash(text)] = key
            self.lsh.add(key, self.hasher.signature(text))

    def find_duplicates(self, text: str) -> List[Tuple[str, float]]:
        """(existing_key, estimated_jaccard) above threshold (reference
        deduplication.py:126-164)."""
        sha = self.exact_hash(text)
        with self._lock:
            exact = self._exact.get(sha)
            sig = self.hasher.signature(text)
            candidates = self.lsh.query(sig)
            out: List[Tuple[str, float]] = []
            if exact is not None:
                out.append((exact, 1.0))
            for key in candidates:
                if exact is not None and key == exact:
                    continue
                other = self.lsh.get(key)
                sim = self.hasher.similarity(sig, other)
                if sim >= self.threshold:
                    out.append((key, sim))
        out.sort(key=lambda t: -t[1])
        return out

    def check_and_handle(self, key: str, text: str) -> Dict:
        """Detect + apply the configured action (reference
        deduplication.py:196-241). Returns a decision record."""
        dups = self.find_duplicates(text)
        if not dups:
            self.add_document(key, text)
            return {"is_duplicate": False, "action": None, "duplicates": []}
        record = {
            "is_duplicate": True,
            "action": self.action.value,
            "duplicates": [{"key": k, "similarity": round(s, 4)} for k, s in dups],
        }
        if self.action in (DedupeAction.FLAG, DedupeAction.MERGE):
            # flagged/merged docs are still indexed so they stay findable
            self.add_document(key, text)
        return record

    def find_all_duplicates(self, docs: Dict[str, str]) -> List[Dict]:
        """Batch scan of a corpus (reference /documents/duplicates endpoint,
        api.py area)."""
        engine = DeduplicationEngine(self.threshold, self.hasher.num_perm,
                                     self.hasher.shingle_len, self.action)
        groups: List[Dict] = []
        for key, text in docs.items():
            dups = engine.find_duplicates(text)
            if dups:
                groups.append({"key": key, "duplicates": [
                    {"key": k, "similarity": round(s, 4)} for k, s in dups
                ]})
            engine.add_document(key, text)
        return groups
