"""Semantic query cache with LSH candidate lookup.

Counterpart of ``hybridsearch_tpu/services/semantic_cache.py`` (parity
with the reference semantic cache, reference semantic_cache.py:42-424):
random-hyperplane LSH (10 tables x 8 bits) over query embeddings, a hit
when the cosine is >= 0.95, pluggable in-memory (LRU + TTL) and Redis
backends, hit/miss statistics.

Hashing a query is one [D] x [D, tables*bits] product and a sign-bit pack
on the device (``ops/lsh.py``); the bucket lookup, the cosine confirmation
over the bucket candidates, the TTL and the statistics are host code, as in
the JAX module. The planes are drawn from ``seed`` on the host (so one seed
gives one set of planes on every device) or passed in: the JAX package's
``jax.random`` planes come across through ``convert.lsh_planes``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.lsh import lsh_planes, lsh_signatures
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device


class CacheBackend:
    """Storage interface (reference semantic_cache.py:157-178)."""

    def get(self, key: str) -> Optional[Any]:
        raise NotImplementedError

    def set(self, key: str, value: Any, ttl: Optional[float] = None) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class InMemoryBackend(CacheBackend):
    """LRU + TTL (reference semantic_cache.py:181-226)."""

    def __init__(self, max_entries: int = 10000) -> None:
        self.max_entries = max_entries
        self._store: "OrderedDict[str, Tuple[Any, Optional[float]]]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            item = self._store.get(key)
            if item is None:
                return None
            value, expires = item
            if expires is not None and time.time() > expires:
                del self._store[key]
                return None
            self._store.move_to_end(key)
            return value

    def set(self, key: str, value: Any, ttl: Optional[float] = None) -> None:
        with self._lock:
            expires = time.time() + ttl if ttl else None
            self._store[key] = (value, expires)
            self._store.move_to_end(key)
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)

    def delete(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


class RedisBackend(CacheBackend):
    """Redis-backed storage (reference semantic_cache.py:228-270); optional
    dependency, used when a client is supplied."""

    def __init__(self, client, prefix: str = "hst:semcache:") -> None:
        import pickle

        self._pickle = pickle
        self.client = client
        self.prefix = prefix

    def get(self, key: str) -> Optional[Any]:
        raw = self.client.get(self.prefix + key)
        return self._pickle.loads(raw) if raw is not None else None

    def set(self, key: str, value: Any, ttl: Optional[float] = None) -> None:
        raw = self._pickle.dumps(value)
        if ttl:
            self.client.setex(self.prefix + key, int(ttl), raw)
        else:
            self.client.set(self.prefix + key, raw)

    def delete(self, key: str) -> None:
        self.client.delete(self.prefix + key)

    def clear(self) -> None:
        for k in self.client.scan_iter(self.prefix + "*"):
            self.client.delete(k)

    def __len__(self) -> int:
        return sum(1 for _ in self.client.scan_iter(self.prefix + "*"))


class SemanticCache:
    """LSH-candidate + cosine-confirm query result cache
    (reference semantic_cache.py:272-424)."""

    def __init__(
        self,
        similarity_threshold: float = 0.95,
        ttl_seconds: float = 3600.0,
        n_tables: int = 10,
        n_bits: int = 8,
        dim: int = 384,
        max_entries: int = 10000,
        backend: Optional[CacheBackend] = None,
        seed: int = 13,
        planes: Optional[torch.Tensor] = None,
        device: DeviceLike = None,
    ) -> None:
        self.similarity_threshold = similarity_threshold
        self.ttl = ttl_seconds
        self.n_tables = n_tables
        self.n_bits = n_bits
        self.dim = dim
        self.device = resolve_device(device)
        # not `backend or ...`: an empty backend has len() 0 and is falsy
        self.backend = backend if backend is not None else InMemoryBackend(max_entries)
        if planes is None:
            planes = lsh_planes(torch.Generator().manual_seed(seed), n_tables,
                                n_bits, dim)
        if tuple(planes.shape) != (n_tables * n_bits, dim):
            raise ValueError(f"planes of shape {tuple(planes.shape)}, expected "
                             f"{(n_tables * n_bits, dim)}")
        self.planes = planes.to(self.device, torch.float32)
        # LSH buckets: (table, signature) -> list of entry keys
        self._buckets: Dict[Tuple[int, int], List[str]] = {}
        self._vectors: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- hashing -----------------------------------------------------------

    @staticmethod
    def _unit(query_vec) -> np.ndarray:
        """The query as a float32 host vector of norm 1 (a tensor is copied
        to the host)."""
        if torch.is_tensor(query_vec):
            query_vec = query_vec.detach().float().cpu().numpy()
        vec = np.asarray(query_vec, dtype=np.float32).reshape(-1)
        return vec / max(float(np.linalg.norm(vec)), 1e-12)

    def _signatures(self, vec: np.ndarray) -> np.ndarray:
        sig = lsh_signatures(self.planes, torch.from_numpy(vec[None, :]).to(self.device),
                             self.n_tables, self.n_bits)
        return sig.cpu().numpy()[0]

    # -- api ----------------------------------------------------------------

    def get(self, query_vec) -> Optional[Any]:
        """Return the cached value of the most similar cached query with
        cosine >= threshold, else None. ``query_vec`` is a numpy vector or
        a tensor."""
        vec = self._unit(query_vec)
        sigs = self._signatures(vec)
        with self._lock:
            cand_keys: List[str] = []
            seen = set()
            for t, s in enumerate(sigs):
                for key in self._buckets.get((t, int(s)), ()):
                    if key not in seen:
                        seen.add(key)
                        cand_keys.append(key)
            cand_vecs = [self._vectors[k] for k in cand_keys if k in self._vectors]
            cand_keys = [k for k in cand_keys if k in self._vectors]
        if not cand_keys:
            self.misses += 1
            return None
        mat = np.stack(cand_vecs)  # already normalized
        sims = mat @ vec
        best = int(np.argmax(sims))
        if sims[best] < self.similarity_threshold:
            self.misses += 1
            return None
        value = self.backend.get(cand_keys[best])
        if value is None:  # expired
            self.misses += 1
            return None
        self.hits += 1
        return value

    def set(self, query_vec, value: Any, key: Optional[str] = None) -> str:
        """Cache ``value`` under the query vector (numpy or tensor)."""
        vec = self._unit(query_vec)
        key = key or f"q{len(self._vectors)}_{time.time_ns()}"
        sigs = self._signatures(vec)
        with self._lock:
            self._vectors[key] = vec
            for t, s in enumerate(sigs):
                self._buckets.setdefault((t, int(s)), []).append(key)
        self.backend.set(key, value, ttl=self.ttl)
        return key

    def invalidate(self) -> int:
        """Clear everything (reference semantic_cache.py:389-410)."""
        with self._lock:
            n = len(self._vectors)
            self._vectors.clear()
            self._buckets.clear()
        self.backend.clear()
        return n

    def stats(self) -> Dict[str, Any]:
        """Hit/miss statistics (reference semantic_cache.py:412-424)."""
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "entries": len(self._vectors),
            "threshold": self.similarity_threshold,
        }
