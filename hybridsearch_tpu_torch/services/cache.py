"""Exact-key result caches + decorator.

Counterpart of ``hybridsearch_tpu/services/cache.py``, host code copied as
it is (parity with the reference cache module, reference cache.py:24-308):
md5-keyed LRU with TTL, a Redis variant with an injected client, a
linear-scan semantic cache variant (kept for API compatibility; the LSH
cache in semantic_cache.py is the production path), and a @cached_search
decorator.
"""

from __future__ import annotations

import functools
import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np


def make_key(query: str, **params) -> str:
    """md5 over query + sorted params (reference cache.py:24-40)."""
    payload = json.dumps({"q": query, **params}, sort_keys=True, default=str)
    return hashlib.md5(payload.encode()).hexdigest()


class InMemoryCache:
    """LRU + TTL exact-key cache (reference cache.py:24-107)."""

    def __init__(self, max_entries: int = 1000, ttl_seconds: float = 3600.0) -> None:
        self.max_entries = max_entries
        self.ttl = ttl_seconds
        self._store: "OrderedDict[str, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            item = self._store.get(key)
            if item is None:
                self.misses += 1
                return None
            value, expires = item
            if expires is not None and time.time() > expires:
                del self._store[key]
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return value

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            expires = time.time() + self.ttl if self.ttl else None
            self._store[key] = (value, expires)
            self._store.move_to_end(key)
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)

    def invalidate(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._store.clear()
            else:
                self._store.pop(key, None)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "entries": len(self._store),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
        }

    def __len__(self) -> int:
        return len(self._store)


class RedisCache:
    """Redis exact-key cache (reference cache.py:110-189). Requires a redis
    client instance; this environment has no redis package, so the client is
    injected."""

    def __init__(self, client, ttl_seconds: float = 3600.0,
                 prefix: str = "hst:cache:") -> None:
        import pickle

        self._pickle = pickle
        self.client = client
        self.ttl = ttl_seconds
        self.prefix = prefix
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        raw = self.client.get(self.prefix + key)
        if raw is None:
            self.misses += 1
            return None
        self.hits += 1
        return self._pickle.loads(raw)

    def set(self, key: str, value: Any) -> None:
        self.client.setex(self.prefix + key, int(self.ttl),
                          self._pickle.dumps(value))

    def invalidate(self, key: Optional[str] = None) -> None:
        if key is not None:
            self.client.delete(self.prefix + key)
        else:
            for k in self.client.scan_iter(self.prefix + "*"):
                self.client.delete(k)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}


class LinearScanSemanticCache:
    """O(n)-scan cosine cache, API-compatible with the reference's
    SemanticCache (reference cache.py:192-281). Kept for small caches and
    compatibility; the LSH cache (services/semantic_cache.py) is the scaled
    path. The scan itself is one vectorized matvec, not a Python loop."""

    def __init__(self, similarity_threshold: float = 0.95,
                 max_entries: int = 1000, ttl_seconds: float = 3600.0) -> None:
        self.similarity_threshold = similarity_threshold
        self.max_entries = max_entries
        self.ttl = ttl_seconds
        self._vecs: list = []
        self._values: list = []
        self._expiry: list = []
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, query_vec: np.ndarray) -> Optional[Any]:
        vec = np.asarray(query_vec, np.float32).reshape(-1)
        vec = vec / max(float(np.linalg.norm(vec)), 1e-12)
        now = time.time()
        with self._lock:
            alive = [i for i, e in enumerate(self._expiry) if e is None or e > now]
            if not alive:
                self.misses += 1
                return None
            mat = np.stack([self._vecs[i] for i in alive])
            sims = mat @ vec
            best = int(np.argmax(sims))
            if sims[best] < self.similarity_threshold:
                self.misses += 1
                return None
            self.hits += 1
            return self._values[alive[best]]

    def set(self, query_vec: np.ndarray, value: Any) -> None:
        vec = np.asarray(query_vec, np.float32).reshape(-1)
        vec = vec / max(float(np.linalg.norm(vec)), 1e-12)
        with self._lock:
            self._vecs.append(vec)
            self._values.append(value)
            self._expiry.append(time.time() + self.ttl if self.ttl else None)
            while len(self._vecs) > self.max_entries:
                self._vecs.pop(0)
                self._values.pop(0)
                self._expiry.pop(0)


def cached_search(cache: Optional[InMemoryCache] = None) -> Callable:
    """Decorator caching search(query, **kwargs) results
    (reference cache.py:284-308)."""
    cache = cache or InMemoryCache()

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(query: str, *args, **kwargs):
            key = make_key(query, args=list(map(str, args)), **kwargs)
            hit = cache.get(key)
            if hit is not None:
                return hit
            result = fn(query, *args, **kwargs)
            cache.set(key, result)
            return result

        inner.cache = cache
        return inner

    return wrap
