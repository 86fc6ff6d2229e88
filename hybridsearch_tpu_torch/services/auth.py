"""API keys, scopes, and rate limiting.

Counterpart of ``hybridsearch_tpu/services/auth.py``, host code copied
with the port's imports.

Parity with the reference auth module (reference auth.py:30-303): API key
management (secrets.token_urlsafe, scopes, expiry), fixed-window rate
limiting (100 req/min per key, 30 req/min per IP defaults), and dependency
hooks. The reference defines all of this but never mounts it in its API
(SURVEY §2.22); here the API layer actually enforces it (api/app.py).
"""

from __future__ import annotations

import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

DEFAULT_KEY_LIMIT = 100  # req/min per key (reference auth.py:132)
DEFAULT_IP_LIMIT = 30  # req/min per IP (reference auth.py:264)


@dataclass
class APIKey:
    key: str
    name: str
    scopes: Set[str] = field(default_factory=lambda: {"read"})
    created_at: float = field(default_factory=time.time)
    expires_at: Optional[float] = None
    rate_limit_per_minute: int = DEFAULT_KEY_LIMIT
    revoked: bool = False

    def is_valid(self) -> bool:
        if self.revoked:
            return False
        if self.expires_at is not None and time.time() > self.expires_at:
            return False
        return True


class APIKeyManager:
    """Create/validate/revoke keys (reference auth.py:30-103)."""

    def __init__(self) -> None:
        self._keys: Dict[str, APIKey] = {}
        self._lock = threading.Lock()

    def create_key(
        self,
        name: str,
        scopes: Optional[Set[str]] = None,
        ttl_seconds: Optional[float] = None,
        rate_limit_per_minute: Optional[int] = None,
    ) -> APIKey:
        key = APIKey(
            key="hst_" + secrets.token_urlsafe(32),
            name=name,
            scopes=set(scopes or {"read"}),
            expires_at=time.time() + ttl_seconds if ttl_seconds else None,
            rate_limit_per_minute=rate_limit_per_minute or 0,
        )
        with self._lock:
            self._keys[key.key] = key
        return key

    def validate(self, key: str) -> Optional[APIKey]:
        with self._lock:
            rec = self._keys.get(key)
        return rec if rec is not None and rec.is_valid() else None

    def revoke(self, key: str) -> bool:
        with self._lock:
            rec = self._keys.get(key)
            if rec is None:
                return False
            rec.revoked = True
            return True

    def list_keys(self) -> List[Dict]:
        with self._lock:
            return [
                {"name": k.name, "scopes": sorted(k.scopes),
                 "expires_at": k.expires_at, "revoked": k.revoked,
                 "prefix": k.key[:12] + "..."}
                for k in self._keys.values()
            ]


class RateLimiter:
    """Fixed-window per-identity limiter (reference auth.py:132-174).
    Returns (allowed, remaining, reset_at)."""

    def __init__(self, default_limit: int = DEFAULT_KEY_LIMIT,
                 window_seconds: float = 60.0) -> None:
        self.default_limit = default_limit
        self.window = window_seconds
        self._counts: Dict[str, Tuple[int, float]] = {}  # id -> (count, window_start)
        self._lock = threading.Lock()

    def check(self, identity: str, limit: Optional[int] = None
              ) -> Tuple[bool, int, float]:
        limit = limit or self.default_limit
        now = time.time()
        with self._lock:
            count, start = self._counts.get(identity, (0, now))
            if now - start >= self.window:
                count, start = 0, now
            count += 1
            self._counts[identity] = (count, start)
            remaining = max(0, limit - count)
            return count <= limit, remaining, start + self.window


class AuthContext:
    """Bundles key manager + limiters; the thing the API mounts
    (the reference defines require_auth/require_scope/rate_limit_by_ip at
    auth.py:201-288 but never wires them — here api/app.py enforces this
    on every route when enabled)."""

    def __init__(
        self,
        enabled: bool = False,
        key_limit: int = DEFAULT_KEY_LIMIT,
        ip_limit: int = DEFAULT_IP_LIMIT,
    ) -> None:
        self.enabled = enabled
        self.keys = APIKeyManager()
        self.key_limiter = RateLimiter(default_limit=key_limit)
        self.ip_limiter = RateLimiter(default_limit=ip_limit)

    def authorize(
        self,
        api_key: Optional[str],
        client_ip: str = "unknown",
        scope: Optional[str] = None,
    ) -> Tuple[bool, int, Dict[str, str]]:
        """Returns (allowed, http_status, rate-limit headers). All
        enforcement (keys, scopes, key and IP rate limits) is gated on
        `enabled` — disabled means open, like the reference's default."""
        headers: Dict[str, str] = {}
        if not self.enabled:
            return True, 200, headers
        ok_ip, rem_ip, reset_ip = self.ip_limiter.check("ip:" + client_ip)
        headers["X-RateLimit-Remaining-IP"] = str(rem_ip)
        if not ok_ip:
            headers["Retry-After"] = str(int(max(0, reset_ip - time.time())))
            return False, 429, headers
        if not api_key:
            return False, 401, headers
        rec = self.keys.validate(api_key)
        if rec is None:
            return False, 401, headers
        if scope is not None and scope not in rec.scopes:
            return False, 403, headers
        ok_key, rem_key, reset_key = self.key_limiter.check(
            "key:" + rec.key, rec.rate_limit_per_minute or None
        )
        headers["X-RateLimit-Remaining"] = str(rem_key)
        headers["X-RateLimit-Reset"] = str(int(reset_key))
        if not ok_key:
            headers["Retry-After"] = str(int(max(0, reset_key - time.time())))
            return False, 429, headers
        return True, 200, headers
