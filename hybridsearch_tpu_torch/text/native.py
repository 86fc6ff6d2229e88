"""Counterpart of the text helpers of ``hybridsearch_tpu/text/native.py``
that no other port module holds: ``minhash_shingle_hashes``. The JAX module
calls a C++ library when it is built and falls back to Python; the port is
that Python fallback (``levenshtein`` and ``partial_ratio`` are in
``text/fuzzy.py``).
"""

from __future__ import annotations

from typing import List

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def minhash_shingle_hashes(text: str, shingle_len: int = 3) -> List[int]:
    """64-bit FNV-1a hashes of the byte shingles of ``text`` (UTF-8):
    ``len(bytes) - shingle_len + 1`` of them, none when the text is shorter
    than a shingle (dedup fingerprinting)."""
    data = text.encode("utf-8", errors="replace")
    hashes = []
    for i in range(max(0, len(data) - shingle_len + 1)):
        h = _FNV_OFFSET
        for byte in data[i:i + shingle_len]:
            h = ((h ^ byte) * _FNV_PRIME) & _MASK64
        hashes.append(h)
    return hashes
