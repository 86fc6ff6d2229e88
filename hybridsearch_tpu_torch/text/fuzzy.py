"""Edit-distance similarity for the searcher's fuzzy lexical arm.

Counterpart of ``levenshtein`` and ``partial_ratio`` of
``hybridsearch_tpu/text/native.py``, as their pure-Python versions (the JAX
package calls a C++ library for them when it is built; on text whose
characters are single bytes both give the same numbers).
"""

from __future__ import annotations


def levenshtein(a: str, b: str) -> int:
    """Edit distance (insertions, deletions, substitutions of one
    character), two-row dynamic programme."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def partial_ratio(a: str, b: str) -> float:
    """Best similarity, in [0, 100], of the shorter string against any
    window of its length in the longer one (the contract of
    ``rapidfuzz.fuzz.partial_ratio``, which the reference's fuzzy arm uses)."""
    if not a or not b:
        return 0.0
    short, long_ = (a, b) if len(a) <= len(b) else (b, a)
    n = len(short)
    best = 0.0
    for start in range(0, len(long_) - n + 1) or [0]:
        dist = levenshtein(short, long_[start:start + n])
        score = 100.0 * (1.0 - dist / max(n, 1))
        if score > best:
            best = score
        if best >= 100.0:
            break
    return best
