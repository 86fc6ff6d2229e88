"""Score normalization and hybrid fusion ops (counterpart of
``hybridsearch_tpu/ops/fusion.py``).

  - min-max normalize with the reference's constant-score edge case: when
    max == min the result is all-ones;
  - weighted fusion hybrid = sem*w_s + lex*w_l;
  - max-normalization (HybridBM25Pipeline semantics);
  - reciprocal-rank fusion (c=60).
"""

from __future__ import annotations

from typing import Optional

import torch


def minmax_normalize(scores: torch.Tensor, dim: int = -1,
                     eps: float = 1e-12) -> torch.Tensor:
    """Min-max normalize to [0, 1]; constant input maps to all-ones."""
    s = scores.float()
    mn = s.amin(dim=dim, keepdim=True)
    mx = s.amax(dim=dim, keepdim=True)
    rng = mx - mn
    return torch.where(rng > eps, (s - mn) / rng.clamp_min(eps), torch.ones_like(s))


def max_normalize(scores: torch.Tensor, dim: int = -1, eps: float = 1e-12,
                  mx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Divide by the max along ``dim``, or by ``mx`` where given (a global
    max); constant-zero input stays as it is."""
    s = scores.float()
    if mx is None:
        mx = s.amax(dim=dim, keepdim=True)
    return torch.where(mx > eps, s / mx.clamp_min(eps), s)


def weighted_fusion(semantic: torch.Tensor, lexical: torch.Tensor,
                    semantic_weight: float = 0.7, lexical_weight: float = 0.3,
                    normalize: str = "minmax") -> torch.Tensor:
    """hybrid = norm(sem)*w_s + norm(lex)*w_l; normalize is "minmax",
    "max" or "none"."""
    if normalize == "minmax":
        semantic, lexical = minmax_normalize(semantic), minmax_normalize(lexical)
    elif normalize == "max":
        semantic, lexical = max_normalize(semantic), max_normalize(lexical)
    return semantic * semantic_weight + lexical * lexical_weight


def rrf_fusion(scores_a: torch.Tensor, scores_b: torch.Tensor,
               c: float = 60.0) -> torch.Tensor:
    """Reciprocal-rank fusion over two score arrays (row-wise ranks)."""

    def ranks(s):
        order = torch.argsort(-s, dim=-1, stable=True)
        return torch.argsort(order, dim=-1)

    ra, rb = ranks(scores_a.float()), ranks(scores_b.float())
    return 1.0 / (c + ra.float() + 1.0) + 1.0 / (c + rb.float() + 1.0)


def validate_weights(semantic_weight: float, lexical_weight: float) -> None:
    """Weights must sum to 1.0 or ValueError."""
    if abs(semantic_weight + lexical_weight - 1.0) > 1e-6:
        raise ValueError(
            f"semantic_weight + lexical_weight must equal 1.0, got "
            f"{semantic_weight} + {lexical_weight}"
        )
