"""Shared result type of the at-scale hybrids (counterpart of the
``NEG_INF`` and ``HybridTopK`` of ``hybridsearch_tpu/ops/hybrid.py``; the
impact and tile hybrids of that module are still to port)."""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = float("-inf")


class HybridTopK(NamedTuple):
    values: torch.Tensor  # [B, k] fused scores (desc)
    indices: torch.Tensor  # [B, k] doc ids, -1 for empty slots
    exact: torch.Tensor  # [B] bool — True when the certificate holds
