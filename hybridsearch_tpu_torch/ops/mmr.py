"""Maximal Marginal Relevance selection as tensor ops.

Counterpart of ``hybridsearch_tpu/ops/mmr.py``: the candidate-candidate
similarity is one float32 product of L2-normalized rows ([C, C], or
[B, C, C] batched), then k rounds of a masked argmax:

    mmr_i = lambda * relevance_i - (1 - lambda) * max_{j in selected} sim(i, j)

The rounds are a Python loop over tensors with no host sync inside, so a
batch on the card is one product and k small launches a round. No Pallas
kernel backs the JAX function: it stays plain PyTorch here.
``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does, so ties
pick the lower candidate in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from hybridsearch_tpu_torch.ops.dense import l2_normalize

NEG = -1e30


def mmr_select(
    relevance: torch.Tensor,
    embeddings: torch.Tensor,
    k: int,
    lam: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select k diverse items from C candidates.

    Args:
      relevance: [C] relevance scores (higher = better).
      embeddings: [C, D] candidate embeddings.
      k: number of items to select (k <= C).
      lam: trade-off lambda (the reference's default 0.5).
    Returns:
      (order [k] int32 selected indices in selection order,
       mmr_scores [k] float32 the MMR score at selection time).
    """
    rel = torch.as_tensor(relevance)[None]
    emb = torch.as_tensor(embeddings)[None]
    blocked = torch.zeros(rel.shape, dtype=torch.bool, device=rel.device)
    order, scores = _mmr_core(rel, emb, k, _lam_rows(lam, 1, rel.device), blocked)
    return order[0], scores[0]


def _lam_rows(lam: Union[float, torch.Tensor], batch: int,
              device: torch.device) -> torch.Tensor:
    """lam as a float32 [B, 1] column (a scalar broadcast to every row)."""
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=device)
    return torch.broadcast_to(lam_t, (batch,))[:, None]


def _mmr_core(rel: torch.Tensor, emb: torch.Tensor, k: int, lam: torch.Tensor,
              blocked: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k masked-argmax rounds over [B, C] rows; ``blocked`` [B, C] marks
    entries that must never be picked (padding rows in the batched path)."""
    rel = rel.float()
    emb = l2_normalize(emb.float())
    sim = torch.matmul(emb, emb.transpose(1, 2))  # [B, C, C]
    B, C = rel.shape
    dev = rel.device
    selected = blocked.clone()
    max_sim = torch.zeros((B, C), dtype=torch.float32, device=dev)
    order = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros((B, k), dtype=torch.float32, device=dev)
    rows = torch.arange(B, device=dev)
    for i in range(k):
        # the first pick is pure relevance: max_sim starts at 0
        mmr = lam * rel - (1.0 - lam) * max_sim
        mmr = torch.where(selected, NEG, mmr)
        pick = torch.argmax(mmr, dim=1)  # [B], the first maximum
        order[:, i] = pick.to(torch.int32)
        scores[:, i] = mmr[rows, pick]
        selected[rows, pick] = True
        max_sim = torch.maximum(max_sim, sim[rows, :, pick])
    return order, scores


def mmr_select_batch(
    relevance: torch.Tensor,
    embeddings: torch.Tensor,
    k: int,
    lam: Union[float, torch.Tensor] = 0.5,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched MMR: one [B, C, C] product and one set of k rounds for B
    queries.

    Args:
      relevance: [B, C] relevance scores.
      embeddings: [B, C, D] candidate embeddings.
      k: selections per query (k <= valid count per row).
      lam: trade-off lambda, scalar or [B].
      valid: [B, C] bool; False marks row padding (rows shorter than C).
        Padded entries can never be selected, whatever lam is.
    Returns:
      (order [B, k] int32, mmr_scores [B, k] float32) per query.
    """
    rel = torch.as_tensor(relevance)
    emb = torch.as_tensor(embeddings)
    B = rel.shape[0]
    blocked = (torch.zeros(rel.shape, dtype=torch.bool, device=rel.device)
               if valid is None else ~torch.as_tensor(valid, device=rel.device))
    return _mmr_core(rel, emb, k, _lam_rows(lam, B, rel.device), blocked)
