"""Spherical k-means for the clustered corpus layout.

Counterpart of ``kmeans_fit`` and ``kmeans_assign`` in
``hybridsearch_tpu/index/ivf.py`` (the IVF index itself is still to port).
Blocked over doc rows so peak memory is O(block * C), with per-block
normalization in float32.

Random draws come from a ``torch.Generator`` seeded with ``seed``; they
cannot repeat ``jax.random``'s bits, so ``init_idx`` (the initial centroid
rows) and ``reseed_idx`` ([iters, C] rows that re-seed empty clusters) may
be passed in to reproduce a JAX fit exactly.

The fit repeats bit for bit on the card: each block's cluster sums are
taken in row order (``_cluster_sums``), never with float atomics, whose
order changes from run to run.
"""

from __future__ import annotations

from typing import Optional

import torch

from hybridsearch_tpu_torch.ops.dense import l2_normalize


def _cluster_sums(vb: torch.Tensor, assign: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
    """[C, D] sum of the rows of ``vb`` assigned to each cluster, each
    cluster's rows added in row order: a stable sort by cluster makes every
    cluster one contiguous segment, and ``segment_reduce`` walks each
    segment in order (one output element per thread on CUDA, no atomics),
    so the sums repeat bit for bit. A one-hot product would cost C times
    the work."""
    order = torch.sort(assign, stable=True).indices
    return torch.segment_reduce(vb[order], "sum", lengths=counts, axis=0,
                                unsafe=True)


def kmeans_fit(
    vectors: torch.Tensor,
    n_clusters: int,
    seed: int = 0,
    iters: int = 10,
    block: int = 16384,
    init_idx: Optional[torch.Tensor] = None,
    reseed_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[n_clusters, D] unit centroids: init from data rows, Lloyd
    iterations with argmax-cosine assignment, empty clusters re-seeded
    from data rows."""
    n, _ = vectors.shape
    dev = vectors.device
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    if init_idx is None:
        init_idx = torch.randperm(n, generator=g)[:n_clusters]
    c = l2_normalize(vectors[torch.as_tensor(init_idx, device=dev).long()].float())
    for it in range(iters):
        sums = torch.zeros((n_clusters, vectors.shape[1]), dtype=torch.float32,
                           device=dev)
        counts = torch.zeros(n_clusters, dtype=torch.float32, device=dev)
        for r0 in range(0, n, block):
            vb = l2_normalize(vectors[r0:r0 + block].float())
            assign = torch.argmax(vb @ c.T, dim=1)
            block_counts = torch.bincount(assign, minlength=n_clusters)
            sums += _cluster_sums(vb, assign, block_counts)
            counts += block_counts.float()
        if reseed_idx is not None:
            rnd_idx = torch.as_tensor(reseed_idx[it], device=dev).long()
        else:
            rnd_idx = torch.randint(0, n, (n_clusters,), generator=g).to(dev)
        rnd = l2_normalize(vectors[rnd_idx].float())
        new_c = torch.where(counts[:, None] > 0,
                            sums / counts[:, None].clamp_min(1.0), rnd)
        c = new_c / new_c.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return c


def kmeans_assign(vectors: torch.Tensor, centroids: torch.Tensor,
                  block: int = 16384) -> torch.Tensor:
    """[n] int64 argmax-cosine cluster assignment, blocked like kmeans_fit."""
    out = []
    for r0 in range(0, vectors.shape[0], block):
        vb = l2_normalize(vectors[r0:r0 + block].float())
        out.append(torch.argmax(vb @ centroids.T, dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.long, device=vectors.device)
    return torch.cat(out)
