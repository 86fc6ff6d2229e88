"""Random-hyperplane LSH as tensor ops.

Counterpart of ``hybridsearch_tpu/ops/lsh.py``: the projection of a batch
onto every table's hyperplanes is one [B, D] x [D, tables*bits] product,
followed by sign-bit packing into one integer signature per table. The
planes are drawn from an explicit ``torch.Generator``; the JAX package's
``jax.random`` draw cannot be repeated in torch, so ``convert.lsh_planes``
carries its planes across where both packages must hash alike.
"""

from __future__ import annotations

import torch


def lsh_planes(generator: torch.Generator, n_tables: int, n_bits: int,
               dim: int) -> torch.Tensor:
    """The [n_tables * n_bits, dim] float32 hyperplane matrix, drawn once
    from ``generator`` on the generator's device."""
    return torch.randn((n_tables * n_bits, dim), generator=generator,
                       dtype=torch.float32, device=generator.device)


def lsh_signatures(planes: torch.Tensor, vectors: torch.Tensor, n_tables: int,
                   n_bits: int) -> torch.Tensor:
    """Hash [B, D] vectors into [B, n_tables] int32 signatures: bit j of
    table t is ``planes[t * n_bits + j] . v >= 0``."""
    proj = vectors.float() @ planes.T  # [B, T*K]
    bits = (proj >= 0).to(torch.int32).reshape(vectors.shape[0], n_tables, n_bits)
    weights = 2 ** torch.arange(n_bits, dtype=torch.int32, device=planes.device)
    return (bits * weights).sum(dim=-1, dtype=torch.int32)
