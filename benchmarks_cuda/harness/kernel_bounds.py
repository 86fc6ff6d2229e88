"""The least time the card could take for one kernel call, from its shapes.

A call's operations and bytes are what its inputs need: each input byte
read once, each output byte written once, the products a score needs.
The least time is the larger of operations over the peak rate and bytes
over the peak bandwidth (NVIDIA's H100 SXM data sheet: 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s HBM3, at the full 700 W power limit).
A kernel's roofline share is the sum of its calls' least times over the
device time they took. Each function takes the arguments the program's
wrapper was called with (``ops/dense.py`` ``tile_stats`` and
``tile_scores``, ``ops/supertile.py`` ``super_scores``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def tile_stats(args, kwargs) -> Tuple[float, float]:
    """K1: [n_tiles, B] tile maxima (and alive minima) of docs @ q.T."""
    q, docs = args[0], args[1]
    bias = args[2] if len(args) > 2 else kwargs.get("bias")
    with_min = kwargs.get("with_min", args[4] if len(args) > 4 else False)
    B, D = q.shape
    N = docs.shape[0]
    nbytes = (N * D * docs.element_size() + B * D * q.element_size()
              + (N * 4 if bias is not None else 0)
              + (2 if with_min else 1) * (N // 128) * B * 4)
    return 2.0 * N * D * B, nbytes


def _chunk_rows(sup: torch.Tensor, n_rows: int, sd: int, ch: int) -> torch.Tensor:
    """[B, S*sd] doc rows each output slot reads: ``sd`` rows a probed
    supertile, in ``ch``-row chunks, chunks past the end clamped to the
    last one."""
    B, S = sup.shape
    nch = sd // ch
    idx = (sup.long()[:, :, None] * nch
           + torch.arange(nch, device=sup.device)).clamp(0, n_rows // ch - 1)
    return (idx[..., None] * ch + torch.arange(ch, device=sup.device)).reshape(B, S * sd)


def super_scores(args, kwargs) -> Tuple[float, float]:
    """K2: exact scores of every row of each query's probed supertiles."""
    q, docs, sup, sd = args[0], args[1], args[2], args[3]
    ch = kwargs.get("ch", args[4] if len(args) > 4 else 1024)
    B, D = q.shape
    S = sup.shape[1]
    unique_rows = int(torch.unique(_chunk_rows(sup, docs.shape[0], sd, ch)).numel())
    nbytes = (unique_rows * D * docs.element_size() + B * D * q.element_size()
              + sup.numel() * 4 + B * S * sd * 4)
    return 2.0 * B * S * sd * D, nbytes


def tile_scores(args, kwargs) -> Tuple[float, float]:
    """K4 at tile grain: exact scores of every row of each query's tiles."""
    q, docs, tiles = args[0], args[1], args[2]
    tile = args[3] if len(args) > 3 else kwargs.get("tile", 128)
    B, D = q.shape
    KT = tiles.shape[1]
    n_read = int(torch.unique(tiles).numel())
    nbytes = (n_read * tile * D * docs.element_size() + q.numel() * q.element_size()
              + tiles.numel() * tiles.element_size() + B * KT * tile * 4)
    return 2.0 * B * KT * tile * D, nbytes


def roofline_pct(calls, device_s: float, bound: Callable):
    """100 x the calls' least seconds over the device seconds they took, or
    None when nothing was called or no device time was attributed."""
    if not calls or device_s <= 0.0:
        return None
    least = sum(least_seconds(*bound(a, kw)) for a, kw in calls)
    return 100.0 * least / device_s
