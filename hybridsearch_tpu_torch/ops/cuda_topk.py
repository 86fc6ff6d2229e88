"""K1: the fused matmul + per-tile max/min sweep of the dense retrieval path.

Counterpart of ``hybridsearch_tpu/ops/pallas_topk.py``: the CUDA kernel
``csrc/tile_stats.cu`` replaces ``pallas_tile_stats_t``. For every 128-row
doc tile it writes the tile's maximum of ``docs @ q.T + bias`` and,
optionally, the minimum of the raw scores over alive rows (bias >= 0);
rows at or past ``n_valid`` are masked to -inf / +inf. The [N, B] score
matrix never reaches device memory.

The port's layout is [n_tiles, B] (the TPU kernel's [nb, tpb, B] with the
block axes merged). ``tile_stats`` launches the kernel for CUDA tensors and
runs ``tile_stats_plain`` only for CPU tensors; the plain version is also
what ``chip_smoke.py`` holds the kernel against on the card.
``tile_stats_v1`` launches the kernel's first design, which the redesign
must equal bit for bit; it takes CUDA tensors only and no served path
calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hybridsearch_tpu_torch.ops import cuda_build

TILE = 128
QUERY_BLOCKS = (32, 64, 128, 256)  # the kernel's query-block widths
_PLAIN_BLOCK = 131072  # doc rows per plain-version matmul


def tile_stats_plain(
    q: torch.Tensor,
    docs: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
    with_min: bool = False,
    tile: int = TILE,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: blockwise float32 matmul and reductions.
    ``q`` [B, D] is in the docs' dtype (bf16 products are exact in float32,
    so both are widened and accumulated in float32)."""
    N, _ = docs.shape
    B = q.shape[0]
    n_valid = N if n_valid is None else n_valid
    assert N % tile == 0
    qf = q.float()
    maxes, mins = [], []
    for r0 in range(0, N, _PLAIN_BLOCK):
        blk = docs[r0:r0 + _PLAIN_BLOCK].float()
        s = blk @ qf.T  # [rows, B]
        rows = torch.arange(r0, r0 + blk.shape[0], device=docs.device)
        valid = (rows < n_valid)[:, None]
        if bias is not None:
            b = bias[r0:r0 + blk.shape[0]].float()[:, None]
            s_max = torch.where(valid, s + b, float("-inf"))
            alive = valid & (b >= 0.0)
        else:
            s_max = torch.where(valid, s, float("-inf"))
            alive = valid
        maxes.append(s_max.reshape(-1, tile, B).amax(dim=1))
        if with_min:
            s_min = torch.where(alive, s, float("inf"))
            mins.append(s_min.reshape(-1, tile, B).amin(dim=1))
    out_max = torch.cat(maxes) if maxes else docs.new_zeros((0, B), dtype=torch.float32)
    if not with_min:
        return (out_max,)
    return out_max, torch.cat(mins)


def query_block(B: int) -> int:
    """The kernel's query-block width for a batch of B queries: the
    smallest of ``QUERY_BLOCKS`` that holds B, else the widest (a tile's
    query blocks then run side by side)."""
    return next((w for w in QUERY_BLOCKS if B <= w), QUERY_BLOCKS[-1])


def _checked(name: str, q, docs, bias, n_valid):
    """The launchers' argument checks; returns (float32 q, bias, n_valid)."""
    N = docs.shape[0]
    n_valid = N if n_valid is None else int(n_valid)
    if not docs.is_cuda:
        raise ValueError(f"{name}: unsupported device {docs.device}")
    if docs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: docs dtype {docs.dtype} not supported")
    if q.dtype != docs.dtype:
        raise ValueError(f"{name}: q must be in the docs' dtype")
    if docs.dim() != 2 or q.dim() != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} docs "
                         f"{tuple(docs.shape)}")
    D = docs.shape[1]
    if N % TILE or D % 128:
        raise ValueError(f"{name}: N={N} and D={D} must be multiples of 128")
    if not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError(f"{name}: docs must be contiguous and 16-byte aligned")
    if q.device != docs.device or (bias is not None and bias.device != docs.device):
        raise ValueError(f"{name}: all tensors must be on one device")
    qf = q.float().contiguous()  # exact for bf16 queries
    if bias is not None:
        if bias.shape != (N,) or bias.dtype != torch.float32:
            raise ValueError(f"{name}: bias must be float32 [N]")
        bias = bias.contiguous()
    return qf, bias, n_valid


def _launch(fn, extra, docs, q_arg, B, bias, n_valid, with_min):
    """Allocate the outputs and call launcher ``fn`` with the queries
    ``q_arg`` (``extra``: its arguments between out_min and the stream)."""
    N, D = docs.shape
    out_max = torch.empty((N // TILE, B), dtype=torch.float32, device=docs.device)
    out_min = torch.empty_like(out_max) if with_min else None
    rc = fn(docs.data_ptr(), int(docs.dtype == torch.bfloat16), q_arg.data_ptr(),
            bias.data_ptr() if bias is not None else None, N, D, B, n_valid,
            out_max.data_ptr(), out_min.data_ptr() if with_min else None, *extra,
            torch.cuda.current_stream(docs.device).cuda_stream)
    cuda_build.check(rc, fn.__name__)
    return (out_max, out_min) if with_min else (out_max,)


def tile_stats(
    q: torch.Tensor,
    docs: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
    with_min: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """([n_tiles, B] tile maxima,) or (maxima, alive-tile minima) of
    ``docs @ q.T``. ``docs`` [N, D] float32 or bf16 with N % 128 == 0 and
    D % 128 == 0; ``q`` [B, D] in the docs' dtype; ``bias`` [N] float32 or
    None. CUDA tensors launch ``csrc/tile_stats.cu``'s ``hst_tile_stats``
    at query blocks of ``query_block(B)``; CPU tensors take
    ``tile_stats_plain``."""
    if docs.device.type == "cpu":
        return tile_stats_plain(q, docs, bias, n_valid, with_min)
    qf, bias, n_valid = _checked("tile_stats", q, docs, bias, n_valid)
    B = qf.shape[0]
    bq = query_block(B)
    # the kernel streams the queries depth-major, zero past B
    qt = torch.zeros((docs.shape[1], -(-B // bq) * bq), dtype=torch.float32,
                     device=docs.device)
    qt[:, :B] = qf.T
    out = _launch(cuda_build.library().hst_tile_stats, (bq,), docs, qt, B, bias,
                  n_valid, with_min)
    tile_stats.launches += 1
    return out


tile_stats.launches = 0


def tile_stats_v1(
    q: torch.Tensor,
    docs: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
    with_min: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``tile_stats`` by the kernel's first design (``hst_tile_stats_v1``),
    the yardstick the redesign is held to bit for bit and timed against.
    No served path calls it; CUDA tensors only."""
    qf, bias, n_valid = _checked("tile_stats_v1", q, docs, bias, n_valid)
    out = _launch(cuda_build.library().hst_tile_stats_v1, (), docs, qf, qf.shape[0],
                  bias, n_valid, with_min)
    tile_stats_v1.launches += 1
    return out


tile_stats_v1.launches = 0
