"""K2 and K3: the supertile hybrid's resident scoring kernels.

Counterpart of ``hybridsearch_tpu/ops/pallas_supertile.py``:

  * ``super_scores`` (``csrc/super_scores.cu``) replaces
    ``pallas_super_scores``: [B, S*sd] raw dots of each query with every
    doc row of its S probed supertiles, chunk indices past the end clamped
    to the last chunk. The caller applies bias and validity.
  * ``place_windows`` (``csrc/place_windows.cu``) replaces
    ``pallas_place_windows``: [BS, super_tiles, 128] resident lexical
    buffers, ``out[bs, l // 128, l % 128] += w`` for 0 <= l < super_tiles*128.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version only for CPU tensors. ``pallas_super_scores_dedup`` (K4) and
``pallas_place_fused`` (K5) are off by default in the JAX package and are
still to port.
"""

from __future__ import annotations

import torch

from hybridsearch_tpu_torch.ops import cuda_build

TILE = 128
# rows a super_scores block scores and (query, probe) pairs it groups
SCORE_ROWS, SCORE_PAIRS = 256, 32
# entries the placement kernel adds between two barriers (one per thread);
# callers lay out each term slot in whole chunks, so a chunk adds at most
# one weight to a cell and every cell's sum runs in slot order
PLACE_CHUNK = 1024
_PLAIN_BUDGET = 1 << 29  # bytes of gathered rows per plain-version step


def _chunk_rows(sup_s: torch.Tensor, n_rows: int, sd: int, ch: int) -> torch.Tensor:
    """[B, S*sd] doc rows read for each output slot, with the kernel's
    clamp of chunk indices past the end to the last chunk."""
    B, S = sup_s.shape
    nch = sd // ch
    last = n_rows // ch - 1
    dev = sup_s.device
    idx = (sup_s.long()[:, :, None] * nch
           + torch.arange(nch, device=dev)).clamp(0, last)  # [B, S, nch]
    rows = idx[..., None] * ch + torch.arange(ch, device=dev)
    return rows.reshape(B, S * sd)


def super_scores_plain(q: torch.Tensor, docs: torch.Tensor, sup_s: torch.Tensor,
                       sd: int, ch: int = 1024) -> torch.Tensor:
    """Plain PyTorch version: gather the probed rows, float32 batched dot."""
    B, D = q.shape
    rows = _chunk_rows(sup_s, docs.shape[0], sd, ch)
    R = rows.shape[1]
    step = max(1, _PLAIN_BUDGET // max(1, R * D * 4))
    out = torch.empty((B, R), dtype=torch.float32, device=docs.device)
    qf = q.float()
    for b0 in range(0, B, step):
        g = docs[rows[b0:b0 + step]].float()  # [b, R, D]
        out[b0:b0 + step] = torch.bmm(g, qf[b0:b0 + step, :, None])[..., 0]
    return out


def super_scores(q: torch.Tensor, docs: torch.Tensor, sup_s: torch.Tensor,
                 sd: int, ch: int = 1024) -> torch.Tensor:
    """[B, S*sd] float32 raw scores. ``q`` [B, D] in the docs' dtype,
    ``docs`` [N, D] float32 or bf16 (N % ch == 0, D % 128 == 0),
    ``sup_s`` [B, S] integer supertile ids, ``sd`` % ``ch`` == 0, and on
    the card ``ch`` % 256 == 0. The kernel scores each probed supertile's
    rows once per group of up to 32 (query, probe) pairs that share it."""
    if docs.device.type == "cpu":
        return super_scores_plain(q, docs, sup_s, sd, ch)
    if not docs.is_cuda:
        raise ValueError(f"super_scores: unsupported device {docs.device}")
    if docs.dtype not in (torch.float32, torch.bfloat16) or q.dtype != docs.dtype:
        raise ValueError(f"super_scores: dtypes q {q.dtype} docs {docs.dtype}")
    N, D = docs.shape
    B, S = sup_s.shape
    if q.shape != (B, D):
        raise ValueError(f"super_scores: q {tuple(q.shape)} vs sup_s "
                         f"{tuple(sup_s.shape)} and D={D}")
    if N % ch or sd % ch or ch % SCORE_ROWS or D % 128:
        raise ValueError(f"super_scores: N={N}, sd={sd}, ch={ch}, D={D} need "
                         f"N % ch == sd % ch == ch % {SCORE_ROWS} == D % 128 == 0")
    n_super = -(-N // sd)
    if B * S >= 2**31 or n_super + 2 > 6144:
        raise ValueError(f"super_scores: B*S={B * S} pairs over {n_super} "
                         "supertiles is past the kernel's limits")
    if not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError("super_scores: docs must be contiguous and aligned")
    if q.device != docs.device or sup_s.device != docs.device:
        raise ValueError("super_scores: all tensors must be on one device")
    qf = q.float().contiguous()
    sup = sup_s.to(torch.int32).contiguous()
    out = torch.empty((B, S * sd), dtype=torch.float32, device=docs.device)
    if B * S == 0:
        return out
    # the pre-pass's pair order and group table (csrc/super_scores.cu)
    g_max = -(-B * S // SCORE_PAIRS) + n_super + 2
    work = torch.empty(B * S + 3 * g_max, dtype=torch.int32, device=docs.device)
    lib = cuda_build.library()
    rc = lib.hst_super_scores(
        docs.data_ptr(), int(docs.dtype == torch.bfloat16), qf.data_ptr(),
        sup.data_ptr(), N, D, B, S, sd, ch, work.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(docs.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_super_scores")
    super_scores.launches += 1
    return out


super_scores.launches = 0


def place_windows_plain(l_flat: torch.Tensor, w_flat: torch.Tensor,
                        super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version: scatter-adds chunk by chunk (the kernel's
    order), out-of-range entries into a dropped column."""
    BS, TE = l_flat.shape
    R = super_tiles * tile
    ok = (l_flat >= 0) & (l_flat < R)
    idx = torch.where(ok, l_flat, R).long()
    w = torch.where(ok, w_flat.float(), 0.0)
    out = torch.zeros((BS, R + 1), dtype=torch.float32, device=l_flat.device)
    for c0 in range(0, TE, PLACE_CHUNK):
        out.scatter_add_(1, idx[:, c0:c0 + PLACE_CHUNK], w[:, c0:c0 + PLACE_CHUNK])
    return out[:, :R].reshape(BS, super_tiles, tile)


def place_windows(l_flat: torch.Tensor, w_flat: torch.Tensor,
                  super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """[BS, super_tiles, tile] float32 resident buffers from ``l_flat``
    [BS, TE] int32 local doc ids and ``w_flat`` [BS, TE] float32 weights."""
    if l_flat.device.type == "cpu":
        return place_windows_plain(l_flat, w_flat, super_tiles, tile)
    if not l_flat.is_cuda:
        raise ValueError(f"place_windows: unsupported device {l_flat.device}")
    if l_flat.shape != w_flat.shape or l_flat.dim() != 2:
        raise ValueError(f"place_windows: shapes {tuple(l_flat.shape)} "
                         f"{tuple(w_flat.shape)}")
    if l_flat.dtype != torch.int32 or w_flat.dtype != torch.float32:
        raise ValueError("place_windows: l must be int32 and w float32")
    if w_flat.device != l_flat.device:
        raise ValueError("place_windows: both tensors must be on one device")
    R = super_tiles * tile
    if R * 4 > 232448:
        raise ValueError(f"place_windows: a {R}-float buffer exceeds shared memory")
    BS, TE = l_flat.shape
    l_c, w_c = l_flat.contiguous(), w_flat.contiguous()
    out = torch.empty((BS, R), dtype=torch.float32, device=l_flat.device)
    if BS == 0:
        return out.reshape(BS, super_tiles, tile)
    lib = cuda_build.library()
    rc = lib.hst_place_windows(
        l_c.data_ptr(), w_c.data_ptr(), BS, TE, R, out.data_ptr(),
        torch.cuda.current_stream(l_flat.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_place_windows")
    place_windows.launches += 1
    return out.reshape(BS, super_tiles, tile)


place_windows.launches = 0
