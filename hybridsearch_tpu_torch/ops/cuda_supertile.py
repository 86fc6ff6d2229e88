"""K2-K5: the supertile hybrid's resident scoring kernels.

Counterpart of ``hybridsearch_tpu/ops/pallas_supertile.py``:

  * ``super_scores`` (K2, ``csrc/super_scores.cu``) replaces
    ``pallas_super_scores``: [B, S*sd] raw dots of each query with every
    doc row of its S probed supertiles, chunk indices past the end clamped
    to the last chunk. The caller applies bias and validity.
  * ``super_scores_dedup`` (K4, the same source) replaces
    ``pallas_super_scores_dedup``: [P, sd] raw dots of pre-gathered
    per-pair query rows with the rows of supertile ``tid[p]``, for pairs
    the caller sorted by supertile (``ops/supertile.py dedup_pairs``);
    the same bits as K2 for each pair.
  * ``place_windows`` (K3, ``csrc/place_windows.cu``) replaces
    ``pallas_place_windows``: [BS, super_tiles, 128] resident lexical
    buffers, ``out[bs, l // 128, l % 128] += w`` for 0 <= l < super_tiles*128.
    ``place_windows_v1`` launches the kernel's first design, which the
    redesign must equal bit for bit (CUDA tensors only; no served path
    calls it).
  * ``place_fused`` (K5, ``csrc/place_fused.cu``) replaces
    ``pallas_place_fused``: the same buffers read straight from the CSR
    windows [lo, hi) of each term slot, with no staged window arrays; the
    same bits as ``window_entries`` + K3.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version only for CPU tensors. K4 and K5 serve the ladder when
``EngineConfig.perf.scores_dedup`` / ``perf.place_fused`` are set.
"""

from __future__ import annotations

import ctypes

import torch

from hybridsearch_tpu_torch.ops import cuda_build

TILE = 128
ROW = 128  # CSR row width (SuperPostings.ids_rows) of the windows' whole-row reads
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


def super_scores_dedup_plain(qp: torch.Tensor, docs: torch.Tensor,
                             tid: torch.Tensor, sd: int,
                             ch: int = 1024) -> torch.Tensor:
    """Plain PyTorch version: each pair's rows gathered, float32 batched
    dot (``super_scores_plain`` with one probe a pair)."""
    return super_scores_plain(qp, docs, tid.reshape(-1, 1), sd, ch)


def super_scores_dedup(qp: torch.Tensor, docs: torch.Tensor, tid: torch.Tensor,
                       sd: int, ch: int = 1024) -> torch.Tensor:
    """[P, sd] float32 raw scores. ``qp`` [P, D] the query row of each pair
    in the docs' dtype, ``docs`` as for ``super_scores``, ``tid`` [P]
    integer supertile ids sorted ascending (any order gives the same
    values; sorted, each run of equal ids reads its rows once per 32
    pairs)."""
    if docs.device.type == "cpu":
        return super_scores_dedup_plain(qp, docs, tid, sd, ch)
    if not docs.is_cuda:
        raise ValueError(f"super_scores_dedup: unsupported device {docs.device}")
    if docs.dtype not in (torch.float32, torch.bfloat16) or qp.dtype != docs.dtype:
        raise ValueError(f"super_scores_dedup: dtypes qp {qp.dtype} docs {docs.dtype}")
    N, D = docs.shape
    P = tid.shape[0]
    if tid.dim() != 1 or qp.shape != (P, D):
        raise ValueError(f"super_scores_dedup: qp {tuple(qp.shape)} vs tid "
                         f"{tuple(tid.shape)} and D={D}")
    if N % ch or sd % ch or ch % SCORE_ROWS or D % 128:
        raise ValueError(f"super_scores_dedup: N={N}, sd={sd}, ch={ch}, D={D} "
                         f"need N % ch == sd % ch == ch % {SCORE_ROWS} == "
                         "D % 128 == 0")
    if P >= 2**31 or (-(-P // SCORE_PAIRS)) >= 2**31:
        raise ValueError(f"super_scores_dedup: {P} pairs is past the kernel's limits")
    if not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError("super_scores_dedup: docs must be contiguous and aligned")
    if qp.device != docs.device or tid.device != docs.device:
        raise ValueError("super_scores_dedup: all tensors must be on one device")
    qf = qp.float().contiguous()
    t32 = tid.to(torch.int32).contiguous()
    out = torch.empty((P, sd), dtype=torch.float32, device=docs.device)
    if P == 0:
        return out
    lib = cuda_build.library()
    rc = lib.hst_super_scores_dedup(
        docs.data_ptr(), int(docs.dtype == torch.bfloat16), qf.data_ptr(),
        t32.data_ptr(), N, D, P, sd, ch, out.data_ptr(),
        torch.cuda.current_stream(docs.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_super_scores_dedup")
    super_scores_dedup.launches += 1
    return out


super_scores_dedup.launches = 0


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


def _place_checked(name: str, l_flat: torch.Tensor, w_flat: torch.Tensor,
                   super_tiles: int, tile: int) -> int:
    """The placement launchers' argument checks; returns the buffer length."""
    if not l_flat.is_cuda:
        raise ValueError(f"{name}: unsupported device {l_flat.device}")
    if l_flat.shape != w_flat.shape or l_flat.dim() != 2:
        raise ValueError(f"{name}: shapes {tuple(l_flat.shape)} "
                         f"{tuple(w_flat.shape)}")
    if l_flat.dtype != torch.int32 or w_flat.dtype != torch.float32:
        raise ValueError(f"{name}: l must be int32 and w float32")
    if w_flat.device != l_flat.device:
        raise ValueError(f"{name}: both tensors must be on one device")
    R = super_tiles * tile
    if R * 4 > 232448:
        raise ValueError(f"{name}: a {R}-float buffer exceeds shared memory")
    return R


def _place_launch(fn, l_flat, w_flat, R: int) -> torch.Tensor:
    BS, TE = l_flat.shape
    l_c, w_c = l_flat.contiguous(), w_flat.contiguous()
    out = torch.empty((BS, R), dtype=torch.float32, device=l_flat.device)
    if BS:
        rc = fn(l_c.data_ptr(), w_c.data_ptr(), BS, TE, R, out.data_ptr(),
                torch.cuda.current_stream(l_flat.device).cuda_stream)
        cuda_build.check(rc, fn.__name__)
    return out


def place_windows(l_flat: torch.Tensor, w_flat: torch.Tensor,
                  super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """[BS, super_tiles, tile] float32 resident buffers from ``l_flat``
    [BS, TE] int32 local doc ids and ``w_flat`` [BS, TE] float32 weights."""
    if l_flat.device.type == "cpu":
        return place_windows_plain(l_flat, w_flat, super_tiles, tile)
    R = _place_checked("place_windows", l_flat, w_flat, super_tiles, tile)
    out = _place_launch(cuda_build.library().hst_place_windows, l_flat, w_flat, R)
    if l_flat.shape[0]:
        place_windows.launches += 1
    return out.reshape(l_flat.shape[0], super_tiles, tile)


place_windows.launches = 0


def place_windows_v1(l_flat: torch.Tensor, w_flat: torch.Tensor,
                     super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """``place_windows`` by the kernel's first design
    (``hst_place_windows_v1``), the yardstick the redesign is held to bit
    for bit and timed against. No served path calls it; CUDA tensors
    only."""
    R = _place_checked("place_windows_v1", l_flat, w_flat, super_tiles, tile)
    out = _place_launch(cuda_build.library().hst_place_windows_v1, l_flat, w_flat, R)
    if l_flat.shape[0]:
        place_windows_v1.launches += 1
    return out.reshape(l_flat.shape[0], super_tiles, tile)


place_windows_v1.launches = 0


def _slot_rows(wcaps) -> list:
    """Whole CSR rows a slot's window may span at cap ``wc``: a window of
    at most wc entries from position lo lies in rows lo // ROW ..
    lo // ROW + wc // ROW."""
    return [int(wc) // ROW + 1 for wc in wcaps]


def window_entries(lo: torch.Tensor, hi: torch.Tensor, base: torch.Tensor,
                   ids_rows: torch.Tensor, ws_rows: torch.Tensor, wcaps,
                   ech: int = PLACE_CHUNK):
    """The two-step path's staged windows: (l [BS, TEp] int32 local doc ids,
    w [BS, TEp] float32 weights) from CSR windows ``lo``/``hi`` [BS, T]
    (absolute positions) of supertiles starting at doc ``base`` [BS]. Slot
    j reads ``wc // ROW + 1`` whole CSR rows from row ``lo // ROW`` (cap
    ``wcaps[j]``); entries outside [lo, hi) weigh 0. Each slot's part is
    padded to whole ``ech`` chunks (l = -1), so no placement chunk mixes
    two slots."""
    BS = lo.shape[0]
    dev = lo.device
    M = ids_rows.shape[0]
    base = base.long()
    parts_l, parts_w = [], []
    for j, m_j in enumerate(_slot_rows(wcaps)):
        lo_j, hi_j = lo[:, j].long(), hi[:, j].long()  # [BS]
        E_j = m_j * ROW
        row0 = lo_j // ROW
        rows_idx = (row0[:, None] + torch.arange(m_j, device=dev)).clamp(max=M - 1)
        wi = ids_rows[rows_idx].reshape(BS, E_j)
        ww = ws_rows[rows_idx].reshape(BS, E_j)
        gpos = row0[:, None] * ROW + torch.arange(E_j, device=dev)
        valid = (gpos >= lo_j[:, None]) & (gpos < hi_j[:, None])
        w_j = torch.where(valid, ww, 0.0)
        l_j = (wi.long() - base[:, None]).to(torch.int32)
        pad_e = -(-E_j // ech) * ech - E_j
        if pad_e:
            l_j = torch.nn.functional.pad(l_j, (0, pad_e), value=-1)
            w_j = torch.nn.functional.pad(w_j, (0, pad_e))
        parts_l.append(l_j)
        parts_w.append(w_j)
    return torch.cat(parts_l, dim=1), torch.cat(parts_w, dim=1)


def place_fused_plain(lo: torch.Tensor, hi: torch.Tensor, base: torch.Tensor,
                      ids_rows: torch.Tensor, ws_rows: torch.Tensor, wcaps,
                      super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version: the staged windows (``window_entries``), then
    ``place_windows_plain``'s chunk-ordered scatter-add."""
    l, w = window_entries(lo, hi, base, ids_rows, ws_rows, wcaps)
    return place_windows_plain(l, w, super_tiles, tile)


def place_fused(lo: torch.Tensor, hi: torch.Tensor, base: torch.Tensor,
                ids_rows: torch.Tensor, ws_rows: torch.Tensor, wcaps,
                super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """[BS, super_tiles, tile] float32 resident buffers straight from the
    CSR: ``lo``/``hi`` [BS, T] integer window bounds, ``base`` [BS]
    supertile base doc ids, ``ids_rows`` [M, 128] int32 / ``ws_rows``
    [M, 128] float32 the doc-sorted CSR, ``wcaps`` T per-slot caps
    (T <= 32). Keeps exactly the entries ``window_entries`` stages."""
    if lo.device.type == "cpu":
        return place_fused_plain(lo, hi, base, ids_rows, ws_rows, wcaps,
                                 super_tiles, tile)
    if not lo.is_cuda:
        raise ValueError(f"place_fused: unsupported device {lo.device}")
    if lo.dim() != 2 or hi.shape != lo.shape or base.shape != lo.shape[:1]:
        raise ValueError(f"place_fused: shapes lo {tuple(lo.shape)} hi "
                         f"{tuple(hi.shape)} base {tuple(base.shape)}")
    BS, T = lo.shape
    if len(wcaps) != T or T > 32:
        raise ValueError(f"place_fused: {len(wcaps)} caps for {T} slots (at most 32)")
    if (ids_rows.dtype != torch.int32 or ws_rows.dtype != torch.float32
            or ids_rows.shape != ws_rows.shape or ids_rows.dim() != 2
            or ids_rows.shape[1] != ROW):
        raise ValueError("place_fused: ids_rows / ws_rows must be [M, 128] "
                         "int32 / float32")
    if not (ids_rows.is_contiguous() and ws_rows.is_contiguous()):
        raise ValueError("place_fused: the CSR rows must be contiguous")
    if any(t.device != lo.device for t in (hi, base, ids_rows, ws_rows)):
        raise ValueError("place_fused: all tensors must be on one device")
    if tile != TILE or super_tiles * tile * 4 > 232448:
        raise ValueError(f"place_fused: a {super_tiles}x{tile} float buffer "
                         "is not taken")
    R = super_tiles * tile
    lo32 = lo.to(torch.int32).contiguous()
    hi32 = hi.to(torch.int32).contiguous()
    base32 = base.to(torch.int32).contiguous()
    out = torch.empty((BS, R), dtype=torch.float32, device=lo.device)
    if BS == 0:
        return out.reshape(BS, super_tiles, tile)
    rows = (ctypes.c_int * T)(*_slot_rows(wcaps))
    lib = cuda_build.library()
    rc = lib.hst_place_fused(
        lo32.data_ptr(), hi32.data_ptr(), base32.data_ptr(), ids_rows.data_ptr(),
        ws_rows.data_ptr(), ids_rows.numel(), BS, T, rows, R, out.data_ptr(),
        torch.cuda.current_stream(lo.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_place_fused")
    place_fused.launches += 1
    return out.reshape(BS, super_tiles, tile)


place_fused.launches = 0
