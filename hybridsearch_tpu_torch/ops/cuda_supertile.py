"""K2-K5: the supertile hybrid's resident scoring kernels.

Counterpart of ``hybridsearch_tpu/ops/pallas_supertile.py``:

  * ``super_scores`` (K2, ``csrc/super_scores.cu``) replaces
    ``pallas_super_scores``: [B, S*sd] raw dots of each query with every
    doc row of its S probed supertiles, chunk indices past the end clamped
    to the last chunk. The caller applies bias and validity.
  * ``super_scores_dedup`` (K4, the same source and scoring body) replaces
    ``pallas_super_scores_dedup``: K2's function and bits on an id table
    [B, n], scored as (query, unit) pairs sorted by unit id
    (``sort_pairs``), each pair's query row read by index and its rows
    written straight to their query-major output row. At ``sd = ch = 128``
    a unit is one tile: ``tile_scores`` is pass 3 of the dense top-k
    (``ops/dense.py`` ``gather_tile_scores``) on the card.
  * ``place_windows`` (K3, ``csrc/place_windows.cu``) replaces
    ``pallas_place_windows``: [BS, super_tiles, 128] resident lexical
    buffers, ``out[bs, l // 128, l % 128] += w`` for 0 <= l < super_tiles*128.
  * ``place_fused`` (K5, ``csrc/place_fused.cu``) replaces
    ``pallas_place_fused``: the same buffers read straight from the CSR
    windows [lo, hi) of each term slot, with no staged window arrays; the
    same bits as ``window_entries`` + K3.

``super_scores_v1``, ``super_scores_dedup_v1``, ``place_windows_v1`` and
``place_fused_v1`` launch the kernels' first designs, which the redesigns
must equal bit for bit (CUDA tensors only; no served path calls them).
Each other wrapper launches its kernel for CUDA tensors and runs its plain
version only for CPU tensors. K5 serves the ladder's rungs on the card
unless ``EngineConfig.perf.place_fused`` is False (then the staged
windows and K3 do); K4 serves them when ``perf.scores_dedup`` is set, and
at tile grain serves pass 3 always.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hybridsearch_tpu_torch.ops import cuda_build

TILE = 128
ROW = 128  # CSR row width (SuperPostings.ids_rows) of the windows' whole-row reads
# rows a block of the scoring body takes (ch must be a multiple) and the
# pair widths it comes in
SCORE_ROWS = 128
PAIR_WIDTHS = (32, 64, 128)
# the first designs' rows a block and pairs a group
V1_SCORE_ROWS, V1_SCORE_PAIRS = 256, 32
MAX_K2_KEYS = 6144  # K2's in-launch pre-pass counts the keys in shared memory
# entries the placement kernel adds between two barriers (one per thread);
# callers lay out each term slot in whole chunks, so a chunk adds at most
# one weight to a cell and every cell's sum runs in slot order
PLACE_CHUNK = 1024
# shared memory: what one block may take, what an SM holds, and what the
# card reserves of it for each block
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024
# K5's plan (place_fused_plan): threads a block, blocks an SM, ring stages
# and window entries a stage. Measured on an H100 at the levers path's
# shapes (chip_probes.py --only k5k7) and at the clustered serving path's
# (--only k5cell), the fastest of the probed plans at both but one: a block
# a row at 512 rows, by 3%.
PLACE_FUSED_THREADS, PLACE_FUSED_BLOCKS = 256, 2
PLACE_FUSED_STAGES, PLACE_FUSED_ENTRIES = 3, 2048
# shared memory beside the buffer and the ring: the slot rows (32 ints) and
# a descriptor of 40 bytes for each of stages + 1 stages
PLACE_FUSED_FIXED = 128 + 40 * (PLACE_FUSED_STAGES + 1)
_PLAIN_BUDGET = 1 << 29  # bytes of gathered rows per plain-version step
_GATHER_BUDGET = 1 << 30  # bytes of gathered doc tiles per plain tile_scores step


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


def n_units(n_rows: int, sd: int, ch: int) -> int:
    """Units of ``sd`` rows (the last one partial) in ``n_rows`` rows."""
    nch = sd // ch
    return -(-(n_rows // ch) // nch)


def pair_width(n_pairs: int, units: int) -> int:
    """The scoring body's pair width for ``n_pairs`` pairs over ``units``
    units: the narrowest of ``PAIR_WIDTHS`` that holds twice the mean pairs
    a unit (the runs spread around the mean; a run one group holds reads
    its rows once), else the widest. Measured on an H100 at the main
    path's shapes (``chip_probes.py``)."""
    mean = n_pairs / max(1, min(units, n_pairs))
    return next((w for w in PAIR_WIDTHS if 2 * mean <= w), PAIR_WIDTHS[-1])


def sort_pairs(ids: torch.Tensor, per_query: int):
    """K4's pair bookkeeping for a query-major id table ``ids`` [B, n]
    (pair p = b * n + j): (tid, qid, dst) int32 [B*n], the unit ids stable-
    sorted ascending, each pair's query b and its output row p. The lean
    form of ``ops/supertile.py dedup_pairs``, which also gives the inverse
    permutation and the JAX kernel's ``rep``; neither is needed here. The
    kernel's group table needs ``tid`` sorted, so K4's wrapper sorts its
    id table itself."""
    flat = ids.reshape(-1).to(torch.int32)
    tid, order = torch.sort(flat, stable=True)
    order = order.to(torch.int32)
    return tid, order // per_query, order


def group_table_plain(tid: torch.Tensor, units: int, group: int):
    """K4's group table with torch ops (the kernel builds the same on the
    card): from ids sorted ascending, clamped into [-1, units], a group
    starts at every ``group``-th position of a run of equal keys and goes
    to slot ``i // group + key + 1``. Returns (g_start, g_len, g_key) int32
    [ceil(P / group) + units + 2]; g_len is 0 at unused slots."""
    P = tid.shape[0]
    dev = tid.device
    g_max = -(-P // group) + units + 2
    key = tid.long().clamp(-1, units)
    pos = torch.arange(P, device=dev)
    run0 = torch.searchsorted(key, key, side="left")
    end = torch.searchsorted(key, key, side="right")
    slot = torch.where((pos - run0) % group == 0, pos // group + key + 1, g_max)

    def table(values):
        out = torch.zeros(g_max + 1, dtype=torch.long, device=dev)
        return out.scatter_(0, slot, values)[:g_max].to(torch.int32)

    return table(pos), table((end - pos).clamp(max=group)), table(key)


def _checked_scores(name: str, q: torch.Tensor, docs: torch.Tensor, sd: int, ch: int,
                    rows: int, d_mult: int) -> None:
    """The scoring launchers' common checks (device, dtypes, shapes)."""
    if not docs.is_cuda:
        raise ValueError(f"{name}: unsupported device {docs.device}")
    if docs.dtype not in (torch.float32, torch.bfloat16) or q.dtype != docs.dtype:
        raise ValueError(f"{name}: dtypes q {q.dtype} docs {docs.dtype}")
    if docs.dim() != 2 or q.dim() != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} docs {tuple(docs.shape)}")
    N, D = docs.shape
    if N % ch or sd % ch or ch % rows or D % d_mult:
        raise ValueError(f"{name}: N={N}, sd={sd}, ch={ch}, D={D} need N % ch == "
                         f"sd % ch == ch % {rows} == D % {d_mult} == 0")
    if not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError(f"{name}: docs must be contiguous and aligned")
    if q.device != docs.device:
        raise ValueError(f"{name}: all tensors must be on one device")


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


def _k2_checked(name: str, q, docs, sup_s, sd, ch, rows, d_mult):
    _checked_scores(name, q, docs, sd, ch, rows, d_mult)
    N, D = docs.shape
    B, S = sup_s.shape
    if q.shape != (B, D) or sup_s.device != docs.device:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs sup_s {tuple(sup_s.shape)} "
                         f"and D={D}")
    units = n_units(N, sd, ch)
    if B * S >= 2**31 or units + 2 > MAX_K2_KEYS:
        raise ValueError(f"{name}: B*S={B * S} pairs over {units} supertiles is "
                         "past the kernel's limits")
    return q.float().contiguous(), sup_s.to(torch.int32).contiguous(), units


def super_scores(q: torch.Tensor, docs: torch.Tensor, sup_s: torch.Tensor,
                 sd: int, ch: int = 1024) -> torch.Tensor:
    """[B, S*sd] float32 raw scores. ``q`` [B, D] in the docs' dtype,
    ``docs`` [N, D] float32 or bf16 (N % ch == 0; on the card D % 16 == 0),
    ``sup_s`` [B, S] integer supertile ids, ``sd`` % ``ch`` == 0, and on
    the card ``ch`` % 128 == 0. The kernel groups the (query, probe) pairs
    by supertile in its own pre-pass and scores a supertile's rows once a
    group of up to ``pair_width`` pairs."""
    if docs.device.type == "cpu":
        return super_scores_plain(q, docs, sup_s, sd, ch)
    qf, sup, units = _k2_checked("super_scores", q, docs, sup_s, sd, ch,
                                 SCORE_ROWS, 16)
    N, D = docs.shape
    B, S = sup_s.shape
    out = torch.empty((B, S * sd), dtype=torch.float32, device=docs.device)
    if B * S == 0:
        return out
    pw = pair_width(B * S, units)
    # the pre-pass's per-pair query and output rows and its group table
    g_max = -(-B * S // pw) + units + 2
    work = torch.empty(2 * B * S + 3 * g_max, dtype=torch.int32, device=docs.device)
    rc = cuda_build.library().hst_super_scores(
        docs.data_ptr(), int(docs.dtype == torch.bfloat16), qf.data_ptr(),
        sup.data_ptr(), N, D, B, S, sd, ch, pw, work.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(docs.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_super_scores")
    super_scores.launches += 1
    return out


super_scores.launches = 0


def super_scores_v1(q: torch.Tensor, docs: torch.Tensor, sup_s: torch.Tensor,
                    sd: int, ch: int = 1024) -> torch.Tensor:
    """``super_scores`` by the kernel's first design (``hst_super_scores_v1``,
    ``ch`` % 256 == 0, D % 128 == 0), the yardstick the redesign is held to
    bit for bit and timed against. No served path calls it; CUDA tensors
    only."""
    qf, sup, units = _k2_checked("super_scores_v1", q, docs, sup_s, sd, ch,
                                 V1_SCORE_ROWS, 128)
    N, D = docs.shape
    B, S = sup_s.shape
    out = torch.empty((B, S * sd), dtype=torch.float32, device=docs.device)
    if B * S == 0:
        return out
    g_max = -(-B * S // V1_SCORE_PAIRS) + units + 2
    work = torch.empty(B * S + 3 * g_max, dtype=torch.int32, device=docs.device)
    rc = cuda_build.library().hst_super_scores_v1(
        docs.data_ptr(), int(docs.dtype == torch.bfloat16), qf.data_ptr(),
        sup.data_ptr(), N, D, B, S, sd, ch, work.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(docs.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_super_scores_v1")
    super_scores_v1.launches += 1
    return out


super_scores_v1.launches = 0


def super_scores_dedup_plain(q: torch.Tensor, docs: torch.Tensor, ids: torch.Tensor,
                             sd: int, ch: int = 1024) -> torch.Tensor:
    """Plain PyTorch version through the card route's bookkeeping: the
    pairs sorted by unit (``sort_pairs``), each pair's query row gathered,
    a float32 batched dot (``super_scores_plain`` with one probe a pair),
    each pair's rows put at their query-major place."""
    B, n = ids.shape
    tid, qid, dst = sort_pairs(ids, n)
    out = torch.empty((B * n, sd), dtype=torch.float32, device=docs.device)
    out[dst.long()] = super_scores_plain(q[qid.long()], docs, tid.reshape(-1, 1), sd, ch)
    return out.reshape(B, n * sd)


def super_scores_dedup(q: torch.Tensor, docs: torch.Tensor, ids: torch.Tensor,
                       sd: int, ch: int = 1024) -> torch.Tensor:
    """[B, n*sd] float32 raw scores, the function and the bits of
    ``super_scores`` on the id table ``ids`` [B, n] (integer unit ids in
    any order; q and docs as there). On the card the B*n (query, unit)
    pairs are stable-sorted by unit (``sort_pairs``) and the kernel builds
    a group table aligned to the runs of equal ids, scores a unit's rows
    once a group of up to ``pair_width`` pairs, reads each pair's query row
    by index and writes its rows straight to their query-major place."""
    if docs.device.type == "cpu":
        return super_scores_dedup_plain(q, docs, ids, sd, ch)
    _checked_scores("super_scores_dedup", q, docs, sd, ch, SCORE_ROWS, 16)
    N, D = docs.shape
    if ids.dim() != 2 or q.shape != (ids.shape[0], D) or ids.device != docs.device:
        raise ValueError(f"super_scores_dedup: q {tuple(q.shape)} vs ids "
                         f"{tuple(ids.shape)} on {ids.device} and D={D}")
    B, n = ids.shape
    if B * n >= 2**31:
        raise ValueError(f"super_scores_dedup: {B * n} pairs is past the kernel's limits")
    out = torch.empty((B, n * sd), dtype=torch.float32, device=docs.device)
    if B * n:
        _launch_sorted_pairs(q.float().contiguous(), docs, *sort_pairs(ids, n), sd,
                             ch, out)
    return out


def _launch_sorted_pairs(qf: torch.Tensor, docs: torch.Tensor, tid: torch.Tensor,
                        qid: torch.Tensor, dst: torch.Tensor, sd: int, ch: int,
                        out: torch.Tensor) -> None:
    """K4's launch, the sort left out: the P >= 1 pairs (tid, qid, dst)
    exactly as ``sort_pairs`` gives them, ``qf`` [B, D] float32 contiguous
    and ``out`` float32 [P*sd] contiguous, all checked by
    ``super_scores_dedup``. The kernel's group table needs ``tid`` sorted,
    so only the wrapper and the timing of the kernel alone
    (``chip_smoke.py``) call it."""
    N, D = docs.shape
    P = tid.shape[0]
    units = n_units(N, sd, ch)
    pw = pair_width(P, units)
    g_max = -(-P // pw) + units + 2
    work = torch.empty(3 * g_max, dtype=torch.int32, device=docs.device)
    rc = cuda_build.library().hst_super_scores_dedup(
        docs.data_ptr(), int(docs.dtype == torch.bfloat16), qf.data_ptr(),
        tid.data_ptr(), qid.data_ptr(), dst.data_ptr(), P, N, D, sd, ch, pw,
        work.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(docs.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_super_scores_dedup")
    super_scores_dedup.launches += 1


super_scores_dedup.launches = 0


def super_scores_dedup_v1(qp: torch.Tensor, docs: torch.Tensor, tid: torch.Tensor,
                          sd: int, ch: int = 1024) -> torch.Tensor:
    """K4 by its first design (``hst_super_scores_dedup_v1``): [P, sd] raw
    scores of pre-gathered query rows ``qp`` [P, D] with the rows of unit
    ``tid[p]``, in pair order (``ch`` % 256 == 0, D % 128 == 0). The
    yardstick the redesign is held to bit for bit and timed against; no
    served path calls it. CUDA tensors only."""
    _checked_scores("super_scores_dedup_v1", qp, docs, sd, ch, V1_SCORE_ROWS, 128)
    N, D = docs.shape
    P = tid.shape[0]
    if tid.dim() != 1 or qp.shape != (P, D) or tid.device != docs.device:
        raise ValueError(f"super_scores_dedup_v1: qp {tuple(qp.shape)} vs tid "
                         f"{tuple(tid.shape)} and D={D}")
    if P >= 2**31:
        raise ValueError(f"super_scores_dedup_v1: {P} pairs is past the kernel's limits")
    qf = qp.float().contiguous()
    t32 = tid.to(torch.int32).contiguous()
    out = torch.empty((P, sd), dtype=torch.float32, device=docs.device)
    if P == 0:
        return out
    rc = cuda_build.library().hst_super_scores_dedup_v1(
        docs.data_ptr(), int(docs.dtype == torch.bfloat16), qf.data_ptr(),
        t32.data_ptr(), N, D, P, sd, ch, out.data_ptr(),
        torch.cuda.current_stream(docs.device).cuda_stream,
    )
    cuda_build.check(rc, "hst_super_scores_dedup_v1")
    super_scores_dedup_v1.launches += 1
    return out


super_scores_dedup_v1.launches = 0


def group_table(tid: torch.Tensor, units: int, group: int):
    """K4's group table as its kernel builds it (``hst_group_table``; CUDA
    tensors), for holding it against ``group_table_plain``; the K4 launcher
    builds its own. Returns (g_start, g_len, g_key) int32, g_start and
    g_key undefined where g_len is 0."""
    if not tid.is_cuda or tid.dim() != 1:
        raise ValueError(f"group_table: a 1-d CUDA tensor, not {tid.device} "
                         f"{tuple(tid.shape)}")
    P = tid.shape[0]
    g_max = -(-P // group) + units + 2
    work = torch.empty(3 * g_max, dtype=torch.int32, device=tid.device)
    t32 = tid.to(torch.int32).contiguous()
    rc = cuda_build.library().hst_group_table(
        t32.data_ptr(), P, units, group, work.data_ptr(),
        torch.cuda.current_stream(tid.device).cuda_stream)
    cuda_build.check(rc, "hst_group_table")
    return work[:g_max], work[g_max:2 * g_max], work[2 * g_max:]


def tile_scores_plain(q: torch.Tensor, docs: torch.Tensor, tiles: torch.Tensor,
                      tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of ``tile_scores``: each query's tiles
    gathered in steps of at most 1 GiB, widened to float32, and an
    ``einsum`` (the JAX package's pass 3)."""
    B, D = q.shape
    n_tiles = docs.shape[0] // tile
    KT = tiles.shape[1]
    d_tiles = docs.reshape(n_tiles, tile, D)
    qf = q.float()
    chunk = max(1, min(KT, _GATHER_BUDGET // max(1, B * tile * D * 4)))
    parts = []
    for c0 in range(0, KT, chunk):
        sel = d_tiles[tiles[:, c0:c0 + chunk].long()].float()  # [B, c, tile, D]
        parts.append(torch.einsum("bktd,bd->bkt", sel, qf).reshape(B, -1))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def tile_scores(q: torch.Tensor, docs: torch.Tensor, tiles: torch.Tensor,
                tile: int = TILE) -> torch.Tensor:
    """[B, KT*tile] float32 raw scores of every row of each query's tiles:
    ``q`` [B, D] in the docs' dtype (bf16 queries rounded), ``docs``
    [n_tiles * tile, D], ``tiles`` [B, KT] tile ids in [0, n_tiles). On the
    card: K4 at ``sd = ch = tile`` (D % 16 == 0, tile % 128 == 0), whose
    query-major output is already this layout; CPU tensors take
    ``tile_scores_plain``."""
    if docs.device.type == "cpu":
        return tile_scores_plain(q, docs, tiles, tile)
    return super_scores_dedup(q, docs, tiles, tile, ch=tile)


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


@functools.lru_cache(maxsize=64)
def _slot_rows_arg(wcaps: tuple):
    """``_slot_rows(wcaps)`` as the launchers' C int array, built once a
    cap tuple (the path repeats a handful of them)."""
    rows = _slot_rows(wcaps)
    return (ctypes.c_int * len(rows))(*rows)


@functools.lru_cache(maxsize=64)
def place_fused_plan(r_len: int, sms: int):
    """(threads a block, ring stages, entries a stage, blocks, shared-memory
    bytes) of K5 for a row buffer of ``r_len`` floats on a card of ``sms``
    SMs: ``PLACE_FUSED_BLOCKS`` blocks an SM when the buffer and a ring of
    ``PLACE_FUSED_STAGES`` stages of ``PLACE_FUSED_ENTRIES`` fit, else one,
    with the entries a stage halved to fit (down to 128); None when no ring
    fits beside the buffer (more than 445 tiles of 128)."""
    stages = PLACE_FUSED_STAGES
    for per_sm in (PLACE_FUSED_BLOCKS, 1):
        room = (min(SMEM_BLOCK, SMEM_SM // per_sm - SMEM_RESERVED) - 4 * r_len
                - PLACE_FUSED_FIXED)
        entries = PLACE_FUSED_ENTRIES
        while entries >= 128:
            if 8 * stages * entries <= room:
                return (PLACE_FUSED_THREADS, stages, entries, sms * per_sm,
                        4 * r_len + 8 * stages * entries + PLACE_FUSED_FIXED)
            entries //= 2
    return None


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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


def _fused_checked(name: str, lo, hi, base, ids_rows, ws_rows, wcaps,
                   super_tiles: int, tile: int):
    """The K5 launchers' argument checks; returns (BS, T, r_len)."""
    if not lo.is_cuda:
        raise ValueError(f"{name}: unsupported device {lo.device}")
    if lo.dim() != 2 or hi.shape != lo.shape or base.shape != lo.shape[:1]:
        raise ValueError(f"{name}: shapes lo {tuple(lo.shape)} hi "
                         f"{tuple(hi.shape)} base {tuple(base.shape)}")
    BS, T = lo.shape
    if len(wcaps) != T or T > 32:
        raise ValueError(f"{name}: {len(wcaps)} caps for {T} slots (at most 32)")
    if (ids_rows.dtype != torch.int32 or ws_rows.dtype != torch.float32
            or ids_rows.shape != ws_rows.shape or ids_rows.dim() != 2
            or ids_rows.shape[1] != ROW):
        raise ValueError(f"{name}: ids_rows / ws_rows must be [M, 128] "
                         "int32 / float32")
    if not (ids_rows.is_contiguous() and ws_rows.is_contiguous()):
        raise ValueError(f"{name}: the CSR rows must be contiguous")
    dev = lo.get_device()
    if (hi.get_device() != dev or base.get_device() != dev
            or ids_rows.get_device() != dev or ws_rows.get_device() != dev):
        raise ValueError(f"{name}: all tensors must be on one device")
    if tile != TILE or super_tiles * tile * 4 > SMEM_BLOCK:
        raise ValueError(f"{name}: a {super_tiles}x{tile} float buffer "
                         "is not taken")
    return BS, T, super_tiles * tile


def _bounds(lo: torch.Tensor, hi: torch.Tensor, base: torch.Tensor):
    """(lo, hi, base) in one index type K5 reads -- int64 if any is int64,
    else int32 -- contiguous, each itself where it is already so; and
    whether that type is int64. The path's bounds are int64: no copy."""
    dt = torch.int64 if torch.int64 in (lo.dtype, hi.dtype, base.dtype) else torch.int32
    out = tuple(t if t.dtype == dt and t.is_contiguous() else t.to(dt).contiguous()
                for t in (lo, hi, base))
    return out, dt == torch.int64


def place_fused(lo: torch.Tensor, hi: torch.Tensor, base: torch.Tensor,
                ids_rows: torch.Tensor, ws_rows: torch.Tensor, wcaps,
                super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """[BS, super_tiles, tile] float32 resident buffers straight from the
    CSR: ``lo``/``hi`` [BS, T] integer window bounds, ``base`` [BS]
    supertile base doc ids, ``ids_rows`` [M, 128] int32 / ``ws_rows``
    [M, 128] float32 the doc-sorted CSR, ``wcaps`` T per-slot caps
    (T <= 32). Keeps exactly the entries ``window_entries`` stages."""
    if not lo.is_cuda and lo.device.type == "cpu":
        return place_fused_plain(lo, hi, base, ids_rows, ws_rows, wcaps,
                                 super_tiles, tile)
    BS, T, R = _fused_checked("place_fused", lo, hi, base, ids_rows, ws_rows, wcaps,
                              super_tiles, tile)
    plan = place_fused_plan(R, _sm_count(lo.get_device()))
    if plan is None:
        raise ValueError(f"place_fused: a {super_tiles}x{tile} float buffer leaves "
                         "no room for the window ring")
    threads, stages, entries, blocks, _smem = plan
    (lo_k, hi_k, base_k), idx64 = _bounds(lo, hi, base)
    out = ws_rows.new_empty((BS, R))
    if BS == 0:
        return out.reshape(BS, super_tiles, tile)
    rc = cuda_build.library().hst_place_fused(
        lo_k.data_ptr(), hi_k.data_ptr(), base_k.data_ptr(), idx64, ids_rows.data_ptr(),
        ws_rows.data_ptr(), ids_rows.numel(), BS, T, _slot_rows_arg(tuple(wcaps)), R,
        out.data_ptr(), threads, stages, entries, min(BS, blocks),
        cuda_build.stream_of(lo))
    cuda_build.check(rc, "hst_place_fused")
    place_fused.launches += 1
    return out.reshape(BS, super_tiles, tile)


place_fused.launches = 0


def place_fused_v1(lo: torch.Tensor, hi: torch.Tensor, base: torch.Tensor,
                   ids_rows: torch.Tensor, ws_rows: torch.Tensor, wcaps,
                   super_tiles: int = 128, tile: int = TILE) -> torch.Tensor:
    """``place_fused`` by the kernel's first design (``hst_place_fused_v1``),
    the yardstick the redesign is held to bit for bit and timed against.
    No served path calls it; CUDA tensors only."""
    BS, T, R = _fused_checked("place_fused_v1", lo, hi, base, ids_rows, ws_rows,
                              wcaps, super_tiles, tile)
    lo32, hi32, base32 = (t.to(torch.int32).contiguous() for t in (lo, hi, base))
    out = torch.empty((BS, R), dtype=torch.float32, device=lo.device)
    if BS == 0:
        return out.reshape(BS, super_tiles, tile)
    rc = cuda_build.library().hst_place_fused_v1(
        lo32.data_ptr(), hi32.data_ptr(), base32.data_ptr(), ids_rows.data_ptr(),
        ws_rows.data_ptr(), ids_rows.numel(), BS, T, _slot_rows_arg(tuple(wcaps)), R,
        out.data_ptr(), cuda_build.stream_of(lo))
    cuda_build.check(rc, "hst_place_fused_v1")
    place_fused_v1.launches += 1
    return out.reshape(BS, super_tiles, tile)


place_fused_v1.launches = 0
