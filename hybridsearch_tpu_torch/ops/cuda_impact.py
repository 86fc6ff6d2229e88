"""K6 and K7: the impact-pruned lexical arm's kernels.

Counterpart of ``hybridsearch_tpu/ops/pallas_impact.py``:

  * ``slice_runs`` (``csrc/slice_runs.cu``) replaces ``pallas_slice_runs``
    and fuses in the tail mask of its caller: [B*T, p] ids and weights, the
    p-entry prefix of each (query, term) impact run from its dynamic start,
    with positions at or past the run's length set to (n_docs, 0).
  * ``rescore`` (``csrc/impact_rescore.cu``) replaces
    ``pallas_onehot_rescore``: [B, C] sums of the posting weights whose id
    equals each candidate. Row b of the postings is T columns of p entries
    (term slot t's slice is column t); within a column a doc id below
    n_docs appears at most once, which is what a term's run gives. The
    kernel keeps a per-query hash table of the candidates in shared memory
    instead of the TPU's one-hot comparison, looks up a group of columns'
    entries before it adds them (``rescore_plan``), and adds the columns in
    order.

``slice_runs_v1`` and ``rescore_v1`` launch the kernels' first designs,
which the redesigns must equal bit for bit (CUDA tensors only; no served
path calls them). Each other wrapper launches its kernel for CUDA tensors
and runs its plain version only for CPU tensors; the plain versions
compute the same numbers in the same order (the card's results equal them
bit for bit). The wrappers convert or copy nothing that is already int32
and contiguous: their host work runs once a launch, every rung. The slice
wrappers check their arguments on every device, the CPU's included.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from hybridsearch_tpu_torch.ops import cuda_build

# widest batch row the rescore takes: 32 term slots (the top of the
# IMPACT_T_LADDER), and a candidate table of at most 2^14 slots of 8 bytes
# (128 KB of shared memory) at a load of at most 0.8
RESCORE_MAX_T = 32
RESCORE_MAX_LOG2_SLOTS = 14
# The rescore's plan (rescore_plan): (widest column p, threads a block,
# entries a thread a group). The walk looks up a group of threads *
# entries positions (whole columns when they fit) before it adds them.
# Measured on an H100 at the ladder's shapes (chip_probes.py --only k7).
RESCORE_PLANS = ((256, 1024, 2), (2**31 - 1, 1024, 4))

def _int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor, itself when it is one already."""
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def slice_runs_plain(doc_ids: torch.Tensor, weights: torch.Tensor,
                     starts: torch.Tensor, lengths: torch.Tensor, p: int,
                     n_docs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one gather of every slice, then the mask."""
    s = starts.reshape(-1).long()
    iota = torch.arange(p, device=doc_ids.device)
    pos = s[:, None] + iota
    valid = iota < lengths.reshape(-1).long()[:, None]
    ids = torch.where(valid, doc_ids[pos], n_docs).to(torch.int32)
    ws = torch.where(valid, weights[pos], 0.0)
    return ids, ws


def _slice_checked(name: str, doc_ids: torch.Tensor, weights: torch.Tensor,
                   starts: torch.Tensor, lengths: torch.Tensor, p: int,
                   n_docs: int) -> None:
    """The slice launchers' argument checks, on tensors of any device."""
    if doc_ids.dtype != torch.int32 or weights.dtype != torch.float32:
        raise ValueError(f"{name}: doc_ids must be int32 and weights float32")
    if doc_ids.dim() != 1 or weights.shape != doc_ids.shape:
        raise ValueError(f"{name}: postings shapes {tuple(doc_ids.shape)} "
                         f"{tuple(weights.shape)}")
    if starts.shape != lengths.shape:
        raise ValueError(f"{name}: starts {tuple(starts.shape)} vs lengths "
                         f"{tuple(lengths.shape)}")
    if not doc_ids.device == weights.device == starts.device == lengths.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if p < 1 or p > doc_ids.shape[0] or not 0 <= n_docs < 2**31:
        raise ValueError(f"{name}: p={p}, n_docs={n_docs} out of range")


def _slice_launch(wrapper, fn, name: str, doc_ids: torch.Tensor,
                  weights: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                  p: int, n_docs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the slice kernel ``fn`` into new outputs and count the launch
    on ``wrapper``. (Two allocations: one [2, rows, p] allocation and two
    views of it took longer on the host, chip_probes.py --only k6.)"""
    rows = starts.numel()
    ids, ws = doc_ids.new_empty((rows, p)), weights.new_empty((rows, p))
    if rows == 0:
        return ids, ws
    if not (starts.dtype == lengths.dtype == torch.int32 and starts.is_contiguous()
            and lengths.is_contiguous()):
        starts, lengths = _int32(starts), _int32(lengths)
    if not (doc_ids.is_contiguous() and weights.is_contiguous()):
        doc_ids, weights = doc_ids.contiguous(), weights.contiguous()
    rc = fn(doc_ids.data_ptr(), weights.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
            rows, p, n_docs, ids.data_ptr(), ws.data_ptr(), cuda_build.stream_of(doc_ids))
    cuda_build.check(rc, name)
    wrapper.launches += 1
    return ids, ws


def slice_runs(doc_ids: torch.Tensor, weights: torch.Tensor,
               starts: torch.Tensor, lengths: torch.Tensor, p: int,
               n_docs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B*T, p] int32 ids, [B*T, p] float32 weights) of the p-entry
    prefixes starting at ``starts`` [B, T], masked to (n_docs, 0) at
    positions >= ``lengths`` [B, T]. ``doc_ids`` int32 and ``weights``
    float32 [nnz + p_max] carry p_max sentinel entries past the last run,
    so every slice with p <= p_max is in bounds (the caller keeps p there)."""
    _slice_checked("slice_runs", doc_ids, weights, starts, lengths, p, n_docs)
    if not doc_ids.is_cuda:
        if doc_ids.device.type == "cpu":
            return slice_runs_plain(doc_ids, weights, starts, lengths, p, n_docs)
        raise ValueError(f"slice_runs: unsupported device {doc_ids.device}")
    return _slice_launch(slice_runs, cuda_build.library().hst_slice_runs,
                         "hst_slice_runs", doc_ids, weights, starts, lengths, p, n_docs)


slice_runs.launches = 0


def slice_runs_v1(doc_ids: torch.Tensor, weights: torch.Tensor,
                  starts: torch.Tensor, lengths: torch.Tensor, p: int,
                  n_docs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``slice_runs`` by the kernel's first design (``hst_slice_runs_v1``),
    the yardstick the redesign is held to bit for bit and timed against.
    No served path calls it; CUDA tensors only."""
    _slice_checked("slice_runs_v1", doc_ids, weights, starts, lengths, p, n_docs)
    if not doc_ids.is_cuda:
        raise ValueError(f"slice_runs_v1: unsupported device {doc_ids.device}")
    return _slice_launch(slice_runs_v1, cuda_build.library().hst_slice_runs_v1,
                         "hst_slice_runs_v1", doc_ids, weights, starts, lengths, p,
                         n_docs)


slice_runs_v1.launches = 0


def rescore_plain(cand: torch.Tensor, ids_flat: torch.Tensor,
                  ws_flat: torch.Tensor, p: int, n_docs: int) -> torch.Tensor:
    """Plain PyTorch version: column by column, each candidate finds its id
    in the sorted column (searchsorted) and adds the weight there; the
    columns are added in order, as the kernel adds them."""
    B, C = cand.shape
    T = ids_flat.shape[1] // p
    valid = (cand >= 0) & (cand < n_docs)
    c32 = cand.to(torch.int32).contiguous()
    acc = torch.zeros((B, C), dtype=torch.float32, device=cand.device)
    for t in range(T):
        col_ids = ids_flat[:, t * p:(t + 1) * p].to(torch.int32)
        srt, perm = torch.sort(col_ids, dim=1, stable=True)
        pos = torch.searchsorted(srt, c32).clamp(max=p - 1)
        hit = valid & (torch.gather(srt, 1, pos) == c32)
        col_ws = torch.gather(ws_flat[:, t * p:(t + 1) * p], 1, perm)
        acc = acc + torch.where(hit, torch.gather(col_ws, 1, pos), 0.0)
    return acc


def rescore_slots(C: int) -> int:
    """log2 of the candidate table's slot count: the least power of two
    holding C at a load of at most 0.8."""
    return max(1, (-(-5 * C // 4) - 1).bit_length())


@functools.lru_cache(maxsize=64)
def rescore_plan(C: int, T: int, p: int) -> Tuple[int, int, int, int]:
    """(log2 table slots, threads a block, entries a thread a group,
    shared-memory bytes: the table) of the rescore kernel for C candidates
    over T columns of width p."""
    log2_slots = rescore_slots(C)
    threads, entries = next((n, e) for widest, n, e in RESCORE_PLANS if p <= widest)
    return log2_slots, threads, entries, 8 << log2_slots


def _rescore_checked(name: str, cand: torch.Tensor, ids_flat: torch.Tensor,
                     ws_flat: torch.Tensor, p: int, n_docs: int):
    """The rescore launchers' argument checks; returns (B, C, T)."""
    if not cand.is_cuda:
        raise ValueError(f"{name}: unsupported device {cand.device}")
    if cand.dim() != 2 or ids_flat.dim() != 2 or ids_flat.shape != ws_flat.shape \
            or ids_flat.shape[0] != cand.shape[0]:
        raise ValueError(f"{name}: shapes cand {tuple(cand.shape)} ids "
                         f"{tuple(ids_flat.shape)} ws {tuple(ws_flat.shape)}")
    if ids_flat.dtype != torch.int32 or ws_flat.dtype != torch.float32:
        raise ValueError(f"{name}: ids must be int32 and ws float32")
    if ids_flat.get_device() != cand.get_device() or ws_flat.get_device() != cand.get_device():
        raise ValueError(f"{name}: all tensors must be on one device")
    B, C = cand.shape
    W = ids_flat.shape[1]
    if p < 1 or W % p or not 0 <= n_docs < 2**31:
        raise ValueError(f"{name}: width {W} is not whole columns of p={p}, "
                         f"or n_docs={n_docs} is out of range")
    T = W // p
    if T > RESCORE_MAX_T or rescore_slots(C) > RESCORE_MAX_LOG2_SLOTS:
        raise ValueError(
            f"{name}: T={T} columns and C={C} candidates exceed the kernel's "
            f"limits (T <= {RESCORE_MAX_T}, C <= "
            f"{4 * (1 << RESCORE_MAX_LOG2_SLOTS) // 5} in shared memory)")
    return B, C, T


def rescore(cand: torch.Tensor, ids_flat: torch.Tensor, ws_flat: torch.Tensor,
            p: int, n_docs: int) -> torch.Tensor:
    """[B, C] float32: for each candidate id in [0, n_docs) of ``cand``
    [B, C], the sum of ``ws_flat`` [B, T*p] float32 over the entries of
    ``ids_flat`` [B, T*p] int32 equal to it, the T columns of width ``p``
    added in order; 0 for every other candidate."""
    if not cand.is_cuda and cand.device.type == "cpu":
        return rescore_plain(cand, ids_flat, ws_flat, p, n_docs)
    B, C, T = _rescore_checked("rescore", cand, ids_flat, ws_flat, p, n_docs)
    out = ws_flat.new_empty((B, C))
    if B == 0 or C == 0:
        return out.zero_()
    log2_slots, threads, entries, _smem = rescore_plan(C, T, p)
    rc = cuda_build.library().hst_impact_rescore(
        _int32(cand).data_ptr(), _contiguous(ids_flat).data_ptr(),
        _contiguous(ws_flat).data_ptr(), B, C, T, p, n_docs, log2_slots,
        out.data_ptr(), threads, entries, cuda_build.stream_of(cand))
    cuda_build.check(rc, "hst_impact_rescore")
    rescore.launches += 1
    return out


rescore.launches = 0


def rescore_v1(cand: torch.Tensor, ids_flat: torch.Tensor, ws_flat: torch.Tensor,
               p: int, n_docs: int) -> torch.Tensor:
    """``rescore`` by the kernel's first design (``hst_impact_rescore_v1``),
    the yardstick the redesign is held to bit for bit and timed against.
    No served path calls it; CUDA tensors only."""
    B, C, T = _rescore_checked("rescore_v1", cand, ids_flat, ws_flat, p, n_docs)
    out = torch.empty((B, C), dtype=torch.float32, device=cand.device)
    if B == 0 or C == 0:
        return out.zero_()
    rc = cuda_build.library().hst_impact_rescore_v1(
        cand.to(torch.int32).contiguous().data_ptr(), ids_flat.contiguous().data_ptr(),
        ws_flat.contiguous().data_ptr(), B, C, T, p, n_docs, rescore_slots(C),
        out.data_ptr(), cuda_build.stream_of(cand))
    cuda_build.check(rc, "hst_impact_rescore_v1")
    rescore_v1.launches += 1
    return out


rescore_v1.launches = 0
