"""Collective retrieval programs over the mesh's data axis.

Counterpart of ``hybridsearch_tpu/parallel/collectives.py``. Every rank
holds one shard of the document rows and runs the same function on the
same (replicated) queries; only O(shards * k) candidates and a few [B]
statistics cross ranks, never an O(N) array. The JAX collectives map one
for one:

  - ``lax.pmin`` / ``lax.pmax``: ``all_reduce`` with MIN / MAX, exact, so
    the result does not depend on the order of the ranks (statistics that
    meet at one point travel in one call, stacked);
  - ``lax.all_gather(..., axis=1, tiled=True)``: ``all_gather`` in rank
    order, then a ``cat`` along dim 1;
  - the merge is ``stable_topk``, so ties break as ``lax.top_k`` breaks
    them (the lower position: the lower rank, then the lower local pick).

Every rank returns the same merged answer. The collectives take the
tensors on their device as they are, on gloo as on NCCL (gloo copies CUDA
tensors through host memory inside the call); each is timed by a
``trace_span`` ("mesh_all_reduce", "mesh_all_gather").
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hybridsearch_tpu_torch.ops.dense import (
    dense_tile_stats,
    gather_tile_scores,
    scan_dense_topk,
    stable_topk,
    tiled_matrix_topk,
)
from hybridsearch_tpu_torch.ops.supertile import EPS_NUM, TILE, _resident_windows
from hybridsearch_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from hybridsearch_tpu_torch.utils.tracing import trace_span

NEG_INF = float("-inf")


def _shard(mesh: Mesh) -> Tuple[int, int]:
    """(shard count, this rank's shard) on the data axis."""
    return mesh.shape[DATA_AXIS], mesh.data_index


def all_reduce(x: torch.Tensor, op: str, mesh: Mesh) -> torch.Tensor:
    """A reduced copy of ``x`` over the data axis; ``op`` "min" or "max"."""
    y = x.contiguous().clone()
    red = dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX
    with trace_span("mesh_all_reduce"):
        dist.all_reduce(y, op=red, group=mesh.data_group)
    return y


def all_reduce_sum(value: int, mesh: Mesh) -> int:
    """A host integer summed over the data axis."""
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=mesh.device if mesh.backend == "nccl" else "cpu")
    with trace_span("mesh_all_reduce"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return int(t.item())


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[DATA_AXIS])]
    with trace_span("mesh_all_gather"):
        dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts, dim=dim)


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int,
               mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of every rank's local candidates: gather in rank order,
    ``stable_topk``."""
    all_vals = all_gather_cat(vals, mesh)
    all_ids = all_gather_cat(ids, mesh)
    mv, sel = stable_topk(all_vals, k)
    return mv, torch.gather(all_ids, 1, sel)


# rows a rank sends in one all-gather of ``move_rows`` (about 25 MB a rank
# at D = 384): bounds the gathered buffer at a few times that
MOVE_CHUNK_ROWS = 16384


def move_rows(mesh: Mesh, local: torch.Tensor, old_per: int, src: np.ndarray,
              new_per: int) -> Tuple[torch.Tensor, int]:
    """This rank's rows of a row-sharded array laid out anew: new global
    row g takes old global row ``src[g]`` (-1: a zero row). Rank r held old
    rows [r * old_per, (r + 1) * old_per) (``local``) and holds new rows
    [r * new_per, (r + 1) * new_per). Every rank passes the same ``src``, so
    each computes the whole plan alike. A row that keeps its rank is copied
    in place; a row whose rank changes travels once: each rank's outgoing
    rows, padded to the largest sender's count, go through all-gathers of
    at most ``MOVE_CHUNK_ROWS`` rows (gloo has no all-to-all), and each
    receiver takes its own. Returns (the [new_per, ...] rows, the rows this
    rank received)."""
    S, me = _shard(mesh)
    dev = local.device
    has = src >= 0
    old_owner = np.where(has, src // old_per, -1)
    new_owner = np.arange(len(src)) // new_per
    moving = has & (old_owner != new_owner)
    lo = me * new_per
    out = local.new_zeros((new_per,) + tuple(local.shape[1:]))
    stay = np.flatnonzero(old_owner[lo:lo + new_per] == me)
    if stay.size:
        out[torch.from_numpy(stay).to(dev)] = local[
            torch.from_numpy(src[lo + stay] - me * old_per).to(dev)]
    # each sender's outgoing rows, by new global row
    sends = [np.flatnonzero(moving & (old_owner == r)) for r in range(S)]
    most = max(len(rows) for rows in sends)
    received = 0
    for c0 in range(0, most, MOVE_CHUNK_ROWS):
        width = min(MOVE_CHUNK_ROWS, most - c0)
        buf = local.new_zeros((width,) + tuple(local.shape[1:]))
        mine = sends[me][c0:c0 + width]
        if mine.size:
            buf[:mine.size] = local[torch.from_numpy(src[mine] - me * old_per).to(dev)]
        every = all_gather_cat(buf[None], mesh, dim=0)  # [S, width, ...]
        for r in range(S):
            part = sends[r][c0:c0 + width]
            take = np.flatnonzero(new_owner[part] == me)
            if r == me or not take.size:
                continue
            out[torch.from_numpy(part[take] - lo).to(dev)] = every[
                r, torch.from_numpy(take).to(dev)]
            received += int(take.size)
    return out, received


def _local_bias(bias: Optional[torch.Tensor], per: int,
                like: torch.Tensor) -> torch.Tensor:
    if bias is None:
        return torch.zeros(per, dtype=torch.float32, device=like.device)
    return bias.float()


def sharded_dense_topk(
    mesh: Mesh,
    queries: torch.Tensor,
    docs_local: torch.Tensor,
    k: int,
    block_n: int = 4096,
    valid_n: Optional[int] = None,
    bias_local: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over doc-sharded rows. ``queries`` [B, D] (the same on
    every rank), ``docs_local`` [per, D] this rank's rows (global rows
    [shard * per, (shard + 1) * per); rows at or past ``valid_n`` are
    padding), ``bias_local`` [per]. Each rank streams its rows
    (``scan_dense_topk``), masks padding, and the k_local = min(k, per)
    candidates of every rank merge. Returns (values [B, k], global indices
    [B, k]) sorted descending."""
    S, shard = _shard(mesh)
    per = docs_local.shape[0]
    valid = per * S if valid_n is None else valid_n
    k_local = min(k, per)
    vals, idxs = scan_dense_topk(queries, docs_local, k_local,
                                 block_n=min(block_n, per),
                                 bias=_local_bias(bias_local, per, queries))
    gidx = torch.where(idxs >= 0, idxs + shard * per, -1)
    ok = (gidx >= 0) & (gidx < valid)
    vals = torch.where(ok, vals, NEG_INF)
    gidx = torch.where(ok, gidx, -1)
    return merge_topk(vals, gidx, k, mesh)


def _norm(x: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    rng = mx - mn
    return torch.where((rng > 1e-12)[:, None],
                       (x - mn[:, None]) / rng.clamp_min(1e-12)[:, None],
                       torch.ones_like(x))


def sharded_fuse_topk(
    mesh: Mesh,
    sem: torch.Tensor,
    lex: torch.Tensor,
    k: int,
    semantic_weight: float,
    lexical_weight: float,
    valid_n: int,
    bias_local: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-max fusion of two [B, per] arms over this rank's columns, with
    the statistics global: each arm's min and max over valid, alive docs
    (bias >= 0) reduce over the data axis (one MIN and one MAX call), the
    fused scores plus bias give a local top-k, and the candidates merge.
    The reference normalizes over every doc; so does this."""
    S, shard = _shard(mesh)
    B, per = sem.shape
    k_local = min(k, per)
    bias = _local_bias(bias_local, per, sem)
    gidx = shard * per + torch.arange(per, device=sem.device)
    valid = (gidx < valid_n)[None, :]
    big = 3.4e38
    stat_ok = valid & (bias >= 0.0)[None, :]
    mins = all_reduce(torch.stack([torch.where(stat_ok, sem, big).amin(dim=1),
                                   torch.where(stat_ok, lex, big).amin(dim=1)]),
                      "min", mesh)
    maxs = all_reduce(torch.stack([torch.where(stat_ok, sem, -big).amax(dim=1),
                                   torch.where(stat_ok, lex, -big).amax(dim=1)]),
                      "max", mesh)
    hybrid = (_norm(sem, mins[0], maxs[0]) * semantic_weight
              + _norm(lex, mins[1], maxs[1]) * lexical_weight)
    hybrid = hybrid + bias[None, :]
    hybrid = torch.where(valid, hybrid, NEG_INF)
    if per > 65536:  # no per-wide sort
        vals, idxs = tiled_matrix_topk(hybrid, k_local)
        idxs = idxs.clamp_min(0)
    else:
        vals, idxs = stable_topk(hybrid, k_local)
    g = gidx[idxs]
    g = torch.where(torch.isfinite(vals), g, -1)
    return merge_topk(vals, g, k, mesh)


def sharded_hybrid_topk(
    mesh: Mesh,
    queries: torch.Tensor,
    docs_local: torch.Tensor,
    bm25_doc_ids: torch.Tensor,
    bm25_weights: torch.Tensor,
    groups: Sequence[Tuple[int, np.ndarray, np.ndarray]],
    k: int,
    semantic_weight: float,
    lexical_weight: float,
    valid_n: int,
    bias_local: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact hybrid over the mesh in one collective program: each rank
    takes both arms over its own doc columns, the [B, per] dense product
    (``queries`` L2-normalized) and its BM25 scores from its shard's
    postings (``bm25_doc_ids`` / ``bm25_weights`` with local doc ids; the
    run pieces ``groups`` of ``encode_run_pieces_sharded`` for this rank),
    then ``sharded_fuse_topk``. Returns (values [B, k], global indices
    [B, k])."""
    from hybridsearch_tpu_torch.ops.bm25 import local_bucketed_scores

    per = docs_local.shape[0]
    q32 = queries.float()
    q_mm = q32.to(docs_local.dtype) if docs_local.dtype == torch.bfloat16 else q32
    sem = (q_mm @ docs_local.T).float()  # [B, per]
    if groups:
        lex = local_bucketed_scores(bm25_doc_ids, bm25_weights, groups, per,
                                    q32.shape[0])
    else:
        lex = torch.zeros_like(sem)
    return sharded_fuse_topk(mesh, sem, lex, k, semantic_weight, lexical_weight,
                             valid_n, bias_local)


def sharded_supertile_topk(
    mesh: Mesh,
    queries: torch.Tensor,
    docs_local: torch.Tensor,
    sup_max: torch.Tensor,
    sup_pos: torch.Tensor,
    ids_rows: torch.Tensor,
    ws_rows: torch.Tensor,
    enc,
    k: int,
    semantic_weight: float,
    lexical_weight: float,
    s_probe: int = 2,
    valid_n: Optional[int] = None,
    n_alive: Optional[int] = None,
    bias_local: Optional[torch.Tensor] = None,
    super_tiles: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The supertile exact-resident hybrid over the mesh: each rank probes
    ``s_probe`` of its own supertiles and scores only their residents.

    Per rank: the dense tile stats of its rows (kernel K1; the alive min
    and max reduce globally), its supertile bounds from its shard's tables
    (``sup_max`` [V+1, ns], ``sup_pos``, ``ids_rows`` / ``ws_rows`` with
    LOCAL doc ids, ``build_super_postings_sharded``) under the global
    bound normalizer, its probes, the exact residents (semantic by K4 at
    tile grain through ``gather_tile_scores``, lexical windows placed by
    K3), fusion under the global resident lexical max, a local top-k and
    the merge. The certificate is global: the merged k-th fused score must
    dominate every rank's best unprobed bound, the resident lexical max
    every rank's unprobed lexical bound (both by the single-device rung's
    ``EPS_NUM``: the stats sweep and the resident scores sum float32
    products in different orders; the JAX program has no margin), and no
    window of any rank may overflow; ``enc`` (``encode_super_queries_sharded``,
    the same on every rank) adds term completeness and the lexical-min-0
    flag. Returns (values [B, k], global indices [B, k], exact [B])."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import place_windows

    S_sh, shard = _shard(mesh)
    per = docs_local.shape[0]
    offset = shard * per
    valid_n = per * S_sh if valid_n is None else valid_n
    n_alive = valid_n if n_alive is None else n_alive
    sd = super_tiles * TILE
    q = queries.float()
    B = q.shape[0]
    dev = q.device
    w_s, w_l = float(semantic_weight), float(lexical_weight)
    eps = 1e-12
    wcaps = tuple(min(w, sd) for w in enc.wcaps)
    lmz = torch.from_numpy(np.asarray(enc.full_touched) < n_alive).to(dev)
    complete = torch.from_numpy(np.asarray(enc.complete)).to(dev)
    bias = _local_bias(bias_local, per, q)
    n_tiles = -(-per // TILE)
    ns = sup_max.shape[1]
    S = min(s_probe, ns)
    tids = enc.term_ids

    # 1. local dense stats; the alive min / max reduce over the data axis
    tile_sem, smin_l, smax_l = dense_tile_stats(q, docs_local, bias)
    # 2. lexical supertile bounds; the bound normalizer is the global max
    slex = sup_max[tids].sum(dim=1)  # [B, ns]
    smin = all_reduce(smin_l, "min", mesh)
    mx = all_reduce(torch.stack([smax_l, slex.amax(dim=1)]), "max", mesh)
    smax, L0 = mx[0], mx[1]
    pad_t = ns * super_tiles - n_tiles
    if pad_t:
        tile_sem = torch.nn.functional.pad(tile_sem, (0, pad_t), value=NEG_INF)
    ssem = tile_sem.reshape(B, ns, super_tiles).amax(dim=2)
    rng_s = smax - smin

    def nsem(x):
        return torch.where(rng_s[:, None] > eps,
                           (x - smin[:, None]) / rng_s[:, None].clamp_min(eps),
                           torch.ones_like(x))

    def nlex(x, L):
        return torch.where(L[:, None] > eps, x / L[:, None].clamp_min(eps),
                           torch.ones_like(x))

    # 3. this rank's probes
    bound0 = w_s * nsem(ssem) + w_l * nlex(slex, L0)
    _, top_sup = stable_topk(bound0, S)
    sup_s = torch.sort(top_sup, dim=1).values

    # 4. exact residents (local ids): semantic, then lexical
    tiles_sel = (sup_s[:, :, None] * super_tiles
                 + torch.arange(super_tiles, device=dev)).reshape(B, S * super_tiles)
    s_res, gidx_l = gather_tile_scores(q, docs_local, tiles_sel, bias)
    R = S * sd
    gidx = gidx_l + offset
    in_range = (gidx_l < per) & (gidx < valid_n)
    s_res = torch.where(in_range, s_res, NEG_INF)
    alive = torch.isfinite(s_res)
    l_cat, w_cat, ovf_l = _resident_windows(sup_pos, ids_rows, ws_rows, tids,
                                            sup_s, sd, wcaps)
    lex_res = place_windows(l_cat.reshape(B * S, -1), w_cat.reshape(B * S, -1),
                            super_tiles, TILE).reshape(B, R)  # K3
    lex_res = torch.where(alive, lex_res, 0.0)

    # 5. the global resident lexical max, fusion, local top-k
    L_res = all_reduce(lex_res.amax(dim=1), "max", mesh)
    fused = w_s * nsem(s_res) + w_l * nlex(lex_res, L_res)
    fused = torch.where(alive, fused, NEG_INF)
    k_local = min(k, R)
    if R > 4096:
        vals, pos = tiled_matrix_topk(fused, k_local)
        pos = pos.clamp_min(0)
    else:
        vals, pos = stable_topk(fused, k_local)
    g = torch.gather(gidx, 1, pos)
    g = torch.where(torch.isfinite(vals) & (vals > NEG_INF / 2), g, -1)

    # 6. certificate pieces, reduced in one call
    probed = torch.zeros((B, ns), dtype=torch.bool, device=dev)
    probed.scatter_(1, sup_s, True)
    slex_un = torch.where(probed, 0.0, slex)
    bound_f = w_s * nsem(ssem) + w_l * nlex(slex, L_res.clamp_min(eps))
    tau_l = torch.where(probed, NEG_INF, bound_f).amax(dim=1)
    cert = all_reduce(torch.stack([slex_un.amax(dim=1), tau_l,
                                   ovf_l.float()]), "max", mesh)
    max_un, tau, ovf = cert[0], cert[1], cert[2] > 0
    cert_norm = (L_res >= max_un + EPS_NUM) | (max_un <= 0.0)

    # 7. candidate merge
    mv, mi = merge_topk(vals, g, k, mesh)
    kth = mv[:, -1]
    exact = (complete & lmz & cert_norm & ~ovf
             & ((kth >= tau + EPS_NUM) | ~torch.isfinite(tau)))
    return mv, mi, exact
