"""Dense retrieval ops: normalization, tile statistics and exact top-k.

Counterpart of ``hybridsearch_tpu/ops/dense.py``. With L2-normalized
embeddings, inner product is cosine and a flat index is a matrix product;
the sweeps here stream the doc matrix once and keep only per-128-doc-tile
statistics, so the [B, N] score matrix is never materialized:

  - ``dense_tile_stats``: exact per-tile maxima plus alive min/max in one
    sweep (step 1 of the supertile prefix, ops/supertile.py);
  - ``tiled_dense_topk``: exact top-k by tile-max selection (pass 1 is the
    same sweep);
  - ``tiled_matrix_topk``: exact top-k over a precomputed score matrix;
  - ``gather_tile_scores``: exact scores of every doc in chosen tiles;
  - ``scan_dense_topk``: exact top-k streamed over doc blocks, a running
    top-k merged with each block's product (each shard's top-k on a mesh,
    parallel/collectives.py; no Pallas kernel backs it);
  - ``dense_topk``: the JAX package's dispatch between the last two;
  - ``cosine_scores`` / ``pairwise_cosine``: full float32 cosine matrices;
  - ``quantize_corpus_int8`` and ``int8_swept_topk``: exact-when-certified
    top-k whose tile selection sweeps a per-doc-scaled int8 copy of the
    corpus (int8 x int8 -> int32, ``torch._int_mm`` on the card), then
    rescores the chosen tiles exactly.

The sweep is kernel K1 (``ops/cuda_topk.py``) on the card, at the shapes the
JAX package sent to its Pallas kernel; elsewhere it is K1's plain version.
Pass 3's rescore of the chosen tiles is kernel K4 at tile grain
(``ops/cuda_supertile.py`` ``tile_scores``) on the card; the JAX package
and the CPU route gather the tiles and take an ``einsum``. The int8
sweep's product has no Pallas kernel in the JAX package (a ``dot_general``);
its pass 3 is ``gather_tile_scores``, so K4 at tile grain on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hybridsearch_tpu_torch.ops.cuda_supertile import (
    SCORE_ROWS,
    tile_scores,
    tile_scores_plain,
)
from hybridsearch_tpu_torch.ops.cuda_topk import tile_stats, tile_stats_plain

NEG_INF = float("-inf")
# The JAX package's kernel route needs n_tiles >= 2 * HST_PALLAS_TPB (32);
# the same floor keeps small corpora on the plain sweep here.
KERNEL_MIN_TILES = 64


def _on_card(t: torch.Tensor) -> bool:
    """The kernel route: tensors on a CUDA card."""
    return t.is_cuda


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim`` (float32 norm), keeping x's dtype."""
    norm = x.float().square().sum(dim=dim, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps)).to(x.dtype)


def cosine_scores(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Full [B, N] float32 cosine matrix of raw (not pre-normalized) rows."""
    return l2_normalize(queries.float()) @ l2_normalize(docs.float()).T


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """All-pairs [n, n] float32 cosine similarity, one product."""
    xn = l2_normalize(x.float())
    return xn @ xn.T


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ties to the lower position, the order
    ``jax.lax.top_k`` gives (``torch.topk`` leaves tie order open). Used on
    rows of at most a few thousand columns."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _pad_rows(docs: torch.Tensor, bias: Optional[torch.Tensor], tile: int):
    N = docs.shape[0]
    n_tiles = -(-N // tile)
    Np = n_tiles * tile
    d = docs
    if Np != N:
        d = torch.cat([docs, docs.new_zeros((Np - N, docs.shape[1]))])
    bias_p = None
    if bias is not None:
        bias_p = bias.float()
        if Np != N:
            bias_p = torch.cat([bias_p, bias_p.new_full((Np - N,), NEG_INF)])
    return d, bias_p, n_tiles, Np


def _sweep(q_mm, d, bias_p, n_valid, n_tiles, tile, with_min):
    """Pass 1: [n_tiles, B] tile maxima (and alive minima). K1 on the card
    when the JAX kernel route's shape conditions hold."""
    Dm = d.shape[1]
    if (_on_card(d) and tile == 128 and Dm % 128 == 0
            and n_tiles >= KERNEL_MIN_TILES):
        return tile_stats(q_mm, d, bias_p, n_valid=n_valid, with_min=with_min)
    return tile_stats_plain(q_mm, d, bias_p, n_valid=n_valid,
                            with_min=with_min, tile=tile)


def dense_tile_stats(
    queries: torch.Tensor,
    docs: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    tile: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """([B, n_tiles] exact per-tile score maxima, [B] alive min, [B] alive
    max) in one sweep. ``bias`` is the 0/-inf alive mask; maxima see
    s + bias, minima the raw scores of alive rows."""
    q = queries.float()
    N = docs.shape[0]
    d, bias_p, n_tiles, _ = _pad_rows(docs, bias, tile)
    q_mm = q.to(torch.bfloat16) if d.dtype == torch.bfloat16 else q
    tmax, tmin = _sweep(q_mm, d, bias_p, N, n_tiles, tile, with_min=True)
    smax = tmax.amax(dim=0)
    smin = tmin.amin(dim=0)
    return tmax.T.contiguous(), smin, smax


def tiled_matrix_topk(scores: torch.Tensor, k: int,
                      tile: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a [B, N] score matrix by tile-max selection: if a
    top-k value lived outside the k best tiles, k tiles would each hold a
    larger value. Every sort is at most a few thousand wide. Columns past
    N count as -inf; empty slots return index -1."""
    B, N = scores.shape
    n_tiles = -(-N // tile)
    Np = n_tiles * tile
    s = scores.float()
    if Np != N:
        s = torch.cat([s, s.new_full((B, Np - N), NEG_INF)], dim=1)
    s_tiles = s.reshape(B, n_tiles, tile)
    k_tiles = min(k, n_tiles)
    _, top_tiles = stable_topk(s_tiles.amax(dim=2), k_tiles)
    sel = torch.gather(s_tiles, 1, top_tiles[:, :, None].expand(B, k_tiles, tile))
    gidx = (top_tiles[:, :, None] * tile
            + torch.arange(tile, device=s.device)).reshape(B, k_tiles * tile)
    vals, pos = stable_topk(sel.reshape(B, k_tiles * tile), min(k, N))
    idxs = torch.gather(gidx, 1, pos)
    idxs = torch.where(torch.isfinite(vals), idxs, -1)
    return vals, idxs


def _tile_route(d: torch.Tensor, tile: int) -> bool:
    """Pass 3's kernel route: on the card, K4 at tile grain takes tiles of
    a multiple of 128 rows and depths of a multiple of 16."""
    return _on_card(d) and tile % SCORE_ROWS == 0 and d.shape[1] % 16 == 0


def _tile_scores(q: torch.Tensor, d: torch.Tensor, top_tiles: torch.Tensor,
                 bias_p: Optional[torch.Tensor], n_valid: int,
                 tile: int) -> torch.Tensor:
    """[B, KT*tile] exact scores of every row of the given tiles of the
    row-padded ``d`` (bias added; rows at or past ``n_valid``, dead rows
    and tiles past the end are -inf). Raw scores by ``tile_scores`` (K4 at
    tile grain) where ``_tile_route`` holds, else by its plain version;
    bias and validity are applied here, after the kernel, in both."""
    B, Dm = q.shape
    n_tiles = d.shape[0] // tile
    KT = top_tiles.shape[1]
    q3 = q.to(torch.bfloat16) if d.dtype == torch.bfloat16 else q
    tt_safe = top_tiles.clamp(max=n_tiles - 1)
    if _tile_route(d, tile):
        s = tile_scores(q3, d, tt_safe, tile)
    else:
        s = tile_scores_plain(q3, d, tt_safe, tile)
    s = s.view(B, KT, tile)
    # one additive row table: the bias, -inf at rows past n_valid
    add = bias_p.float() if bias_p is not None else None
    if n_valid < d.shape[0]:
        add = (add.clone() if add is not None
               else torch.zeros(d.shape[0], dtype=torch.float32, device=d.device))
        add[n_valid:] = NEG_INF
    if add is not None:
        s = s + add.view(n_tiles, tile)[tt_safe]
    s = s.masked_fill(~(top_tiles < n_tiles)[:, :, None], NEG_INF)
    return s.reshape(B, KT * tile)


def gather_tile_scores(
    queries: torch.Tensor,
    docs: torch.Tensor,
    top_tiles: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    tile: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scores of every doc in the given tiles: ([B, KT*tile] scores,
    [B, KT*tile] global doc ids). bf16 docs meet bf16-rounded queries with
    float32 accumulation. Rows past len(docs) and bias-dead docs score -inf.

    Route, by shape before any launch: on the card with D % 16 == 0 and
    tile % 128 == 0, kernel K4 at tile grain (``tile_scores``: the (query,
    tile) pairs sorted by tile, each tile's rows read once a group of
    queries, written straight to this [B, KT*tile] layout); otherwise, and
    for CPU tensors, its plain version (tile gather + ``einsum``)."""
    q = queries.float()
    N = docs.shape[0]
    d, bias_p, n_tiles, _ = _pad_rows(docs, bias, tile)
    KT = top_tiles.shape[1]
    s = _tile_scores(q, d, top_tiles, bias_p, N, tile)
    tt_safe = top_tiles.clamp(max=n_tiles - 1).long()
    gidx = (tt_safe[:, :, None] * tile
            + torch.arange(tile, device=q.device)).reshape(-1, KT * tile)
    return s, gidx


def tiled_dense_topk(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    tile: int = 128,
    bias: Optional[torch.Tensor] = None,
    with_stats: bool = False,
    probe_tiles: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Exact top-k via tile-max three-pass selection:
      pass 1: one sweep -> per-tile maxima (K1 on the card);
      pass 2: the k best tiles per query by their maxima;
      pass 3: rescore those tiles' docs exactly (K4 at tile grain on the
              card, ``gather_tile_scores``) and take the top-k.
    Exact by the tile-max argument (see tiled_matrix_topk).

    with_stats=True also returns (smin [B], smax [B]), the alive min/max of
    the raw scores. probe_tiles < k bounds pass 3 to that many tiles and
    appends a per-query ``covered`` flag: the result is exact iff covered
    (the k-th value >= the best unselected tile's max)."""
    q = queries.float()
    B = q.shape[0]
    N = docs.shape[0]
    d, bias_p, n_tiles, Np = _pad_rows(docs, bias, tile)
    q_mm = q.to(torch.bfloat16) if d.dtype == torch.bfloat16 else q
    outs1 = _sweep(q_mm, d, bias_p, N, n_tiles, tile, with_min=with_stats)
    tiles = outs1[0].T  # [B, n_tiles]

    if probe_tiles is not None and probe_tiles < min(k, n_tiles):
        k_gather = max(1, probe_tiles, -(-min(k, N) // tile))
        k_tiles = min(k_gather + 1, n_tiles)
    else:
        k_tiles = min(k, n_tiles)
        k_gather = k_tiles
    tmvals, top_tiles = stable_topk(tiles, k_tiles)
    next_tile_max = None
    if k_gather < k_tiles:
        next_tile_max = tmvals[:, k_gather]
        top_tiles = top_tiles[:, :k_gather]

    s3 = _tile_scores(q, d, top_tiles, bias_p, N, tile)
    k_eff = min(k, N)
    vals, sel3 = stable_topk(s3, k_eff)
    idxs = (torch.gather(top_tiles.clamp(max=n_tiles - 1), 1, sel3 // tile) * tile
            + sel3 % tile)
    idxs = torch.where(torch.isfinite(vals), idxs, -1)
    outs: Tuple[torch.Tensor, ...] = (vals, idxs)
    if with_stats:
        outs = outs + (outs1[1].amin(dim=0), tiles.amax(dim=1))
    if next_tile_max is not None:
        covered = ((vals[:, k_eff - 1] >= next_tile_max)
                   | ~torch.isfinite(next_tile_max))
        outs = outs + (covered,)
    elif probe_tiles is not None:
        outs = outs + (torch.ones(B, dtype=torch.bool, device=q.device),)
    return outs


def scan_dense_topk(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    block_n: int = 4096,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search (queries and docs L2-normalized)
    streamed over doc blocks: each [B, block_n] block product (plus
    ``bias``; rows past N score -inf) is merged into the running top-k
    with ``stable_topk``, the running entries first, so ties keep the lower
    doc id as ``jax.lax.top_k`` keeps it. Returns (values [B, k] float32,
    indices [B, k] int64); slots past N hold -inf / -1. No Pallas kernel
    backs the JAX function."""
    q = queries.float()
    d = docs
    B = q.shape[0]
    N = d.shape[0]
    nb = max(1, -(-N // block_n))
    q_mm = q.to(torch.bfloat16) if d.dtype == torch.bfloat16 else q
    vals = q.new_full((B, k), NEG_INF)
    idxs = torch.full((B, k), -1, dtype=torch.long, device=q.device)
    for i in range(nb):
        blk = d[i * block_n:(i + 1) * block_n]
        s = (q_mm @ blk.T).float()
        if bias is not None:
            s = s + bias[i * block_n:(i + 1) * block_n].float()[None, :]
        if blk.shape[0] < block_n:  # the padded tail of the last block
            s = torch.cat([s, s.new_full((B, block_n - blk.shape[0]), NEG_INF)], 1)
        gidx = i * block_n + torch.arange(block_n, device=q.device)
        vals, sel = stable_topk(torch.cat([vals, s], dim=1), k)
        idxs = torch.gather(torch.cat([idxs, gidx.expand(B, block_n)], dim=1), 1, sel)
    return vals, idxs


def scatter_topk_to_dense(values: torch.Tensor, indices: torch.Tensor,
                          n: int) -> torch.Tensor:
    """[B, n] scores with each row's top-k values scattered in, zeros
    elsewhere (the reference's FAISS-branch semantics)."""
    B = values.shape[0]
    out = torch.zeros((B, n), dtype=torch.float32, device=values.device)
    idx = indices.clamp(0, n - 1).long()
    vals = torch.where(indices >= 0, values.float(), 0.0)
    return out.scatter_add_(1, idx, vals)


def dense_topk(
    queries: torch.Tensor,
    docs: torch.Tensor,
    k: int,
    block_n: int = 4096,
    normalized: bool = True,
    use_tiled: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k dense search with the JAX package's dispatch: the tiled
    three-pass route (``tiled_dense_topk``: K1, then K4 at tile grain on the
    card) from ``4 * block_n`` docs while k <= 512, else ``scan_dense_topk``
    over blocks of ``min(block_n, N rounded up to 128)`` rows. The JAX
    tiled route's own scan block (at least 65,536 rows) has no counterpart:
    the port's sweep is one launch. ``normalized=False`` L2-normalizes both
    sides first."""
    N = docs.shape[0]
    k_eff = min(k, N)
    if not normalized:
        queries = l2_normalize(queries.float())
        docs = l2_normalize(docs.float())
    if use_tiled is None:
        use_tiled = N >= 4 * block_n and k_eff <= 512
    if use_tiled:
        return tiled_dense_topk(queries, docs, k_eff)
    return scan_dense_topk(queries, docs, k_eff,
                           block_n=min(block_n, -(-N // 128) * 128))


def quantize_corpus_int8(
    docs: torch.Tensor, tile: int = 128
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-doc symmetric int8 quantization of an L2-normalized corpus:
    (d8 [N, D] int8, scale [N] float32, tile_resid [n_tiles] float32) with
      d8_j = round(d_j / s_j * 127), s_j = max_i |d_j[i]| (half to even);
      resid_j = ||d_j - d8_j * s_j / 127||_2, computed exactly here;
      tile_resid[t] = the largest resid_j of tile t's docs.
    The per-doc step s_j / 127 keeps the sweep's error interval (and so
    ``int8_swept_topk``'s certificate slack) small."""
    d = docs.float()
    N = d.shape[0]
    scale = d.abs().amax(dim=1).clamp_min(1e-12)
    d8 = torch.round(d / scale[:, None] * 127.0).clamp(-127.0, 127.0)
    resid = (d - d8 * (scale[:, None] / 127.0)).square().sum(dim=1).sqrt()
    n_tiles = -(-N // tile)
    resid = torch.cat([resid, resid.new_zeros(n_tiles * tile - N)])
    return d8.to(torch.int8), scale, resid.view(n_tiles, tile).amax(dim=1)


# torch._int_mm (cuBLASLt's int8 product) takes more than 16 rows and
# depths and widths that are multiples of 8
_INT_MM_MIN_ROWS = 32
_INT_MM_ALIGN = 8


def _int8_product(q8: torch.Tensor, d8: torch.Tensor) -> torch.Tensor:
    """[B, n] int32 = q8 [B, D] int8 x d8 [n, D] int8 transposed, exact (the
    sums fit int32 far below D = 2^17). On the card ``torch._int_mm`` with
    the query rows padded to at least 32 and D to a multiple of 8 (zero
    rows and columns add nothing); on the CPU an int32 product."""
    if not q8.is_cuda:
        return q8.int() @ d8.int().T
    B, D = q8.shape
    Bp = max(_INT_MM_MIN_ROWS, -(-B // _INT_MM_ALIGN) * _INT_MM_ALIGN)
    pad_d = -D % _INT_MM_ALIGN
    q8p = torch.nn.functional.pad(q8, (0, pad_d, 0, Bp - B))
    if pad_d:
        d8 = torch.nn.functional.pad(d8, (0, pad_d))
    return torch._int_mm(q8p, d8.T)[:B]


def _quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(q8 [B, D] int8, inv [B], rq [B]): the queries quantized as the corpus
    is, each query's dequantization factor sq / 127^2 (times a doc's
    scale) and its exact error rq = ||q - q8 * sq / 127||."""
    sq = q.abs().amax(dim=1).clamp_min(1e-12)
    q8f = torch.round(q / sq[:, None] * 127.0).clamp(-127.0, 127.0)
    rq = (q - q8f * (sq[:, None] / 127.0)).square().sum(dim=1).sqrt()
    return q8f.to(torch.int8), sq / (127.0 * 127.0), rq


def _int8_tile_maxima(q8: torch.Tensor, inv: torch.Tensor, d8: torch.Tensor,
                      d_scale: torch.Tensor, bias_p: Optional[torch.Tensor],
                      n_valid: int, block_n: int, tile: int) -> torch.Tensor:
    """Pass 1 of ``int8_swept_topk``: [B, n_tiles] per-tile maxima of the
    dequantized int8 scores s32 * (inv * scale_j) of the row-padded ``d8``,
    over blocks of ``block_n`` rows; rows at or past ``n_valid`` and rows
    whose bias is below 0 (the 0 / -inf alive mask) are -inf."""
    B = q8.shape[0]
    Np = d8.shape[0]
    blk = max(tile, (min(block_n, Np) // tile) * tile)
    tile_hat = inv.new_empty((B, Np // tile))
    for b0 in range(0, Np, blk):
        b1 = min(b0 + blk, Np)
        s = _int8_product(q8, d8[b0:b1]).float() * (inv[:, None] * d_scale[None, b0:b1])
        dead = None
        if b1 > n_valid:
            dead = torch.arange(b0, b1, device=s.device) >= n_valid
        if bias_p is not None:
            dead_b = bias_p[b0:b1] < 0.0
            dead = dead_b if dead is None else dead | dead_b
        if dead is not None:
            s = s.masked_fill(dead[None, :], NEG_INF)
        tile_hat[:, b0 // tile:b1 // tile] = s.view(B, -1, tile).amax(dim=2)
    return tile_hat


def int8_swept_topk(
    queries: torch.Tensor,
    d8: torch.Tensor,
    d_scale: torch.Tensor,
    docs: torch.Tensor,
    tile_resid: torch.Tensor,
    k: int,
    probe_tiles: Optional[int] = None,
    block_n: int = 262144,
    tile: int = 128,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-when-certified top-k whose tile selection sweeps the int8 copy
    (``quantize_corpus_int8``) of the corpus ``docs`` [N, D]; ``queries``
    [B, D] L2-normalized. Returns (values [B, k'], ids [B, k'], covered [B]),
    k' = min(k, N):

      pass 1: the queries quantized alike (rq = ||q - q^||), the int8 x int8
              -> int32 product over blocks of ``block_n`` docs, and each
              tile's maximum of the dequantized scores s32 * (sq / 127^2 *
              s_j) (dead and overhang rows -inf);
      pass 2: tiles ranked by the sound bound tile_hat + rq + (1 + rq) *
              tile_resid (|q.d - q^.d^| <= rq + (1 + rq) r_j for unit q, d),
              ``k_gather = max(1, min(probe_tiles, n_tiles), ceil(k / tile))``
              of them taken, and one more as the witness;
      pass 3: every doc of the chosen tiles rescored exactly
              (``gather_tile_scores``: K4 at tile grain on the card), so the
              values are ``tiled_dense_topk``'s.

    covered[b] is the certificate: the k-th value is at least the best
    unchosen tile's bound (or every tile was chosen), so the row is exact.
    Callers escalate ``probe_tiles`` on the rows left uncovered.
    ``probe_tiles`` defaults to 4 * k. Ties go to the lower position, as
    ``jax.lax.top_k`` breaks them."""
    q = queries.float()
    B = q.shape[0]
    N = d8.shape[0]
    n_tiles = -(-N // tile)
    Np = n_tiles * tile
    if Np != N:
        d8 = torch.cat([d8, d8.new_zeros((Np - N, d8.shape[1]))])
        d_scale = torch.cat([d_scale, d_scale.new_zeros(Np - N)])
    bias_p = None
    if bias is not None:
        bias_p = torch.cat([bias.float(), bias.new_full((Np - N,), NEG_INF).float()])

    # -- pass 1: the int8 sweep -> dequantized tile maxima
    q8, inv, rq = _quantize_queries(q)
    tile_hat = _int8_tile_maxima(q8, inv, d8, d_scale, bias_p, N, block_n, tile)

    # -- pass 2: rank the tiles by their sound bounds
    delta = rq[:, None] + (1.0 + rq)[:, None] * tile_resid.float()[None, :]
    bounds = torch.where(torch.isfinite(tile_hat), tile_hat + delta, NEG_INF)
    if probe_tiles is None:
        probe_tiles = 4 * k
    k_gather = max(1, min(probe_tiles, n_tiles), -(-min(k, N) // tile))
    k_sel = min(k_gather + 1, n_tiles)  # + 1: the coverage witness
    if n_tiles > 4096:
        bvals, top_tiles = tiled_matrix_topk(bounds, k_sel)
        top_tiles = top_tiles.clamp_min(0)
    else:
        bvals, top_tiles = stable_topk(bounds, k_sel)
    if k_gather < k_sel:
        next_bound = bvals[:, k_gather]
        top_tiles = top_tiles[:, :k_gather]
    else:
        next_bound = q.new_full((B,), NEG_INF)

    # -- pass 3: the chosen tiles rescored exactly
    s3, gidx3 = gather_tile_scores(q, docs, top_tiles, bias, tile=tile)
    k_eff = min(k, N)
    if k_gather * tile > 4096:
        vals, sel3 = tiled_matrix_topk(s3, k_eff)
        sel3 = sel3.clamp_min(0)
    else:
        vals, sel3 = stable_topk(s3, k_eff)
    idxs = torch.gather(gidx3, 1, sel3)
    idxs = torch.where(torch.isfinite(vals), idxs, -1)
    covered = (vals[:, k_eff - 1] >= next_bound) | ~torch.isfinite(next_bound)
    return vals, idxs, covered
