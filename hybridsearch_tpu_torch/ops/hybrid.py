"""At-scale hybrid top-k without [B, n] arrays.

Counterpart of ``hybridsearch_tpu/ops/hybrid.py``: three ways to the fused
min-max (or max) hybrid of the full corpus, each with a per-query
``exact`` certificate that is True only when the top-k provably equals
full-corpus fusion.

``hybrid_impact_topk`` (the impact ladder of a ``layout="source"`` index):

  dense    exact top-K' and exact alive min/max in one sweep
           (ops/dense.py tiled_dense_topk, kernel K1 on the card);
  lexical  the top-cp prefix of each query term's impact run is its
           candidate set (kernel K6 slices the runs); the candidate union of
           both arms is rescored exactly over the pruned runs (kernel K7);
  margin   with hot descriptors, the best ``margin`` fused candidates get
           exact lexical scores (bisection over the full runs, minus the
           pruned prefix already counted) and are re-fused.

``hybrid_tile_topk`` (the tile ladder of a clustered index): block-max WAND
on the fused score at 128-doc tile grain. Every tile gets an upper bound
from its exact semantic maximum (``dense_tile_stats``, K1) and its per-term
pruned weight maxima plus the truncation slack (K6 slices the runs); the
best ``kt`` tiles are probed and every doc in them scored exactly
(``gather_tile_scores``, K4 at tile grain; the pruned postings placed into
the resident buffer column by column), then the best ``margin`` get the
hot-term correction.

``hybrid_sparse_topk`` (a direct entry, on no searcher route): Fagin's
threshold algorithm over the full CSR. The dense arm's exact top-K' and
stats (K1); lexical tile bounds as sums of the run pieces' weights a
128-doc tile (hot terms: one row of their precomputed table), the top-M
tiles rescored exactly by binary search; the deduplicated union fused.

Every float sum that the JAX package takes with a scatter-add is taken in
a fixed order here (a column of a run holds a doc once; segment sums walk
their rows in order), so a batch repeats bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.bm25 import (
    BM25Postings,
    _cand_scores_runs,
    cand_scores_bisect,
)
from hybridsearch_tpu_torch.ops.dense import (
    dense_tile_stats,
    gather_tile_scores,
    stable_topk,
    tiled_dense_topk,
    tiled_matrix_topk,
)
from hybridsearch_tpu_torch.ops.impact import onehot_rescore, slice_impact_runs

NEG_INF = float("-inf")
TILE = 128


class HybridTopK(NamedTuple):
    values: torch.Tensor  # [B, k] fused scores (desc)
    indices: torch.Tensor  # [B, k] doc ids, -1 for empty slots
    exact: torch.Tensor  # [B] bool — True when the certificate holds


def _sem_norm(smin: torch.Tensor, smax: torch.Tensor, norm: str, eps: float = 1e-12):
    """The semantic normalizer: min-max over the alive stats, or divide by
    the max ("max", the HybridBM25Pipeline quirk)."""
    if norm == "minmax":
        rng_s = smax - smin

        def nsem(x):
            return torch.where(rng_s[:, None] > eps,
                               (x - smin[:, None]) / rng_s[:, None].clamp_min(eps),
                               torch.ones_like(x))
    else:
        def nsem(x):
            return torch.where(smax[:, None] > eps,
                               x / smax[:, None].clamp_min(eps), x)
    return nsem


def _normalizers(smin, smax, lex_max, norm: str, eps: float = 1e-12):
    """(nsem, nlex): the lexical arm's min is certified 0 by the caller, so
    min-max divides by the exact max; an all-zero arm normalizes to ones
    under min-max and stays as it is under "max"."""
    def nlex(x):
        return torch.where(lex_max[:, None] > eps,
                           x / lex_max[:, None].clamp_min(eps),
                           torch.ones_like(x) if norm == "minmax" else x)
    return _sem_norm(smin, smax, norm, eps), nlex


def _hybrid_impact_impl(
    q: torch.Tensor,  # [B, D] L2-normalized float32 queries
    docs: torch.Tensor,  # [N, D] L2-normalized rows
    imp_doc_ids: torch.Tensor,
    imp_weights: torch.Tensor,
    starts: torch.Tensor,  # [B, T]
    lengths: torch.Tensor,  # [B, T]
    slack: torch.Tensor,  # [B, T] tail bound at p_depth
    complete: torch.Tensor,  # [B] bool — all query terms fully covered
    w_s: float,
    w_l: float,
    bias: Optional[torch.Tensor],  # [N] 0/-inf alive mask or None
    n_alive: int,
    hot_starts: Optional[torch.Tensor],  # [B, Hm] full-CSR starts (or None)
    hot_lens: Optional[torch.Tensor],  # [B, Hm]
    hot_cols: Optional[torch.Tensor],  # [B, T] bool truncated columns
    full_doc_ids: Optional[torch.Tensor],  # full doc-sorted CSR arrays
    full_weights: Optional[torch.Tensor],
    corrected_complete: Optional[torch.Tensor],  # [B] bool (margin cert gate)
    full_touched: Optional[torch.Tensor],  # [B] int64 sum of FULL dfs
    k: int,
    k_dense: int,
    c_per_term: int,
    p_depth: int,
    norm: str,
    margin: int,
    kd_tiles: Optional[int] = None,
) -> HybridTopK:
    B, D = q.shape
    N = docs.shape[0]
    eps = 1e-12
    T = starts.shape[1]
    cp = min(c_per_term, p_depth)

    # -- dense arm: exact top-K' + exact alive min/max in one sweep. kd_tiles
    # bounds pass 3's tile gather; the coverage flag then gates both
    # certificates (an uncovered probe may under-estimate the K'-th value)
    kd = min(k_dense, N)
    if kd_tiles is not None:
        vals_d, idxs_d, smin, smax, dense_covered = tiled_dense_topk(
            q, docs, kd, bias=bias, with_stats=True, probe_tiles=kd_tiles)
    else:
        vals_d, idxs_d, smin, smax = tiled_dense_topk(
            q, docs, kd, bias=bias, with_stats=True)
        dense_covered = None

    # -- lexical arm: impact-run prefixes (K6)
    ids_r, ws_r = slice_impact_runs(imp_doc_ids, imp_weights, starts, lengths,
                                    p_depth=p_depth, n_docs=N)  # [B, T, p]
    ids_flat = ids_r.reshape(B, T * p_depth)
    ws_flat = ws_r.reshape(B, T * p_depth)
    # lexical candidates: the top-cp prefix of every term (impact order makes
    # the prefix the per-term argmax set)
    cand_l = ids_r[:, :, :cp].reshape(B, T * cp)
    # unseen-doc bound: a doc outside term t's top-cp has w_t <= the cp-th
    # kept weight (or the tail slack when the term was truncated shallower)
    wcp = torch.where(lengths > cp, ws_r[:, :, cp - 1], 0.0)
    tau_lex = torch.maximum(wcp, slack).sum(dim=1)  # [B]

    # -- rescore the full candidate union (K7)
    safe_d = torch.where(idxs_d >= 0, idxs_d, N + 2).to(torch.int32)
    cand_all = torch.cat([safe_d, cand_l], dim=1)  # [B, kd + T*cp] int32
    lex_all = onehot_rescore(cand_all, ids_flat, ws_flat, p_depth, N)
    alive_all = cand_all < N
    if bias is not None:
        alive_all = alive_all & (bias[cand_all.clamp(max=N - 1)] >= 0.0)
    lex_alive = torch.where(alive_all, lex_all, NEG_INF)
    lex_max = lex_alive.amax(dim=1).clamp_min(0.0)  # [B]
    cert_lexmax = lex_max >= tau_lex

    # semantic scores of the lexical candidates: gather rows + dot (the
    # dense arm's candidates already carry exact semantic values)
    d_sel = docs[cand_l.clamp(0, N - 1)]  # [B, T*cp, D]
    q_g = q.float()
    if docs.dtype == torch.bfloat16:
        q_g = q_g.to(torch.bfloat16).float()
    sem_l = torch.einsum("bcd,bd->bc", d_sel.float(), q_g)
    sem_all = torch.cat([vals_d, sem_l], dim=1)

    # -- normalization with exact semantic stats + pruned lexical max
    touched = lengths.long().sum(dim=1)  # [B] pruned postings touched
    lex_min_zero = touched < n_alive
    nsem, nlex = _normalizers(smin, smax, lex_max, norm)

    # the normalized K'-th dense value bounds every doc outside the dense arm
    nsem_kth = nsem(vals_d[:, -1:])[:, 0]
    lex_live = torch.where(alive_all, lex_all, 0.0)
    fused = w_s * nsem(sem_all) + w_l * nlex(lex_live)
    fused = torch.where(alive_all, fused, NEG_INF)

    # dedup docs in both arms: a stable sort by id keeps the first copy (the
    # dense arm's, whose score the sweep computed), kills the repeats
    ids_sorted, order = torch.sort(cand_all, dim=1, stable=True)
    fused_sorted = torch.gather(fused, 1, order)
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=q.device),
                     ids_sorted[:, 1:] == ids_sorted[:, :-1]], dim=1)
    fused_sorted = torch.where(dup, NEG_INF, fused_sorted)
    k_eff = min(k, cand_all.shape[1])

    margin_exact = None
    if hot_starts is not None:
        # margin correction: pruning drops the tails of stopword-grade runs.
        # Take a top-`margin` cushion by pruned fused score (never narrower
        # than k), make its lexical scores exact, re-fuse.
        c2 = min(max(margin, k_eff), ids_sorted.shape[1])
        sem_sorted = torch.gather(sem_all, 1, order)
        lex_sorted = torch.gather(lex_live, 1, order)
        mvals, mpos = stable_topk(fused_sorted, c2)
        mids = torch.gather(ids_sorted, 1, mpos)
        msem = torch.gather(sem_sorted, 1, mpos)
        mlex = torch.gather(lex_sorted, 1, mpos)
        malive = torch.isfinite(mvals)
        safe_m = torch.where(malive, mids, N + 2)
        full_hot = cand_scores_bisect(full_doc_ids, full_weights, hot_starts,
                                      hot_lens, safe_m)
        ws_hot = (ws_r * hot_cols[:, :, None]).reshape(B, T * p_depth)
        prefix_hot = onehot_rescore(safe_m, ids_flat, ws_hot, p_depth, N)
        mlex_corr = (mlex - prefix_hot + full_hot).clamp_min(0.0)
        lex_max2 = torch.maximum(
            lex_max, torch.where(malive, mlex_corr, 0.0).amax(dim=1))
        nsem_m = nsem(msem)
        nlex_m = torch.where(lex_max2[:, None] > eps,
                             mlex_corr / lex_max2[:, None].clamp_min(eps),
                             torch.ones_like(mlex_corr))
        fused_corr = torch.where(malive, w_s * nsem_m + w_l * nlex_m, NEG_INF)
        vals_f, pos2 = stable_topk(fused_corr, min(k_eff, c2))
        idxs_f = torch.gather(mids, 1, pos2)
        idxs_f = torch.where(torch.isfinite(vals_f), idxs_f, -1)

        # -- margin-path certificate (sound without `complete`): with every
        # truncated term bisected, the cushion's lexical scores are exact;
        # a doc outside the union has true lex <= tau_lex, one in the union
        # but not in the cushion has true lex <= pruned + S (S = total tail
        # slack). The global top-k is inside the cushion when both outside
        # bounds fall below the k-th corrected fused value.
        if corrected_complete is not None:
            S = slack.sum(dim=1)  # [B]
            sel_mask = torch.zeros(fused_sorted.shape, dtype=torch.bool,
                                   device=q.device).scatter_(1, mpos, True)
            pruned_out_max = torch.where(sel_mask, 0.0,
                                         lex_sorted.clamp_min(0.0)).amax(dim=1)
            cert_norm = ((lex_max2 >= tau_lex)
                         & (lex_max2 >= pruned_out_max + S))
            l2s = lex_max2.clamp_min(eps)
            tau_out = w_s * nsem_kth + w_l * tau_lex / l2s
            c2_vals = mvals[:, -1]
            tau_mid = torch.where(torch.isfinite(c2_vals),
                                  c2_vals + w_l * S / l2s, NEG_INF)
            kth_m = vals_f[:, -1]
            margin_exact = (corrected_complete & cert_norm
                            & (kth_m >= tau_out) & (kth_m >= tau_mid))
            if norm == "minmax":
                # the true lexical min is 0 only if some alive doc holds no
                # query term: that needs FULL dfs
                if full_touched is not None:
                    margin_exact = margin_exact & (full_touched < n_alive)
                else:
                    margin_exact = None
    else:
        vals_f, pos = stable_topk(fused_sorted, k_eff)
        idxs_f = torch.gather(ids_sorted, 1, pos)
        idxs_f = torch.where(torch.isfinite(vals_f), idxs_f, -1)

    # -- exactness certificate: sound only when every query term's FULL run
    # is covered (`complete`): candidate scores are then true scores, tau_lex
    # bounds every non-candidate doc, and sem <= the K'-th dense value
    # outside the dense candidates
    tau = w_s * nsem_kth + w_l * nlex(tau_lex[:, None])[:, 0]
    kth = vals_f[:, -1]
    # slicing shallower than the encoded runs drops tail entries from the
    # rescore: never exact then
    sliced_full = (lengths <= p_depth).all(dim=1)
    if dense_covered is not None:
        sliced_full = sliced_full & dense_covered
    cert = complete & sliced_full & cert_lexmax
    if norm == "minmax":
        cert = cert & lex_min_zero
    exact = ((kth >= tau) | ~torch.isfinite(kth)) & cert
    if margin_exact is not None:
        # the margin-path certificate covers queries with truncated terms
        # the `complete` gate can never certify
        exact = exact | (margin_exact & sliced_full)
    return HybridTopK(values=vals_f, indices=idxs_f, exact=exact)


def hybrid_impact_topk(
    q: torch.Tensor,
    docs: torch.Tensor,
    imp,  # ImpactPostings
    enc,  # ImpactQueryEnc
    k: int,
    w_s: float,
    w_l: float,
    bias: Optional[torch.Tensor] = None,
    k_dense: int = 512,
    c_per_term: int = 64,
    p_depth: int = 1024,
    norm: str = "minmax",
    n_alive: Optional[int] = None,
    full_postings: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    margin: int = 128,
    kd_tiles: Optional[int] = None,
) -> HybridTopK:
    """Hybrid top-k at scale through the impact-pruned lexical arm: the
    fused semantics of the full hybrid over the pruned posting set, with a
    per-query ``exact`` flag that is True only when the result provably
    equals full-corpus fusion. q must be L2-normalized, docs pre-normalized.

    ``full_postings`` = (doc_ids, weights) of the FULL doc-sorted CSR
    (``enc.full_postings`` when None) enables the hot-term margin
    correction when enc carries hot descriptors. The JAX function's
    ``block_n`` and ``bq`` tile the TPU's sweep and rescore and have no
    counterpart here."""
    N = docs.shape[0]
    dev = q.device
    return _hybrid_impact_impl(
        q, docs, imp.doc_ids, imp.weights, enc.starts, enc.lengths, enc.slack,
        torch.from_numpy(np.asarray(enc.complete)).to(dev), float(w_s),
        float(w_l), bias, int(N if n_alive is None else n_alive),
        *_hot_args(enc, full_postings, dev),
        k=k, k_dense=k_dense, c_per_term=c_per_term,
        p_depth=min(p_depth, imp.p_max), norm=norm, margin=margin,
        kd_tiles=kd_tiles,
    )


def _hybrid_tile_impl(
    q: torch.Tensor,  # [B, D] L2-normalized float32 queries
    docs: torch.Tensor,  # [N, D] L2-normalized rows, N % 128 == 0
    imp_doc_ids: torch.Tensor,
    imp_weights: torch.Tensor,
    starts: torch.Tensor,  # [B, T]
    lengths: torch.Tensor,  # [B, T]
    slack: torch.Tensor,  # [B, T]
    complete: torch.Tensor,  # [B] bool
    w_s: float,
    w_l: float,
    bias: Optional[torch.Tensor],
    n_alive: int,
    hot_starts: Optional[torch.Tensor],
    hot_lens: Optional[torch.Tensor],
    hot_cols: Optional[torch.Tensor],
    full_doc_ids: Optional[torch.Tensor],
    full_weights: Optional[torch.Tensor],
    corrected_complete: Optional[torch.Tensor],
    full_touched: Optional[torch.Tensor],
    k: int,
    kt: int,
    p_depth: int,
    norm: str,
    margin: int,
) -> HybridTopK:
    B = q.shape[0]
    N = docs.shape[0]
    dev = q.device
    n_tiles = -(-N // TILE)
    eps = 1e-12
    T = starts.shape[1]

    # -- dense arm: exact per-tile maxima + exact alive min/max, one sweep (K1)
    tile_sem, smin, smax = dense_tile_stats(q, docs, bias)

    # -- lexical arm: pruned run prefixes (K6)
    ids_r, ws_r = slice_impact_runs(imp_doc_ids, imp_weights, starts, lengths,
                                    p_depth=p_depth, n_docs=N)  # [B, T, p]
    W = T * p_depth
    ids_l = ids_r.long()
    ids_flat = ids_l.reshape(B, W)
    ws_flat = ws_r.reshape(B, W)
    tids = ids_flat // TILE  # sentinel ids land on n_tiles: the spare column
    S = slack.sum(dim=1)  # [B] per-doc missing-mass bound

    # per-term per-tile MAX weights, the block-max bound at tile grain: a doc
    # of tile τ scores at most Σ_t max(tile-max of term t in τ, slack_t). The
    # maximum is free of order; the spare column takes the sentinels.
    lex_bound_tile = torch.zeros((B, n_tiles), dtype=torch.float32, device=dev)
    tids_r = (ids_l // TILE).clamp(max=n_tiles)  # [B, T, p]
    for t in range(T):
        bm_t = torch.zeros((B, n_tiles + 1), dtype=torch.float32, device=dev)
        bm_t.scatter_reduce_(1, tids_r[:, t], ws_r[:, t], reduce="amax")
        lex_bound_tile = lex_bound_tile + torch.maximum(bm_t[:, :n_tiles],
                                                        slack[:, t:t + 1])

    # -- joint bound + probe selection
    nsem = _sem_norm(smin, smax, norm, eps)
    L0 = lex_bound_tile.amax(dim=1).clamp_min(eps)
    bound0 = w_s * nsem(tile_sem) + w_l * lex_bound_tile / L0[:, None]
    kt_eff = min(kt, n_tiles)
    if n_tiles > 8192:
        _, top_tiles = tiled_matrix_topk(bound0, kt_eff)
        top_tiles = top_tiles.clamp_min(0)
    else:
        _, top_tiles = stable_topk(bound0, kt_eff)
    ts = torch.sort(top_tiles, dim=1).values  # ascending: bisect + buffer order

    # -- resident scores: semantic by tile (K4 at tile grain), lexical by
    # placing each pruned posting into its probed tile's buffer slot
    s3, gidx3 = gather_tile_scores(q, docs, ts, bias)  # [B, R]
    R = kt_eff * TILE
    alive_res = torch.isfinite(s3)
    pos_c = torch.searchsorted(ts, tids).clamp(0, kt_eff - 1)  # [B, W]
    hit = torch.gather(ts, 1, pos_c) == tids
    bufidx = torch.where(hit, pos_c * TILE + ids_flat % TILE, R)  # R: dropped

    def place(ws):
        # a column (one term's slice) names a doc at most once, so each
        # scatter_add_ touches distinct slots and every slot sums its terms
        # in column order, as the JAX package's index-order add does
        buf = torch.zeros((B, R + 1), dtype=torch.float32, device=dev)
        for t in range(T):
            cols = slice(t * p_depth, (t + 1) * p_depth)
            buf.scatter_add_(1, bufidx[:, cols], ws[:, cols])
        return buf[:, :R]

    lex_res = torch.where(alive_res, place(ws_flat), 0.0)
    lex_max1 = lex_res.amax(dim=1)  # [B] >= 0
    L1 = lex_max1.clamp_min(eps)
    fused0 = w_s * nsem(s3) + w_l * lex_res / L1[:, None]
    fused0 = torch.where(alive_res, fused0, NEG_INF)

    # -- cushion: exact lexical correction for the top-`margin` fused
    k_eff = min(k, R)
    c2 = min(max(margin, k_eff), R)
    if R > 4096:
        mvals, mpos = tiled_matrix_topk(fused0, c2)
        mpos = mpos.clamp_min(0)
    else:
        mvals, mpos = stable_topk(fused0, c2)
    mids = torch.gather(gidx3, 1, mpos)
    msem = torch.gather(s3, 1, mpos)
    mlex = torch.gather(lex_res, 1, mpos)
    malive = torch.isfinite(mvals)
    safe_m = torch.where(malive, mids, N + 2)
    if hot_starts is not None:
        full_hot = cand_scores_bisect(full_doc_ids, full_weights, hot_starts,
                                      hot_lens, safe_m)
        # the truncated columns' pruned prefix, placed like lex_res
        hot_res = place((ws_r * hot_cols[:, :, None]).reshape(B, W))
        prefix_hot = torch.gather(hot_res, 1, mpos)
        mlex_corr = (mlex - prefix_hot + full_hot).clamp_min(0.0)
    else:
        mlex_corr = mlex
    lex_max2 = torch.maximum(lex_max1,
                             torch.where(malive, mlex_corr, 0.0).amax(dim=1))
    L2 = lex_max2.clamp_min(eps)
    fused_corr = torch.where(malive, w_s * nsem(msem) + w_l * mlex_corr / L2[:, None],
                             NEG_INF)
    vals_f, pos2 = stable_topk(fused_corr, min(k_eff, c2))
    idxs_f = torch.gather(mids, 1, pos2)
    idxs_f = torch.where(torch.isfinite(vals_f), idxs_f, -1)

    # -- certificate: (a) no unprobed tile's joint bound under the final
    # normalizers reaches the k-th result; (b) no probed doc outside the
    # cushion can, with its slack; (c) lex_max2 is the true global lexical
    # max; (d) min-max: the true lexical min is 0 (sem stats: a full sweep)
    kth = vals_f[:, -1]
    probed = torch.zeros((B, n_tiles), dtype=torch.bool, device=dev)
    probed.scatter_(1, ts, True)
    bound_f = w_s * nsem(tile_sem) + w_l * lex_bound_tile / L2[:, None]
    tau_tile = torch.where(probed, NEG_INF, bound_f).amax(dim=1)
    c2_vals = mvals[:, -1]
    tau_mid = torch.where(torch.isfinite(c2_vals), c2_vals + w_l * S / L2, NEG_INF)
    sel_mask = torch.zeros((B, R), dtype=torch.bool, device=dev)
    sel_mask.scatter_(1, mpos, True)
    pruned_out_max = torch.where(sel_mask, 0.0, lex_res.clamp_min(0.0)).amax(dim=1)
    lex_unprobed = torch.where(probed, NEG_INF, lex_bound_tile).amax(dim=1).clamp_min(0.0)
    cert_norm = (lex_max2 >= pruned_out_max + S) & (lex_max2 >= lex_unprobed)
    cc = complete if corrected_complete is None else complete | corrected_complete
    exact = (cc & cert_norm
             & ((kth >= tau_tile) | ~torch.isfinite(tau_tile))
             & ((kth >= tau_mid) | ~torch.isfinite(tau_mid)))
    if norm == "minmax":
        if full_touched is not None:
            exact = exact & (full_touched < n_alive)
        else:
            exact = exact & complete & (lengths.long().sum(dim=1) < n_alive)
        # an all-zero lexical arm min-max-normalizes to ones in full fusion
        # (and in the other two hybrids): every doc gains w_l, which moves no
        # rank and no certificate. The JAX function adds 0 here (ROADMAP R8).
        vals_f = torch.where(lex_max2[:, None] > eps, vals_f, vals_f + w_l)
    return HybridTopK(values=vals_f, indices=idxs_f, exact=exact)


def _hot_args(enc, full_postings, dev):
    """(hot_starts, hot_lens, hot_cols, full doc_ids, full weights,
    corrected_complete, full_touched) for the margin correction when enc
    carries hot descriptors and the full CSR is known, else all None."""
    if full_postings is None:
        full_postings = enc.full_postings
    if enc.hot_starts is None or full_postings is None:
        return (None,) * 7
    cc = ft = None
    if enc.corrected_complete is not None:
        cc = torch.from_numpy(np.asarray(enc.corrected_complete)).to(dev)
    if enc.full_touched is not None:
        ft = torch.from_numpy(np.asarray(enc.full_touched)).to(dev)
    return (enc.hot_starts, enc.hot_lens, enc.hot_cols, *full_postings, cc, ft)


def hybrid_tile_topk(
    q: torch.Tensor,
    docs: torch.Tensor,
    imp,  # ImpactPostings
    enc,  # ImpactQueryEnc
    k: int,
    w_s: float,
    w_l: float,
    bias: Optional[torch.Tensor] = None,
    kt: int = 128,
    p_depth: int = 1024,
    norm: str = "minmax",
    n_alive: Optional[int] = None,
    full_postings: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    margin: int = 128,
) -> HybridTopK:
    """Tile-resident joint-bound hybrid (clustered layouts). The fused
    semantics and HybridTopK contract of ``hybrid_impact_topk``, with
    ``exact`` sound a query; ``kt`` is the probe budget in 128-doc tiles
    (the searcher's tile ladder escalates it). q must be L2-normalized,
    docs pre-normalized with docs.shape[0] % 128 == 0. The JAX function's
    ``block_n`` tiles the TPU's sweep and has no counterpart here."""
    N = docs.shape[0]
    dev = q.device
    return _hybrid_tile_impl(
        q, docs, imp.doc_ids, imp.weights, enc.starts, enc.lengths, enc.slack,
        torch.from_numpy(np.asarray(enc.complete)).to(dev), float(w_s),
        float(w_l), bias, int(N if n_alive is None else n_alive),
        *_hot_args(enc, full_postings, dev),
        k=k, kt=kt, p_depth=min(p_depth, imp.p_max), norm=norm, margin=margin)


def _bm25_tile_bounds(doc_ids: torch.Tensor, weights: torch.Tensor,
                      starts: torch.Tensor, lengths: torch.Tensor,
                      n_tiles: int) -> torch.Tensor:
    """[B, n_tiles] per-tile SUMS of the posting weights of each query's run
    pieces (starts/lengths [B, T]): an upper bound on any one doc's score in
    the tile, since weights are >= 0. Only the pieces' own entries are read.
    A piece is doc-sorted, so its entries of one tile are contiguous: a
    segment sum walks each (piece, tile) in row order, and a second one adds
    a cell's pieces in term order after a stable sort; neither uses atomics,
    so the sums repeat bit for bit. Docs past n_tiles * 128 are dropped."""
    B, T = starts.shape
    dev = doc_ids.device
    out = torch.zeros((B, n_tiles), dtype=torch.float32, device=dev)
    ln = lengths.long().reshape(-1)
    total = int(ln.sum())
    if total == 0:
        return out
    piece = torch.repeat_interleave(torch.arange(B * T, device=dev), ln,
                                    output_size=total)
    first = torch.cumsum(ln, 0) - ln  # flat offset of each piece's first entry
    pos = starts.long().reshape(-1)[piece] + torch.arange(total, device=dev) - first[piece]
    tile = doc_ids[pos].long() // TILE
    keep = tile < n_tiles
    key = piece[keep] * n_tiles + tile[keep]  # non-decreasing
    seg, counts = torch.unique_consecutive(key, return_counts=True)
    sums = torch.segment_reduce(weights[pos][keep], "sum", lengths=counts,
                                unsafe=True)
    cell = (seg // (T * n_tiles)) * n_tiles + seg % n_tiles
    cell, order = torch.sort(cell, stable=True)
    cells, counts = torch.unique_consecutive(cell, return_counts=True)
    out.view(-1)[cells] = torch.segment_reduce(sums[order], "sum", lengths=counts,
                                               unsafe=True)
    return out


def _hybrid_sparse_impl(
    q: torch.Tensor,  # [B, D] L2-normalized float32 queries
    docs: torch.Tensor,  # [N, D] L2-normalized rows, N % 128 == 0
    po_doc_ids: torch.Tensor,
    po_weights: torch.Tensor,
    groups: Sequence[Tuple[int, torch.Tensor, torch.Tensor]],
    hot_rows: Optional[torch.Tensor],  # [B, Hm] rows into hot_bounds (pad = H)
    hot_starts: Optional[torch.Tensor],  # [B, Hm] hot-term run starts
    hot_lens: Optional[torch.Tensor],  # [B, Hm] hot-term run lengths (0 = pad)
    hot_bounds: Optional[torch.Tensor],  # [H+1, >= n_tiles] per-tile sums
    w_s: float,
    w_l: float,
    bias: Optional[torch.Tensor],  # [N] 0/-inf alive mask or None
    lex_min_zero: torch.Tensor,  # [B] bool host certificate
    k: int,
    k_dense: int,
    m_tiles: int,
    c_lex: int,
    norm: str,
) -> HybridTopK:
    B = q.shape[0]
    N = docs.shape[0]
    dev = q.device
    n_tiles = N // TILE

    # -- dense arm: exact top-K' + exact alive min/max in one sweep (K1)
    kd = min(k_dense, N)
    vals_d, idxs_d, smin, smax = tiled_dense_topk(q, docs, kd, bias=bias,
                                                  with_stats=True)

    # -- lexical arm: tile bounds -> top-M tiles -> exact rescore
    m_eff = min(m_tiles, n_tiles)
    bounds = torch.zeros((B, n_tiles), dtype=torch.float32, device=dev)
    for _w, starts, lengths in groups:
        bounds = bounds + _bm25_tile_bounds(po_doc_ids, po_weights, starts,
                                            lengths, n_tiles)
    if hot_rows is not None:
        # hot terms: one precomputed tile-bound row gather a term
        hb = hot_bounds[:, :n_tiles]
        for j in range(hot_rows.shape[1]):
            bounds = bounds + hb[hot_rows[:, j].long()]
    if n_tiles > 65536:
        bvals, btiles = tiled_matrix_topk(bounds, m_eff)
        btiles = btiles.clamp_min(0)
    else:
        bvals, btiles = stable_topk(bounds, m_eff)
    # unseen-tile score bound; with every tile a candidate, the floor 0
    tau_b = (bvals[:, -1] if m_eff < n_tiles
             else torch.zeros(B, dtype=torch.float32, device=dev))

    cand = (btiles[:, :, None] * TILE
            + torch.arange(TILE, device=dev)).reshape(B, m_eff * TILE)
    safe_c = torch.where(cand < N, cand, N + 2)

    def lexical(cands):
        acc = torch.zeros(cands.shape, dtype=torch.float32, device=dev)
        for width, starts, lengths in groups:
            acc = acc + _cand_scores_runs(po_doc_ids, po_weights, starts, lengths,
                                          cands, N, width)
        if hot_rows is not None:
            acc = acc + cand_scores_bisect(po_doc_ids, po_weights, hot_starts,
                                           hot_lens, cands)
        return acc

    lex_c = lexical(safe_c)
    alive_c = cand < N
    if bias is not None:
        alive_c = alive_c & (bias[cand.clamp(max=N - 1)] >= 0)
    lex_c_m = torch.where(alive_c, lex_c, NEG_INF)
    lex_max = lex_c_m.amax(dim=1)  # [B]
    # the global alive lexical max lies in the candidate tiles (every other
    # tile's bound <= tau_b <= lex_max)
    cert_lexmax = lex_max >= tau_b

    ce = min(c_lex, m_eff * TILE)
    lex_sel_vals, sel_pos = stable_topk(lex_c_m, ce)  # [B, C']
    ids_lex = torch.gather(cand, 1, sel_pos)
    alive_lex = torch.isfinite(lex_sel_vals)
    # semantic scores of the lexical candidates: gather rows + dot (bf16
    # docs meet bf16-rounded queries, float32 sums, as the dense arm)
    d_sel = docs[ids_lex.clamp(0, N - 1)]  # [B, C', D]
    q_g = q.float()
    if docs.dtype == torch.bfloat16:
        q_g = q_g.to(torch.bfloat16).float()
    sem_lex = torch.einsum("bcd,bd->bc", d_sel.float(), q_g)

    # lexical scores of the dense candidates (exact CSR binary search)
    lex_d = lexical(torch.where(idxs_d >= 0, idxs_d, N + 2))

    # -- fuse the candidate union under the exact global statistics
    nsem, nlex = _normalizers(smin, smax, lex_max, norm)
    ids_all = torch.cat([idxs_d, ids_lex], dim=1)  # [B, K'+C']
    sem_all = torch.cat([vals_d, sem_lex], dim=1)
    lex_all = torch.cat([lex_d, lex_sel_vals], dim=1)
    alive_all = torch.cat([torch.isfinite(vals_d), alive_lex], dim=1)
    fused = w_s * nsem(sem_all) + w_l * nlex(torch.where(alive_all, lex_all, 0.0))
    fused = torch.where(alive_all, fused, NEG_INF)

    # dedup docs in both arms: a stable sort by id keeps the dense arm's copy
    ids_sorted, order = torch.sort(ids_all, dim=1, stable=True)
    fused_sorted = torch.gather(fused, 1, order)
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                     ids_sorted[:, 1:] == ids_sorted[:, :-1]], dim=1)
    fused_sorted = torch.where(dup, NEG_INF, fused_sorted)
    k_eff = min(k, ids_all.shape[1])
    vals_f, pos = stable_topk(fused_sorted, k_eff)
    idxs_f = torch.gather(ids_sorted, 1, pos)
    idxs_f = torch.where(torch.isfinite(vals_f), idxs_f, -1)

    # -- TA certificate: an unseen doc has sem <= the K'-th dense value and
    # lex <= max(tau_b, the C'-th lexical candidate)
    lex_bound = torch.maximum(tau_b, lex_sel_vals[:, -1])
    tau = (w_s * nsem(vals_d[:, -1:])[:, 0]
           + w_l * nlex(lex_bound.clamp_min(0.0)[:, None])[:, 0])
    kth = vals_f[:, k_eff - 1]
    cert = cert_lexmax
    if norm == "minmax":  # min-max needs the lexical min too: 0 when certified
        cert = cert & lex_min_zero
    # a -inf k-th value means fewer than k alive docs: all retrieved
    exact = ((kth >= tau) | ~torch.isfinite(kth)) & cert
    return HybridTopK(values=vals_f, indices=idxs_f, exact=exact)


def hybrid_sparse_topk(
    q: torch.Tensor,
    docs: torch.Tensor,
    postings: BM25Postings,
    groups: Sequence[Tuple[int, np.ndarray, np.ndarray]],
    k: int,
    w_s: float,
    w_l: float,
    bias: Optional[torch.Tensor] = None,
    k_dense: int = 128,
    m_tiles: int = 64,
    c_lex: int = 512,
    norm: str = "minmax",
    n_alive: Optional[int] = None,
    hot: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> HybridTopK:
    """Exact hybrid top-k at scale through the full CSR, without [B, N]
    arrays. q must be L2-normalized; docs pre-normalized with
    docs.shape[0] % 128 == 0. ``groups`` and ``hot`` come from
    ``BM25.encode_queries_sparse`` (the run pieces with the hot terms left
    out; the hot terms' table rows and runs). Returns per-query ``exact``
    flags; callers escalate (k_dense, m_tiles) or fall back to full fusion
    when False. The JAX function's ``block_n`` has no counterpart here."""
    B = q.shape[0]
    N = docs.shape[0]
    dev = q.device
    n_tiles = N // TILE
    hot_rows = hot_starts = hot_lens = hot_bounds = None
    if hot is not None:
        hot_rows, hot_starts, hot_lens = (torch.from_numpy(np.asarray(a)).to(dev)
                                          for a in hot)
        hot_bounds = postings.hot_tile_bounds
        if hot_bounds.shape[1] < n_tiles:  # capacity-padded doc matrix
            hot_bounds = torch.nn.functional.pad(
                hot_bounds, (0, n_tiles - hot_bounds.shape[1]))
    # lexical-min-is-zero certificate: postings touched < alive docs
    n_alive = N if n_alive is None else n_alive
    touched = np.zeros(B, dtype=np.int64)
    for _w, _st, ln in groups:
        touched += np.asarray(ln).sum(axis=1)
    if hot is not None:
        touched += np.asarray(hot[2]).sum(axis=1)
    dev_groups = [(int(w), torch.from_numpy(np.asarray(st)).to(dev),
                   torch.from_numpy(np.asarray(ln)).to(dev)) for w, st, ln in groups]
    return _hybrid_sparse_impl(
        q, docs, postings.doc_ids, postings.weights, dev_groups, hot_rows,
        hot_starts, hot_lens, hot_bounds, float(w_s), float(w_l), bias,
        torch.from_numpy(touched < n_alive).to(dev),
        k=k, k_dense=k_dense, m_tiles=m_tiles, c_lex=c_lex, norm=norm)
