"""At-scale hybrid top-k over the impact-pruned lexical arm.

Counterpart of ``NEG_INF``, ``HybridTopK``, ``_hybrid_impact_impl`` and
``hybrid_impact_topk`` of ``hybridsearch_tpu/ops/hybrid.py``: the fused
min-max (or max) hybrid of a ``layout="source"`` index at scale, without
[B, n] arrays:

  dense    exact top-K' and exact alive min/max in one sweep
           (ops/dense.py tiled_dense_topk, kernel K1 on the card);
  lexical  the top-cp prefix of each query term's impact run is its
           candidate set (kernel K6 slices the runs); the candidate union of
           both arms is rescored exactly over the pruned runs (kernel K7);
  margin   with hot descriptors, the best ``margin`` fused candidates get
           exact lexical scores (bisection over the full runs, minus the
           pruned prefix already counted) and are re-fused;
  exact    a per-query certificate: True only when the top-k provably
           equals full-corpus fusion.

The clustered tile hybrid (``hybrid_tile_topk``) of the JAX module is still
to port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.bm25 import cand_scores_bisect
from hybridsearch_tpu_torch.ops.dense import stable_topk, tiled_dense_topk
from hybridsearch_tpu_torch.ops.impact import onehot_rescore, slice_impact_runs

NEG_INF = float("-inf")


class HybridTopK(NamedTuple):
    values: torch.Tensor  # [B, k] fused scores (desc)
    indices: torch.Tensor  # [B, k] doc ids, -1 for empty slots
    exact: torch.Tensor  # [B] bool — True when the certificate holds


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
    if norm == "minmax":
        rng_s = smax - smin

        def nsem(x):
            return torch.where(rng_s[:, None] > eps,
                               (x - smin[:, None]) / rng_s[:, None].clamp_min(eps),
                               torch.ones_like(x))

        def nlex(x):
            return torch.where(lex_max[:, None] > eps,
                               x / lex_max[:, None].clamp_min(eps),
                               torch.ones_like(x))
    else:  # "max" (HybridBM25Pipeline quirk: divide by max only)
        def nsem(x):
            return torch.where(smax[:, None] > eps,
                               x / smax[:, None].clamp_min(eps), x)

        def nlex(x):
            return torch.where(lex_max[:, None] > eps,
                               x / lex_max[:, None].clamp_min(eps), x)

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
    margin: int = 128,
    kd_tiles: Optional[int] = None,
) -> HybridTopK:
    """Hybrid top-k at scale through the impact-pruned lexical arm: the
    fused semantics of the full hybrid over the pruned posting set, with a
    per-query ``exact`` flag that is True only when the result provably
    equals full-corpus fusion. q must be L2-normalized, docs pre-normalized.

    ``enc.full_postings`` = (doc_ids, weights) of the FULL doc-sorted CSR
    enables the hot-term margin correction when enc carries hot
    descriptors. The JAX function's ``block_n`` and ``bq`` tile the TPU's
    sweep and rescore and have no counterpart here."""
    N = docs.shape[0]
    dev = q.device
    p = min(p_depth, imp.p_max)
    hs = hl = hc = fdi = fwi = cc = ft = None
    if enc.hot_starts is not None and enc.full_postings is not None:
        hs, hl, hc = enc.hot_starts, enc.hot_lens, enc.hot_cols
        fdi, fwi = enc.full_postings
        if enc.corrected_complete is not None:
            cc = torch.from_numpy(np.asarray(enc.corrected_complete)).to(dev)
        if enc.full_touched is not None:
            ft = torch.from_numpy(np.asarray(enc.full_touched)).to(dev)
    return _hybrid_impact_impl(
        q, docs, imp.doc_ids, imp.weights, enc.starts, enc.lengths, enc.slack,
        torch.from_numpy(np.asarray(enc.complete)).to(dev), float(w_s),
        float(w_l), bias, int(N if n_alive is None else n_alive),
        hs, hl, hc, fdi, fwi, cc, ft,
        k=k, k_dense=k_dense, c_per_term=c_per_term, p_depth=p, norm=norm,
        margin=margin, kd_tiles=kd_tiles,
    )
