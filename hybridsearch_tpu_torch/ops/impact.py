"""Impact-ordered pruned postings — the lexical arm of the at-scale hybrid
on a ``layout="source"`` index.

Counterpart of ``hybridsearch_tpu/ops/impact.py``:

  build   per term, keep the P highest-weight postings, stored
          weight-descending ("impact order"), plus the P-th weight as the
          tail bound (slack). Terms with df <= P are complete (slack 0).
  query   the top-Cp lexical candidates of a term are the first Cp entries
          of its pruned run: a contiguous slice (kernel K6, ``slice_runs``).
          A doc outside a term's top-Cp has at most that term's Cp-th
          weight.
  rescore the candidates' exact pruned scores (kernel K7, ``rescore``): a
          per-query hash table of candidate ids in shared memory, filled
          column by column from the sliced runs.

Scores are exact over the PRUNED entries; ``hybrid_impact_topk``
(ops/hybrid.py) reports per query whether the fused top-k provably equals
full-corpus fusion.

The JAX module's run-start alignment (``align``) and its row-gather and DMA
slice paths exist for the TPU's DMA tiling; runs here start anywhere. Its
sort-merge rescore is the TPU's default route to K7's function and is not
a path of the port.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.cuda_impact import rescore, slice_runs

# Per-query term-count pad ladder (ops/bm25.py TERM_LADDER's role).
IMPACT_T_LADDER = (8, 16, 32)
# Serving-time slice depths.
IMPACT_P_LADDER = (256, 1024, 4096)
# hot (bisected) terms a query may carry, padded to this ladder
_HOT_H_LADDER = (1, 2, 4)


class ImpactPostings(NamedTuple):
    """Device-resident impact-ordered pruned postings (term-major CSR).

    doc_ids/weights are weight-descending within each term's run and
    padded with one extra run of ``p_max`` sentinel entries (doc_id =
    n_docs, weight = 0) so every slice of width <= p_max is in bounds."""

    doc_ids: torch.Tensor  # [nnz_pruned + p_max] int32
    weights: torch.Tensor  # [nnz_pruned + p_max] float32
    n_docs: int
    p_max: int  # build-time prune depth
    starts_host: np.ndarray  # [V] int64 run starts
    lengths_host: np.ndarray  # [V] int64 pruned run lengths (= min(df, P))
    slack_host: np.ndarray  # [V] f32 — P-th weight when df > P else 0
    weights_host: np.ndarray  # [nnz_pruned] f32 — for depth-d slack lookups
    df_host: np.ndarray  # [V] int64 full document frequencies


def build_impact_postings(
    term_ids: np.ndarray,
    doc_ids: np.ndarray,
    weights: np.ndarray,
    n_docs: int,
    vocab_size: int,
    p_max: int = IMPACT_P_LADDER[-1],
    device: Optional[torch.device] = None,
) -> ImpactPostings:
    """Host-side build from COO (term, doc, weight) triples: one lexsort
    (term asc, weight desc) and one vectorized prefix mask, then the arrays
    move to ``device``."""
    t = np.asarray(term_ids, dtype=np.int64)
    d = np.asarray(doc_ids, dtype=np.int64)
    w = np.asarray(weights, dtype=np.float32)
    order = np.lexsort((-w, t))
    t, d, w = t[order], d[order], w[order]
    df = np.bincount(t, minlength=vocab_size).astype(np.int64)
    starts_full = np.concatenate([[0], np.cumsum(df)])
    pos_in_run = np.arange(len(t), dtype=np.int64) - starts_full[t]
    keep = pos_in_run < p_max
    imp_d = d[keep].astype(np.int32)
    imp_w = w[keep].astype(np.float32)
    keep_len = np.minimum(df, p_max)
    imp_starts = np.concatenate([[0], np.cumsum(keep_len)])[:-1]
    # slack: weight at position p_max-1 of each truncated run
    slack = np.zeros(vocab_size, dtype=np.float32)
    trunc = df > p_max
    if trunc.any():
        slack[trunc] = w[starts_full[:-1][trunc] + p_max - 1]
    d_pad = np.concatenate([imp_d, np.full(p_max, n_docs, np.int32)])
    w_pad = np.concatenate([imp_w, np.zeros(p_max, np.float32)])
    dev = torch.device("cpu") if device is None else device
    return ImpactPostings(
        doc_ids=torch.from_numpy(d_pad).to(dev),
        weights=torch.from_numpy(w_pad).to(dev),
        n_docs=n_docs,
        p_max=p_max,
        starts_host=imp_starts.astype(np.int64),
        lengths_host=keep_len.astype(np.int64),
        slack_host=slack,
        weights_host=imp_w,
        df_host=df,
    )


class ImpactQueryEnc(NamedTuple):
    """Encoded query batch against an ImpactPostings tier."""

    starts: torch.Tensor  # [B, T] int32 pruned-run starts (pad -> sentinel run)
    lengths: torch.Tensor  # [B, T] int32 pruned-run lengths (pad -> 0)
    slack: torch.Tensor  # [B, T] f32 per-term tail bound AT the encode depth
    complete: np.ndarray  # [B] bool — every query term's full run covered
    certifiable_deeper: np.ndarray  # [B] bool — complete achievable at p_max
    t_pad: int
    # [B] bool — every truncated term carries a hot (bisect) descriptor and
    # no term was dropped: the margin correction then gives exact lexical
    # scores for the cushion, enabling the margin-path certificate
    corrected_complete: Optional[np.ndarray] = None
    # [B] int64 — sum of FULL dfs of the query's terms; full_touched <
    # n_alive certifies the true lexical min is 0
    full_touched: Optional[np.ndarray] = None
    # hot-term margin correction: FULL doc-sorted run descriptors of the
    # terms truncated at the encode depth, and which columns they occupy
    hot_starts: Optional[torch.Tensor] = None  # [B, Hm] int32 into full CSR
    hot_lens: Optional[torch.Tensor] = None  # [B, Hm] int32 (0 = pad)
    hot_cols: Optional[torch.Tensor] = None  # [B, T] bool — truncated columns
    # (doc_ids, weights) of the FULL doc-sorted CSR the hot descriptors
    # index into, attached from the same state snapshot as the tier
    full_postings: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def encode_impact_queries(
    imp: ImpactPostings,
    query_term_ids: Sequence[Sequence[int]],
    p_depth: Optional[int] = None,
    full_starts: Optional[np.ndarray] = None,
    full_lengths: Optional[np.ndarray] = None,
) -> ImpactQueryEnc:
    """Host-side encode: term-id lists -> padded [B, T] run descriptors on
    the tier's device.

    p_depth (<= p_max) limits the slice depth; the per-term slack is then
    the weight at position p_depth-1. With full_starts/full_lengths (the
    full doc-sorted CSR's run table), terms truncated at this depth also
    get hot descriptors for the margin correction."""
    p = imp.p_max if p_depth is None else min(p_depth, imp.p_max)
    B = len(query_term_ids)
    longest = max((len(ids) for ids in query_term_ids), default=1)
    t_pad = next((t for t in IMPACT_T_LADDER if t >= longest),
                 IMPACT_T_LADDER[-1])
    sentinel_start = len(imp.weights_host)  # the all-pad tail run
    st = np.full((B, t_pad), sentinel_start, dtype=np.int32)
    ln = np.zeros((B, t_pad), dtype=np.int32)
    sl = np.zeros((B, t_pad), dtype=np.float32)
    complete = np.ones(B, dtype=bool)
    certifiable = np.ones(B, dtype=bool)
    corrected = np.ones(B, dtype=bool)
    full_touched = np.zeros(B, dtype=np.int64)
    with_hot = full_starts is not None and full_lengths is not None
    hot_cols = np.zeros((B, t_pad), dtype=bool)
    hot_rows: List[List[Tuple[int, int]]] = [[] for _ in range(B)]
    for b, ids in enumerate(query_term_ids):
        for j, tid in enumerate(ids[:t_pad]):
            full_len = int(imp.df_host[tid])
            full_touched[b] += full_len
            kept = int(imp.lengths_host[tid])
            s0 = int(imp.starts_host[tid])
            st[b, j] = s0
            ln[b, j] = min(kept, p)
            if full_len > p:
                sl[b, j] = float(imp.weights_host[s0 + min(p, kept) - 1])
                complete[b] = False
                # mark a column only when it is bisected: the correction
                # subtracts every marked column's pruned prefix
                if with_hot and len(hot_rows[b]) < _HOT_H_LADDER[-1]:
                    hot_cols[b, j] = True
                    hot_rows[b].append((int(full_starts[tid]),
                                        int(full_lengths[tid])))
                else:
                    corrected[b] = False
            if full_len > imp.p_max:
                certifiable[b] = False
        if len(ids) > t_pad:
            # dropped terms are absent from the rescore and the correction
            complete[b] = False
            corrected[b] = False
            for tid in ids[t_pad:]:
                full_touched[b] += int(imp.df_host[tid])
            if len(ids) > IMPACT_T_LADDER[-1]:
                certifiable[b] = False
    dev = imp.doc_ids.device
    hs = hl = hc = None
    longest_hot = max((len(r) for r in hot_rows), default=0)
    if with_hot and longest_hot:
        hm = next((h for h in _HOT_H_LADDER if h >= longest_hot),
                  _HOT_H_LADDER[-1])
        hs_np = np.zeros((B, hm), dtype=np.int32)
        hl_np = np.zeros((B, hm), dtype=np.int32)
        for b, rows in enumerate(hot_rows):
            for j, (s0, l0) in enumerate(rows[:hm]):
                hs_np[b, j], hl_np[b, j] = s0, l0
        hs = torch.from_numpy(hs_np).to(dev)
        hl = torch.from_numpy(hl_np).to(dev)
        hc = torch.from_numpy(hot_cols).to(dev)
    return ImpactQueryEnc(
        starts=torch.from_numpy(st).to(dev),
        lengths=torch.from_numpy(ln).to(dev),
        slack=torch.from_numpy(sl).to(dev),
        complete=complete,
        certifiable_deeper=certifiable,
        t_pad=t_pad,
        corrected_complete=corrected,
        full_touched=full_touched,
        hot_starts=hs,
        hot_lens=hl,
        hot_cols=hc,
    )


def slice_impact_runs(
    doc_ids: torch.Tensor,
    weights: torch.Tensor,
    starts: torch.Tensor,  # [B, T]
    lengths: torch.Tensor,  # [B, T]
    p_depth: int,
    n_docs: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, T, p] ids, [B, T, p] weights) — contiguous top-p prefixes of
    each query term's impact run; tails past the run masked to (n_docs, 0).
    Kernel K6 on the card."""
    B, T = starts.shape
    ids, ws = slice_runs(doc_ids, weights, starts, lengths, p_depth, n_docs)
    return ids.reshape(B, T, p_depth), ws.reshape(B, T, p_depth)


def onehot_rescore(
    cand: torch.Tensor,  # [B, C] candidate doc ids (sentinels score 0)
    ids_flat: torch.Tensor,  # [B, T*p] pruned posting doc ids (pad = n_docs)
    ws_flat: torch.Tensor,  # [B, T*p] pruned posting weights (pad = 0)
    p: int,
    n_docs: int,
) -> torch.Tensor:
    """[B, C] exact sums of the pruned posting weights at each candidate.
    The JAX function's name is kept; the port takes the column width ``p``
    and ``n_docs`` instead of a block size. Kernel K7 on the card."""
    return rescore(cand, ids_flat.to(torch.int32), ws_flat, p, n_docs)


def impact_scores_np(
    imp: ImpactPostings,
    term_ids: Sequence[int],
    p_depth: Optional[int] = None,
) -> np.ndarray:
    """NumPy oracle: dense [n_docs] pruned lexical scores for one query."""
    p = imp.p_max if p_depth is None else min(p_depth, imp.p_max)
    out = np.zeros(imp.n_docs, dtype=np.float64)
    d_all = imp.doc_ids.cpu().numpy()
    w_all = imp.weights.cpu().numpy()
    for tid in term_ids:
        s0 = int(imp.starts_host[tid])
        ln = min(int(imp.lengths_host[tid]), p)
        np.add.at(out, d_all[s0:s0 + ln], w_all[s0:s0 + ln])
    return out.astype(np.float32)
