"""Supertile hybrid — exact-resident fused top-k at scale.

Counterpart of ``hybridsearch_tpu/ops/supertile.py`` (single device). The
corpus is cluster-ordered (index/builder.py), so a query's best docs sit in
few supertiles of 128 tiles = 16384 docs:

  build   * a dense per-term supertile-maximum table [V+1, n_super]:
            sup_max[t, s] is the exact max BM25 weight of term t over the
            docs of supertile s; row V is zeros (the query-pad term);
          * sup_pos[t, s]: the CSR position of term t's first posting in a
            supertile >= s, so a (term, supertile) window is two lookups;
          * the full doc-sorted CSR reshaped to 128-wide rows.
  query   1. one sweep -> exact per-tile semantic maxima and alive min/max
             (ops/dense.py dense_tile_stats, kernel K1 on the card);
          2. joint supertile bound = w_s*nsem(supertile sem max)
             + w_l*nlex(sum_t sup_max[t, s]); the best S supertiles are
             probed (steps 1-2 are the rung-invariant ``super_prefix``);
          3. EVERY doc of a probed supertile is scored exactly: semantic
             scores by kernel K2 (ops/cuda_supertile.py super_scores),
             lexical scores by placing each query term's CSR window inside
             the supertile into a [128, 128] buffer (kernel K3,
             place_windows);
          4. certificate: the k-th fused result beats every unprobed
             supertile's joint bound under the final normalizers (by the
             eps_num margin), and the resident lexical max dominates every
             unprobed supertile's lexical bound.

``exact`` is True only when the result provably equals full-corpus
min-max fusion. The rung's two opt-in levers (``EngineConfig.perf``, the
JAX module's ``HST_SCORES_DEDUP`` and ``HST_PLACE_FUSED``) swap step 3's
kernels for K4 (``super_scores_dedup``, the (query, probe) pairs sorted
by supertile) and K5 (``place_fused``, the windows read inside the
kernel); both give the same bits as K2 and K3. ``save_super_postings`` /
``load_super_postings`` keep the build-time structures as the JAX
package's ``.npy`` files. The mesh build (``build_super_postings_sharded``)
is not part of the port yet.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.cuda_supertile import (
    PLACE_CHUNK,
    ROW,
    place_fused,
    place_windows,
    super_scores,
    super_scores_dedup,
    window_entries,
)
from hybridsearch_tpu_torch.ops.dense import (
    _on_card,
    dense_tile_stats,
    gather_tile_scores,
    stable_topk,
    tiled_matrix_topk,
)
from hybridsearch_tpu_torch.ops.hybrid import NEG_INF, HybridTopK
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

TILE = 128

# Window-cap ladder: each query-term slot's CSR window is gathered at the
# smallest rung covering the build-time window maxima of the terms in it.
WCAP_LADDER = (512, 1024, 2048, 4096, 8192, 16384)
# Per-query term-count pad ladder.
SUPER_T_LADDER = (8, 16, 32)
# Resident-score chunk (rows per K2 block).
SCORE_CHUNK = 1024
# Certificate margin: the sweep's tile maxima (K1) and the resident scores
# (K2, rescore) sum the same float32 products in different orders, so they
# can disagree by ~D * eps_f32; certify only past that noise floor.
EPS_NUM = 1e-4


class SuperPostings(NamedTuple):
    """Build-time lexical structures for the supertile hybrid."""

    sup_max: torch.Tensor  # [V+1, n_super] float32 per-term supertile maxima
    sup_pos: torch.Tensor  # [V+1, n_super+1] int32 window start positions
    ids_rows: torch.Tensor  # [M, ROW] int32 doc-sorted CSR ids (pad n_docs)
    ws_rows: torch.Tensor  # [M, ROW] float32 CSR weights (pad 0)
    n_docs: int
    n_super: int
    super_tiles: int  # tiles per supertile
    starts_host: np.ndarray  # [V] int64 run starts into the flat CSR
    df_host: np.ndarray  # [V] int64 document frequencies
    win_max_host: np.ndarray  # [V] int64 widest (term, supertile) window

    @property
    def super_docs(self) -> int:
        return self.super_tiles * TILE


def build_super_postings(
    term_ids: np.ndarray,
    doc_ids: np.ndarray,
    weights: np.ndarray,
    n_docs: int,
    vocab_size: int,
    device: torch.device,
    super_tiles: int = 128,
) -> SuperPostings:
    """Host-side build from term-major doc-sorted COO triples: segment
    reductions over the (term, supertile) boundaries of the sorted order."""
    t = np.asarray(term_ids, dtype=np.int64)
    d = np.asarray(doc_ids, dtype=np.int64)
    w = np.asarray(weights, dtype=np.float32)
    if len(t) >= 2**31:
        raise ValueError("int32 CSR positions (sup_pos) cap nnz at 2^31")
    V = vocab_size
    sd = super_tiles * TILE
    n_tiles = max(1, -(-n_docs // TILE))
    n_super = max(1, -(-n_tiles // super_tiles))
    df = np.bincount(t, minlength=V).astype(np.int64)[:V]
    starts = np.concatenate([[0], np.cumsum(df)])[:-1]

    table = np.zeros((V + 1, n_super), dtype=np.float32)
    pos_tab = np.zeros((V + 1, n_super + 1), dtype=np.int32)
    pos_tab[:V, n_super] = (starts + df).astype(np.int32)
    win_max = np.zeros(V, dtype=np.int64)
    nnz = len(t)
    if nnz:
        sig = d // sd
        key = t * n_super + sig
        seg_starts = np.concatenate([[0], np.flatnonzero(np.diff(key)) + 1])
        seg_t = t[seg_starts]
        seg_s = sig[seg_starts]
        table[seg_t, seg_s] = np.maximum.reduceat(w, seg_starts)
        seg_len = np.diff(np.concatenate([seg_starts, [nnz]]))
        tb = np.concatenate([[0], np.flatnonzero(np.diff(seg_t)) + 1])
        win_max[seg_t[tb]] = np.maximum.reduceat(seg_len, tb)
        # a supertile with no segment inherits the next one's start
        present = np.zeros((V, n_super), bool)
        seg_pos = np.zeros((V, n_super), np.int64)
        present[seg_t, seg_s] = True
        seg_pos[seg_t, seg_s] = seg_starts
        for s in range(n_super - 1, -1, -1):
            pos_tab[:V, s] = np.where(present[:, s], seg_pos[:, s],
                                      pos_tab[:V, s + 1])

    M = max(1, -(-(nnz + 1) // ROW))
    ids_pad = np.full(M * ROW, n_docs, dtype=np.int32)
    ws_pad = np.zeros(M * ROW, dtype=np.float32)
    ids_pad[:nnz] = d
    ws_pad[:nnz] = w
    return SuperPostings(
        sup_max=torch.from_numpy(table).to(device),
        sup_pos=torch.from_numpy(pos_tab).to(device),
        ids_rows=torch.from_numpy(ids_pad.reshape(M, ROW)).to(device),
        ws_rows=torch.from_numpy(ws_pad.reshape(M, ROW)).to(device),
        n_docs=n_docs,
        n_super=n_super,
        super_tiles=super_tiles,
        starts_host=starts,
        df_host=df,
        win_max_host=win_max,
    )


_SUPER_DEVICE = {"sup_max": torch.float32, "sup_pos": torch.int32,
                 "ids_rows": torch.int32, "ws_rows": torch.float32}
_SUPER_HOST = ("starts_host", "df_host", "win_max_host")


def save_super_postings(sp: SuperPostings, path: str) -> None:
    """Write the build-time supertile structures as one ``.npy`` file an
    array plus ``meta.json`` (the JAX package's file names), so a serving
    process skips the host build and maps them back."""
    os.makedirs(path, exist_ok=True)
    for name in _SUPER_DEVICE:
        np.save(os.path.join(path, f"{name}.npy"), getattr(sp, name).cpu().numpy())
    for name in _SUPER_HOST:
        np.save(os.path.join(path, f"{name}.npy"), getattr(sp, name))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_docs": sp.n_docs, "n_super": sp.n_super,
                   "super_tiles": sp.super_tiles, "version": 1}, f)


def load_super_postings(path: str, device: DeviceLike = None) -> SuperPostings:
    """Structures ``save_super_postings`` (of either package) wrote; the
    device arrays upload from memory maps."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    def npy(name, mode=None):
        return np.load(os.path.join(path, f"{name}.npy"), mmap_mode=mode)

    return SuperPostings(
        **{name: torch.from_numpy(npy(name, "c")).to(dev, dtype)
           for name, dtype in _SUPER_DEVICE.items()},
        n_docs=int(meta["n_docs"]), n_super=int(meta["n_super"]),
        super_tiles=int(meta["super_tiles"]),
        **{name: np.asarray(npy(name), np.int64) for name in _SUPER_HOST})


class SuperQueryEnc(NamedTuple):
    """Encoded query batch against a SuperPostings build."""

    term_ids: torch.Tensor  # [B, T] int64 (pad = V -> the table's zero row)
    starts: torch.Tensor  # [B, T] int32 full-run starts (pad 0)
    lens: torch.Tensor  # [B, T] int32 full dfs (pad 0)
    complete: np.ndarray  # [B] bool — no term dropped by the T pad
    full_touched: np.ndarray  # [B] int64 — sum of full dfs (lex-min-0 cert)
    wcaps: tuple  # per-slot window caps (WCAP_LADDER rungs; terms slotted
    #               widest-first)
    t_pad: int

    @property
    def wcap(self) -> int:
        return max(self.wcaps)


def encode_super_queries(
    sp: SuperPostings,
    query_term_ids: Sequence[Sequence[int]],
    wcap: Optional[int] = None,
) -> SuperQueryEnc:
    """Host-side encode: term-id lists -> padded [B, T] slots, sorted
    widest-window-first; slot 0 gets the rung covering the widest window
    in the batch and every other slot the rung covering the rest (two
    rungs in all). No window can silently truncate: the rungs cover the
    build-time maxima, and an overflow is flagged per query by the rung.
    ``wcap`` forces one uniform rung."""
    df_host, win_max_host = sp.df_host, sp.win_max_host
    cap = min(sp.super_docs, WCAP_LADDER[-1])
    device = sp.sup_max.device
    B = len(query_term_ids)
    V = len(df_host)
    lens = np.fromiter((len(ids) for ids in query_term_ids), dtype=np.int64,
                       count=B)
    total = int(lens.sum())
    longest = int(lens.max()) if B else 1
    t_pad = next((t for t in SUPER_T_LADDER if t >= max(longest, 1)),
                 SUPER_T_LADDER[-1])
    flat = np.fromiter((t for ids in query_term_ids for t in ids),
                       dtype=np.int64, count=total)
    row_of = np.repeat(np.arange(B, dtype=np.int64), lens)
    off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    pos_in_row = np.arange(total, dtype=np.int64) - off[row_of]

    full_touched = np.zeros(B, dtype=np.int64)
    np.add.at(full_touched, row_of, df_host[flat])
    complete = lens <= t_pad

    tid = np.full((B, t_pad), V, dtype=np.int64)
    keep = pos_in_row < t_pad
    tid[row_of[keep], pos_in_row[keep]] = flat[keep]

    win_ext = np.concatenate([win_max_host, [0]])
    wm = win_ext[tid]
    order = np.argsort(-wm, axis=1, kind="stable")
    tid = np.take_along_axis(tid, order, axis=1)
    wm = np.take_along_axis(wm, order, axis=1)

    st_ext = np.concatenate([sp.starts_host, [0]])
    df_ext = np.concatenate([df_host, [0]])
    st = st_ext[tid].astype(np.int32)
    ln = df_ext[tid].astype(np.int32)

    slot_need = np.maximum(wm.max(axis=0), 1) if B else np.ones(t_pad)

    def _rung(need):
        r = next((c for c in WCAP_LADDER if c >= min(int(need), cap)), cap)
        return min(r, max(cap, WCAP_LADDER[0]))

    if wcap is None:
        rest = _rung(slot_need[1:].max()) if t_pad > 1 else None
        wcaps = (_rung(slot_need[0]),) + (rest,) * (t_pad - 1)
    else:
        wcaps = (int(wcap),) * t_pad
    return SuperQueryEnc(
        term_ids=torch.from_numpy(tid).to(device),
        starts=torch.from_numpy(st).to(device),
        lens=torch.from_numpy(ln).to(device),
        complete=complete,
        full_touched=full_touched,
        wcaps=wcaps,
        t_pad=t_pad,
    )


def _window_bounds(sup_pos, term_ids, sup_s):
    """[B, T, S] (lo, hi) absolute CSR positions of every (query term
    slot, probed supertile) window; supertiles past the table (capacity
    padding) get empty windows."""
    ns_tab = sup_pos.shape[1] - 1
    sup_c = sup_s.clamp(max=ns_tab - 1)
    tab_idx = term_ids[:, :, None] * (ns_tab + 1) + sup_c[:, None, :]
    pos_flat = sup_pos.reshape(-1).long()
    lo = pos_flat[tab_idx]
    hi = pos_flat[tab_idx + 1]
    in_tab = (sup_s < ns_tab)[:, None, :]
    return torch.where(in_tab, lo, 0), torch.where(in_tab, hi, 0)


def _flat_windows(sup_pos, term_ids, sup_s, sd, wcaps):
    """(lo, hi [B*S, T] window bounds, base [B*S] supertile base doc ids,
    ovf [B] bool: some slot's window is wider than its cap) of every
    (query, probed supertile) row."""
    B, T = term_ids.shape
    S = sup_s.shape[1]
    lo, hi = _window_bounds(sup_pos, term_ids, sup_s)  # [B, T, S]
    ovf = torch.zeros(B, dtype=torch.bool, device=lo.device)
    for j, wc in enumerate(wcaps):
        ovf = ovf | ((hi[:, j] - lo[:, j]) > wc).any(dim=1)
    return (lo.transpose(1, 2).reshape(B * S, T),
            hi.transpose(1, 2).reshape(B * S, T),
            (sup_s * sd).reshape(B * S), ovf)


def _resident_windows(sup_pos, ids_rows, ws_rows, term_ids, sup_s, sd, wcaps,
                      ech: int = PLACE_CHUNK):
    """Per-slot CSR windows for every (query term, probed supertile), as
    whole-row gathers at the slot's cap: (l_cat [B, S, TEp] int32 local doc
    ids, w_cat float32 weights (0 outside the window), ovf [B] bool). Each
    slot's part is padded to whole ``ech`` chunks (l = -1), so no
    placement chunk mixes two slots."""
    B, S = sup_s.shape
    lo, hi, base, ovf = _flat_windows(sup_pos, term_ids, sup_s, sd, wcaps)
    l_cat, w_cat = window_entries(lo, hi, base, ids_rows, ws_rows, wcaps, ech)
    return l_cat.reshape(B, S, -1), w_cat.reshape(B, S, -1), ovf


def _place_windows_fused(sup_pos, ids_rows, ws_rows, term_ids, sup_s, sd,
                         wcaps, super_tiles):
    """Gather-fused placement (kernel K5): window bounds from the position
    table, then one kernel that reads each slot's window straight from the
    CSR, with no [B, S, E] staging arrays. Returns (lex4 [B*S, St, TILE],
    ovf [B])."""
    lo, hi, base, ovf = _flat_windows(sup_pos, term_ids, sup_s, sd, wcaps)
    return place_fused(lo, hi, base, ids_rows, ws_rows, wcaps, super_tiles,
                       TILE), ovf


def dedup_pairs(sup_s: torch.Tensor, group: int = 8):
    """(tid, qid, rep, inv), the JAX package's pair bookkeeping for its K4,
    from the per-query probe table ``sup_s`` [B, S]: the B*S (query, probe)
    pairs stable-sorted by supertile id (tid), each pair's query (qid),
    ``rep`` the first pair of its equal-tid run clamped into its
    ``group``-sized block (the JAX kernel's DMA owner), and ``inv`` the
    inverse permutation: ``out_sorted[inv].reshape(B, S*sd)`` restores
    query-major order. The card's K4 writes query-major rows itself and
    takes the lean form (``ops/cuda_supertile.py sort_pairs``)."""
    B, S = sup_s.shape
    P = B * S
    dev = sup_s.device
    flat = sup_s.reshape(-1).to(torch.int32)
    order = torch.sort(flat, stable=True).indices
    tid = flat[order]
    qid = order // S
    run0 = torch.searchsorted(tid, tid, side="left")
    pos = torch.arange(P, device=dev)
    rep = torch.maximum(run0, (pos // group) * group)
    inv = torch.empty_like(order)
    inv[order] = pos
    return tid, qid, rep, inv


class SuperPrefix(NamedTuple):
    """Rung-invariant prefix: dense tile stats + lexical bounds + the top
    s_max probe candidates by joint bound. The ladder computes it once per
    batch; rung r probes the first r candidates."""

    ssem: torch.Tensor  # [B, n_super] exact dense supertile maxima
    slex: torch.Tensor  # [B, n_super] lexical supertile upper bounds
    smin: torch.Tensor  # [B] alive dense min (minmax normalizer)
    smax: torch.Tensor  # [B] alive dense max
    sup_all: torch.Tensor  # [B, s_max] probe candidates, bound-descending


def _normalizers(smin, smax, norm):
    eps = 1e-12
    rng_s = smax - smin
    if norm == "minmax":
        def nsem(x):
            return torch.where(rng_s[:, None] > eps,
                               (x - smin[:, None]) / rng_s[:, None].clamp_min(eps),
                               torch.ones_like(x))
    else:  # "max"
        def nsem(x):
            return torch.where(smax[:, None] > eps,
                               x / smax[:, None].clamp_min(eps), x)

    def nlex(x, L):
        # an all-zero lexical arm min-max-normalizes to ones
        return torch.where(L[:, None] > eps, x / L[:, None].clamp_min(eps),
                           torch.ones_like(x))

    return nsem, nlex


def super_prefix(
    q: torch.Tensor,
    docs: torch.Tensor,
    sp: SuperPostings,
    enc: SuperQueryEnc,
    bias: Optional[torch.Tensor] = None,
    w_s: float = 0.7,
    w_l: float = 0.3,
    norm: str = "minmax",
    s_max: int = 16,
) -> SuperPrefix:
    """Steps 1-2 for a ladder of hybrid_supertile_topk_rung calls: one
    full-corpus stats sweep and bound selection serve every probe depth up
    to s_max."""
    B = q.shape[0]
    N = docs.shape[0]
    super_tiles = sp.super_tiles
    n_tiles = -(-N // TILE)
    sup_max = sp.sup_max
    n_super = sup_max.shape[1]

    tile_sem, smin, smax = dense_tile_stats(q, docs, bias)
    # capacity-padded doc matrices can hold more supertiles than the
    # build-time table: their lexical columns are zero
    need_super = -(-n_tiles // super_tiles)
    if need_super > n_super:
        sup_max = torch.nn.functional.pad(sup_max, (0, need_super - n_super))
        n_super = need_super
    pad_t = n_super * super_tiles - n_tiles
    if pad_t:
        tile_sem = torch.nn.functional.pad(tile_sem, (0, pad_t), value=NEG_INF)
    ssem = tile_sem.reshape(B, n_super, super_tiles).amax(dim=2)
    slex = sup_max[enc.term_ids].sum(dim=1)  # [B, n_super]

    nsem, nlex = _normalizers(smin, smax, norm)
    L0 = slex.amax(dim=1)
    bound0 = w_s * nsem(ssem) + w_l * nlex(slex, L0)
    _, sup_all = stable_topk(bound0, min(s_max, n_super))
    return SuperPrefix(ssem=ssem, slex=slex, smin=smin, smax=smax,
                       sup_all=sup_all)


def hybrid_supertile_topk_rung(
    q: torch.Tensor,
    docs: torch.Tensor,
    sp: SuperPostings,
    enc: SuperQueryEnc,
    prefix: SuperPrefix,
    k: int,
    w_s: float,
    w_l: float,
    bias: Optional[torch.Tensor] = None,
    s_probe: int = 4,
    norm: str = "minmax",
    n_alive: Optional[int] = None,
    scores_dedup: bool = False,
    place_fused: bool = False,
) -> HybridTopK:
    """Steps 3-4 at probe budget ``s_probe`` from a shared prefix: exact
    resident scores, fusion, float32 finalist rescore and the per-query
    certificate. ``q`` [B, D] L2-normalized float32; ``docs`` [N, D].
    ``scores_dedup``: on the card's score route, K4 on pairs sorted by
    supertile when B*S % 8 == 0 (else K2); ``place_fused``: K5 instead of
    staged windows + K3. Either gives the same bits as the default."""
    B, Dm = q.shape
    N = docs.shape[0]
    dev = q.device
    n_alive = N if n_alive is None else n_alive
    super_tiles = sp.super_tiles
    sd = super_tiles * TILE
    wcaps = tuple(min(w, sp.super_docs) for w in enc.wcaps)
    ssem, slex = prefix.ssem, prefix.slex
    n_super = ssem.shape[1]
    S = min(s_probe, n_super, prefix.sup_all.shape[1])
    nsem, nlex = _normalizers(prefix.smin, prefix.smax, norm)
    sup_s = torch.sort(prefix.sup_all[:, :S], dim=1).values  # [B, S] ascending

    # -- resident semantic scores -----------------------------------------
    R = S * sd
    CH = SCORE_CHUNK
    if _on_card(docs) and N % CH == 0 and Dm % 128 == 0 and sd % CH == 0:
        q3 = q.to(docs.dtype) if docs.dtype == torch.bfloat16 else q
        if scores_dedup and (B * S) % 8 == 0:
            s_res = super_scores_dedup(q3, docs, sup_s, sd, ch=CH)  # K4
        else:
            s_res = super_scores(q3, docs, sup_s, sd, ch=CH)  # K2
        gidx = (sup_s[:, :, None] * sd
                + torch.arange(sd, device=dev)).reshape(B, R)
        if bias is not None:
            bias2 = bias.float().reshape(N // CH, CH)
            blk = (sup_s[:, :, None] * (sd // CH)
                   + torch.arange(sd // CH, device=dev)).clamp(
                max=N // CH - 1).reshape(B, S * (sd // CH))
            s_res = s_res + bias2[blk].reshape(B, R)
        s_res = torch.where(gidx < N, s_res, NEG_INF)
    else:
        tiles_sel = (sup_s[:, :, None] * super_tiles
                     + torch.arange(super_tiles, device=dev)).reshape(
            B, S * super_tiles)
        s_res, gidx = gather_tile_scores(q, docs, tiles_sel, bias)
    alive = torch.isfinite(s_res)

    # -- resident lexical scores ------------------------------------------
    if place_fused:
        lex4, ovf = _place_windows_fused(sp.sup_pos, sp.ids_rows, sp.ws_rows,
                                         enc.term_ids, sup_s, sd, wcaps,
                                         super_tiles)  # K5
    else:
        l_cat, w_cat, ovf = _resident_windows(sp.sup_pos, sp.ids_rows,
                                              sp.ws_rows, enc.term_ids, sup_s,
                                              sd, wcaps)
        lex4 = place_windows(l_cat.reshape(B * S, -1), w_cat.reshape(B * S, -1),
                             super_tiles, TILE)  # K3
    lex_res = torch.where(alive, lex4.reshape(B, R), 0.0)

    # -- exact fusion + top-k ---------------------------------------------
    L_res = lex_res.amax(dim=1)  # [B] exact resident lexical max
    fused = w_s * nsem(s_res) + w_l * nlex(lex_res, L_res)
    fused = torch.where(alive, fused, NEG_INF)
    k_eff = min(k, R)
    M = min(4 * k_eff, R)  # finalist margin for the rescore
    if R > 4096:
        vals_m, pos_m = tiled_matrix_topk(fused, M)
        pos_m = pos_m.clamp_min(0)
    else:
        vals_m, pos_m = stable_topk(fused, M)
    # float32 tie-break rescore: the resident kernel sums in another order
    # than a plain dot, so near-ties can swap against the exact reference;
    # rescore the M finalists with the reference's own contraction
    idxs_m = torch.gather(gidx, 1, pos_m)
    safe = idxs_m.clamp(0, N - 1)
    q_m = q.to(torch.bfloat16).float() if docs.dtype == torch.bfloat16 else q
    s_m = torch.einsum("bmd,bd->bm", docs[safe].float(), q_m)
    if bias is not None:
        s_m = s_m + bias.float()[safe]
    lex_m = torch.gather(lex_res, 1, pos_m)
    alive_m = torch.gather(alive, 1, pos_m)
    fused_m = w_s * nsem(s_m) + w_l * nlex(lex_m, L_res)
    fused_m = torch.where(alive_m & (vals_m > NEG_INF), fused_m, NEG_INF)
    vals, sel = stable_topk(fused_m, k_eff)
    idxs = torch.gather(idxs_m, 1, sel)
    idxs = torch.where(torch.isfinite(vals), idxs, -1)

    # -- certificate --------------------------------------------------------
    # (a) residents are exact (whole supertiles, full windows unless ovf);
    # (b) an unprobed resident's fused score <= its supertile's joint bound
    #     under the final normalizers;
    # (c) L_res is the global lexical max: it is achieved and dominates
    #     every unprobed supertile's lexical bound;
    # (d) minmax: the true lexical min is 0 (some alive doc holds no query
    #     term) and the dense stats are exact (full sweep).
    kth = vals[:, -1]
    probed = torch.zeros((B, n_super), dtype=torch.bool, device=dev)
    probed.scatter_(1, sup_s, True)
    max_un = torch.where(probed, 0.0, slex).amax(dim=1)
    # max_un <= 0 is exact (no query term in any unprobed supertile)
    cert_norm = (L_res >= max_un + EPS_NUM) | (max_un <= 0.0)
    bound_f = w_s * nsem(ssem) + w_l * nlex(slex, L_res.clamp_min(1e-12))
    tau = torch.where(probed, NEG_INF, bound_f).amax(dim=1)
    complete = torch.from_numpy(np.asarray(enc.complete)).to(dev)
    exact = (complete & cert_norm & ~ovf
             & ((kth >= tau + EPS_NUM) | ~torch.isfinite(tau)))
    if norm == "minmax":
        lex_min_zero = torch.from_numpy(
            np.asarray(enc.full_touched) < n_alive).to(dev)
        exact = exact & lex_min_zero
    return HybridTopK(values=vals, indices=idxs, exact=exact)
