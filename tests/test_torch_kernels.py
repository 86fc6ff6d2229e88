"""The port's kernel wrappers (K1-K3) against the JAX package's Pallas
kernels, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode, as tests/test_supertile.py
does. Inputs come from a seeded numpy generator and go to both.

Tolerances: scores rtol=1e-4, atol=1e-5 -- both sides sum the same float32
(or bf16-exact) products over D <= 256 unit-vector coordinates, in
different orders. Placement sums at most a handful of float32 weights per
cell: atol=1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridsearch_tpu.ops.pallas_supertile import (
    pallas_place_windows,
    pallas_super_scores,
)
from hybridsearch_tpu.ops.pallas_topk import pallas_tile_stats_t
from hybridsearch_tpu_torch.ops.cuda_supertile import (
    place_windows,
    place_windows_v1,
    super_scores,
)
from hybridsearch_tpu_torch.ops.cuda_topk import query_block, tile_stats, tile_stats_v1


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_min", [False, True])
def test_tile_stats_matches_pallas(with_min, with_bias):
    rng = np.random.default_rng(0)
    N, D, B = 2048, 128, 128
    docs, q = _unit(rng, N, D), _unit(rng, B, D)
    bias = None
    if with_bias:
        bias = np.zeros(N, np.float32)
        bias[rng.choice(N, 200, replace=False)] = -np.inf
    n_valid = N - 100  # rows past n_valid mask to -inf / +inf
    want = pallas_tile_stats_t(
        jnp.asarray(q.T), jnp.asarray(docs),
        None if bias is None else jnp.asarray(bias), n_valid=n_valid,
        block_n=1024, with_min=with_min, interpret=True)
    got = tile_stats(torch.from_numpy(q), torch.from_numpy(docs),
                     None if bias is None else torch.from_numpy(bias),
                     n_valid=n_valid, with_min=with_min)
    assert len(got) == len(want) == (2 if with_min else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(-1, B),
                                   rtol=1e-4, atol=1e-5)


def test_tile_stats_bf16_matches_pallas():
    """bf16 docs and queries: exact products, float32 accumulation."""
    rng = np.random.default_rng(1)
    N, D, B = 1024, 128, 128
    docs, q = _unit(rng, N, D), _unit(rng, B, D)
    want = pallas_tile_stats_t(
        jnp.asarray(q.T).astype(jnp.bfloat16),
        jnp.asarray(docs).astype(jnp.bfloat16), None, n_valid=N,
        block_n=1024, with_min=True, interpret=True)
    got = tile_stats(torch.from_numpy(q).bfloat16(),
                     torch.from_numpy(docs).bfloat16(), None, with_min=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(-1, B),
                                   rtol=1e-4, atol=1e-5)


def test_super_scores_matches_pallas_with_clamp():
    """Probed supertile 4 runs past the end of the doc matrix: its chunk
    indices clamp to the last chunk on both sides."""
    rng = np.random.default_rng(2)
    sd, ch, D, B, S = 1024, 256, 128, 10, 2
    N = 4 * sd + 2 * ch
    docs, q = _unit(rng, N, D), _unit(rng, B, D)
    sup = np.sort(np.stack([rng.choice(5, S, replace=False) for _ in range(B)]),
                  axis=1).astype(np.int32)
    sup[0] = [3, 4]  # make sure the clamp is exercised
    want = pallas_super_scores(jnp.asarray(q), jnp.asarray(docs),
                               jnp.asarray(sup), sd, ch=ch, interpret=True)
    got = super_scores(torch.from_numpy(q), torch.from_numpy(docs),
                       torch.from_numpy(sup), sd, ch=ch)
    assert got.shape == (B, S * sd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("skip", [False, True])
def test_place_windows_matches_pallas_with_out_of_range(skip):
    rng = np.random.default_rng(3)
    st, tile, ech, BS, TE = 8, 128, 256, 12, 1024
    R = st * tile
    l = rng.integers(-40, R + 40, size=(BS, TE)).astype(np.int32)
    w = rng.random((BS, TE)).astype(np.float32)
    w[:, ::5] = 0.0
    want = pallas_place_windows(jnp.asarray(l), jnp.asarray(w), st, tile,
                                ech=ech, interpret=True, tlhs=True, skip=skip)
    got = place_windows(torch.from_numpy(l), torch.from_numpy(w), st, tile)
    assert got.shape == (BS, st, tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # entries outside [0, R) contribute nothing
    ok = (l >= 0) & (l < R)
    np.testing.assert_allclose(got.numpy().sum(axis=(1, 2)),
                               np.where(ok, w, 0).sum(axis=1), rtol=1e-5)


def test_wrappers_take_plain_versions_only_on_the_cpu():
    """A tensor on a device that is neither the CPU nor a CUDA card is
    refused rather than computed some other way."""
    meta = torch.empty((256, 128), device="meta")
    with pytest.raises(ValueError):
        tile_stats(torch.empty((4, 128), device="meta"), meta)
    with pytest.raises(ValueError):
        super_scores(torch.empty((4, 128), device="meta"), meta,
                     torch.zeros((4, 1), dtype=torch.int32, device="meta"), 256,
                     ch=128)
    with pytest.raises(ValueError):
        place_windows(torch.zeros((2, 8), dtype=torch.int32, device="meta"),
                      torch.zeros((2, 8), device="meta"))
    assert tile_stats.launches == 0


def test_first_designs_refuse_cpu_tensors():
    """``tile_stats_v1`` and ``place_windows_v1`` are yardsticks for the
    card: on CPU (or meta) tensors they raise rather than run the plain
    version, and count no launch."""
    rng = np.random.default_rng(9)
    docs = torch.from_numpy(_unit(rng, 256, 128))
    q = torch.from_numpy(_unit(rng, 4, 128))
    l = torch.zeros((2, 1024), dtype=torch.int32)
    w = torch.zeros((2, 1024))
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError):
            tile_stats_v1(q.to(dev), docs.to(dev))
        with pytest.raises(ValueError):
            place_windows_v1(l.to(dev), w.to(dev))
    assert tile_stats_v1.launches == 0 and place_windows_v1.launches == 0


@pytest.mark.parametrize("B,bq", [(1, 32), (32, 32), (33, 64), (64, 64), (100, 128),
                                  (129, 256), (256, 256), (1000, 256)])
def test_query_block_is_the_smallest_width_that_holds_the_batch(B, bq):
    assert query_block(B) == bq


# -- K5's redesign: its host-side plan and its stage walk, on the CPU ----------

def _k5_plan_np(r_len, sms):
    """``place_fused_plan`` as one numpy pick: every (blocks an SM, stages,
    entries) candidate in preference order, the first that fits."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    entries = [cs.PLACE_FUSED_ENTRIES >> k
               for k in range(cs.PLACE_FUSED_ENTRIES.bit_length())
               if cs.PLACE_FUSED_ENTRIES >> k >= 128]
    cand = np.array([(per_sm, cs.PLACE_FUSED_STAGES, e)
                     for per_sm in (cs.PLACE_FUSED_BLOCKS, 1) for e in entries])
    fixed = 4 * 32 + 40 * (cs.PLACE_FUSED_STAGES + 1)  # slot rows, stage descriptors
    room = (np.minimum(cs.SMEM_BLOCK, cs.SMEM_SM // cand[:, 0] - cs.SMEM_RESERVED)
            - 4 * r_len - fixed)
    fits = 8 * cand[:, 1] * cand[:, 2] <= room
    if not fits.any():
        return None
    per_sm, st, e = (int(x) for x in cand[int(np.argmax(fits))])
    return (cs.PLACE_FUSED_THREADS, st, e, sms * per_sm, 4 * r_len + 8 * st * e + fixed)


@pytest.mark.parametrize("super_tiles", [1, 8, 128, 256, 300, 440, 447, 448, 454])
def test_place_fused_plan_matches_numpy(super_tiles):
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    r_len = super_tiles * 128
    plan = cs.place_fused_plan(r_len, 132)
    assert plan == _k5_plan_np(r_len, 132)
    if plan is None:  # no ring fits beside the buffer
        assert 4 * r_len + cs.PLACE_FUSED_FIXED + 8 * cs.PLACE_FUSED_STAGES * 128 > cs.SMEM_BLOCK
        return
    _threads, _stages, _entries, blocks, smem = plan
    per_sm = blocks // 132
    assert smem <= cs.SMEM_BLOCK and per_sm * (smem + cs.SMEM_RESERVED) <= cs.SMEM_SM
    if super_tiles == 128:  # the path's buffer: the plan's first choice
        assert plan[1:3] == (cs.PLACE_FUSED_STAGES, cs.PLACE_FUSED_ENTRIES)
        assert per_sm == cs.PLACE_FUSED_BLOCKS


def _k5_walk_np(lo, hi, base, ids, ws, slot_rows, r_len, entries, grid, piece):
    """The K5 kernel's walk in numpy: block b takes rows b, b + grid, ...;
    each slot's window [lo, end) is cut into stages of ``entries`` positions
    from lo rounded down to ``piece``; a stage adds its staged positions
    inside the window (one add a cell, checked), stages in slot order; a
    row's buffer is written out once and starts the next row at zero."""
    rows, T = lo.shape
    n_entries = ids.size
    out = np.full((rows, r_len), np.nan, np.float32)
    for b in range(min(grid, rows)):
        for r in range(b, rows, grid):
            buf = np.zeros(r_len, np.float32)
            for j in range(T):
                lo_j = int(lo[r, j])
                end = min(int(hi[r, j]), (lo_j // 128 + slot_rows[j]) * 128, n_entries)
                if end <= lo_j:
                    continue
                a, ea = lo_j - lo_j % piece, -(-end // piece) * piece
                assert ea <= n_entries
                for s0 in range(a, ea, entries):
                    pos = np.arange(s0, min(s0 + entries, ea))
                    pos = pos[(pos >= lo_j) & (pos < end)]
                    w = ws[pos]
                    lv = ids[pos].astype(np.int64) - int(base[r])
                    keep = (w != 0) & (lv >= 0) & (lv < r_len)
                    assert np.unique(lv[keep]).size == keep.sum()
                    buf[lv[keep]] += w[keep]
            assert np.isnan(out[r]).all()  # written once
            out[r] = buf
    return out


def _k5_case(seed, B=12, S=3, T=6, n_docs=4096, super_tiles=8):
    """A doc-sorted CSR over supertiles of super_tiles * 128 docs, terms from
    dense (windows past the caps) to sparse, and int64 window bounds of B
    queries x S probes (one past the position table) for T slots."""
    from hybridsearch_tpu_torch.ops import supertile as st

    rng = np.random.default_rng(seed)
    V = 24
    t_l, d_l = [], []
    for term in range(V):
        frac = 0.7 if term % 6 == 0 else float(rng.uniform(0.01, 0.3))
        hit = np.flatnonzero(rng.random(n_docs) < frac)
        t_l.append(np.full(len(hit), term))
        d_l.append(hit)
    t_a, d_a = np.concatenate(t_l), np.concatenate(d_l)
    w_a = (rng.random(len(t_a)) * 8 + 0.01).astype(np.float32)
    w_a[::11] = 0.0
    sp = st.build_super_postings(t_a, d_a, w_a, n_docs, V, torch.device("cpu"),
                                 super_tiles=super_tiles)
    term_ids = torch.from_numpy(rng.integers(0, V + 1, (B, T)))
    sup_s = torch.from_numpy(np.sort(rng.integers(0, sp.n_super + 1, (B, S)), axis=1))
    wcaps = (512,) + (256,) * (T - 1)
    lo, hi, base, ovf = st._flat_windows(sp.sup_pos, term_ids, sup_s, sp.super_docs,
                                         wcaps)
    return sp, lo, hi, base, ovf, wcaps


@pytest.mark.parametrize("entries,grid,piece", [(2048, 264, 4), (128, 5, 4), (64, 3, 1)])
def test_place_fused_stage_walk_matches_the_plain_version(entries, grid, piece):
    """The kernel's cut of each window into aligned stages, masked to the
    window, and its row walk give the plain version's bits: overflowing,
    empty and past-the-table windows, zero weights, fewer and more rows
    than blocks."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    sp, lo, hi, base, ovf, wcaps = _k5_case(21)
    assert ovf.any() and (lo == hi).any()
    want = cs.place_fused_plain(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps,
                                sp.super_tiles)
    got = _k5_walk_np(lo.numpy(), hi.numpy(), base.numpy(), sp.ids_rows.numpy().ravel(),
                      sp.ws_rows.numpy().ravel(), cs._slot_rows(wcaps),
                      sp.super_tiles * 128, entries, grid, piece)
    assert torch.equal(torch.from_numpy(got).reshape(want.shape), want)
    assert (want != 0).any()


def test_place_fused_host_work_caches_and_converts_nothing_it_need_not():
    """The slot rows' C array is built once a cap tuple; int64 bounds (the
    path's) and int32 ones pass through as they are, mixed ones meet at
    int64, and only a non-contiguous one is copied."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    a = cs._slot_rows_arg((8192, 512, 512))
    assert a is cs._slot_rows_arg((8192, 512, 512))
    assert list(a) == cs._slot_rows((8192, 512, 512)) == [65, 5, 5]
    lo = torch.zeros((6, 4), dtype=torch.int64)
    base = torch.zeros(6, dtype=torch.int64)
    (lo_k, hi_k, base_k), idx64 = cs._bounds(lo, lo, base)
    assert idx64 and lo_k is lo and hi_k is lo and base_k is base
    (lo_k, _hi, base_k), idx64 = cs._bounds(lo.int(), lo.int(), base.int())
    assert not idx64 and lo_k.dtype == torch.int32 and base_k.dtype == torch.int32
    (lo_k, hi_k, base_k), idx64 = cs._bounds(lo.int(), lo.t().contiguous().t(), base)
    assert idx64 and all(t.dtype == torch.int64 and t.is_contiguous()
                         for t in (lo_k, hi_k, base_k))


def test_place_fused_v1_refuses_cpu_tensors():
    """``place_fused_v1`` is a yardstick for the card: on CPU (or meta)
    tensors it raises rather than run the plain version, and counts no
    launch."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    for dev in ("cpu", "meta"):
        z = torch.zeros((2, 3), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError):
            cs.place_fused_v1(z, z, torch.zeros(2, dtype=torch.int32, device=dev),
                              torch.zeros((4, 128), dtype=torch.int32, device=dev),
                              torch.zeros((4, 128), device=dev), (512, 512, 512))
    assert cs.place_fused_v1.launches == 0 and cs.place_fused.launches == 0
