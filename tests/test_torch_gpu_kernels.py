"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

Without a card every test here skips (the decision is made inside each
test, never at import). This file imports no JAX, so it runs where only
PyTorch is installed.

Tolerances: float32 kernels sum in another order than the plain matmul,
on unit vectors (|score| <= 1) that is ~D * 6e-8, inside rtol = atol =
1e-5. bf16 docs (with bf16-rounded queries) give exact float32 products,
so the same bound holds; 1e-3 is kept as the stated bf16 tolerance. The
placement kernel adds the same float32 values in slot order: 1e-6 abs.
The impact kernels are held to 0: the slice kernel copies, and the
rescore kernel adds the same float32 weights in the same column order as
its plain version. Two k-means fits from one seed must be equal bit for
bit. K4 runs K2's per-pair sum and is held to K2 bit for bit; K5 adds the
same weights in the same slot order as the staged windows + K3, and is held
to them bit for bit. The run-ordered BM25 sum and the top-k scatter must
repeat bit for bit.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_min", [False, True])
def test_gpu_tile_stats_matches_plain(dtype, with_bias, with_min):
    from hybridsearch_tpu_torch.ops.cuda_topk import tile_stats, tile_stats_plain

    dev = _card()
    rng = np.random.default_rng(0)
    N, D, B = 16384, 384, 200
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    bias = None
    if with_bias:
        b = np.zeros(N, np.float32)
        b[rng.choice(N, 500, replace=False)] = -np.inf
        bias = torch.from_numpy(b).to(dev)
    n_valid = N - 300
    got = tile_stats(q, docs, bias, n_valid=n_valid, with_min=with_min)
    torch.cuda.synchronize()
    want = tile_stats_plain(q, docs, bias, n_valid=n_valid, with_min=with_min)
    tol = 1e-5 if dtype == "float32" else 1e-3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
def test_gpu_super_scores_matches_plain_with_clamp(dtype, shared):
    """``shared``: many queries probe few supertiles, so a supertile's
    (query, probe) pairs fill several groups of 32, and ids below 0 or past
    the last supertile read the first or last chunk throughout."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        super_scores,
        super_scores_plain,
    )

    dev = _card()
    rng = np.random.default_rng(1)
    sd, ch, D = 4096, 1024, 384
    B, S = (300, 4) if shared else (37, 3)
    N = 5 * sd + 2 * ch  # the last supertile is partial: its chunks clamp
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    sup = np.sort(np.stack([rng.choice(6, S, replace=False) for _ in range(B)]),
                  axis=1).astype(np.int32)
    if shared:
        sup[:5] = [[-3, -1, 6, 100]] * 5
    sup_t = torch.from_numpy(sup).to(dev)
    got = super_scores(q, docs, sup_t, sd, ch=ch)
    torch.cuda.synchronize()
    want = super_scores_plain(q, docs, sup_t, sd, ch=ch)
    tol = 1e-5 if dtype == "float32" else 1e-3
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_gpu_place_windows_matches_plain():
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        place_windows,
        place_windows_plain,
    )

    dev = _card()
    rng = np.random.default_rng(2)
    BS, TE, st = 96, 3072, 128
    R = st * 128
    l = rng.integers(-50, R + 50, size=(BS, TE)).astype(np.int32)
    w = rng.random((BS, TE)).astype(np.float32)
    w[:, ::7] = 0.0
    lt, wt = torch.from_numpy(l).to(dev), torch.from_numpy(w).to(dev)
    got = place_windows(lt, wt, super_tiles=st)
    torch.cuda.synchronize()
    want = place_windows_plain(lt, wt, super_tiles=st)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_gpu_place_windows_sums_in_slot_order():
    """Laid out as the path lays windows out (whole 1024-entry chunks, no
    cell twice in a chunk), the kernel adds in chunk order: bit-identical
    to the plain version, run after run."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        place_windows,
        place_windows_plain,
    )

    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    R, M, rows, n_chunks = 128 * 128, 128 * 128 + 128, 64, 9
    start = torch.randint(0, M, (rows, n_chunks, 1), generator=gen, device=dev)
    l = ((start + 1021 * torch.arange(1024, device=dev)) % M - 64).reshape(
        rows, -1).int()
    w = torch.rand(l.shape, generator=gen, device=dev) * 30.0
    first = place_windows(l, w)
    assert torch.equal(first, place_windows(l, w))
    assert torch.equal(first, place_windows_plain(l, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
def test_gpu_super_scores_dedup_equals_k2_bitwise(dtype, shared):
    """K4 on the pairs ``dedup_pairs`` sorts, unpermuted, against K2 on the
    probe table: the same bits. ``shared``: runs of equal ids longer than
    32 pairs, and ids below 0 or past the last supertile (first or last
    chunk throughout)."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        super_scores,
        super_scores_dedup,
        super_scores_dedup_plain,
    )
    from hybridsearch_tpu_torch.ops.supertile import dedup_pairs

    dev = _card()
    rng = np.random.default_rng(6)
    sd, ch, D = 4096, 1024, 384
    B, S = (300, 4) if shared else (37, 3)
    N = 5 * sd + 2 * ch
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    sup = np.sort(np.stack([rng.choice(6, S, replace=False) for _ in range(B)]),
                  axis=1).astype(np.int32)
    if shared:
        sup[:5] = [[-3, -1, 6, 100]] * 5
    sup_t = torch.from_numpy(sup).to(dev)
    tid, qid, _rep, inv = dedup_pairs(sup_t)
    k4 = super_scores_dedup(q[qid], docs, tid, sd, ch=ch)
    got = k4[inv].reshape(B, S * sd)
    want = super_scores(q, docs, sup_t, sd, ch=ch)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    tol = 1e-5 if dtype == "float32" else 1e-3
    torch.testing.assert_close(k4, super_scores_dedup_plain(q[qid], docs, tid, sd, ch=ch),
                               rtol=tol, atol=tol)
    # unsorted pairs give the same values, only more runs
    perm = torch.randperm(tid.shape[0], device=dev)
    assert torch.equal(super_scores_dedup(q[qid][perm], docs, tid[perm], sd, ch=ch),
                       k4[perm])


def _csr_case(dev, rng, n_docs=65536, V=64, B=256, S=2, T=8):
    """A doc-sorted CSR over 16,384-doc supertiles where some terms hold more
    than 8,192 docs of a supertile (windows past the 8,192 cap), and window
    bounds of B queries x S probes (a probe past the position table among
    them) for T term slots, padded with the query-pad term."""
    from hybridsearch_tpu_torch.ops import supertile as st

    t, d = [], []
    for term in range(V):
        frac = 0.6 if term % 8 == 0 else float(rng.uniform(0.01, 0.3))
        docs = np.flatnonzero(rng.random(n_docs) < frac)
        t.append(np.full(len(docs), term))
        d.append(docs)
    t, d = np.concatenate(t), np.concatenate(d)
    w = (rng.random(len(t)) * 8 + 0.01).astype(np.float32)
    sp = st.build_super_postings(t, d, w, n_docs, V, dev)
    term_ids = torch.from_numpy(rng.integers(0, V + 1, (B, T))).to(dev)
    sup_s = torch.from_numpy(np.sort(rng.integers(0, sp.n_super + 1, (B, S)),
                                     axis=1)).to(dev)
    return sp, term_ids, sup_s


@pytest.mark.parametrize("wcaps", [(8192,) * 8, (8192, 2048, 2048, 2048, 512, 512,
                                                  512, 512)])
def test_gpu_place_fused_equals_the_two_step_path_bitwise(wcaps):
    """K5 against the staged windows + K3 at B*S = 512 rows, with
    overflowing, empty and past-the-table windows; (8192,)*8 at BS = 512 is
    the shape at which the TPU kernel faulted."""
    from hybridsearch_tpu_torch.ops import supertile as st
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        place_fused,
        place_fused_plain,
        place_windows,
    )

    dev = _card()
    rng = np.random.default_rng(7)
    sp, term_ids, sup_s = _csr_case(dev, rng)
    lo, hi, base, ovf = st._flat_windows(sp.sup_pos, term_ids, sup_s, sp.super_docs,
                                         wcaps)
    assert lo.shape == (512, 8) and ovf.any() and (lo == hi).any()
    got = place_fused(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps, sp.super_tiles)
    torch.cuda.synchronize()
    l_cat, w_cat, _ovf = st._resident_windows(sp.sup_pos, sp.ids_rows, sp.ws_rows,
                                              term_ids, sup_s, sp.super_docs, wcaps)
    two = place_windows(l_cat.reshape(512, -1), w_cat.reshape(512, -1), sp.super_tiles)
    assert torch.equal(got, two)
    assert torch.equal(got, place_fused_plain(lo, hi, base, sp.ids_rows, sp.ws_rows,
                                              wcaps, sp.super_tiles))
    assert torch.equal(got, place_fused(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps,
                                        sp.super_tiles))
    assert (got.reshape(512, -1) != 0).any(dim=1).float().mean() > 0.5


def test_gpu_gated_wrappers_count_launches_and_reject_bad_input():
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    dev = _card()
    docs = torch.zeros((2048, 384), device=dev)
    qp = torch.zeros((8, 384), device=dev)
    tid = torch.zeros(8, dtype=torch.int32, device=dev)
    before = cs.super_scores_dedup.launches
    assert cs.super_scores_dedup(qp, docs, tid, 1024).shape == (8, 1024)
    assert cs.super_scores_dedup.launches == before + 1
    with pytest.raises(ValueError):
        cs.super_scores_dedup(qp.half(), docs.half(), tid, 1024)
    with pytest.raises(ValueError):  # one query row short
        cs.super_scores_dedup(qp[:7], docs, tid, 1024)
    with pytest.raises(ValueError):  # sd % ch != 0
        cs.super_scores_dedup(qp, docs, tid, 1000)
    assert cs.super_scores_dedup.launches == before + 1

    ids = torch.zeros((16, 128), dtype=torch.int32, device=dev)
    ws = torch.zeros((16, 128), device=dev)
    lo = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    base = torch.zeros(4, dtype=torch.int32, device=dev)
    before = cs.place_fused.launches
    out = cs.place_fused(lo, lo + 5, base, ids, ws, (512, 512, 512))
    assert out.shape == (4, 128, 128) and cs.place_fused.launches == before + 1
    with pytest.raises(ValueError):  # a cap per slot
        cs.place_fused(lo, lo, base, ids, ws, (512, 512))
    with pytest.raises(ValueError):  # at most 32 slots
        z = torch.zeros((4, 33), dtype=torch.int32, device=dev)
        cs.place_fused(z, z, base, ids, ws, (512,) * 33)
    with pytest.raises(ValueError):
        cs.place_fused(lo, lo, base, ids.long(), ws, (512, 512, 512))
    assert cs.place_fused.launches == before + 1


def test_gpu_bm25_scores_runs_and_topk_scatter_repeat_bitwise():
    """The run sum adds its T columns in order, a column's cells distinct:
    two runs at T = 8, W = 4096 on runs that share docs, with weights whose
    float32 sum depends on the order, are equal bit for bit. The top-k
    scatter (distinct ids a row, empty slots adding 0) repeats too."""
    from hybridsearch_tpu_torch.ops.bm25 import bm25_scores_runs
    from hybridsearch_tpu_torch.ops.dense import scatter_topk_to_dense

    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    n_docs, n_runs, W, B, T = 20_000, 64, 4096, 256, 8
    # 64 runs, each doc-sorted and duplicate-free, over a small doc range so
    # the runs of one query share most of their docs
    runs = [torch.sort(torch.randperm(n_docs // 2, generator=gen, device=dev)[:W]).values
            for _ in range(n_runs)]
    doc_ids = torch.cat(runs + [torch.zeros(W, dtype=torch.long, device=dev)]).int()
    weights = (torch.rand(doc_ids.shape[0], generator=gen, device=dev) - 0.5) * 1e4
    starts = (torch.randint(0, n_runs, (B, T), generator=gen, device=dev) * W).int()
    lengths = torch.randint(0, W + 1, (B, T), generator=gen, device=dev).int()
    a = bm25_scores_runs(doc_ids, weights, starts, lengths, n_docs, W)
    b = bm25_scores_runs(doc_ids, weights, starts, lengths, n_docs, W)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and (a != 0).any()
    vals, idx = torch.topk(a, 10, dim=1)
    idx[:, -2:] = -1
    idx[:, 0] = 0
    assert torch.equal(scatter_topk_to_dense(vals, idx, n_docs),
                       scatter_topk_to_dense(vals, idx, n_docs))


def test_gpu_wrappers_count_launches_and_reject_bad_input():
    from hybridsearch_tpu_torch.ops.cuda_topk import tile_stats

    dev = _card()
    docs = torch.zeros((256, 384), device=dev)
    q = torch.zeros((4, 384), device=dev)
    before = tile_stats.launches
    tile_stats(q, docs)
    assert tile_stats.launches == before + 1
    with pytest.raises(ValueError):
        tile_stats(q, torch.zeros((200, 384), device=dev))  # N % 128 != 0
    with pytest.raises(ValueError):
        tile_stats(q.half(), docs.half())  # float16 is not taken
    assert tile_stats.launches == before + 1


def _impact_inputs(rng, dev, B, T, p, nd, nnz=2_000_000):
    """Postings with p sentinel entries past nnz, whose windows of fewer
    than nd entries name a doc at most once (as a term's run does), and
    (B, T) slices of random starts and lengths (some past p, some 0)."""
    run = np.arange(nnz, dtype=np.int64) * 7919 % nd  # 7919 is prime to nd
    ids = np.concatenate([run, np.full(p, nd)]).astype(np.int32)
    ws = np.concatenate([rng.random(nnz) + 0.01, np.zeros(p)]).astype(np.float32)
    starts = rng.integers(0, nnz - p, (B, T)).astype(np.int32)
    lengths = rng.integers(0, 2 * p, (B, T)).astype(np.int32)
    lengths[:, -1] = 0
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(ids), t(ws), t(starts), t(lengths)


# (T, p, C): the three rungs of the impact ladder at T=8, the third at
# T=16 and T=32 (C = k_dense + T * c_per_term), and the margin call
LADDER_SHAPES = [(8, 256, 1024), (8, 1024, 2048), (8, 4096, 4096),
                 (16, 4096, 6144), (32, 4096, 10240), (8, 1024, 128)]


@pytest.mark.parametrize("T,p,C", LADDER_SHAPES)
def test_gpu_slice_runs_and_rescore_match_plain_bitwise(T, p, C):
    from hybridsearch_tpu_torch.ops.cuda_impact import (
        rescore,
        rescore_plain,
        slice_runs,
        slice_runs_plain,
    )

    dev = _card()
    rng = np.random.default_rng(4)
    B, nd = 256, 600_000
    ids, ws, starts, lengths = _impact_inputs(rng, dev, B, T, p, nd)
    got_i, got_w = slice_runs(ids, ws, starts, lengths, p, nd)
    want_i, want_w = slice_runs_plain(ids, ws, starts, lengths, p, nd)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i) and torch.equal(got_w, want_w)
    # candidates as the path makes them: column entries (planted hits),
    # repeats, sentinels and -1
    ids_flat, ws_flat = got_i.reshape(B, T * p), got_w.reshape(B, T * p)
    cand = ids_flat[:, torch.randperm(T * p, device=dev)[:C]].clone()
    cand[:, 1::13] = cand[:, :1]
    cand[:, -3:] = torch.tensor([nd, nd + 2, -1], device=dev)
    got = rescore(cand, ids_flat, ws_flat, p, nd)
    torch.cuda.synchronize()
    want = rescore_plain(cand, ids_flat, ws_flat, p, nd)
    assert torch.equal(got, want)
    assert (got[:, -3:] == 0).all() and (got > 0).any()


def test_gpu_rescore_shared_memory_limit_and_refusals():
    from hybridsearch_tpu_torch.ops import cuda_impact

    dev = _card()
    B, p, nd = 4, 1024, 1000
    ids = torch.randint(0, nd, (B, 32 * p), dtype=torch.int32, device=dev)
    ws = torch.zeros((B, 32 * p), device=dev)
    c_max = 4 * (1 << cuda_impact.RESCORE_MAX_LOG2_SLOTS) // 5
    before = cuda_impact.rescore.launches
    cand = torch.randint(0, nd, (B, c_max), device=dev)
    out = cuda_impact.rescore(cand, ids, ws, p, nd)  # the 128 KB table
    torch.cuda.synchronize()
    assert out.shape == (B, c_max) and (out == 0).all()
    assert cuda_impact.rescore.launches == before + 1
    with pytest.raises(ValueError):
        cuda_impact.rescore(torch.zeros((B, c_max + 1), dtype=torch.int32,
                                        device=dev), ids, ws, p, nd)
    with pytest.raises(ValueError):  # 33 columns
        cuda_impact.rescore(cand, torch.zeros((B, 33 * 8), dtype=torch.int32,
                                              device=dev),
                            torch.zeros((B, 33 * 8), device=dev), 8, nd)
    with pytest.raises(ValueError):  # not whole columns
        cuda_impact.rescore(cand, ids, ws, 1000, nd)
    with pytest.raises(ValueError):
        cuda_impact.rescore(cand, ids.long(), ws, p, nd)
    with pytest.raises(ValueError):
        cuda_impact.slice_runs(ids[0].long(), ws[0], torch.zeros((2, 8), dtype=torch.int32,
                                                                device=dev),
                               torch.zeros((2, 8), dtype=torch.int32, device=dev),
                               p, nd)
    assert cuda_impact.rescore.launches == before + 1
    before = cuda_impact.slice_runs.launches
    cuda_impact.slice_runs(ids[0], ws[0], torch.zeros((2, 8), dtype=torch.int32,
                                                      device=dev),
                           torch.full((2, 8), 3, dtype=torch.int32, device=dev),
                           p, nd)
    assert cuda_impact.slice_runs.launches == before + 1


def test_gpu_kmeans_fit_repeats_bitwise():
    from hybridsearch_tpu_torch.index.ivf import kmeans_assign, kmeans_fit

    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    centers = torch.randn((64, 384), generator=gen, device=dev) * 3
    pick = torch.randint(0, 64, (131_072,), generator=gen, device=dev)
    v = centers[pick] + torch.randn((131_072, 384), generator=gen, device=dev)
    a = kmeans_fit(v, 362, seed=0)
    b = kmeans_fit(v, 362, seed=0)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(kmeans_assign(v, a), kmeans_assign(v, b))
