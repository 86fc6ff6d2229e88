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
The impact kernels are held to 0: the slice kernel copies (and is held
to its first design bit for bit), and the rescore kernel adds the same
float32 weights in the same column order as its plain version. Two k-means fits from one seed must be equal bit for
bit. K2 and K4 run one scoring body and are held to each other and to
their first designs bit for bit; pass 3 on the card (K4 at tile grain) is
held to its plain version within 1e-5 and its tile maxima to K1's bit for
bit (the same fmaf chain a score). K5 adds the
same weights in the same slot order as the staged windows + K3 and as its
first design, and is held to both bit for bit; K7 to its first design and
its plain version likewise. The run-ordered BM25 sum and the top-k scatter must
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
@pytest.mark.parametrize("D", [128, 384, 768])
@pytest.mark.parametrize("B", [1, 17, 32, 100, 256])
def test_gpu_tile_stats_equals_v1_bitwise(dtype, D, B):
    """The redesigned K1 against its first design, bit for bit: 301 tiles
    (not a multiple of the persistent grid), n_valid < N, bias with -inf
    and negative-finite rows, with_min off and on; and within the stated
    tolerance of the plain version."""
    from hybridsearch_tpu_torch.ops.cuda_topk import (
        tile_stats,
        tile_stats_plain,
        tile_stats_v1,
    )

    dev = _card()
    rng = np.random.default_rng(10 + D + B)
    N = 128 * 301
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    b = np.zeros(N, np.float32)
    b[rng.choice(N, 700, replace=False)] = -np.inf
    b[rng.choice(N, 700, replace=False)] = -0.25
    b[:128] = -np.inf  # a tile with no alive row
    bias = torch.from_numpy(b).to(dev)
    n_valid = N - 77
    tol = 1e-5 if dtype == "float32" else 1e-3
    for with_min in (False, True):
        got = tile_stats(q, docs, bias, n_valid=n_valid, with_min=with_min)
        want = tile_stats_v1(q, docs, bias, n_valid=n_valid, with_min=with_min)
        torch.cuda.synchronize()
        assert len(got) == len(want) == 1 + with_min
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        plain = tile_stats_plain(q, docs, bias, n_valid=n_valid, with_min=with_min)
        for g, w in zip(got, plain):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    assert torch.isinf(got[1][0]).all() and torch.isinf(got[0][-1]).logical_not().all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [257, 600])
def test_gpu_tile_stats_past_one_query_block_equals_v1_bitwise(dtype, B):
    """Past 256 queries a tile's queries span several 256-wide blocks, the
    last one partial; the bits stay the first design's."""
    from hybridsearch_tpu_torch.ops.cuda_topk import tile_stats, tile_stats_v1

    dev = _card()
    rng = np.random.default_rng(11)
    N, D = 128 * 530, 384
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    got = tile_stats(q, docs, None, n_valid=N - 1000, with_min=True)
    want = tile_stats_v1(q, docs, None, n_valid=N - 1000, with_min=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _order_sensitive_windows(gen, dev, rows, te):
    """Windows that break every shortcut of the chunk order: each chunk of
    1,024 entries names 1,024 distinct cells (a stride prime to the
    range, out-of-range and negative ids among them), consecutive chunks
    name the same cells, weights span ten orders of magnitude with both
    signs (so another order of adds gives other bits), every fifth chunk
    weighs nothing."""
    R, M = 128 * 128, 128 * 128 + 128
    n_chunks = -(-te // 1024)
    start = torch.randint(0, M, (rows, (n_chunks + 1) // 2, 1), generator=gen,
                          device=dev).repeat_interleave(2, dim=1)[:, :n_chunks]
    l = ((start + 1021 * torch.arange(1024, device=dev)) % M - 64).reshape(rows, -1)
    l = l[:, :te].int().contiguous()
    mag = 10.0 ** torch.randint(-5, 5, (rows, te), generator=gen, device=dev)
    sign = torch.randint(0, 2, (rows, te), generator=gen, device=dev) * 2 - 1
    w = torch.rand((rows, te), generator=gen, device=dev) * mag * sign
    w[:, ::5] = 0.0
    for c in range(4, n_chunks, 5):
        w[:, c * 1024:(c + 1) * 1024] = 0.0
    return l, w.float().contiguous()


@pytest.mark.parametrize("BS", [1, 513, 4096])
@pytest.mark.parametrize("te", [1024, 24 * 1024, 3 * 1024 + 6])
def test_gpu_place_windows_equals_v1_bitwise(BS, te):
    """The redesigned K3 against its first design, bit for bit, on windows
    whose sums depend on the chunk order (``te`` not a multiple of 4 takes
    the scalar loads), and equal to the plain version too (it adds the
    same weights chunk by chunk, a chunk's cells distinct)."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        place_windows,
        place_windows_plain,
        place_windows_v1,
    )

    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    l, w = _order_sensitive_windows(gen, dev, BS, te)
    got = place_windows(l, w)
    want = place_windows_v1(l, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, place_windows(l, w))
    plain = place_windows_plain(l, w)
    assert torch.equal(got, plain)
    assert (got != 0).any()


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
    """K4 on the probe table writes K2's query-major layout with no
    unpermute: the same bits as K2, and as the first design on the pairs
    ``dedup_pairs`` sorts, unpermuted. ``shared``: runs of equal ids longer
    than 32 pairs, and ids below 0 or past the last supertile (first or
    last chunk throughout)."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        super_scores,
        super_scores_dedup,
        super_scores_dedup_plain,
        super_scores_dedup_v1,
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
    k4 = super_scores_dedup(q, docs, sup_t, sd, ch=ch)
    want = super_scores(q, docs, sup_t, sd, ch=ch)
    torch.cuda.synchronize()
    assert torch.equal(k4, want)
    jtid, jqid, _rep, inv = dedup_pairs(sup_t)
    assert torch.equal(super_scores_dedup_v1(q[jqid], docs, jtid, sd, ch=ch)[inv]
                       .reshape(B, -1), k4)
    tol = 1e-5 if dtype == "float32" else 1e-3
    torch.testing.assert_close(k4, super_scores_dedup_plain(q, docs, sup_t, sd, ch=ch),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd,ch", [(128, 128), (4096, 1024)])
def test_gpu_super_scores_dedup_unsorted_table_gives_k2_bits(dtype, sd, ch):
    """An id table in no order (each query's probes shuffled, ids repeated
    within and across queries) gives K2's bits on the same table: K4's
    wrapper sorts the pairs itself, so no order reaches the kernel's group
    table unsorted."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import super_scores, super_scores_dedup

    dev = _card()
    rng = np.random.default_rng(8)
    D, B, S = 384, 96, 6
    units = 24
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, units * sd, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    ids = rng.integers(0, units, (B, S)).astype(np.int32)
    ids[:40, :3] = [7, 2, 7]  # a long run and repeats within a query
    assert not (np.diff(ids, axis=1) >= 0).all()
    ids_t = torch.from_numpy(ids).to(dev)
    got = super_scores_dedup(q, docs, ids_t, sd, ch=ch)
    torch.cuda.synchronize()
    assert torch.equal(got, super_scores(q, docs, ids_t, sd, ch=ch))


def _bench_case(dev, dtype, S, seed):
    """B = 256 queries over 8 supertiles of 16,384 x 384 rows (the slice's
    widths), each query probing S of them sorted, some probes past the end."""
    rng = np.random.default_rng(seed)
    sd, D, B = 16384, 384, 256
    N = 8 * sd
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    sup = np.sort(rng.integers(0, 8 + S // 4, (B, S)), axis=1).astype(np.int32)
    return docs, q, torch.from_numpy(sup).to(dev), sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 4, 8, 16])
def test_gpu_super_scores_equal_v1_bitwise(dtype, S):
    """The redesigned K2 and K4 against their first designs, bit for bit,
    at every probe count of the ladder (each width of the pair groups)."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        super_scores,
        super_scores_dedup,
        super_scores_dedup_v1,
        super_scores_v1,
    )
    from hybridsearch_tpu_torch.ops.supertile import dedup_pairs

    dev = _card()
    docs, q, sup, sd = _bench_case(dev, dtype, S, 20 + S)
    B = q.shape[0]
    k2 = super_scores(q, docs, sup, sd)
    assert torch.equal(k2, super_scores_v1(q, docs, sup, sd))
    k4 = super_scores_dedup(q, docs, sup, sd)
    torch.cuda.synchronize()
    assert torch.equal(k4, k2)
    jtid, jqid, _rep, inv = dedup_pairs(sup)
    assert torch.equal(super_scores_dedup_v1(q[jqid], docs, jtid, sd)[inv].reshape(B, -1),
                       k4)


def _k4_cases(n_units, B):
    """Sorted unit ids of query-major pairs (query b = pair // n) for K4's
    group table: a run longer than every pair width, runs that cross the
    first design's 32-pair windows, single-pair runs, ids past the last
    unit and below 0 (clamped chunks), and units no pair names."""
    runs = [(-2, 1), (0, 300), (2, 5), (3, 1), (4, 29), (5, 40), (7, 1), (8, 33),
            (n_units - 1, 64), (n_units + 4, 2), (n_units + 9, 1)]
    ids = np.concatenate([np.full(c, u) for u, c in runs]).astype(np.int32)
    P = len(ids)
    ids = np.concatenate([ids, np.full(B * -(-P // B) - P, n_units - 1, np.int32)])
    return ids.reshape(B, -1)


@pytest.mark.parametrize("sd,ch", [(128, 128), (16384, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_super_scores_dedup_group_cases(sd, ch, dtype):
    """K4 at sd = 128 (a tile) and sd = 16,384 on ``_k4_cases``' runs, each
    pair in a random query-major order: equal to K2 on the same probe table
    bit for bit (and to the first design at 16,384), within the stated
    tolerance of the plain version; its group table equals the plain one."""
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        PAIR_WIDTHS,
        group_table,
        group_table_plain,
        n_units,
        pair_width,
        sort_pairs,
        super_scores,
        super_scores_dedup,
        super_scores_dedup_plain,
        super_scores_v1,
    )

    dev = _card()
    rng = np.random.default_rng(30)
    D, B = 384, 64
    units = 40 if sd == 128 else 12
    N = units * sd
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev, dt)
    table = _k4_cases(units, B)
    flat = table.reshape(-1).copy()
    rng.shuffle(flat)
    ids = torch.from_numpy(flat.reshape(B, -1)).to(dev)
    S = ids.shape[1]
    got = super_scores_dedup(q, docs, ids, sd, ch=ch)
    k2 = super_scores(q, docs, ids, sd, ch=ch)
    torch.cuda.synchronize()
    assert torch.equal(got, k2)
    if ch % 256 == 0:
        assert torch.equal(k2, super_scores_v1(q, docs, ids, sd, ch=ch))
    tol = 1e-5 if dtype == "float32" else 1e-3
    torch.testing.assert_close(got, super_scores_dedup_plain(q, docs, ids, sd, ch=ch),
                               rtol=tol, atol=tol)
    tid, _qid, _dst = sort_pairs(ids, S)
    U = n_units(N, sd, ch)
    for group in PAIR_WIDTHS + (pair_width(tid.shape[0], U),):
        g_start, g_len, g_key = group_table(tid, U, group)
        p_start, p_len, p_key = group_table_plain(tid, U, group)
        used = p_len > 0
        assert torch.equal(g_len, p_len) and int(g_len.sum()) == tid.shape[0]
        assert torch.equal(g_start[used], p_start[used])
        assert torch.equal(g_key[used], p_key[used])
        assert int(g_len.max()) <= group


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_gather_tile_scores_matches_plain(dtype):
    """Pass 3 on the card (K4 at tile grain) against its plain version on
    the CPU: unit rows, a bias that kills rows, a partial last tile and
    tile ids past the end. Tolerance 1e-5: the kernel sums in depth order,
    the einsum in its own."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs
    from hybridsearch_tpu_torch.ops import dense

    dev = _card()
    rng = np.random.default_rng(31)
    N, D, B, KT = 128 * 300 - 50, 384, 96, 160
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dt)
    q = torch.from_numpy(_unit(rng, B, D))
    b = np.zeros(N, np.float32)
    b[rng.choice(N, 900, replace=False)] = -np.inf
    bias = torch.from_numpy(b)
    tt = np.stack([rng.choice(300, KT, replace=False) for _ in range(B)])
    tt[:, :3] = [299, 300, 310]  # the partial tile and two past the end
    top = torch.from_numpy(tt)
    before = cs.super_scores_dedup.launches
    got, gidx = dense.gather_tile_scores(q.to(dev), docs.to(dev), top.to(dev),
                                         bias.to(dev))
    torch.cuda.synchronize()
    assert cs.super_scores_dedup.launches == before + 1
    want, widx = dense.gather_tile_scores(q, docs, top, bias)
    assert torch.equal(gidx.cpu(), widx)
    got = got.cpu()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.isinf(got[:, 128:384]).all() and torch.isfinite(got).float().mean() > 0.9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_rescored_tile_max_equals_k1_bitwise(dtype):
    """Pass 3's scores are K1's arithmetic: each rescored tile's max over
    its alive rows equals K1's tile max for that (query, tile) bit for bit,
    with a bias that kills rows (a whole tile of them) and a partial last
    tile, so the certificate's ``covered`` flag compares like with like."""
    from hybridsearch_tpu_torch.ops import dense
    from hybridsearch_tpu_torch.ops.cuda_topk import tile_stats

    dev = _card()
    rng = np.random.default_rng(32)
    N, D, B = 128 * 257 - 77, 384, 256
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dev, dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dev)
    b = np.zeros(N, np.float32)
    b[rng.choice(N, 3000, replace=False)] = -np.inf
    b[128:256] = -np.inf
    d, bias_p, n_tiles, _ = dense._pad_rows(docs, torch.from_numpy(b).to(dev), 128)
    top = torch.stack([torch.randperm(n_tiles, device=dev) for _ in range(B)])
    s = dense._tile_scores(q, d, top, bias_p, N, 128).view(B, n_tiles, 128)
    q_mm = q.to(torch.bfloat16) if dt == torch.bfloat16 else q
    (k1,) = tile_stats(q_mm, d, bias_p, n_valid=N)
    torch.cuda.synchronize()
    assert torch.equal(s.amax(dim=2), torch.gather(k1.T, 1, top))
    assert torch.isinf(k1[1]).all() and torch.isfinite(k1[-1]).all()


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


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("idx", ["int64", "int32"])
@pytest.mark.parametrize("S", [2, 16])
@pytest.mark.parametrize("wcaps", [(8192,) * 8, (8192, 2048, 2048, 2048, 512, 512,
                                                  512, 512)])
def test_gpu_place_fused_equals_v1_bitwise(wcaps, S, idx, aligned):
    """K5 against its first design at B*S = 512 and 4,096 rows, with
    overflowing, empty and past-the-table windows, on int64 bounds (the
    path's) and int32 ones, and on CSR rows 4 bytes off 16-byte alignment
    (the kernel's 4-byte copies); and against the staged windows + K3."""
    from hybridsearch_tpu_torch.ops import supertile as st
    from hybridsearch_tpu_torch.ops.cuda_supertile import (
        place_fused,
        place_fused_v1,
        place_windows,
    )

    dev = _card()
    rng = np.random.default_rng(17)
    sp, term_ids, sup_s = _csr_case(dev, rng, S=S)
    lo, hi, base, ovf = st._flat_windows(sp.sup_pos, term_ids, sup_s, sp.super_docs,
                                         wcaps)
    assert lo.shape == (256 * S, 8) and ovf.any() and (lo == hi).any()
    lo, hi, base = (t.to(getattr(torch, idx)) for t in (lo, hi, base))
    ids_rows, ws_rows = sp.ids_rows, sp.ws_rows
    if not aligned:
        flat_i = torch.empty(ids_rows.numel() + 1, dtype=torch.int32, device=dev)
        flat_w = torch.empty(ws_rows.numel() + 1, device=dev)
        flat_i[1:], flat_w[1:] = ids_rows.reshape(-1), ws_rows.reshape(-1)
        ids_rows, ws_rows = flat_i[1:].view_as(ids_rows), flat_w[1:].view_as(ws_rows)
        assert ids_rows.data_ptr() % 16 and ws_rows.data_ptr() % 16
    got = place_fused(lo, hi, base, ids_rows, ws_rows, wcaps, sp.super_tiles)
    want = place_fused_v1(lo, hi, base, ids_rows, ws_rows, wcaps, sp.super_tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    l_cat, w_cat, _ovf = st._resident_windows(sp.sup_pos, sp.ids_rows, sp.ws_rows,
                                              term_ids, sup_s, sp.super_docs, wcaps)
    rows = 256 * S
    assert torch.equal(got, place_windows(l_cat.reshape(rows, -1),
                                          w_cat.reshape(rows, -1), sp.super_tiles))
    assert (got.reshape(rows, -1) != 0).any(dim=1).float().mean() > 0.5


def test_gpu_place_fused_few_rows_and_empty_slots_equal_v1_bitwise():
    """Fewer rows than blocks, rows whose every window is empty between
    rows that are not, and no slots at all: each row still written whole."""
    from hybridsearch_tpu_torch.ops import supertile as st
    from hybridsearch_tpu_torch.ops.cuda_supertile import place_fused, place_fused_v1

    dev = _card()
    rng = np.random.default_rng(18)
    sp, term_ids, sup_s = _csr_case(dev, rng, B=5, S=3)
    wcaps = (8192,) * 8
    lo, hi, base, _ovf = st._flat_windows(sp.sup_pos, term_ids, sup_s, sp.super_docs,
                                          wcaps)
    hi[1::3] = lo[1::3]
    got = place_fused(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps, sp.super_tiles)
    assert torch.equal(got, place_fused_v1(lo, hi, base, sp.ids_rows, sp.ws_rows,
                                           wcaps, sp.super_tiles))
    assert (got[1::3] == 0).all() and (got[::3] != 0).any()
    none = place_fused(lo[:, :0], hi[:, :0], base, sp.ids_rows, sp.ws_rows, (),
                       sp.super_tiles)
    torch.cuda.synchronize()
    assert none.shape == got.shape and (none == 0).all()


def test_gpu_gated_wrappers_count_launches_and_reject_bad_input():
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    dev = _card()
    docs = torch.zeros((2048, 384), device=dev)
    q = torch.zeros((3, 384), device=dev)
    ids = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    tid = torch.zeros(8, dtype=torch.int32, device=dev)
    before = cs.super_scores_dedup.launches
    assert cs.super_scores_dedup(q, docs, ids, 1024).shape == (3, 2 * 1024)
    assert cs.super_scores_dedup.launches == before + 1
    # no pairs: nothing launches, nothing is counted
    assert cs.super_scores_dedup(q, docs, ids[:, :0], 1024).shape == (3, 0)
    assert cs.super_scores_dedup.launches == before + 1
    with pytest.raises(ValueError):
        cs.super_scores_dedup(q.half(), docs.half(), ids, 1024)
    with pytest.raises(ValueError):  # one query short
        cs.super_scores_dedup(q, docs, ids[:2], 1024)
    with pytest.raises(ValueError):  # sd % ch != 0
        cs.super_scores_dedup(q, docs, ids, 1000)
    with pytest.raises(ValueError):  # the ids on another device
        cs.super_scores_dedup(q, docs, ids.cpu(), 1024)
    assert cs.super_scores_dedup.launches == before + 1
    # the first designs take CUDA tensors only, and their own shapes
    before = (cs.super_scores_v1.launches, cs.super_scores_dedup_v1.launches)
    sup = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        cs.super_scores_v1(q[:1].cpu().expand(4, -1), docs.cpu(), sup, 1024)
    with pytest.raises(ValueError):
        cs.super_scores_dedup_v1(q[:1].cpu().expand(8, -1), docs.cpu(), tid.cpu(), 1024)
    with pytest.raises(ValueError):  # ch % 256 != 0
        cs.super_scores_v1(q[:1].expand(4, -1), docs, sup.to(dev), 128, ch=128)
    assert (cs.super_scores_v1.launches, cs.super_scores_dedup_v1.launches) == before
    # tile_scores launches K4 and counts nothing of its own
    before = (cs.super_scores.launches, cs.super_scores_dedup.launches)
    out = cs.tile_scores(q, docs, torch.zeros((3, 5), dtype=torch.long, device=dev))
    assert out.shape == (3, 5 * 128)
    assert not hasattr(cs.tile_scores, "launches")
    assert (cs.super_scores.launches, cs.super_scores_dedup.launches) == (before[0],
                                                                          before[1] + 1)
    cs.super_scores(q, docs, sup.to(dev)[:3], 1024)
    assert cs.super_scores.launches == before[0] + 1

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


def _slice_cases(rng, dev, nnz, rows, p, nd):
    """Postings of nnz entries whose windows name a doc at most once, a
    tail of p sentinels (nd, 0), and (starts, lengths) [rows] int32 with
    starts at every residue mod 4 and lengths 0, < p, = p and > p in turn;
    then a run that ends at the tail (its slice reads into the sentinels),
    the sentinel slot (start nnz, length 0) and a negative length."""
    run = np.arange(nnz, dtype=np.int64) * 7919 % nd
    ids = np.concatenate([run, np.full(p, nd)]).astype(np.int32)
    ws = np.concatenate([rng.random(nnz) + 0.01, np.zeros(p)]).astype(np.float32)
    starts = (rng.integers(0, nnz - p, rows) // 4) * 4 + np.arange(rows) % 4
    kind = (np.arange(rows) // 4) % 4
    short = rng.integers(1, p, rows)
    lengths = np.choose(kind, [np.zeros(rows, np.int64), short, np.full(rows, p),
                               p + 1 + short])
    starts[-3:], lengths[-3:] = [nnz - 3, nnz, 5], [3, 0, -2]
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(dev)  # noqa: E731
    return (t(ids, np.int32), t(ws, np.float32), t(starts, np.int32),
            t(lengths, np.int32))


# (B, T, p): the ladder's (T, p) at B = 256 (T = 32: 8,192 rows), p not a
# multiple of 4, and B = 1 (8 rows)
SLICE_SHAPES = sorted({(256, T, p) for T, p, _C in LADDER_SHAPES}
                      | {(256, 8, 255), (256, 8, 1022), (256, 8, 4097), (1, 8, 256),
                         (1, 8, 4096), (256, 32, 256)})


@pytest.mark.parametrize("B,T,p", SLICE_SHAPES)
def test_gpu_slice_runs_equals_v1_and_plain_bitwise(B, T, p):
    """K6 against its first design and its plain version, bit for bit, on
    starts at every residue mod 4, lengths 0, < p, = p, > p and negative,
    a slice that reads into the sentinel tail and the sentinel slot."""
    from hybridsearch_tpu_torch.ops.cuda_impact import (
        slice_runs,
        slice_runs_plain,
        slice_runs_v1,
    )

    dev = _card()
    rng = np.random.default_rng(24)
    nd = 600_000
    ids, ws, starts, lengths = _slice_cases(rng, dev, 2_000_000, B * T, p, nd)
    starts, lengths = starts.reshape(B, T), lengths.reshape(B, T)
    got = slice_runs(ids, ws, starts, lengths, p, nd)
    v1 = slice_runs_v1(ids, ws, starts, lengths, p, nd)
    plain = slice_runs_plain(ids, ws, starts, lengths, p, nd)
    torch.cuda.synchronize()
    for want in (v1, plain):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == got[1].shape == (B * T, p)
    assert got[0].is_contiguous() and got[1].is_contiguous()
    assert (got[0][-2] == nd).all() and (got[1][-2] == 0).all()  # the sentinel slot


def test_gpu_slice_runs_v1_counts_launches_and_refuses_cpu_tensors():
    """``slice_runs_v1`` launches on CUDA tensors and counts its own
    launches (not the served wrapper's); it raises on CPU tensors and on
    mixed devices without counting."""
    from hybridsearch_tpu_torch.ops import cuda_impact as ci

    dev = _card()
    ids = torch.zeros(64, dtype=torch.int32, device=dev)
    ws = torch.zeros(64, device=dev)
    starts = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    before = (ci.slice_runs_v1.launches, ci.slice_runs.launches)
    out = ci.slice_runs_v1(ids, ws, starts, starts + 3, 16, 100)
    torch.cuda.synchronize()
    assert out[0].shape == out[1].shape == (16, 16)
    after = (before[0] + 1, before[1])
    assert (ci.slice_runs_v1.launches, ci.slice_runs.launches) == after
    with pytest.raises(ValueError):
        ci.slice_runs_v1(ids.cpu(), ws.cpu(), starts.cpu(), starts.cpu(), 16, 100)
    with pytest.raises(ValueError):  # the weights on another device
        ci.slice_runs_v1(ids, ws.cpu(), starts, starts, 16, 100)
    assert (ci.slice_runs_v1.launches, ci.slice_runs.launches) == after


# LADDER_SHAPES, then p not a multiple of 4 (4-byte copies): whole rows
# staged, and a column cut into ring chunks
V1_SHAPES = LADDER_SHAPES + [(8, 255, 1024), (8, 1022, 128), (8, 4097, 4096)]


@pytest.mark.parametrize("T,p,C", V1_SHAPES)
def test_gpu_rescore_equals_v1_bitwise(T, p, C):
    """K7 against its first design and its plain version at the three
    rungs, T = 16 and 32, the margin call, and widths p not a multiple of
    4, with repeated candidates, sentinels and -1."""
    from hybridsearch_tpu_torch.ops.cuda_impact import (
        rescore,
        rescore_plain,
        rescore_v1,
        slice_runs,
    )

    dev = _card()
    rng = np.random.default_rng(14)
    B, nd = 256, 600_000
    ids, ws, starts, lengths = _impact_inputs(rng, dev, B, T, p, nd)
    got_i, got_w = slice_runs(ids, ws, starts, lengths, p, nd)
    ids_flat, ws_flat = got_i.reshape(B, T * p), got_w.reshape(B, T * p)
    cand = ids_flat[:, torch.randperm(T * p, device=dev)[:C]].clone()
    cand[:, 1::13] = cand[:, :1]
    cand[:, -3:] = torch.tensor([nd, nd + 2, -1], device=dev)
    got = rescore(cand, ids_flat, ws_flat, p, nd)
    want = rescore_v1(cand, ids_flat, ws_flat, p, nd)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, rescore_plain(cand, ids_flat, ws_flat, p, nd))
    assert (got[:, -3:] == 0).all() and (got > 0).any()


def test_gpu_first_designs_count_launches_and_refuse_cpu_tensors():
    """``place_fused_v1`` and ``rescore_v1`` launch on CUDA tensors, count
    their own launches (not the served wrappers'), and raise on CPU
    tensors without counting."""
    from hybridsearch_tpu_torch.ops import cuda_impact as ci
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    dev = _card()
    ids = torch.zeros((16, 128), dtype=torch.int32, device=dev)
    ws = torch.zeros((16, 128), device=dev)
    lo = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    base = torch.zeros(4, dtype=torch.int32, device=dev)
    cand = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    flat_i = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    flat_w = torch.zeros((2, 16), device=dev)
    before = (cs.place_fused_v1.launches, cs.place_fused.launches,
              ci.rescore_v1.launches, ci.rescore.launches)
    assert cs.place_fused_v1(lo, lo + 5, base, ids, ws, (512,) * 3).shape == (4, 128, 128)
    assert ci.rescore_v1(cand, flat_i, flat_w, 8, 100).shape == (2, 8)
    torch.cuda.synchronize()
    after = (before[0] + 1, before[1], before[2] + 1, before[3])
    assert (cs.place_fused_v1.launches, cs.place_fused.launches,
            ci.rescore_v1.launches, ci.rescore.launches) == after
    with pytest.raises(ValueError):
        cs.place_fused_v1(lo.cpu(), lo.cpu(), base.cpu(), ids.cpu(), ws.cpu(), (512,) * 3)
    with pytest.raises(ValueError):
        ci.rescore_v1(cand.cpu(), flat_i.cpu(), flat_w.cpu(), 8, 100)
    with pytest.raises(ValueError):  # the ids on another device
        cs.place_fused_v1(lo, lo, base, ids.cpu(), ws, (512,) * 3)
    assert (cs.place_fused_v1.launches, cs.place_fused.launches,
            ci.rescore_v1.launches, ci.rescore.launches) == after


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
