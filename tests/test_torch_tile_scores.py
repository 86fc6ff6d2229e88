"""K4's group table and pass 3 of the dense top-k on K4's route (at tile
grain), against a plain numpy construction and the JAX package, on the CPU.

On a CPU tensor K4's wrapper runs its plain version, which goes through
the card route's bookkeeping (the pair sort, query and destination rows),
so pass 3 is driven through K4 at ``sd = ch = 128`` to check it here. Inputs come from a seeded
numpy generator. Tolerances: the group table and the pair bookkeeping are
integers and must be equal; scores rtol = atol = 1e-5 (unit rows; float32
sums in another order than the JAX einsum), ids exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybridsearch_tpu.ops.dense as jd
from hybridsearch_tpu.ops import pallas_supertile as jps
import hybridsearch_tpu_torch.ops.dense as td
from hybridsearch_tpu_torch.ops import cuda_supertile as tcs

TOL = dict(rtol=1e-5, atol=1e-5)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _table_numpy(tid, units, group):
    """The group table built run by run: each run of equal clamped keys
    cut every ``group`` positions, group at i in slot i // group + key + 1."""
    key = np.clip(tid, -1, units)
    g_max = -(-len(key) // group) + units + 2
    start, length, gkey = (np.zeros(g_max, np.int64) for _ in range(3))
    i = 0
    while i < len(key):
        j = i
        while j < len(key) and key[j] == key[i]:
            j += 1
        for s0 in range(i, j, group):
            slot = s0 // group + key[i] + 1
            assert length[slot] == 0, "two groups in one slot"
            start[slot], length[slot], gkey[slot] = s0, min(group, j - s0), key[i]
        i = j
    return start, length, gkey


@pytest.mark.parametrize("group", [8, 32, 128])
@pytest.mark.parametrize("case", ["runs", "uniform", "one_unit"])
def test_group_table_plain_matches_numpy(group, case):
    rng = np.random.default_rng(group)
    units = 40
    if case == "runs":  # long runs, single pairs, ids past both ends
        tid = np.concatenate([np.full(3, -5), np.full(300, 0), [2], np.full(33, 5),
                              np.full(129, 7), [39], np.full(4, 40), np.full(2, 77)])
    elif case == "uniform":
        tid = np.sort(rng.integers(0, units, 1000))
    else:
        tid = np.full(257, 11)
    got = tcs.group_table_plain(torch.from_numpy(tid.astype(np.int32)), units, group)
    want = _table_numpy(tid, units, group)
    used = want[1] > 0
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy()[used], want[0][used])
    np.testing.assert_array_equal(got[2].numpy()[used], want[2][used])
    assert want[1].sum() == len(tid) and want[1].max() <= group


@pytest.mark.parametrize("B,S,n_super", [(16, 4, 6), (8, 2, 4), (5, 3, 40)])
def test_sort_pairs_matches_jax_dedup_pairs(B, S, n_super):
    """The card route's lean bookkeeping: the same sorted ids and queries
    as JAX's dedup_pairs, and destinations that put each pair back."""
    rng = np.random.default_rng(B + S)
    sup = np.sort(rng.integers(0, n_super, (B, S)), axis=1).astype(np.int32)
    jtid, jqid, _rep, _inv = jps.dedup_pairs(jnp.asarray(sup))
    tid, qid, dst = tcs.sort_pairs(torch.from_numpy(sup), S)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jtid))
    np.testing.assert_array_equal(qid.numpy(), np.asarray(jqid))
    assert tid.dtype == qid.dtype == dst.dtype == torch.int32
    np.testing.assert_array_equal(sup.reshape(-1)[dst.numpy()], tid.numpy())
    np.testing.assert_array_equal(dst.numpy() // S, qid.numpy())


def test_pair_width_at_the_paths_shapes():
    """The narrowest width that holds twice the mean pairs a unit: K2/K4
    at S = 2..16 probes of 256 queries over 32 supertiles, pass 3 at 512,
    1,024 and 2,048 tiles a query over 4,096 tiles."""
    got = [tcs.pair_width(256 * S, 32) for S in (2, 4, 8, 16)]
    assert got == [32, 64, 128, 128]
    assert [tcs.pair_width(256 * kd, 4096) for kd in (512, 1024, 2048)] == [64, 128, 128]
    assert tcs.pair_width(3, 1000) == 32 and tcs.pair_width(0, 5) == 32


def _k4_tile_scores(q, docs, tiles, tile):
    """Pass 3's card route on the CPU: K4 at sd = ch = tile (its plain
    version, through the card route's pair bookkeeping)."""
    return tcs.super_scores_dedup(q, docs, tiles, tile, ch=tile)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_tile_scores_on_k4_route_matches_jax(dtype, monkeypatch):
    """Pass 3 through the card route's bookkeeping and K4's plain version at
    sd = ch = 128 equals the JAX package's gather_tile_scores: a partial
    last tile, bias-dead rows and tile ids past the end (scored -inf)."""
    monkeypatch.setattr(td, "_on_card", lambda t: True)
    calls = []

    def by_pairs(*a, **k):
        calls.append(1)
        return _k4_tile_scores(*a, **k)

    monkeypatch.setattr(td, "tile_scores", by_pairs)
    rng = np.random.default_rng(40)
    n, D, B, KT = 128 * 12 - 37, 128, 6, 7
    docs, q = _unit(rng, n, D), _unit(rng, B, D)
    bias = np.zeros(n, np.float32)
    bias[rng.choice(n, 60, replace=False)] = -np.inf
    tiles = np.stack([rng.choice(12, KT, replace=False) for _ in range(B)]).astype(np.int32)
    tiles[0, :3] = [11, 12, 15]  # the partial tile, two past the end
    tiles[1, :] = tiles[2, :]    # two queries sharing every tile
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ws, wg = jd.gather_tile_scores(jnp.asarray(q), jnp.asarray(docs).astype(jdt),
                                   jnp.asarray(tiles), jnp.asarray(bias))
    tdocs = torch.from_numpy(docs).to(getattr(torch, dtype))
    gs, gg = td.gather_tile_scores(torch.from_numpy(q), tdocs, torch.from_numpy(tiles),
                                   torch.from_numpy(bias))
    assert calls == [1]
    ws = np.asarray(ws)
    np.testing.assert_array_equal(np.isinf(gs.numpy()), np.isinf(ws))
    np.testing.assert_allclose(gs.numpy(), ws, **TOL)
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    assert np.isinf(gs.numpy()[0, 128:384]).all()


@pytest.mark.parametrize("probe_tiles", [None, 3])
def test_tiled_dense_topk_on_k4_route_matches_jax(probe_tiles, monkeypatch):
    """The whole three-pass top-k with pass 3 on the card route's
    bookkeeping: values, ids, stats and the covered flag as JAX's."""
    monkeypatch.setattr(td, "_on_card", lambda t: True)
    monkeypatch.setattr(td, "tile_scores", _k4_tile_scores)
    rng = np.random.default_rng(41)
    n, D, B, k = 128 * 20 - 5, 64, 5, 40
    docs, q = _unit(rng, n, D), _unit(rng, B, D)
    bias = np.zeros(n, np.float32)
    bias[rng.choice(n, 90, replace=False)] = -np.inf
    want = jd.tiled_dense_topk(jnp.asarray(q), jnp.asarray(docs), k,
                               bias=jnp.asarray(bias), with_stats=True,
                               probe_tiles=probe_tiles)
    got = td.tiled_dense_topk(torch.from_numpy(q), torch.from_numpy(docs), k,
                              bias=torch.from_numpy(bias), with_stats=True,
                              probe_tiles=probe_tiles)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if probe_tiles is not None:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_super_scores_dedup_plain_takes_any_order(dtype):
    """K4's plain version on an id table in no order (ids repeated within
    and across queries, below 0 and past the end) equals K2's plain version
    on it bit for bit: the pair sort puts every row back at its place."""
    rng = np.random.default_rng(42)
    B, S, D, sd, ch = 6, 3, 64, 256, 128
    N = 5 * sd
    dt = getattr(torch, dtype)
    docs = torch.from_numpy(_unit(rng, N, D)).to(dt)
    q = torch.from_numpy(_unit(rng, B, D)).to(dt)
    sup = torch.from_numpy(rng.integers(-1, 7, (B, S)).astype(np.int32))
    sup[1] = torch.tensor([4, 4, 0], dtype=torch.int32)
    assert not bool((sup[:, 1:] >= sup[:, :-1]).all())
    got = tcs.super_scores_dedup(q, docs, sup, sd, ch=ch)
    assert got.shape == (B, S * sd)
    assert torch.equal(got, tcs.super_scores_plain(q, docs, sup, sd, ch))
