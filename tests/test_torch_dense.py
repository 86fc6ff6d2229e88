"""The port's dense and fusion ops against the JAX package's, on the CPU.

Inputs come from a seeded numpy generator and go to both packages.
Tolerances: scores rtol=1e-4, atol=1e-5 (float32 sums in another order);
ids exact (random unit vectors leave no ties within that tolerance).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybridsearch_tpu.ops.dense as jd
import hybridsearch_tpu.ops.fusion as jf
import hybridsearch_tpu_torch.ops.dense as td
import hybridsearch_tpu_torch.ops.fusion as tf

TOL = dict(rtol=1e-4, atol=1e-5)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bias(rng, n, dead):
    b = np.zeros(n, np.float32)
    b[rng.choice(n, dead, replace=False)] = -np.inf
    return b


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(0).standard_normal((7, 33)).astype(np.float32)
    x[3] = 0.0  # zero rows stay zero under the eps guard
    np.testing.assert_allclose(td.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jd.l2_normalize(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("n", [1000, 1024])
def test_dense_tile_stats_matches_jax(n):
    """Alive max/min over a padded, tombstoned corpus (n % 128 != 0 pads)."""
    rng = np.random.default_rng(n)
    docs, q, bias = _unit(rng, n, 64), _unit(rng, 5, 64), _bias(rng, n, 40)
    want = jd.dense_tile_stats(jnp.asarray(q), jnp.asarray(docs),
                               jnp.asarray(bias), block_n=256)
    got = td.dense_tile_stats(torch.from_numpy(q), torch.from_numpy(docs),
                              torch.from_numpy(bias))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_dense_tile_stats_kernel_route_matches_jax(monkeypatch):
    """With the kernel route taken (K1's wrapper, its plain version on the
    CPU), the [n_tiles, B] layout is turned back into [B, n_tiles] right."""
    calls = []
    real = td.tile_stats
    monkeypatch.setattr(td, "_on_card", lambda t: True)
    monkeypatch.setattr(td, "tile_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    n = 64 * 128  # the kernel route needs >= 64 tiles
    docs, q, bias = _unit(rng, n, 128), _unit(rng, 3, 128), _bias(rng, n, 100)
    want = jd.dense_tile_stats(jnp.asarray(q), jnp.asarray(docs),
                               jnp.asarray(bias))
    got = td.dense_tile_stats(torch.from_numpy(q), torch.from_numpy(docs),
                              torch.from_numpy(bias))
    assert calls
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("probe_tiles", [None, 2])
def test_tiled_dense_topk_matches_jax(probe_tiles):
    rng = np.random.default_rng(7)
    n, k = 3000, 10
    docs, q, bias = _unit(rng, n, 64), _unit(rng, 6, 64), _bias(rng, n, 100)
    want = jd.tiled_dense_topk(jnp.asarray(q), jnp.asarray(docs), k,
                               block_n=1024, bias=jnp.asarray(bias),
                               with_stats=True, probe_tiles=probe_tiles)
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
    # exact against a brute-force oracle wherever the result is covered
    s = q @ docs.T + bias[None, :]
    rows = np.ones(len(q), bool) if probe_tiles is None else got[4].numpy()
    np.testing.assert_array_equal(got[1].numpy()[rows, :3],
                                  np.argsort(-s, axis=1)[rows, :3])


def test_tiled_matrix_topk_and_gather_tile_scores_match_jax():
    rng = np.random.default_rng(9)
    s = rng.standard_normal((4, 5000)).astype(np.float32)
    wv, wi = jd.tiled_matrix_topk(jnp.asarray(s), 17)
    gv, gi = td.tiled_matrix_topk(torch.from_numpy(s), 17)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))

    n = 1000
    docs, q, bias = _unit(rng, n, 32), _unit(rng, 4, 32), _bias(rng, n, 30)
    tiles = np.array([[0, 7], [3, 1], [7, 7], [2, 5]], np.int32)  # 7 = partial
    ws, wg = jd.gather_tile_scores(jnp.asarray(q), jnp.asarray(docs),
                                   jnp.asarray(tiles), jnp.asarray(bias))
    gs, gg = td.gather_tile_scores(torch.from_numpy(q), torch.from_numpy(docs),
                                   torch.from_numpy(tiles), torch.from_numpy(bias))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))


def test_scatter_topk_to_dense_matches_jax():
    vals = np.array([[0.5, 0.2, -1.0], [0.9, 0.1, 0.3]], np.float32)
    idxs = np.array([[3, 0, -1], [1, 4, 2]], np.int32)
    want = jd.scatter_topk_to_dense(jnp.asarray(vals), jnp.asarray(idxs), 6)
    got = td.scatter_topk_to_dense(torch.from_numpy(vals), torch.from_numpy(idxs), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fusion_ops_match_jax():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 50)).astype(np.float32)
    b = rng.random((3, 50)).astype(np.float32)
    b[1] = 0.25  # constant row -> all-ones under min-max
    for norm in ("minmax", "max", "none"):
        np.testing.assert_allclose(
            tf.weighted_fusion(torch.from_numpy(a), torch.from_numpy(b), 0.6, 0.4,
                               normalize=norm).numpy(),
            np.asarray(jf.weighted_fusion(jnp.asarray(a), jnp.asarray(b), 0.6, 0.4,
                                          normalize=norm)), **TOL)
    np.testing.assert_allclose(
        tf.rrf_fusion(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jf.rrf_fusion(jnp.asarray(a), jnp.asarray(b))), **TOL)
    tf.validate_weights(0.7, 0.3)
    with pytest.raises(ValueError):
        tf.validate_weights(0.7, 0.4)


# -- cosine matrices, dense_topk's dispatch, the int8 sweep -------------------

def test_cosine_scores_and_pairwise_cosine_match_jax():
    rng = np.random.default_rng(21)
    q = rng.standard_normal((5, 48)).astype(np.float32) * 3.0  # raw rows
    d = rng.standard_normal((70, 48)).astype(np.float32)
    np.testing.assert_allclose(
        td.cosine_scores(torch.from_numpy(q), torch.from_numpy(d)).numpy(),
        np.asarray(jd.cosine_scores(jnp.asarray(q), jnp.asarray(d))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        td.pairwise_cosine(torch.from_numpy(d)).numpy(),
        np.asarray(jd.pairwise_cosine(jnp.asarray(d))), rtol=0, atol=1e-5)


def _ties_ok(got_v, got_i, want_v, want_i, tie=1e-6):
    """Values within 1e-5; ids equal except at a slot whose wanted value
    another slot matches within ``tie``."""
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5)
    for b, j in zip(*np.nonzero(np.asarray(got_i) != np.asarray(want_i))):
        assert (np.abs(want_v[b] - want_v[b][j]) <= tie).sum() > 1, (b, j)


@pytest.mark.parametrize("n,normalized,use_tiled", [
    (500, True, None),      # below 4 * block_n: the scan route
    (4096, True, None),     # from 4 * block_n: the tiled route
    (1500, False, True),    # raw rows, the tiled route asked for
    (300, True, False),     # k past N, the scan route
])
def test_dense_topk_routes_match_jax(n, normalized, use_tiled):
    rng = np.random.default_rng(n)
    d = rng.standard_normal((n, 64)).astype(np.float32)
    q = rng.standard_normal((6, 64)).astype(np.float32)
    if normalized:
        d, q = _unit(rng, n, 64), _unit(rng, 6, 64)
    k = 400 if n == 300 else 10
    want = jd.dense_topk(jnp.asarray(q), jnp.asarray(d), k, block_n=1024,
                         normalized=normalized, use_tiled=use_tiled)
    got = td.dense_topk(torch.from_numpy(q), torch.from_numpy(d), k, block_n=1024,
                        normalized=normalized, use_tiled=use_tiled)
    assert got[0].shape == (6, min(k, n))
    _ties_ok(got[0].numpy(), got[1].numpy(), np.asarray(want[0]), np.asarray(want[1]))


def _int8_corpus(n, d, seed, clustered=True):
    """tests/test_int8_sweep.py's corpora: 16 clusters, or none."""
    rng = np.random.default_rng(seed)
    if clustered:
        cents = rng.standard_normal((16, d)).astype(np.float32)
        x = cents[rng.integers(0, 16, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n", [1024, 1000])
def test_quantize_corpus_int8_matches_jax(n):
    """scale equal; d8 equal but at half-way ties (d / s * 127 within 1e-5
    of a .5), which may round one step apart; tile_resid within 1e-6 (a
    partial last tile when n % 128 != 0)."""
    x = _int8_corpus(n, 128, seed=3)
    jd8, jsc, jres = jd.quantize_corpus_int8(jnp.asarray(x))
    d8, sc, res = td.quantize_corpus_int8(torch.from_numpy(x))
    assert d8.dtype == torch.int8 and res.shape == (-(-n // 128),)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    diff = d8.numpy().astype(np.int32) - np.asarray(jd8).astype(np.int32)
    frac = np.abs(x / np.asarray(jsc)[:, None] * 127.0) % 1.0
    assert np.abs(diff).max() <= 1
    assert np.all(np.abs(frac[diff != 0] - 0.5) <= 1e-5)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0, atol=1e-6)


@pytest.mark.parametrize("clustered,dead", [(True, 0), (False, 0), (True, 600),
                                            (False, 600)])
def test_int8_swept_topk_matches_jax(clustered, dead):
    """The same corpus, queries, int8 copy (carried with convert.int8_corpus)
    and tombstone bias through both packages: the certificates agree but
    where the k-th value and the witness bound lie within 1e-6; certified
    rows have JAX's ids and values (1e-5), and the exact oracle's ids."""
    from hybridsearch_tpu_torch import convert

    n, d, k = 4096, 128, 10
    x = _int8_corpus(n, d, seed=1, clustered=clustered)
    rng = np.random.default_rng(2)
    q = _unit(rng, 16, d)
    bias = _bias(rng, n, dead) if dead else None
    jq = jd.quantize_corpus_int8(jnp.asarray(x))
    jv, ji, jc = jd.int8_swept_topk(jnp.asarray(q), jq[0], jq[1], jnp.asarray(x), jq[2],
                                    k, bias=None if bias is None else jnp.asarray(bias))
    d8, sc, res = convert.int8_corpus(*(np.asarray(a) for a in jq), device="cpu")
    tv, ti, tc = td.int8_swept_topk(torch.from_numpy(q), d8, sc, torch.from_numpy(x), res,
                                    k, bias=None if bias is None else torch.from_numpy(bias))
    jv, ji, jc = np.asarray(jv), np.asarray(ji), np.asarray(jc)
    tv, ti, tc = tv.numpy(), ti.numpy(), tc.numpy()
    assert tc.any()
    # the witness: the best unchosen tile's bound, recomputed from JAX's pass 1
    s = q @ x.T + (0.0 if bias is None else bias[None, :])
    for b in np.nonzero(tc != jc)[0]:
        margin = jv[b, k - 1] - _witness_bound(q[b], x, bias, k)
        assert abs(margin) <= 1e-6, (b, margin)
    both = tc & jc
    np.testing.assert_allclose(tv[both], jv[both], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti[both], ji[both])
    oracle = np.argsort(-s, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ti[tc], oracle[tc])
    if bias is not None:
        assert np.isfinite(bias[ti[tc]]).all()


def _witness_bound(qv, x, bias, k, tile=128, probe=None):
    """The bound of the (k_gather + 1)-th tile, by numpy, for one query."""
    n = len(x)
    probe = 4 * k if probe is None else probe
    sc = np.maximum(np.abs(x).max(1), 1e-12)
    x8 = np.clip(np.round(x / sc[:, None] * 127.0), -127, 127)
    resid = np.sqrt(((x - x8 * (sc[:, None] / 127.0)) ** 2).sum(1))
    sq = max(np.abs(qv).max(), 1e-12)
    q8 = np.clip(np.round(qv / sq * 127.0), -127, 127)
    rq = np.sqrt(((qv - q8 * (sq / 127.0)) ** 2).sum())
    s = (x8 @ q8) * (sq / 127.0 / 127.0 * sc)
    if bias is not None:
        s = np.where(bias >= 0, s, -np.inf)
    n_tiles = -(-n // tile)
    hat = np.full(n_tiles * tile, -np.inf)
    hat[:n] = s
    hat = hat.reshape(n_tiles, tile).max(1)
    rt = np.zeros(n_tiles * tile)
    rt[:n] = resid
    bound = hat + rq + (1 + rq) * rt.reshape(n_tiles, tile).max(1)
    k_gather = max(1, min(probe, n_tiles), -(-k // tile))
    return np.sort(bound)[::-1][k_gather]


def test_int8_swept_topk_full_probe_certifies_every_row():
    """probe_tiles = every tile: all rows certified and equal to the exact
    oracle, with a bias masking half the rows (tests/test_int8_sweep.py)."""
    n, d, k = 2048, 64, 8
    x = _int8_corpus(n, d, seed=7)
    rng = np.random.default_rng(8)
    q = _unit(rng, 4, d)
    bias = _bias(rng, n, n // 2)
    d8, sc, res = td.quantize_corpus_int8(torch.from_numpy(x))
    v, i, c = td.int8_swept_topk(torch.from_numpy(q), d8, sc, torch.from_numpy(x), res,
                                 k, probe_tiles=n // 128, bias=torch.from_numpy(bias))
    assert bool(c.all())
    s = q @ x.T + bias[None, :]
    np.testing.assert_array_equal(i.numpy(), np.argsort(-s, axis=1, kind="stable")[:, :k])


def test_int8_swept_topk_takes_the_kernel_routes(monkeypatch):
    """With the card's routes taken (the wrappers' plain versions on the
    CPU), pass 3 goes through K4 at tile grain (``tile_scores``), and the
    rows equal the CPU route's bit for bit."""
    calls = []
    real = td.tile_scores
    n, d, k = 64 * 128, 128, 10
    x = _int8_corpus(n, d, seed=11)
    q = torch.from_numpy(_unit(np.random.default_rng(12), 8, d))
    d8, sc, res = td.quantize_corpus_int8(torch.from_numpy(x))
    want = td.int8_swept_topk(q, d8, sc, torch.from_numpy(x), res, k)
    monkeypatch.setattr(td, "_on_card", lambda t: True)
    monkeypatch.setattr(td, "tile_scores",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = td.int8_swept_topk(q, d8, sc, torch.from_numpy(x), res, k)
    assert calls
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_query_tracer_writes_a_trace(tmp_path):
    from hybridsearch_tpu_torch.utils.tracing import QueryTracer

    tracer = QueryTracer(str(tmp_path / "trace"))
    with tracer.profile() as log_dir:
        td.cosine_scores(torch.ones(4, 8), torch.ones(16, 8))
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert log_dir == str(tmp_path / "trace") and len(files) == 1
    with open(os.path.join(log_dir, files[0])) as f:
        assert "traceEvents" in json.load(f)
