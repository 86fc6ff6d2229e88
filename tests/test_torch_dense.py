"""The port's dense and fusion ops against the JAX package's, on the CPU.

Inputs come from a seeded numpy generator and go to both packages.
Tolerances: scores rtol=1e-4, atol=1e-5 (float32 sums in another order);
ids exact (random unit vectors leave no ties within that tolerance).
"""

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
