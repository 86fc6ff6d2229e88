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
