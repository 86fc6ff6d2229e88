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
