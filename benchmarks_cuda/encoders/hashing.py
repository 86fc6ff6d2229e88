"""Encoder kind ``hashing``: the port's ``HashingEncoder`` over a drawn table.

The configuration's ``encoder`` block gives ``dim``, ``n_buckets``,
``bigram_weight``, ``max_tokens`` and ``table_seed``.

- ``draw``: the [n_buckets, dim] table, N(0, 1/dim), drawn on the device
  from ``table_seed`` (the same in every run, as a deployment's weights
  are); the harness hands it to the program and to the reference alike.
- ``program``: ``HashingEncoder`` with that table, for ``Searcher(encoder=)``.
- ``Embedder``: the plain reference's embedding of texts: each text's
  features gathered from the same table, weighted mean, L2-normalized. It
  imports nothing of the program.

``encoder_features`` is a frozen copy of the program's feature rule, on
the token hashes of ``harness/textops.py``; a test holds it to the
program's on sample text.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from harness import textops

_EMBED_CHUNK = 32768  # texts whose features are gathered in one call


def draw(cfg: dict, dev: torch.device) -> torch.Tensor:
    enc = cfg["encoder"]
    g = torch.Generator(device=dev)
    g.manual_seed(int(enc["table_seed"]))
    return torch.randn((enc["n_buckets"], enc["dim"]), generator=g, device=dev,
                       dtype=torch.float32) / math.sqrt(enc["dim"])


def program(cfg: dict, weights: torch.Tensor, dev: torch.device):
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    e = cfg["encoder"]
    enc = HashingEncoder(dim=e["dim"], n_buckets=e["n_buckets"],
                         bigram_weight=e["bigram_weight"], max_tokens=e["max_tokens"],
                         device=dev)
    enc.table = weights
    return enc


class Features(NamedTuple):
    """The hashing encoder's features of many texts, flat."""

    text_of: np.ndarray  # [F] int64
    bucket: np.ndarray  # [F] int64
    weight: np.ndarray  # [F] float32


def encoder_features(hashed: textops.Hashed, n_buckets: int, bigram_weight: float,
                     max_tokens: int) -> Features:
    """Per text: its unigram buckets (weight 1), then its bigram buckets
    (weight ``bigram_weight``), the first ``max_tokens`` of them kept."""
    counts = hashed.counts
    n = len(counts)
    nb = np.uint64(n_buckets)
    uni_text = np.repeat(np.arange(n, dtype=np.int64), counts)
    uni_pos = np.arange(len(uni_text), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    bi_counts = np.maximum(counts - 1, 0)
    bi_text = np.repeat(np.arange(n, dtype=np.int64), bi_counts)
    bi_pos = (np.arange(len(bi_text), dtype=np.int64)
              - np.repeat(np.cumsum(bi_counts) - bi_counts, bi_counts)
              + counts[bi_text])
    keep_u = uni_pos < max_tokens
    keep_b = bi_pos < max_tokens
    text_of = np.concatenate([uni_text[keep_u], bi_text[keep_b]])
    bucket = np.concatenate([(hashed.hashes[keep_u] % nb).astype(np.int64),
                             (hashed.bigrams[keep_b] % nb).astype(np.int64)])
    weight = np.concatenate([np.ones(int(keep_u.sum()), np.float32),
                             np.full(int(keep_b.sum()), bigram_weight, np.float32)])
    return Features(text_of, bucket, weight)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.square().sum(dim=-1, keepdim=True).sqrt().clamp_min(1e-12)


class Embedder:
    """``embed(texts)``: [n, dim] float32, L2-normalized, on the table's
    device. The features are gathered and averaged, with no product, so
    every ``precision`` embeds alike."""

    def __init__(self, cfg: dict, weights: torch.Tensor, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        e = cfg["encoder"]
        self.n_buckets, self.bigram_weight = e["n_buckets"], e["bigram_weight"]
        self.max_tokens = e["max_tokens"]
        self.table = weights.float()

    def embed(self, texts: Sequence[str]) -> torch.Tensor:
        """The weighted mean of each text's features. The features are
        sorted by text, stably, so each text adds its own in their order,
        and gathered ``_EMBED_CHUNK`` texts at a time."""
        f = encoder_features(textops.hash_texts(texts), self.n_buckets,
                             self.bigram_weight, self.max_tokens)
        n, dev = len(texts), self.table.device
        order = np.argsort(f.text_of, kind="stable")
        text_of, bucket, weight = f.text_of[order], f.bucket[order], f.weight[order]
        out = torch.zeros((n, self.table.shape[1]), dtype=torch.float32, device=dev)
        denom = torch.zeros(n, dtype=torch.float32, device=dev)
        bounds = np.searchsorted(text_of, np.arange(0, n + _EMBED_CHUNK, _EMBED_CHUNK))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi <= lo:
                continue
            t = torch.from_numpy(text_of[lo:hi]).to(dev)
            w = torch.from_numpy(weight[lo:hi]).to(dev)
            rows = self.table[torch.from_numpy(bucket[lo:hi]).to(dev)] * w[:, None]
            out.index_add_(0, t, rows)
            denom.index_add_(0, t, w)
        return _normalize(out / denom.clamp_min(1e-9)[:, None])
