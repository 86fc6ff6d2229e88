"""Text encoders producing the document/query embedding space.

Counterpart of ``hybridsearch_tpu/models/encoder.py``. An ``Encoder`` maps
texts to a float32 tensor [len(texts), dim] on its device:

- ``HashingEncoder``: tokens and token bigrams hash into a fixed bucket
  table of random vectors, and a text's embedding is the weighted mean of
  its features' vectors (bigrams down-weighted). Features are
  hash-identical to the JAX package's (same tokenizer, same FNV-1a); the
  table comes from a ``torch.Generator`` on the device, which cannot repeat
  ``jax.random``'s bits, so a test that compares the two carries the JAX
  table across (``convert.hashing_encoder``).
- ``ByteTrigramEncoder``: the same gather-mean over hashed UTF-8 byte
  trigrams, for any script.
- ``MiniLMEncoder`` (``models/minilm.py``): the transformer bi-encoder.
- ``DeepseekV2Encoder`` (``models/deepseek_v2.py``): a DeepSeek-V2 decoder,
  last-token pooled, at its hidden width.

``default_encoder`` picks MiniLM when a checkpoint of the requested width is
found, else hashing; ``kind="deepseek_v2"`` serves the decoder.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.text.extractor import hash_docs, stable_token_hash
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

# the JAX package exposes the token hash under this name here
stable_hash = stable_token_hash


class Encoder(Protocol):
    dim: int
    name: str

    def encode(self, texts: Sequence[str], batch_size: int = 64) -> torch.Tensor:
        """[len(texts), dim] float32 embeddings on the encoder's device."""
        ...


class HashingEncoder:
    """Deterministic offline feature-hashing encoder (see module docstring)."""

    def __init__(
        self,
        dim: int = 384,
        n_buckets: int = 1 << 15,
        seed: int = 42,
        bigram_weight: float = 0.5,
        max_tokens: int = 256,
        name: str = "hashing-encoder",
        device: DeviceLike = None,
    ) -> None:
        self.dim = dim
        self.n_buckets = n_buckets
        self.seed = seed
        self.bigram_weight = bigram_weight
        self.max_tokens = max_tokens
        self.name = name
        self.device = resolve_device(device)
        self._table: Optional[torch.Tensor] = None

    @property
    def table(self) -> torch.Tensor:
        """[n_buckets, dim] float32 bucket vectors, N(0, 1/dim)."""
        if self._table is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed)
            self._table = torch.randn(
                (self.n_buckets, self.dim), generator=g, device=self.device,
                dtype=torch.float32) / float(np.sqrt(self.dim))
        return self._table

    @table.setter
    def table(self, value: torch.Tensor) -> None:
        if tuple(value.shape) != (self.n_buckets, self.dim):
            raise ValueError(f"table must be [{self.n_buckets}, {self.dim}]")
        self._table = value.to(self.device, torch.float32)

    def features(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """([B, L] int64 bucket ids, [B, L] float32 weights): per text its
        unigram features (weight 1) then bigram features (``a_b``, weight
        ``bigram_weight``), cut at ``max_tokens``; an empty text holds one
        zero-weight feature. L is a power of two >= 8, as in the JAX encoder."""
        uni_h, counts, bi_h = hash_docs(texts, bigrams=True)
        B = len(texts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        doc_of = np.repeat(np.arange(B, dtype=np.int64), counts)
        pos = np.arange(len(uni_h), dtype=np.int64) - starts[doc_of]
        # a bigram starts at every token but a text's last
        a = np.flatnonzero(pos < (counts[doc_of] - 1))
        n_feat = np.minimum(counts + np.maximum(counts - 1, 0), self.max_tokens)
        n_feat = np.maximum(n_feat, 1)
        longest = int(n_feat.max()) if B else 1
        L = max(8, 1 << (longest - 1).bit_length())
        out_ids = np.zeros((B, L), dtype=np.int64)
        out_w = np.zeros((B, L), dtype=np.float32)
        nb = np.uint64(self.n_buckets)
        keep = pos < self.max_tokens
        out_ids[doc_of[keep], pos[keep]] = (uni_h[keep] % nb).astype(np.int64)
        out_w[doc_of[keep], pos[keep]] = 1.0
        col = counts[doc_of[a]] + pos[a]
        keep = col < self.max_tokens
        out_ids[doc_of[a][keep], col[keep]] = (bi_h[keep] % nb).astype(np.int64)
        out_w[doc_of[a][keep], col[keep]] = self.bigram_weight
        return out_ids, out_w

    def encode(self, texts: Sequence[str], batch_size: int = 64) -> torch.Tensor:
        """[len(texts), dim] float32 embeddings on the encoder's device (not
        normalized): one gather-mean over the whole call, whatever
        ``batch_size`` (taken, as the JAX encoder takes it, for the callers
        of the Encoder protocol)."""
        if not len(texts):
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        ids, w = self.features(texts)
        ids_t = torch.from_numpy(ids).to(self.device)
        w_t = torch.from_numpy(w).to(self.device)
        vecs = self.table[ids_t]  # [B, L, D]
        summed = (vecs * w_t[..., None]).sum(dim=1)
        denom = w_t.sum(dim=1, keepdim=True).clamp_min(1e-9)
        return summed / denom


class ByteTrigramEncoder(HashingEncoder):
    """Language-agnostic byte-trigram hashing encoder: a text's features are
    the FNV-1a hashes of its UTF-8 byte trigrams (lowercased, whitespace
    runs folded to one space, one space added at each end), each of weight
    1 (a repeated trigram counts again), cut at ``max_tokens``. Same table
    and gather-mean as ``HashingEncoder``."""

    def __init__(self, dim: int = 384, n_buckets: int = 1 << 15,
                 seed: int = 7, max_tokens: int = 512,
                 name: str = "byte-trigram-encoder", device: DeviceLike = None) -> None:
        super().__init__(dim=dim, n_buckets=n_buckets, seed=seed,
                         bigram_weight=0.0, max_tokens=max_tokens,
                         name=name, device=device)

    def _feature_arrays(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        raw = (" " + " ".join(text.lower().split()) + " ").encode("utf-8")
        if len(raw) < 3:
            return np.zeros(1, np.int64), np.zeros(1, np.float32)
        arr = np.frombuffer(raw, dtype=np.uint8).astype(np.uint64)
        h = np.full(len(arr) - 2, 0xCBF29CE484222325, dtype=np.uint64)
        with np.errstate(over="ignore"):
            for k in range(3):
                h = (h ^ arr[k:len(arr) - 2 + k]) * np.uint64(0x100000001B3)
        ids = (h % np.uint64(self.n_buckets)).astype(np.int64)[: self.max_tokens]
        return ids, np.ones(len(ids), np.float32)

    def features(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        feats = [self._feature_arrays(t) for t in texts]
        longest = max(len(f) for f, _w in feats)
        L = max(8, 1 << (longest - 1).bit_length())
        ids = np.zeros((len(texts), L), dtype=np.int64)
        ws = np.zeros((len(texts), L), dtype=np.float32)
        for i, (f, w) in enumerate(feats):
            ids[i, :len(f)] = f
            ws[i, :len(w)] = w
        return ids, ws


def default_encoder(dim: int = 384, kind: str = "auto", device: DeviceLike = None,
                    **kwargs) -> Encoder:
    """MiniLM with a checkpoint's weights if one is found, else the hashing
    encoder, on ``device``.

    ``HST_ENCODER`` (hashing|minilm|deepseek_v2|auto) overrides an "auto"
    kind. In auto mode a discovered checkpoint is served only when its
    width is ``dim`` (the embedding space is a contract with the index
    built on it); one of another width is skipped with a warning. A
    discovered checkpoint that fails to load raises: there is no silent
    fallback.

    ``deepseek_v2``: ``DeepseekV2Encoder`` with ``kwargs`` (``config``, the
    published DeepSeek-V2-Lite by default; ``state_dict`` under the public
    names, or weights drawn from ``seed``); ``dim`` must be its hidden
    width."""
    if kind == "auto":
        kind = os.environ.get("HST_ENCODER", "auto")
    if kind == "deepseek_v2":
        from hybridsearch_tpu_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Encoder

        width = kwargs.get("config", DeepseekV2Config()).hidden_size
        if width != dim:
            raise ValueError(f"the DeepSeek-V2 encoder is {width} wide and {dim} was asked "
                             "for: set the index's width to the trunk's")
        return DeepseekV2Encoder(device=device, **kwargs)
    if kind in ("auto", "minilm"):
        from hybridsearch_tpu_torch.models.minilm import (
            MiniLMEncoder,
            checkpoint_dim,
            find_checkpoint,
        )

        ckpt = find_checkpoint("MiniLM")
        width = checkpoint_dim(ckpt) if ckpt else None
        if kind == "auto" and width not in (None, dim):
            warnings.warn(f"checkpoint {ckpt} is {width} wide and {dim} was asked "
                          "for: serving the hashing encoder", stacklevel=2)
            ckpt = None
        if kind == "minilm" or ckpt:
            return MiniLMEncoder(dim=dim, checkpoint=ckpt, device=device, **kwargs)
    return HashingEncoder(dim=dim, device=device, **kwargs)
