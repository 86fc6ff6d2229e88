"""Cross-encoder and late-interaction reranking.

Counterpart of ``hybridsearch_tpu/retrieval/reranker.py``:

- ``CrossEncoderReranker.rerank`` scores (query, doc) pairs with the
  cross-encoder and sorts by that score (stable on ties);
  ``rerank_with_fusion`` blends 0.3 * minmax(original) + 0.7 * minmax(CE);
- ``LateInteractionReranker``: ColBERT-style MaxSim over the bi-encoder
  trunk's unit token states (the sum over query tokens of the best cosine
  against the doc's tokens);
- ``create_reranker`` picks one by name.

A result is a ``(score, content, doc_id)`` tuple, as ``search_batch``
returns them. Models load lazily, on ``device`` (the card unless the caller
asks for the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.utils.device import DeviceLike

SearchResult = Tuple[float, str, int]


def _minmax(x: np.ndarray) -> np.ndarray:
    if x.size == 0:
        return x
    mn, mx = float(x.min()), float(x.max())
    if mx - mn < 1e-12:
        return np.ones_like(x)
    return (x - mn) / (mx - mn)


def _ranked(scores: np.ndarray, results: Sequence[SearchResult],
            top_k: Optional[int]) -> List[SearchResult]:
    order = np.argsort(-scores, kind="stable")
    out = [(float(scores[i]), results[i][1], results[i][2]) for i in order]
    return out[: top_k if top_k is not None else len(out)]


class CrossEncoderReranker:
    def __init__(self, model=None, model_name: str = "ms-marco-MiniLM-L-6-v2",
                 device: DeviceLike = None) -> None:
        self._model = model
        self.model_name = model_name
        self.device = device

    @property
    def model(self):
        if self._model is None:
            from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder

            self._model = MiniLMCrossEncoder(name=self.model_name, device=self.device)
        return self._model

    def _scores(self, query: str, results: Sequence[SearchResult]) -> np.ndarray:
        pairs = [(query, content) for _s, content, _i in results]
        return self.model.predict(pairs).cpu().numpy()

    def rerank(
        self,
        query: str,
        results: Sequence[SearchResult],
        top_k: Optional[int] = None,
    ) -> List[SearchResult]:
        """Candidates sorted by cross-encoder score."""
        if not results:
            return []
        return _ranked(self._scores(query, results), results, top_k)

    def rerank_with_fusion(
        self,
        query: str,
        results: Sequence[SearchResult],
        top_k: Optional[int] = None,
        original_weight: float = 0.3,
        ce_weight: float = 0.7,
    ) -> List[SearchResult]:
        """``original_weight * minmax(orig) + ce_weight * minmax(CE)``."""
        if not results:
            return []
        ce = _minmax(self._scores(query, results))
        orig = _minmax(np.asarray([s for s, _c, _i in results], dtype=np.float32))
        return _ranked(original_weight * orig + ce_weight * ce, results, top_k)


class LateInteractionReranker:
    """MaxSim reranker over the bi-encoder trunk's token states."""

    def __init__(self, encoder=None, device: DeviceLike = None) -> None:
        self._encoder = encoder
        self.device = device

    @property
    def encoder(self):
        if self._encoder is None:
            from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder

            self._encoder = MiniLMEncoder(device=self.device)
        return self._encoder

    @torch.inference_mode()
    def _token_states(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """([B, L, H] unit float32 token states, [B, L] mask) on the device."""
        enc = self.encoder
        ids, mask = enc.tokenizer.batch_encode(list(texts), enc.max_seq_len)
        ids_t = torch.from_numpy(ids.astype(np.int64)).to(enc.device)
        mask_t = torch.from_numpy(mask).to(enc.device)
        states = enc.model.bert(ids_t, mask_t).float()
        norms = states.norm(dim=-1, keepdim=True)
        return states / norms.clamp_min(1e-12), mask_t

    def rerank(
        self,
        query: str,
        results: Sequence[SearchResult],
        top_k: Optional[int] = None,
    ) -> List[SearchResult]:
        if not results:
            return []
        q_states, q_mask = self._token_states([query])
        d_states, d_mask = self._token_states([c for _s, c, _i in results])
        # MaxSim: [C, Lq, Ld] -> max over Ld -> sum over Lq
        sim = torch.einsum("qd,cld->cql", q_states[0], d_states)
        sim = sim.masked_fill(d_mask[:, None, :] <= 0, float("-inf"))
        maxsim = sim.amax(dim=2)
        maxsim = torch.where(q_mask[0][None, :] > 0, maxsim, 0.0)
        return _ranked(maxsim.sum(dim=1).cpu().numpy(), results, top_k)


def create_reranker(kind: str = "cross_encoder", **kwargs):
    """A reranker by name: "cross_encoder", "colbert" or "late_interaction"."""
    table = {
        "cross_encoder": CrossEncoderReranker,
        "colbert": LateInteractionReranker,
        "late_interaction": LateInteractionReranker,
    }
    if kind not in table:
        raise ValueError(f"unknown reranker kind: {kind!r}")
    return table[kind](**kwargs)
