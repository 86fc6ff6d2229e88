"""Indexer: document ingest -> host store + device indexes.

Counterpart of ``hybridsearch_tpu/index/builder.py``: a destructive full
reindex (``index_documents``) that, for ``layout="clustered"``, embeds the
corpus first and orders it by spherical k-means cluster so similar docs
share 128-doc tiles and 16384-doc supertiles; doc ids are assigned after
the permutation, so the store, the dense index and BM25 see one ordering.
BM25 is fitted through the token-hash path (HashVocabulary), the state the
JAX package's native bulk path builds.

Incremental adds, persistence, export/import and the IVF index of the JAX
module are still to port.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.dense_index import DenseIndex
from hybridsearch_tpu_torch.index.ivf import kmeans_assign, kmeans_fit
from hybridsearch_tpu_torch.index.sparse_index import BM25, BM25Plus
from hybridsearch_tpu_torch.store.docstore import DocStore
from hybridsearch_tpu_torch.text.extractor import preprocess_text, token_hashes_docs
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device


class Indexer:
    """Builds and maintains the dense + sparse indexes and the host store."""

    def __init__(
        self,
        db_path: str = ":memory:",
        encoder=None,
        config: Optional[EngineConfig] = None,
        device: DeviceLike = None,
    ) -> None:
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.db_path = db_path
        self.store = DocStore(db_path)
        self._encoder = encoder
        if encoder is not None and getattr(encoder, "dim", None):
            # the embedding dim is dictated by the encoder
            self.config.index.dim = encoder.dim
        bm25_cls = BM25Plus if self.config.bm25.variant == "bm25plus" else BM25
        self.bm25 = bm25_cls(k1=self.config.bm25.k1, b=self.config.bm25.b,
                             delta=self.config.bm25.delta, device=self.device)
        self.dense = DenseIndex(dim=self.config.index.dim,
                                capacity_round=self.config.index.capacity_round,
                                device=self.device)
        self.contents: List[str] = []
        self.doc_ids: List[int] = []

    def __enter__(self) -> "Indexer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self.store.close()

    @property
    def encoder(self):
        if self._encoder is None:
            from hybridsearch_tpu_torch.models.encoder import HashingEncoder

            self._encoder = HashingEncoder(dim=self.config.index.dim,
                                           device=self.device)
        return self._encoder

    def embed(self, texts: Sequence[str], batch_size: int = 2048) -> torch.Tensor:
        """[len(texts), dim] float32 embeddings on the device, encoded in
        batches of ``batch_size``."""
        out = [self.encoder.encode(list(texts[i:i + batch_size]))
               for i in range(0, len(texts), batch_size)]
        if not out:
            return torch.zeros((0, self.config.index.dim), dtype=torch.float32,
                               device=self.device)
        return torch.cat(out)

    def index_documents(
        self,
        documents: Sequence[str],
        paths: Optional[Sequence[Optional[str]]] = None,
        metas: Optional[Sequence[Optional[Dict]]] = None,
    ) -> Dict[str, object]:
        """Destructive full reindex. ``metas`` are permuted with the corpus
        under the clustered layout. Returns the count, the dim and the
        seconds of each stage."""
        if self.config.index.ann == "ivf" or (
                self.config.index.ann == "auto" and len(documents) >= 4_000_000):
            raise NotImplementedError("the IVF index is not ported yet")
        tmark = time.perf_counter()
        timings: Dict[str, float] = {}

        def _mark(stage: str) -> None:
            nonlocal tmark
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            timings[stage] = timings.get(stage, 0.0) + now - tmark
            tmark = now

        docs = [preprocess_text(d) for d in documents]
        _mark("preprocess_s")
        paths = list(paths) if paths is not None else None
        metas = list(metas) if metas is not None else None
        vectors = None
        if self.config.index.layout == "clustered" and len(docs) > 256:
            vectors = self.embed(docs)
            _mark("embed_s")
            perm = _cluster_permutation(vectors)
            _mark("cluster_s")
            vectors = vectors[torch.from_numpy(perm).to(vectors.device)]
            docs = [docs[i] for i in perm]
            if paths is not None:
                paths = [paths[i] for i in perm]
            if metas is not None:
                metas = [metas[i] for i in perm]
        hashes, counts = token_hashes_docs(docs)
        _mark("tokenize_s")
        ids = self.store.replace_documents(docs, paths, counts.tolist())
        if metas is not None:
            for did, m in zip(ids, metas):
                if m:
                    self.store.set_metadata(did, m)
        _mark("store_s")
        if vectors is None:
            vectors = self.embed(docs)
            _mark("embed_s")
        self.dense.build(vectors)
        _mark("dense_build_s")
        self.bm25.fit_coo_from_hashes(hashes, counts)
        _mark("bm25_s")
        self.contents = list(docs)
        self.doc_ids = ids
        return {"indexed": len(docs), "dim": self.config.index.dim,
                "timings_s": timings}

    def delete_documents(self, doc_ids: Sequence[int]) -> int:
        """Tombstone docs in the dense index (bias -> -inf, so they stop
        surfacing from every search path) and in the host store."""
        ids = [int(i) for i in doc_ids]
        self.dense.delete(ids)
        self.store.delete_documents(ids)
        return len(ids)


def _cluster_permutation(vectors: torch.Tensor, seed: int = 0,
                         k: int = 0) -> np.ndarray:
    """Permutation ordering docs by spherical k-means cluster (sqrt(N)
    clusters unless ``k`` pins it), stable within clusters."""
    n = vectors.shape[0]
    k = k or max(2, int(np.sqrt(n)))
    cent = kmeans_fit(vectors, k, seed=seed)
    assign = kmeans_assign(vectors, cent).cpu().numpy()
    return np.argsort(assign, kind="stable")
