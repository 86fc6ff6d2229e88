"""Indexer: document ingest -> host store + device indexes.

Counterpart of ``hybridsearch_tpu/index/builder.py``: a destructive full
reindex (``index_documents``) that, for ``layout="clustered"``, embeds the
corpus first and orders it by spherical k-means cluster so similar docs
share 128-doc tiles and 16384-doc supertiles; doc ids are assigned after
the permutation, so the store, the dense index and BM25 see one ordering.
BM25 is fitted through the token-hash path (HashVocabulary), the state the
JAX package's native bulk path builds.

Given no encoder, the Indexer serves ``models/encoder.py``
``default_encoder`` at the index's width, as the JAX package does: the
promoted transformer checkpoint where one is found, else hashing.

``add_documents`` keeps the store, the dense index and BM25 live: BM25
takes the new docs into its delta segment (or merges them in when a drift
bound trips) and only the new docs are tokenized and embedded.
``delete_documents`` tombstones all three. ``save`` / ``load`` write and
read the JAX package's directory (dense shards, ``bm25.npz``,
``engine_manifest.json``; the docs stay in the store at ``db_path``), and
``export_json`` / ``import_json`` its JSON dump.

With ``config.index.ann = "ivf"`` (or ``"auto"`` at ``IVF_AUTO_MIN_DOCS``
docs or more) the build also makes an IVF index (``self.ivf``), which scatter
mode searches while it covers every doc: on a clustered build the one
k-means serves layout and quantizer (``IVFIndex.from_layout`` adopts the
dense snapshot's buffer), otherwise ``IVFIndex.build`` fits its own.

On a mesh (``Indexer(mesh=)``, every rank calling every method with the
same arguments) each rank embeds and tokenizes the whole corpus, as every
host of a multi-host JAX program does, and keeps its own shard of each
index: the dense rows, the BM25 postings (partitioned by the dense index's
rows a shard, ``_align_bm25_shards``) and the IVF chunks (built on their
own, no reserved overhang and no ``from_layout``). The clustered layout's
k-means runs on rank 0 and its assignment is broadcast. Each rank opens its
own store: give each one its own ``db_path`` (or ``":memory:"``).
``save`` writes the JAX package's mesh layout (no ``bm25.npz``: a sharded
BM25 cannot be saved) and ``load(directory, mesh=)`` reads this rank's rows
back and refits BM25 aligned; ``add_documents`` past the dense capacity
grows it across the ranks (``DenseIndex.add``) and realigns BM25;
``export_json`` has each rank format its own rows and rank 0 write the file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.dense_index import DenseIndex
from hybridsearch_tpu_torch.index.ivf import (
    IVFIndex,
    kmeans_assign,
    kmeans_fit,
    mesh_kmeans,
)
from hybridsearch_tpu_torch.index.sparse_index import BM25, BM25Plus
from hybridsearch_tpu_torch.store.docstore import DocStore
from hybridsearch_tpu_torch.text.extractor import (
    HashVocabulary,
    extract_tokens,
    preprocess_text,
    token_hashes_docs,
)
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

# ann="auto" builds the IVF quantizer from this many docs (the JAX package's
# measured exact <-> IVF crossover)
IVF_AUTO_MIN_DOCS = 4_000_000


class Indexer:
    """Builds and maintains the dense + sparse indexes and the host store."""

    def __init__(
        self,
        db_path: str = ":memory:",
        encoder=None,
        config: Optional[EngineConfig] = None,
        device: DeviceLike = None,
        mesh=None,
    ) -> None:
        self.config = config or EngineConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.db_path = db_path
        self.store = DocStore(db_path)
        self._encoder = encoder
        if encoder is not None and getattr(encoder, "dim", None):
            # the embedding dim is dictated by the encoder
            self.config.index.dim = encoder.dim
        bm25_cls = BM25Plus if self.config.bm25.variant == "bm25plus" else BM25
        self.bm25 = bm25_cls(k1=self.config.bm25.k1, b=self.config.bm25.b,
                             delta=self.config.bm25.delta, device=self.device,
                             mesh=mesh)
        self.dense = DenseIndex(dim=self.config.index.dim,
                                capacity_round=self.config.index.capacity_round,
                                device=self.device, mesh=mesh,
                                block_n=self.config.index.block_n)
        self.ivf: Optional[IVFIndex] = None  # built when _want_ivf
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
            from hybridsearch_tpu_torch.models.encoder import default_encoder

            self._encoder = default_encoder(dim=self.config.index.dim,
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
        cluster_cent = cluster_assign = None
        if self.config.index.layout == "clustered" and len(docs) > 256:
            vectors = self.embed(docs)
            _mark("embed_s")
            # one k-means serves the layout and, with IVF on, the quantizer:
            # the IVF cluster count then pins k
            want_ivf = self._want_ivf(len(docs))
            perm, cluster_cent, cluster_assign = _cluster_permutation(
                vectors, k=self.config.index.ivf_clusters if want_ivf else 0,
                mesh=self.mesh)
            _mark("cluster_s")
            vectors = vectors[torch.from_numpy(perm).to(vectors.device)]
            docs = [docs[i] for i in perm]
            if paths is not None:
                paths = [paths[i] for i in perm]
            if metas is not None:
                metas = [metas[i] for i in perm]
            if want_ivf and self.mesh is None:
                # the IVF chunk overhang lives inside the dense capacity, so
                # the IVF's probes never run past the shared buffer
                self.dense.reserve_rows = (
                    self.config.index.ivf_chunk_cap
                    or max(8, (4 * len(docs)) // max(len(cluster_cent), 1)))
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
        if self._want_ivf(len(vectors)):
            ix = self.config.index
            ivf = IVFIndex(dim=ix.dim, n_clusters=ix.ivf_clusters,
                           nprobe=ix.ivf_nprobe, chunk_cap=ix.ivf_chunk_cap,
                           device=self.device, mesh=self.mesh)
            if cluster_cent is not None and self.mesh is None:
                # the corpus is cluster-ordered and already normalized on the
                # device: adopt that buffer and the one k-means' centroids
                ivf.from_layout(self.dense._snap.docs, len(docs), cluster_cent,
                                cluster_assign)
            else:
                ivf.build(vectors)
            self.ivf = ivf
        _mark("ivf_s")
        self._align_bm25_shards()
        self.bm25.fit_coo_from_hashes(hashes, counts)
        _mark("bm25_s")
        self.contents = list(docs)
        self.doc_ids = ids
        return {"indexed": len(docs), "dim": self.config.index.dim,
                "timings_s": timings}

    def add_documents(
        self,
        documents: Sequence[str],
        paths: Optional[Sequence[Optional[str]]] = None,
        metas: Optional[Sequence[Optional[Dict]]] = None,
    ) -> List[int]:
        """Incremental add keeping the store, the dense index and BM25
        consistent; only the new docs are tokenized and embedded. BM25 adds
        in O(new) when its tf cache covers the corpus, else refits on every
        doc."""
        if not documents:
            return []
        docs = [preprocess_text(d) for d in documents]
        hashes, counts = token_hashes_docs(docs)
        ids = self.store.add_documents(docs, paths, counts.tolist())
        if metas is not None:
            for did, m in zip(ids, metas):
                if m:
                    self.store.set_metadata(did, m)
        self.dense.add(self.embed(docs))
        self.contents.extend(docs)
        self.doc_ids.extend(ids)
        self._align_bm25_shards()
        bm25 = self.bm25
        if (bm25._state.tf_cache is not None
                and bm25.n_docs == len(self.contents) - len(docs)):
            if isinstance(bm25.vocab, HashVocabulary):
                bm25.add_hashes(hashes, counts)
            else:
                bm25.add_tokens([extract_tokens(d) for d in docs])
        else:  # no cache (a loaded state) or the counts diverged: refit
            bm25.fit_tokens([extract_tokens(c) for c in self.contents])
        return ids

    def _want_ivf(self, n: int) -> bool:
        """The exact <-> IVF policy: "flat" never, "ivf" for any corpus,
        "auto" from IVF_AUTO_MIN_DOCS docs (the streaming exact top-k wins
        below it)."""
        mode = self.config.index.ann
        if mode == "ivf":
            return n > 0
        return mode == "auto" and n >= IVF_AUTO_MIN_DOCS

    def _align_bm25_shards(self) -> None:
        """On a mesh, partition the BM25 postings by the dense index's rows
        a shard, so hybrid fusion runs shard-locally."""
        if self.mesh is not None:
            from hybridsearch_tpu_torch.parallel.mesh import shard_count

            self.bm25.docs_per_shard = self.dense.capacity // shard_count(self.mesh)

    def delete_documents(self, doc_ids: Sequence[int]) -> int:
        """Tombstone docs in the dense index (bias -> -inf), in BM25 and in
        the host store: they stop surfacing from every search path."""
        ids = [int(i) for i in doc_ids]
        self.dense.delete(ids)
        self.bm25.delete(ids)
        self.store.delete_documents(ids)
        return len(ids)

    def reload(self) -> int:
        """Rebuild the in-memory state from the host store: re-embed only if
        the dense index does not hold every doc, refit BM25, re-apply the
        store's tombstones to both."""
        ids, contents = self.store.get_contents()
        self.contents = contents
        self.doc_ids = ids
        if contents:
            if self.dense.n_docs != len(contents):
                self.dense.build(self.embed(contents))
            self._align_bm25_shards()
            self.bm25.fit(contents)
            deleted = self.store.deleted_ids()
            if deleted:
                self.dense.delete(deleted)
                self.bm25.delete(deleted)
        return len(contents)

    def save(self, directory: str) -> None:
        """Write the dense shards, the BM25 state and the engine manifest
        (with the config) under ``directory``; the docs and their metadata
        stay in the store at ``db_path``. On a mesh (every rank calling it)
        rank 0 writes the manifest and every rank its own dense rows."""
        os.makedirs(directory, exist_ok=True)
        self.dense.save(os.path.join(directory, "dense"))
        if self.bm25.postings is not None:
            self.bm25.save(os.path.join(directory, "bm25.npz"))
        if self.mesh is not None and self.mesh.data_index != 0:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.data_group)  # rank 0's manifest
            return
        manifest = {"engine": "hybridsearch_tpu_torch",
                    "encoder": getattr(self.encoder, "name", "unknown"),
                    "dim": self.config.index.dim, "n_docs": len(self.contents),
                    "db_path": self.db_path,
                    "config": json.loads(self.config.to_json())}
        with open(os.path.join(directory, "engine_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.data_group)

    @classmethod
    def load(cls, directory: str, encoder=None, db_path: Optional[str] = None,
             device: DeviceLike = None, mesh=None) -> "Indexer":
        """An Indexer over a directory ``save`` (of either package) wrote,
        with no re-embedding and no BM25 refit where ``bm25.npz`` exists;
        the store's tombstones are re-applied to BM25 (the dense bias keeps
        its own). Without ``bm25.npz`` BM25 refits from the store's docs
        through ``fit``, as the JAX package does. On a mesh each rank reads
        its own dense rows (from files of any shard count) and BM25, loaded
        or refitted, is partitioned by them (the JAX package's load leaves
        it unaligned); a mesh save writes no ``bm25.npz``, and the refit
        there takes the token-hash path ``index_documents`` takes, so a
        loaded mesh index serves as the built one (``fit`` gives the same
        scores in another vocab order)."""
        with open(os.path.join(directory, "engine_manifest.json")) as f:
            manifest = json.load(f)
        config = EngineConfig.from_dict(manifest.get("config", {}))
        idx = cls(db_path=db_path or manifest.get("db_path", ":memory:"),
                  encoder=encoder, config=config, device=device, mesh=mesh)
        idx.dense = DenseIndex.load(os.path.join(directory, "dense"),
                                    capacity_round=config.index.capacity_round,
                                    device=idx.device, mesh=mesh,
                                    block_n=config.index.block_n)
        idx._align_bm25_shards()
        idx.doc_ids, idx.contents = idx.store.get_contents()
        bm25_path = os.path.join(directory, "bm25.npz")
        if os.path.exists(bm25_path):
            idx.bm25.load(bm25_path)
        elif idx.contents and mesh is not None:
            idx.bm25.fit_hashes(idx.contents)
        elif idx.contents:
            idx.bm25.fit(idx.contents)
        deleted = idx.store.deleted_ids()
        if deleted:
            idx.bm25.delete(deleted)
        return idx

    def export_json(self, path: str) -> None:
        """Dump the docs, their ids and their (normalized) vectors as JSON.
        On a mesh (every rank calling it with the same ``path``) each rank
        formats its own rows as JSON text, the texts are gathered to rank
        0 (an all-gather of their bytes, which every rank joins), and rank
        0 writes the file one device writes, byte for byte (under a
        temporary name, then renamed, so the file appears whole); a barrier
        holds every rank until it is written. Formatting the floats is most of
        an export's time, so the ranks share it."""
        if self.mesh is None:
            with open(path, "w") as f:
                json.dump({"documents": self.contents, "doc_ids": self.doc_ids,
                           "vectors": self.dense.get_vectors(
                               list(range(self.dense.n_docs))).tolist()}, f)
            return
        import torch.distributed as dist

        rows = self._mesh_rows_json()
        if self.mesh.data_index == 0:
            # what json.dump writes for the same dict, its vectors' rows
            # joined from every rank's text; renamed into place whole
            with open(path + ".tmp", "w") as f:
                f.write('{"documents": ' + json.dumps(self.contents)
                        + ', "doc_ids": ' + json.dumps(self.doc_ids)
                        + ', "vectors": [' + rows + "]}")
            os.replace(path + ".tmp", path)
        dist.barrier(group=self.mesh.data_group)

    def _mesh_rows_json(self) -> str:
        """On a mesh, the JSON text of every real dense row, the rows
        separated as ``json.dumps`` separates a list's items (on rank 0;
        the other ranks get an empty string): each rank formats its own
        rows and one all-gather of the padded UTF-8 bytes brings them
        together in rank order."""
        from hybridsearch_tpu_torch.parallel.collectives import all_gather_cat

        snap = self.dense._snap
        lo, per = self.dense._rows(snap.capacity)
        mine = snap.docs[:max(0, min(per, snap.n - lo))].cpu().numpy()
        text = json.dumps(mine.tolist())[1:-1].encode()  # no outer brackets
        dev = self.mesh.device if self.mesh.backend == "nccl" else torch.device("cpu")
        sizes = all_gather_cat(torch.tensor([len(text)], device=dev), self.mesh, dim=0)
        buf = torch.zeros(int(sizes.max()), dtype=torch.uint8)
        if text:  # a rank past the last row has none
            buf[:len(text)] = torch.frombuffer(bytearray(text), dtype=torch.uint8)
        every = all_gather_cat(buf[None].to(dev), self.mesh, dim=0).cpu().numpy()
        if self.mesh.data_index != 0:
            return ""
        pieces = [every[r, :int(size)].tobytes().decode()
                  for r, size in enumerate(sizes.tolist()) if size]
        return ", ".join(pieces)

    def import_json(self, path: str) -> int:
        """Replace the index with a JSON dump: its vectors are adopted when
        there is one a doc, else the docs are embedded; BM25 refits."""
        with open(path) as f:
            data = json.load(f)
        docs = data["documents"]
        self.store.replace_documents(docs)
        vecs = np.asarray(data.get("vectors", []), dtype=np.float32)
        if len(vecs) == len(docs) and len(docs):
            self.dense.build(vecs)
        elif docs:
            self.dense.build(self.embed(docs))
        self._align_bm25_shards()
        self.bm25.fit(docs)
        self.contents = list(docs)
        self.doc_ids = list(range(len(docs)))
        return len(docs)


def _cluster_permutation(vectors: torch.Tensor, seed: int = 0, k: int = 0,
                         mesh=None) -> Tuple[np.ndarray, torch.Tensor, np.ndarray]:
    """(perm, centroids [k, D], sorted_assign): the permutation ordering docs
    by spherical k-means cluster (sqrt(N) clusters unless ``k`` pins it),
    stable within clusters, with the centroids and each permuted row's
    cluster, so one k-means serves the layout and the IVF quantizer
    (``IVFIndex.from_layout``). On a mesh rank 0 fits and its result is
    broadcast (``mesh_kmeans``)."""
    n = vectors.shape[0]
    k = k or max(2, int(np.sqrt(n)))
    if mesh is not None:
        cent, assign = mesh_kmeans(mesh, vectors, k, seed=seed)
        perm = np.argsort(assign, kind="stable")
        return perm, cent, assign[perm]
    cent = kmeans_fit(vectors, k, seed=seed)
    assign = kmeans_assign(vectors, cent).cpu().numpy()
    perm = np.argsort(assign, kind="stable")
    return perm, cent, assign[perm]
