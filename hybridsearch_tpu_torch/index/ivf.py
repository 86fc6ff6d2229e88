"""IVF (inverted-file) approximate dense index, and the spherical k-means
behind it and behind the clustered corpus layout.

Counterpart of ``hybridsearch_tpu/index/ivf.py`` on one device:

  - coarse quantizer: k-means centroids trained on the device
    (``kmeans_fit``, Lloyd iterations as matmuls), blocked over doc rows so
    peak memory is O(block * C), with per-block normalization in float32;
  - storage: docs permuted into cluster order (float32, or bfloat16 with
    ``storage_dtype``), so a cluster is one contiguous row range; clusters
    larger than ``chunk_cap`` split into chunks that share the parent
    centroid, so every probe has one width;
  - query: score the chunks' centroids, take the top ``nprobe`` chunks,
    score their rows, exact top-k within the probed set (``_ivf_search``).

``IVFIndex.from_layout`` adopts the dense snapshot of a clustered build (one
corpus copy on the device, one k-means for layout and quantizer).

On a mesh (``IVFIndex(mesh=)``) the chunks go round-robin over the shards
(``_build_sharded``): each rank keeps its own chunks' rows, centroids and
doc ids; a search probes each rank's best ceil(nprobe / shards) chunks and
merges the per-rank top-k through the data axis. Rank 0's centroids and
assignment are broadcast, so every rank cuts the same chunks.
``from_layout`` stays single-device, as in the JAX package.

Random draws come from a ``torch.Generator`` seeded with ``seed``; they
cannot repeat ``jax.random``'s bits, so ``init_idx`` (the initial centroid
rows) and ``reseed_idx`` ([iters, C] rows that re-seed empty clusters) may
be passed in to reproduce a JAX fit exactly.

The fit repeats bit for bit on the card: each block's cluster sums are
taken in row order (``_cluster_sums``), never with float atomics, whose
order changes from run to run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.dense import l2_normalize, stable_topk
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

# query rows scored at once a probe: the [rows, chunk_cap, D] float32 gather
# stays under this many bytes (one query's row at 524,288 docs, D = 384 and
# chunk_cap = 2,896 is 4.4 MB, so 60 queries a block)
IVF_GATHER_BYTES = 256 << 20


def _cluster_sums(vb: torch.Tensor, assign: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
    """[C, D] sum of the rows of ``vb`` assigned to each cluster, each
    cluster's rows added in row order: a stable sort by cluster makes every
    cluster one contiguous segment, and ``segment_reduce`` walks each
    segment in order (one output element per thread on CUDA, no atomics),
    so the sums repeat bit for bit. A one-hot product would cost C times
    the work."""
    order = torch.sort(assign, stable=True).indices
    return torch.segment_reduce(vb[order], "sum", lengths=counts, axis=0,
                                unsafe=True)


def kmeans_fit(
    vectors: torch.Tensor,
    n_clusters: int,
    seed: int = 0,
    iters: int = 10,
    block: int = 16384,
    init_idx: Optional[torch.Tensor] = None,
    reseed_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[n_clusters, D] unit centroids: init from data rows, Lloyd
    iterations with argmax-cosine assignment, empty clusters re-seeded
    from data rows."""
    n, _ = vectors.shape
    dev = vectors.device
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    if init_idx is None:
        init_idx = torch.randperm(n, generator=g)[:n_clusters]
    c = l2_normalize(vectors[torch.as_tensor(init_idx, device=dev).long()].float())
    for it in range(iters):
        sums = torch.zeros((n_clusters, vectors.shape[1]), dtype=torch.float32,
                           device=dev)
        counts = torch.zeros(n_clusters, dtype=torch.float32, device=dev)
        for r0 in range(0, n, block):
            vb = l2_normalize(vectors[r0:r0 + block].float())
            assign = torch.argmax(vb @ c.T, dim=1)
            block_counts = torch.bincount(assign, minlength=n_clusters)
            sums += _cluster_sums(vb, assign, block_counts)
            counts += block_counts.float()
        if reseed_idx is not None:
            rnd_idx = torch.as_tensor(reseed_idx[it], device=dev).long()
        else:
            rnd_idx = torch.randint(0, n, (n_clusters,), generator=g).to(dev)
        rnd = l2_normalize(vectors[rnd_idx].float())
        new_c = torch.where(counts[:, None] > 0,
                            sums / counts[:, None].clamp_min(1.0), rnd)
        c = new_c / new_c.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return c


def kmeans_assign(vectors: torch.Tensor, centroids: torch.Tensor,
                  block: int = 16384) -> torch.Tensor:
    """[n] int64 argmax-cosine cluster assignment, blocked like kmeans_fit."""
    out = []
    for r0 in range(0, vectors.shape[0], block):
        vb = l2_normalize(vectors[r0:r0 + block].float())
        out.append(torch.argmax(vb @ centroids.T, dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.long, device=vectors.device)
    return torch.cat(out)


def _ivf_search(
    queries: torch.Tensor,  # [B, D]
    centroids_per_chunk: torch.Tensor,  # [n_chunks, D]
    docs_perm: torch.Tensor,  # [>= N + chunk_cap, D] cluster-ordered
    chunk_starts: torch.Tensor,  # [n_chunks] int64 row offsets
    chunk_lens: torch.Tensor,  # [n_chunks] int64
    perm_to_orig: torch.Tensor,  # [rows] int64 doc id of each row (-1 pad)
    k: int,
    nprobe: int,
    chunk_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, k] scores, [B, k] doc ids, -1 where fewer than k rows were
    probed): each query's top-``nprobe`` chunks by centroid score, every row
    of those chunks scored in float32, exact top-k over the probed rows
    (ties to the lower probe, then row). A probe reads ``chunk_cap`` rows
    from its chunk's start (rows past the chunk's length score -inf), so
    the buffer holds ``chunk_cap`` rows past the last chunk. The gather is
    done a probe at a time for blocks of queries (``IVF_GATHER_BYTES``)."""
    q = l2_normalize(queries.float())
    B, D = q.shape
    dev = q.device
    c_scores = q @ centroids_per_chunk.float().T
    # a shard's pad chunks (length 0) are never probed
    c_scores = torch.where(chunk_lens[None, :] > 0, c_scores, float("-inf"))
    _, probe = stable_topk(c_scores, nprobe)  # [B, P]
    iota = torch.arange(chunk_cap, device=dev)
    rows = chunk_starts[probe][:, :, None] + iota  # [B, P, cap]
    valid = iota < chunk_lens[probe][:, :, None]
    scores = torch.empty((B, nprobe, chunk_cap), dtype=torch.float32, device=dev)
    blk = max(1, IVF_GATHER_BYTES // (chunk_cap * D * 4))
    for b0 in range(0, B, blk):
        qb = q[b0:b0 + blk]
        for p in range(nprobe):
            scores[b0:b0 + blk, p] = torch.einsum(
                "bcd,bd->bc", docs_perm[rows[b0:b0 + blk, p]].float(), qb)
    scores = torch.where(valid, scores, float("-inf")).reshape(B, -1)
    vals, sel = stable_topk(scores, k)
    ids = perm_to_orig[torch.gather(rows.reshape(B, -1), 1, sel)]
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def mesh_kmeans(mesh, vectors: torch.Tensor, n_clusters: int, seed: int = 0,
                iters: int = 10) -> Tuple[torch.Tensor, np.ndarray]:
    """(centroids [C, D], assignment [n]) of ``vectors`` (the whole matrix,
    the same on every rank), fitted on rank 0 and broadcast over the data
    axis, so every rank cuts the same clusters whatever its float order."""
    from hybridsearch_tpu_torch.parallel.mesh import broadcast_host

    n, dim = int(vectors.shape[0]), int(vectors.shape[1])
    if mesh.data_index == 0:
        cent = kmeans_fit(vectors, n_clusters, seed=seed, iters=iters)
        assign = kmeans_assign(vectors, cent).cpu().numpy()
        cent_np = cent.cpu().numpy()
    else:
        cent_np = np.zeros((n_clusters, dim), np.float32)
        assign = np.zeros(n, np.int64)
    cent_np = broadcast_host(mesh, cent_np)
    assign = broadcast_host(mesh, assign.astype(np.int64))
    return torch.from_numpy(cent_np).to(vectors.device), assign


def _chunkify(sorted_assign: np.ndarray, cap: int):
    """(starts, lens, centroid id) of the chunks of a cluster-sorted
    assignment: each cluster's row range cut into pieces of at most
    ``cap`` rows."""
    n = len(sorted_assign)
    bounds = np.flatnonzero(np.diff(sorted_assign)) + 1
    cl_starts = np.concatenate([[0], bounds])
    cl_ends = np.concatenate([bounds, [n]])
    starts, lens, cids = [], [], []
    for s, e in zip(cl_starts, cl_ends):
        for p in range(s, e, cap):
            starts.append(p)
            lens.append(min(cap, e - p))
            cids.append(sorted_assign[s])
    return (np.asarray(starts, np.int64), np.asarray(lens, np.int64),
            np.asarray(cids, np.int64))


class IVFIndex:
    """Approximate inner-product index over L2-normalized embeddings.
    ``mesh`` shards the chunks over the data axis. ``storage_dtype``
    (float32 or bfloat16) is the dtype of the permuted rows a build stores:
    bfloat16 halves their bytes. k-means runs on the float32 vectors
    whatever it is, and a probe casts the stored rows to float32 before its
    float32 product, so a bfloat16 index differs from a float32 one only by
    the rounding of the stored rows. ``from_layout`` adopts the dense
    buffer as it is (float32)."""

    def __init__(
        self,
        dim: int = 384,
        n_clusters: int = 0,  # 0 = sqrt(N) at build time
        nprobe: int = 8,
        chunk_cap: int = 0,  # 0 = 4 * N / n_clusters
        seed: int = 0,
        device: DeviceLike = None,
        mesh=None,
        storage_dtype: torch.dtype = torch.float32,
    ) -> None:
        self.dim = dim
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.chunk_cap = chunk_cap
        self.seed = seed
        self.mesh = mesh
        self.storage_dtype = storage_dtype
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.n_docs = 0
        self._built = False

    def load_arrays(self, centroids_per_chunk: torch.Tensor,
                    docs_perm: torch.Tensor, chunk_starts: torch.Tensor,
                    chunk_lens: torch.Tensor, perm_to_orig: torch.Tensor,
                    chunk_cap: int, n_docs: int) -> "IVFIndex":
        """Adopt built arrays as they are (``docs_perm`` is not copied): the
        per-chunk centroids [n_chunks, D], the cluster-ordered rows with at
        least ``chunk_cap`` rows past the last chunk, the chunks' row starts
        and lengths, and each row's doc id (-1 pad). convert.py carries the
        JAX package's index through this."""
        dev = docs_perm.device
        self.n_docs = int(n_docs)
        self.dim = int(docs_perm.shape[1])
        self._cap = int(chunk_cap)
        self._centroids = centroids_per_chunk.to(dev, torch.float32)
        self._docs_perm = docs_perm
        self._chunk_starts = chunk_starts.to(dev, torch.int64)
        self._chunk_lens = chunk_lens.to(dev, torch.int64)
        self._perm_to_orig = perm_to_orig.to(dev, torch.int64)
        self._built = True
        return self

    def _adopt_clusters(self, centroids: torch.Tensor, sorted_assign: np.ndarray,
                        cap: int, docs_perm: torch.Tensor,
                        perm_to_orig: np.ndarray, n: int) -> "IVFIndex":
        starts, lens, cids = _chunkify(sorted_assign, cap)
        dev = docs_perm.device
        return self.load_arrays(centroids.to(dev)[torch.from_numpy(cids).to(dev)],
                                docs_perm, torch.from_numpy(starts),
                                torch.from_numpy(lens),
                                torch.from_numpy(perm_to_orig), cap, n)

    def build(self, vectors, kmeans_iters: int = 10) -> "IVFIndex":
        """Build from [n, D] vectors (tensor or numpy) on the index's device:
        k-means, argmax assignment, docs permuted into cluster order (stable
        within a cluster), normalized in float32 and stored in
        ``storage_dtype`` in a buffer with ``chunk_cap`` spare rows."""
        v = (vectors if torch.is_tensor(vectors)
             else torch.from_numpy(np.asarray(vectors, dtype=np.float32)))
        v = v.to(self.device)
        n, dim = int(v.shape[0]), int(v.shape[1])
        C = min(self.n_clusters or max(1, int(np.sqrt(n))), n)
        cap = self.chunk_cap or max(8, (4 * n) // C)
        if self.mesh is not None:
            centroids, assign = mesh_kmeans(self.mesh, v, C, self.seed, kmeans_iters)
            return self._build_sharded(v, centroids, assign, cap)
        centroids = kmeans_fit(v, C, seed=self.seed, iters=kmeans_iters)
        assign = kmeans_assign(v, centroids).cpu().numpy()
        order = np.argsort(assign, kind="stable")
        docs_perm = torch.zeros((n + cap, dim), dtype=self.storage_dtype,
                                device=self.device)
        docs_perm[:n] = l2_normalize(v[torch.from_numpy(order).to(self.device)].float())
        perm_to_orig = np.full(n + cap, -1, dtype=np.int64)
        perm_to_orig[:n] = order
        return self._adopt_clusters(centroids, assign[order], cap, docs_perm,
                                    perm_to_orig, n)

    def from_layout(self, docs_dev: torch.Tensor, n_docs: int, centroids,
                    sorted_assign: np.ndarray) -> "IVFIndex":
        """Adopt a cluster-ordered, L2-normalized device matrix (the dense
        snapshot of a ``layout="clustered"`` build, rows beyond ``n_docs``
        spare) with the layout k-means' centroids [C, D] and the cluster of
        each row, instead of a second k-means and a second corpus copy: row
        ids are doc ids. The buffer must hold ``chunk_cap`` rows past
        ``n_docs`` (``DenseIndex.reserve_rows``). Single-device only: the
        sharded build places the rows itself."""
        if self.mesh is not None:
            raise ValueError("from_layout is single-device; use build()")
        n = int(n_docs)
        sorted_assign = np.asarray(sorted_assign)
        centroids = (centroids if torch.is_tensor(centroids)
                     else torch.from_numpy(np.asarray(centroids, np.float32)))
        C = int(centroids.shape[0])
        cap = self.chunk_cap or max(8, (4 * n) // max(C, 1))
        if int(docs_dev.shape[0]) < n + cap:
            # a probe of the last chunks would run past the buffer
            raise ValueError(f"shared buffer too small: need >= {n + cap} rows "
                             f"(n + chunk overhang), got {docs_dev.shape[0]}")
        ids = np.full(int(docs_dev.shape[0]), -1, dtype=np.int64)
        ids[:n] = np.arange(n)
        return self._adopt_clusters(centroids, sorted_assign, cap, docs_dev, ids, n)

    def search(self, queries, k: int,
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-k: numpy (values [B, k'], doc ids [B, k'], -1 for
        an empty slot), k' = min(k, n_docs). queries [B, D] raw embeddings
        (tensor or numpy), normalized here."""
        if not self._built:
            raise RuntimeError("IVFIndex.search before build()")
        q = (queries if torch.is_tensor(queries)
             else torch.from_numpy(np.asarray(queries, dtype=np.float32)))
        npr = nprobe or self.nprobe
        if self.mesh is not None:
            from hybridsearch_tpu_torch.parallel.collectives import merge_topk
            from hybridsearch_tpu_torch.parallel.mesh import shard_count

            # a rank's probe depth keeps the probed chunks ~ nprobe in all
            npr = max(1, -(-npr // shard_count(self.mesh)))
        npr = min(npr, int(self._centroids.shape[0]))
        k_eff = min(k, self.n_docs)
        vals, idxs = _ivf_search(q.to(self._docs_perm.device), self._centroids,
                                 self._docs_perm, self._chunk_starts,
                                 self._chunk_lens, self._perm_to_orig,
                                 k_eff, npr, self._cap)
        if self.mesh is not None:
            vals, idxs = merge_topk(vals, idxs, k_eff, self.mesh)
        return vals.cpu().numpy(), idxs.cpu().numpy()

    def _build_sharded(self, v: torch.Tensor, centroids: torch.Tensor,
                       assign: np.ndarray, cap: int) -> "IVFIndex":
        """The chunks round-robin over the shards (balancing rows for
        equal-size chunks); this rank keeps its own, each padded to the
        largest shard's chunk and row counts (rows + the chunk overhang),
        its rows' global doc ids (-1 pad)."""
        from hybridsearch_tpu_torch.parallel.mesh import shard_count

        S, shard = shard_count(self.mesh), self.mesh.data_index
        n, dim = int(v.shape[0]), int(v.shape[1])
        order = np.argsort(assign, kind="stable")
        starts, lens, cids = _chunkify(assign[order], cap)
        owner = np.arange(len(starts)) % S
        chunks_pad = max(1, -(-len(starts) // S))
        rows_pad = max(int(lens[owner == s].sum()) for s in range(S)) + cap
        mine = np.flatnonzero(owner == shard)
        my_lens = lens[mine]
        my_starts = np.concatenate([[0], np.cumsum(my_lens)[:-1]]).astype(np.int64)
        rows = (np.concatenate([order[starts[c]:starts[c] + lens[c]] for c in mine])
                if len(mine) else np.zeros(0, np.int64))
        dev = self.device
        docs = torch.zeros((rows_pad, dim), dtype=self.storage_dtype, device=dev)
        docs[:len(rows)] = l2_normalize(v[torch.from_numpy(rows).to(dev)].float())
        orig = np.full(rows_pad, -1, dtype=np.int64)
        orig[:len(rows)] = rows
        st = np.zeros(chunks_pad, np.int64)
        ln = np.zeros(chunks_pad, np.int64)
        st[:len(mine)], ln[:len(mine)] = my_starts, my_lens
        cent = torch.zeros((chunks_pad, dim), dtype=torch.float32, device=dev)
        cent[:len(mine)] = centroids.to(dev)[torch.from_numpy(cids[mine]).to(dev)]
        return self.load_arrays(cent, docs, torch.from_numpy(st), torch.from_numpy(ln),
                                torch.from_numpy(orig), cap, n)
