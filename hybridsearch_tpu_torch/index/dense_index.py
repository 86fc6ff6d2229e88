"""Device-resident dense (semantic) index.

Counterpart of ``hybridsearch_tpu/index/dense_index.py`` on one device: a
flat exact index is a capacity-padded [capacity, D] matrix of L2-normalized
embeddings plus a tombstone bias vector (0 alive, -inf deleted or padding).
Mutations (build, add, delete, compact) build a new snapshot and swap it
atomically, so a reader always sees a consistent (docs, bias, n) triple;
``add`` grows the buffers on the device in steps of ``capacity_round``.
``save`` / ``load`` write and read the JAX package's layout (a manifest,
one shard file, the bias). ``reserve_rows`` keeps spare zero rows past the
docs for an IVF index that shares the buffer. The mesh-sharded layout is
still to port.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.dense import l2_normalize, tiled_dense_topk
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

NEG_INF_F32 = float("-inf")


class _Snapshot:
    """Immutable view of the index state; swapped atomically on mutation."""

    __slots__ = ("docs", "bias", "n", "capacity")

    def __init__(self, docs: torch.Tensor, bias: torch.Tensor, n: int,
                 capacity: int):
        self.docs = docs  # [capacity, D] float32, L2-normalized rows
        self.bias = bias  # [capacity] float32, 0 alive / -inf deleted
        self.n = n  # rows assigned
        self.capacity = capacity


class DenseIndex:
    """Exact inner-product index over L2-normalized embeddings."""

    def __init__(self, dim: int = 384, capacity_round: int = 4096,
                 device: DeviceLike = None) -> None:
        self.dim = dim
        self.capacity_round = capacity_round
        self.device = resolve_device(device)
        # zero rows kept past n in every snapshot: a clustered IVF build sets
        # it to the IVF chunk width, so IVFIndex.from_layout's probes of the
        # last chunks stay inside the shared buffer (index/builder.py)
        self.reserve_rows = 0
        self._lock = threading.Lock()  # writers only; readers are lock-free
        self._snap = self._make_snapshot(
            torch.zeros((0, dim), dtype=torch.float32), None, 0)
        self.deleted_count = 0

    @property
    def n_docs(self) -> int:
        return self._snap.n

    @property
    def capacity(self) -> int:
        return self._snap.capacity

    def __len__(self) -> int:
        return self._snap.n - self.deleted_count

    def _round_capacity(self, n: int) -> int:
        r = self.capacity_round
        return -(-(max(n, 1) + self.reserve_rows) // r) * r

    def _make_snapshot(self, vectors: torch.Tensor, bias: Optional[torch.Tensor],
                       n: int, normalize: bool = False) -> _Snapshot:
        """Snapshot of the first n rows; capacity-padding rows are zero with
        -inf bias, so they never displace real docs from a top-k."""
        cap = self._round_capacity(n)
        docs = torch.zeros((cap, self.dim), dtype=torch.float32, device=self.device)
        docs[:n] = vectors[:n].to(self.device, torch.float32)
        if normalize:
            docs = l2_normalize(docs)  # zero rows stay zero under the eps guard
        b = torch.full((cap,), NEG_INF_F32, dtype=torch.float32, device=self.device)
        b[:n] = 0.0 if bias is None else bias[:n].to(self.device, torch.float32)
        return _Snapshot(docs, b, n, cap)

    def build(self, vectors) -> "DenseIndex":
        """(Re)build from [N, D] raw embeddings (tensor or numpy);
        normalization runs on the device."""
        v = (vectors if torch.is_tensor(vectors)
             else torch.from_numpy(np.asarray(vectors, dtype=np.float32)))
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}] vectors, got {tuple(v.shape)}")
        snap = self._make_snapshot(v, None, v.shape[0], normalize=True)
        with self._lock:
            self._snap = snap
            self.deleted_count = 0
        return self

    def load_snapshot(self, docs: torch.Tensor, bias: torch.Tensor, n: int) -> None:
        """Adopt an already-normalized snapshot (convert.py carries the JAX
        package's state through this)."""
        cap = docs.shape[0]
        if docs.shape[1] != self.dim or bias.shape != (cap,) or n > cap:
            raise ValueError("snapshot shapes do not match")
        snap = _Snapshot(docs.to(self.device, torch.float32).contiguous(),
                         bias.to(self.device, torch.float32).contiguous(), n, cap)
        with self._lock:
            self._snap = snap
            self.deleted_count = int((snap.bias[:n] == NEG_INF_F32).sum())

    def add(self, vectors) -> np.ndarray:
        """Append [M, D] raw embeddings (normalized here, on the device);
        returns their row ids. Rows past the old count get bias 0; a full
        buffer grows on the device to the next ``capacity_round``."""
        v = (vectors if torch.is_tensor(vectors)
             else torch.from_numpy(np.asarray(vectors, dtype=np.float32)))
        if v.numel() == 0:
            return np.zeros((0,), dtype=np.int64)
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected [M, {self.dim}] vectors, got {tuple(v.shape)}")
        v = l2_normalize(v.to(self.device, torch.float32))
        with self._lock:
            snap = self._snap
            n_new = snap.n + v.shape[0]
            cap = max(snap.capacity, self._round_capacity(n_new))
            # copy-on-write: readers of the old snapshot keep its buffers
            docs = snap.docs.new_zeros((cap, self.dim))
            docs[:snap.n] = snap.docs[:snap.n]
            docs[snap.n:n_new] = v
            bias = snap.bias.new_full((cap,), NEG_INF_F32)
            bias[:snap.n] = snap.bias[:snap.n]
            bias[snap.n:n_new] = 0.0
            self._snap = _Snapshot(docs, bias, n_new, cap)
            return np.arange(snap.n, n_new, dtype=np.int64)

    def delete(self, row_ids) -> None:
        """Tombstone rows (score bias -> -inf). A row named twice, or already
        tombstoned, is counted once."""
        ids = torch.as_tensor(np.unique(np.asarray(row_ids, dtype=np.int64)),
                              device=self.device)
        with self._lock:
            snap = self._snap
            bias = snap.bias.clone()
            newly = int((bias[ids] == 0).sum())
            bias[ids] = NEG_INF_F32
            self._snap = _Snapshot(snap.docs, bias, snap.n, snap.capacity)
            self.deleted_count += newly

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows; returns the old row -> new row mapping (-1
        for a deleted row)."""
        with self._lock:
            snap = self._snap
            alive = snap.bias[:snap.n] == 0
            keep = alive.cpu().numpy()
            mapping = np.full(snap.n, -1, dtype=np.int64)
            mapping[keep] = np.arange(int(keep.sum()))
            self._snap = self._make_snapshot(snap.docs[:snap.n][alive], None,
                                             int(keep.sum()))
            self.deleted_count = 0
            return mapping

    def get_vectors(self, row_ids) -> np.ndarray:
        """[len(row_ids), D] normalized rows (ids clipped into the buffer)."""
        snap = self._snap
        ids = torch.as_tensor(np.asarray(row_ids, dtype=np.int64),
                              device=self.device).clamp(0, snap.capacity - 1)
        return snap.docs[ids].cpu().numpy()

    def save(self, path: str) -> None:
        """Write ``path/manifest.json``, ``path/shard_00000.npy`` (the n
        assigned rows) and ``path/bias.npy``: the JAX package's layout."""
        os.makedirs(path, exist_ok=True)
        snap = self._snap
        manifest = {"kind": "dense", "dim": self.dim, "n_docs": snap.n,
                    "n_shards": 1, "rows_per_shard": snap.n,
                    "dtype": "float32", "normalized": True}
        np.save(os.path.join(path, "shard_00000.npy"),
                snap.docs[:snap.n].cpu().numpy())
        np.save(os.path.join(path, "bias.npy"), snap.bias[:snap.n].cpu().numpy())
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load(cls, path: str, capacity_round: int = 4096,
             device: DeviceLike = None) -> "DenseIndex":
        """An index from a directory ``save`` (of either package) wrote; the
        shards upload from memory maps."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        idx = cls(dim=manifest["dim"], capacity_round=capacity_round, device=device)
        shards = [np.load(os.path.join(path, f"shard_{s:05d}.npy"), mmap_mode="c")
                  for s in range(manifest["n_shards"])]
        docs = ([torch.from_numpy(s) for s in shards]
                or [torch.zeros((0, idx.dim), dtype=torch.float32)])
        docs = docs[0] if len(docs) == 1 else torch.cat(docs)
        bias_path = os.path.join(path, "bias.npy")
        bias = (torch.from_numpy(np.load(bias_path)) if os.path.exists(bias_path)
                else None)
        with idx._lock:
            idx._snap = idx._make_snapshot(docs, bias, manifest["n_docs"])
            idx.deleted_count = (int((bias == NEG_INF_F32).sum())
                                 if bias is not None else 0)
        return idx

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k. queries: [B, D] raw embeddings (normalized here).
        Returns numpy (values [B, k'], indices [B, k']), k' = min(k, n)."""
        snap = self._snap
        q = (queries if torch.is_tensor(queries) else
             torch.from_numpy(np.array(queries, dtype=np.float32))).to(self.device)
        if snap.n == 0:
            B = q.shape[0]
            return np.zeros((B, 0), np.float32), np.zeros((B, 0), np.int64)
        k_eff = min(k, snap.n)
        vals, idxs = tiled_dense_topk(l2_normalize(q), snap.docs, k_eff,
                                      bias=snap.bias)
        valid = (idxs >= 0) & (idxs < snap.n)
        vals = torch.where(valid, vals, NEG_INF_F32)
        idxs = torch.where(valid, idxs, -1)
        return vals.cpu().numpy(), idxs.cpu().numpy()
