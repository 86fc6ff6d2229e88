"""Device-resident dense (semantic) index.

Counterpart of ``hybridsearch_tpu/index/dense_index.py`` on one device: a
flat exact index is a capacity-padded [capacity, D] matrix of L2-normalized
embeddings plus a tombstone bias vector (0 alive, -inf deleted or padding).
Mutations (build, add, delete, compact) build a new snapshot and swap it
atomically, so a reader always sees a consistent (docs, bias, n) triple;
``add`` grows the buffers on the device in steps of ``capacity_round``.
``save`` / ``load`` write and read the JAX package's layout (a manifest,
one shard file, the bias). ``reserve_rows`` keeps spare zero rows past the
docs for an IVF index that shares the buffer.

On a mesh (``parallel/mesh.py``) the capacity rounds per shard and each
rank's snapshot holds only its ``capacity / shards`` rows and their bias
(global rows [shard * per, (shard + 1) * per)); ``n`` and the capacity
stay global. Search is the collective ``sharded_dense_topk``, ``delete``
tombstones this rank's rows, and ``save`` writes the JAX layout (one
``shard_{s:05d}.npy`` of ceil(n / shards) rows a shard), each rank writing
its own rows into the files; ``load(path, mesh=)`` reads this rank's rows
out of the files of any shard count. Growing a sharded capacity (``add``
past it) and ``compact`` change which rank owns a row, which the JAX
package leaves to XLA's partitioning: here each rank lays out its part of
the new snapshot, keeps the rows it still owns and receives from their old
owners only the rows that change rank (``parallel/collectives.py``
``move_rows``); ``moved_rows`` says how many it received.
"""

from __future__ import annotations

import json
import os
import threading
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from hybridsearch_tpu_torch.ops.dense import l2_normalize, tiled_dense_topk
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

if TYPE_CHECKING:
    from hybridsearch_tpu_torch.parallel.mesh import Mesh

NEG_INF_F32 = float("-inf")


class _Snapshot:
    """Immutable view of the index state; swapped atomically on mutation."""

    __slots__ = ("docs", "bias", "n", "capacity")

    def __init__(self, docs: torch.Tensor, bias: torch.Tensor, n: int,
                 capacity: int):
        # [capacity, D] float32 L2-normalized rows and [capacity] bias (0
        # alive / -inf deleted); on a mesh this rank's [capacity / shards]
        self.docs = docs
        self.bias = bias
        self.n = n  # rows assigned
        self.capacity = capacity


class DenseIndex:
    """Exact inner-product index over L2-normalized embeddings."""

    def __init__(self, dim: int = 384, capacity_round: int = 4096,
                 device: DeviceLike = None, mesh: Optional["Mesh"] = None,
                 block_n: int = 4096) -> None:
        self.dim = dim
        self.capacity_round = capacity_round
        self.mesh = mesh
        self.block_n = block_n  # doc block of the mesh's streaming top-k
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # zero rows kept past n in every snapshot: a clustered IVF build sets
        # it to the IVF chunk width, so IVFIndex.from_layout's probes of the
        # last chunks stay inside the shared buffer (index/builder.py)
        self.reserve_rows = 0
        self._lock = threading.Lock()  # writers only; readers are lock-free
        self._snap = self._make_snapshot(
            torch.zeros((0, dim), dtype=torch.float32), None, 0)
        self.deleted_count = 0
        self.moved_rows = 0  # rows this rank received in the last re-layout

    @property
    def n_docs(self) -> int:
        return self._snap.n

    @property
    def capacity(self) -> int:
        return self._snap.capacity

    def __len__(self) -> int:
        return self._snap.n - self.deleted_count

    def _n_shards(self) -> int:
        from hybridsearch_tpu_torch.parallel.mesh import shard_count

        return shard_count(self.mesh) if self.mesh is not None else 1

    def _round_capacity(self, n: int) -> int:
        """Capacity for n rows: each shard's rows rounded up to
        ``capacity_round``."""
        r, shards = self.capacity_round, self._n_shards()
        per = -(-(max(n, 1) + self.reserve_rows) // shards)
        return -(-per // r) * r * shards

    def _rows(self, cap: int) -> Tuple[int, int]:
        """(first global row, rows) of this rank's part of a capacity."""
        if self.mesh is None:
            return 0, cap
        per = cap // self._n_shards()
        return self.mesh.data_index * per, per

    def _make_snapshot(self, vectors, bias, n: int,
                       normalize: bool = False) -> _Snapshot:
        """Snapshot of the first n rows of ``vectors`` (a tensor, or numpy
        such as a memory map; on a mesh only this rank's rows are read);
        capacity-padding rows are zero with -inf bias, so they never
        displace real docs from a top-k."""
        cap = self._round_capacity(n)
        lo, rows = self._rows(cap)
        m = max(0, min(n - lo, rows))  # assigned rows of this part
        docs = torch.zeros((rows, self.dim), dtype=torch.float32, device=self.device)
        b = torch.full((rows,), NEG_INF_F32, dtype=torch.float32, device=self.device)
        if m:
            part = vectors[lo:lo + m]
            part = part if torch.is_tensor(part) else torch.from_numpy(
                np.array(part, dtype=np.float32))  # a copy: maps are read-only
            docs[:m] = part.to(self.device, torch.float32)
            if bias is None:
                b[:m] = 0.0
            else:
                bp = bias[lo:lo + m]
                bp = bp if torch.is_tensor(bp) else torch.from_numpy(
                    np.array(bp, dtype=np.float32))
                b[:m] = bp.to(self.device, torch.float32)
        if normalize:
            docs = l2_normalize(docs)  # zero rows stay zero under the eps guard
        return _Snapshot(docs, b, n, cap)

    def _dead_total(self, local_dead: int) -> int:
        """Tombstoned rows over every shard (one collective on a mesh)."""
        if self.mesh is None:
            return local_dead
        from hybridsearch_tpu_torch.parallel.collectives import all_reduce_sum

        return all_reduce_sum(local_dead, self.mesh)

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
        if self.mesh is not None:
            raise ValueError("load_snapshot adopts a single-device snapshot")
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
        buffer grows on the device to the next ``capacity_round``. On a
        mesh every rank adds the same vectors: growth lays the old rows out
        over the new capacity's parts first (``_relayout``), then each rank
        writes the new rows it owns."""
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
            if self.mesh is not None:
                return self._add_sharded(snap, v, n_new)
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

    def _add_sharded(self, snap: _Snapshot, v: torch.Tensor, n_new: int) -> np.ndarray:
        fresh = False  # the buffers are this call's own
        if n_new > snap.capacity:
            new_cap = self._round_capacity(n_new)
            src = np.full(new_cap, -1, dtype=np.int64)
            src[:snap.n] = np.arange(snap.n)
            snap = _Snapshot(*self._relayout(snap, src, new_cap), snap.n, new_cap)
            fresh = True
        lo, rows = self._rows(snap.capacity)
        a, e = max(snap.n, lo), min(n_new, lo + rows)  # new rows of this rank
        docs, bias = snap.docs, snap.bias
        if a < e:
            if not fresh:
                docs, bias = docs.clone(), bias.clone()  # copy-on-write
            docs[a - lo:e - lo] = v[a - snap.n:e - snap.n]
            bias[a - lo:e - lo] = 0.0
        self._snap = _Snapshot(docs, bias, n_new, snap.capacity)
        return np.arange(snap.n, n_new, dtype=np.int64)

    def _relayout(self, snap: _Snapshot, src: np.ndarray,
                  new_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's (docs, bias) of a new capacity ``new_cap`` whose
        global row g holds old row ``src[g]`` with its bias (-1: a zero row
        at -inf), the same ``src`` on every rank. Docs and bias travel
        together as one [rows, D + 1] array, so each moving row is one
        entry of one collective."""
        from hybridsearch_tpu_torch.parallel.collectives import move_rows

        shards = self._n_shards()
        packed = torch.cat([snap.docs, snap.bias[:, None]], dim=1)
        rows, self.moved_rows = move_rows(self.mesh, packed, snap.capacity // shards,
                                          src, new_cap // shards)
        lo, per = self._rows(new_cap)
        bias = rows[:, self.dim].contiguous()
        bias[torch.from_numpy(src[lo:lo + per] < 0).to(bias.device)] = NEG_INF_F32
        return rows[:, :self.dim].contiguous(), bias

    def delete(self, row_ids) -> None:
        """Tombstone rows (score bias -> -inf). A row named twice, or already
        tombstoned, is counted once. An id outside ``[0, capacity)`` raises
        ``IndexError`` before any row changes (a negative id too: it names no
        row). On a mesh every rank is given the same ids, so every rank
        raises alike; each tombstones the rows it owns, and the count is
        summed over the shards."""
        ids = np.unique(np.asarray(row_ids, dtype=np.int64))
        with self._lock:
            snap = self._snap
            if ids.size and (ids[0] < 0 or ids[-1] >= snap.capacity):
                bad = ids[0] if ids[0] < 0 else ids[-1]
                raise IndexError(f"row {bad} is out of range for a dense index "
                                 f"of capacity {snap.capacity}")
            lo, rows = self._rows(snap.capacity)
            ids = ids[(ids >= lo) & (ids < lo + rows)] - lo
            ids = torch.as_tensor(ids, device=self.device)
            bias = snap.bias.clone()
            newly = int((bias[ids] == 0).sum())
            bias[ids] = NEG_INF_F32
            self._snap = _Snapshot(snap.docs, bias, snap.n, snap.capacity)
            self.deleted_count += self._dead_total(newly)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows; returns the old row -> new row mapping (-1
        for a deleted row). On a mesh every rank gathers the whole bias (4
        bytes a row), so each computes the same mapping and returns it, and
        the surviving rows move to their new owners (``_relayout``)."""
        with self._lock:
            snap = self._snap
            if self.mesh is not None:
                from hybridsearch_tpu_torch.parallel.collectives import all_gather_cat

                keep = (all_gather_cat(snap.bias, self.mesh, dim=0)[:snap.n] == 0)
                keep = keep.cpu().numpy()
                n_alive = int(keep.sum())
                mapping = np.full(snap.n, -1, dtype=np.int64)
                mapping[keep] = np.arange(n_alive)
                new_cap = self._round_capacity(n_alive)
                src = np.full(new_cap, -1, dtype=np.int64)
                src[:n_alive] = np.flatnonzero(keep)
                self._snap = _Snapshot(*self._relayout(snap, src, new_cap), n_alive,
                                       new_cap)
                self.deleted_count = 0
                return mapping
            alive = snap.bias[:snap.n] == 0
            keep = alive.cpu().numpy()
            mapping = np.full(snap.n, -1, dtype=np.int64)
            mapping[keep] = np.arange(int(keep.sum()))
            self._snap = self._make_snapshot(snap.docs[:snap.n][alive], None,
                                             int(keep.sum()))
            self.deleted_count = 0
            return mapping

    def get_vectors(self, row_ids) -> np.ndarray:
        """[len(row_ids), D] normalized rows (ids clipped into the buffer).
        On a mesh each rank gives the rows it owns and one gather of the
        [len(row_ids), D] rows of every rank fills the rest."""
        snap = self._snap
        ids = torch.as_tensor(np.asarray(row_ids, dtype=np.int64),
                              device=self.device).clamp(0, snap.capacity - 1)
        if self.mesh is None:
            return snap.docs[ids].cpu().numpy()
        from hybridsearch_tpu_torch.parallel.collectives import all_gather_cat

        lo, rows = self._rows(snap.capacity)
        owner = ids // rows
        mine = snap.docs[(ids - lo).clamp(0, rows - 1)]
        every = all_gather_cat(mine[None], self.mesh, dim=0)  # [S, M, D]
        return every[owner, torch.arange(len(ids), device=self.device)].cpu().numpy()

    def save(self, path: str) -> None:
        """Write ``path/manifest.json``, ``path/shard_{s:05d}.npy`` (the n
        assigned rows, ceil(n / shards) a file) and ``path/bias.npy``: the
        JAX package's layout. On a mesh rank 0 creates the files, every
        rank writes its own rows into them, and a barrier on each side
        orders the writes (``path`` must be on a file system every rank
        sees)."""
        snap = self._snap
        if self.mesh is None:
            os.makedirs(path, exist_ok=True)
            np.save(os.path.join(path, "shard_00000.npy"),
                    snap.docs[:snap.n].cpu().numpy())
            np.save(os.path.join(path, "bias.npy"), snap.bias[:snap.n].cpu().numpy())
            self._write_manifest(path, 1, snap.n)
            return
        import torch.distributed as dist

        shards = self._n_shards()
        per_file = -(-snap.n // shards) if snap.n else 0
        group = self.mesh.data_group
        if self.mesh.data_index == 0:
            os.makedirs(path, exist_ok=True)
            for f in range(shards):
                rows = max(0, min(per_file, snap.n - f * per_file))
                np.lib.format.open_memmap(os.path.join(path, f"shard_{f:05d}.npy"),
                                          mode="w+", dtype=np.float32,
                                          shape=(rows, self.dim)).flush()
            np.lib.format.open_memmap(os.path.join(path, "bias.npy"), mode="w+",
                                      dtype=np.float32, shape=(snap.n,)).flush()
            self._write_manifest(path, shards, per_file)
        dist.barrier(group=group)
        lo, rows = self._rows(snap.capacity)
        hi = min(lo + rows, snap.n)
        if lo < hi:
            docs = snap.docs[:hi - lo].cpu().numpy()
            bias_file = np.load(os.path.join(path, "bias.npy"), mmap_mode="r+")
            bias_file[lo:hi] = snap.bias[:hi - lo].cpu().numpy()
            bias_file.flush()
            for f in range(lo // per_file, -(-hi // per_file)):
                a, e = max(lo, f * per_file), min(hi, (f + 1) * per_file)
                out = np.load(os.path.join(path, f"shard_{f:05d}.npy"), mmap_mode="r+")
                out[a - f * per_file:e - f * per_file] = docs[a - lo:e - lo]
                out.flush()
            del bias_file, out
        dist.barrier(group=group)

    def _write_manifest(self, path: str, shards: int, rows_per_shard: int) -> None:
        manifest = {"kind": "dense", "dim": self.dim, "n_docs": self._snap.n,
                    "n_shards": shards, "rows_per_shard": rows_per_shard,
                    "dtype": "float32", "normalized": True}
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load(cls, path: str, capacity_round: int = 4096,
             device: DeviceLike = None, mesh: Optional["Mesh"] = None,
             block_n: int = 4096) -> "DenseIndex":
        """An index from a directory ``save`` (of either package, with any
        number of shard files) wrote; the rows upload from memory maps, on
        a mesh only this rank's."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        idx = cls(dim=manifest["dim"], capacity_round=capacity_round,
                  device=device, mesh=mesh, block_n=block_n)
        rows = _ShardFiles([np.load(os.path.join(path, f"shard_{s:05d}.npy"),
                                    mmap_mode="r")
                            for s in range(manifest["n_shards"])], idx.dim)
        bias_path = os.path.join(path, "bias.npy")
        bias = np.load(bias_path, mmap_mode="r") if os.path.exists(bias_path) else None
        n = manifest["n_docs"]
        with idx._lock:
            idx._snap = idx._make_snapshot(rows, bias, n)
            idx.deleted_count = (int((np.asarray(bias[:n]) == NEG_INF_F32).sum())
                                 if bias is not None else 0)
        return idx

    def search(self, queries, k: int, extra_bias=None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k. queries: [B, D] raw embeddings (normalized here).
        ``extra_bias``: an optional [n_docs] additive bias (the metadata
        pre-filter; numpy or a tensor, shorter than capacity), zero-padded
        to capacity and added to the tombstone bias.
        Returns numpy (values [B, k'], indices [B, k']), k' = min(k, n). On a
        mesh every rank passes the same queries and bias and gets the same
        answer (``sharded_dense_topk``; each rank adds its own rows' part)."""
        snap = self._snap
        q = (queries if torch.is_tensor(queries) else
             torch.from_numpy(np.array(queries, dtype=np.float32))).to(self.device)
        if snap.n == 0:
            B = q.shape[0]
            return np.zeros((B, 0), np.float32), np.zeros((B, 0), np.int64)
        k_eff = min(k, snap.n)
        bias = snap.bias
        if extra_bias is not None:
            bias = bias + self._local_extra_bias(extra_bias, snap.capacity)
        if self.mesh is not None:
            from hybridsearch_tpu_torch.parallel.collectives import sharded_dense_topk

            vals, idxs = sharded_dense_topk(self.mesh, l2_normalize(q.float()),
                                            snap.docs, k_eff, block_n=self.block_n,
                                            valid_n=snap.n, bias_local=bias)
            return vals.cpu().numpy(), idxs.cpu().numpy()
        vals, idxs = tiled_dense_topk(l2_normalize(q), snap.docs, k_eff, bias=bias)
        valid = (idxs >= 0) & (idxs < snap.n)
        vals = torch.where(valid, vals, NEG_INF_F32)
        idxs = torch.where(valid, idxs, -1)
        return vals.cpu().numpy(), idxs.cpu().numpy()

    def _local_extra_bias(self, extra_bias, capacity: int) -> torch.Tensor:
        """This rank's rows of ``extra_bias`` zero-padded to ``capacity``."""
        eb = (extra_bias if torch.is_tensor(extra_bias) else
              torch.from_numpy(np.asarray(extra_bias, dtype=np.float32)))
        eb = eb.to(self.device, torch.float32).reshape(-1)[:capacity]
        full = torch.zeros((capacity,), dtype=torch.float32, device=self.device)
        full[:eb.shape[0]] = eb
        lo, rows = self._rows(capacity)
        return full[lo:lo + rows]


class _ShardFiles:
    """Rows of the shard files of a saved index as one [n, D] array that
    only slices: ``[a:b]`` reads the rows from the memory maps it spans."""

    def __init__(self, files, dim: int) -> None:
        self.files = files
        self.dim = dim
        self.ends = np.cumsum([len(f) for f in files])

    def __len__(self) -> int:
        return int(self.ends[-1]) if len(self.files) else 0

    def __getitem__(self, sl: slice) -> np.ndarray:
        a, e = sl.start or 0, min(sl.stop, len(self))
        parts = []
        begin = 0
        for f, end in zip(self.files, self.ends):
            lo, hi = max(a, begin), min(e, int(end))
            if lo < hi:
                parts.append(np.asarray(f[lo - begin:hi - begin], dtype=np.float32))
            begin = int(end)
        if not parts:
            return np.zeros((0, self.dim), np.float32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
