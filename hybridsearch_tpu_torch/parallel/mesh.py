"""The (data, model) mesh over ``torch.distributed`` ranks.

Counterpart of ``hybridsearch_tpu/parallel/mesh.py``. The JAX mesh is one
program over a grid of devices; here it is one process a rank, every rank
running the same code on the same inputs (SPMD). The caller starts the
ranks and initializes the default process group (NCCL with one card a
rank, gloo when ranks share a card or run on the CPU); ``build_mesh`` lays
the group's ranks out row-major on a (data, model) grid, as the JAX
function reshapes its device list, and never picks a backend itself.

  data  — the document axis: each rank of a data row holds one shard of
          the rows of every index (``doc_sharding``);
  model — tensor parallelism for encoder weights in training: the ranks
          of a model row (``model_group``, the ranks that share a data
          coordinate) each hold one slice of every sharded weight
          (``model_bounds``; ``training/contrastive.py`` names the
          sharded weights). Serving uses the data axis only.

Collectives over the data axis (``parallel/collectives.py``) take CUDA
tensors on both backends: gloo copies them through host memory inside the
call, NCCL keeps them on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's view of the (data, model) grid: the axis sizes, its
    coordinates, the process group of its data row (the ranks that share
    its model coordinate), that of its model row (the ranks that share its
    data coordinate; None when the model axis has one rank), and the
    device its shards live on."""

    def __init__(self, n_data: int, n_model: int, data_index: int,
                 model_index: int, data_group, device: torch.device,
                 model_group=None) -> None:
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.data_index = data_index
        self.model_index = model_index
        self.data_group = data_group
        self.model_group = model_group
        self.device = device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.data_group)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"at=({self.data_index}, {self.model_index}), backend={self.backend}, "
                f"device={self.device})")


def build_mesh(n_data: int = -1, n_model: int = 1,
               device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh over the initialized default process group;
    ``n_data == -1`` takes every rank left (world // n_model). Rank r sits
    at (r // n_model, r % n_model). Raises when no group is initialized or
    the grid does not fit the world. Every rank must call it (the data-row
    and model-row groups are created collectively)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "build_mesh needs an initialized torch.distributed default process "
            "group (init_process_group with this rank and the world size); a "
            "mesh never falls back to a single device")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or (n_data == -1 and world % n_model):
        raise ValueError(f"mesh ?x{n_model} does not fit {world} ranks")
    if n_data == -1:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} "
                         f"ranks, the world has {world}")
    group = model_group = None
    if n_model == 1:
        group = dist.group.WORLD
    else:
        for m in range(n_model):  # every rank creates every row's group
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, group,
                resolve_device(device), model_group)


def shard_count(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def model_bounds(mesh: Mesh, n: int) -> Tuple[int, int]:
    """(first, end) of this rank's slice of an axis of length ``n`` split
    evenly over the model axis (a weight's sharded dimension)."""
    m = mesh.shape[MODEL_AXIS]
    if n % m:
        raise ValueError(f"{n} does not split into {m} model shards")
    per = n // m
    return mesh.model_index * per, (mesh.model_index + 1) * per


def pad_to_shards(n: int, n_shards: int, multiple: int = 8) -> int:
    """Round n up so it divides evenly into n_shards shards, each a multiple
    of ``multiple`` rows."""
    per = -(-n // n_shards)
    per = ((per + multiple - 1) // multiple) * multiple
    return per * n_shards


class DocSharding:
    """Rows split evenly over the data axis: shard s holds rows
    [s * per, (s + 1) * per) of an array of ``n_shards * per`` rows."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh

    def bounds(self, n_rows: int) -> Tuple[int, int]:
        """(first row, end) of this rank's shard of ``n_rows`` rows."""
        s = shard_count(self.mesh)
        if n_rows % s:
            raise ValueError(f"{n_rows} rows do not split into {s} shards")
        per = n_rows // s
        return self.mesh.data_index * per, (self.mesh.data_index + 1) * per

    def local(self, host) -> torch.Tensor:
        """This rank's rows of a host array (numpy or tensor), on the
        mesh's device."""
        lo, hi = self.bounds(len(host))
        part = host[lo:hi]
        t = part if torch.is_tensor(part) else torch.from_numpy(np.ascontiguousarray(part))
        return t.to(self.mesh.device)


class Replicated:
    """Every rank holds the whole array."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh

    def local(self, host) -> torch.Tensor:
        t = host if torch.is_tensor(host) else torch.from_numpy(np.ascontiguousarray(host))
        return t.to(self.mesh.device)


def doc_sharding(mesh: Mesh) -> DocSharding:
    """[N, D] document rows sharded along the data axis."""
    return DocSharding(mesh)


def replicated_sharding(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def broadcast_host(mesh: Optional[Mesh], array: np.ndarray) -> np.ndarray:
    """Rank 0's copy of a host array on every rank of the data row (its
    shape and dtype must already agree): for host values that decide shapes
    or layouts and whose agreement across ranks is not proven."""
    if mesh is None or shard_count(mesh) == 1:
        return array
    t = torch.from_numpy(np.ascontiguousarray(array))
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = t.to(dev)
    src = dist.get_global_rank(mesh.data_group, 0) if mesh.shape[MODEL_AXIS] > 1 else 0
    dist.broadcast(t, src=src, group=mesh.data_group)
    return t.cpu().numpy()


def check_agreement(mesh: Optional[Mesh], value: int, what: str) -> None:
    """Raise unless every rank of the data row holds the same integer
    ``value`` (a digest of a host value every rank computes for itself and
    that decides shapes or branches): one MIN and one MAX all-reduce. A
    disagreement then fails every rank at once instead of hanging a later
    collective."""
    if mesh is None:
        return
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    lo = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.data_group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.data_group)
    if int(lo.item()) != int(hi.item()):
        raise RuntimeError(f"the mesh's ranks disagree on {what}")
