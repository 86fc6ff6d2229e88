"""Contrastive fine-tuning of the bi-encoder (in-batch negatives).

Counterpart of ``hybridsearch_tpu/training/contrastive.py``:

  - loss: symmetric InfoNCE over in-batch negatives (the
    sentence-transformers MultipleNegativesRankingLoss recipe);
  - optimizer: ``torch.optim.AdamW`` set as ``optax.adamw(learning_rate)``:
    betas (0.9, 0.999), eps 1e-8 outside the square root, weight decay 1e-4
    on every parameter (one group, no mask: optax decays biases, LayerNorm
    scales and embeddings too);
  - parallelism: on a mesh the batch splits over the data axis (every rank
    is handed the same global batch and keeps its data rows; ``B % n_data
    == 0``) and the trunk's projections over the model axis
    (``models/bert.py`` ``shard_model``, the ``param_shardings`` specs).

The JAX step is one jitted program that XLA partitions. Here every rank
runs the same code (``_MeshStep``): its rows through its slice of the
trunk, the embeddings (or logits) all-gathered over the data axis
(``gather_data``: the backward pass is the sum of every rank's gradient,
then this rank's rows, as a reduce-scatter), the whole batch's loss on
every rank, then the gradients synchronized: the column-parallel layers'
bias gradients (each rank's slice) summed over the model axis, and every
gradient summed over the data axis and divided by ``n_data`` once (each
data rank computed the same global loss, so the gather's backward already
counts each rank's rows ``n_data`` times). Every rank then takes the same
AdamW step on its own shards.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hybridsearch_tpu_torch.models.bert import (
    BertConfig,
    BiEncoder,
    Dense,
    init_params,
    shard_model,
)
from hybridsearch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    model_bounds,
)
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device
from hybridsearch_tpu_torch.utils.tracing import trace_span

# optax.adamw's defaults beside learning_rate (torch's weight decay is 1e-2)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives: the logits ``q @ d.T``
    in float32 over the temperature, cross-entropy both ways, averaged and
    halved. Embeddings are already L2-normalized by the BiEncoder head."""
    logits = torch.matmul(q_emb.float(), d_emb.float().t()) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_qd = F.cross_entropy(logits, labels, reduction="none")
    loss_dq = F.cross_entropy(logits.t(), labels, reduction="none")
    return (loss_qd + loss_dq).mean() * 0.5


def make_optimizer(model: nn.Module, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` as ``torch.optim.AdamW``."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
                             eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)


def make_train_step(model: BiEncoder, optimizer: torch.optim.Optimizer,
                    temperature: float = 0.05) -> Callable:
    """Returns ``train_step(batch) -> loss`` (a float32 scalar tensor) on
    one device: the gradient of InfoNCE, then one optimizer step. batch =
    (q_ids, q_mask, d_ids, d_mask) tensors on the model's device."""

    def train_step(batch):
        q_ids, q_mask, d_ids, d_mask = batch
        optimizer.zero_grad(set_to_none=True)
        loss = info_nce_loss(model(q_ids, q_mask), model(d_ids, d_mask), temperature)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def param_shardings(mesh: Optional[Mesh], model: nn.Module) -> Dict[str, tuple]:
    """The partition spec of every parameter, keyed by its state-dict name,
    as ``nn.get_partition_spec`` of the JAX parameter tree (transposed with
    the ``[in, out]`` -> ``[out, in]`` kernels): ``(MODEL_AXIS, None)`` for
    a column-parallel weight, ``(None, MODEL_AXIS)`` for a row-parallel
    one, ``()`` (replicated) for everything else. The specs do not depend
    on ``mesh``; ``model_bounds(mesh, ...)`` names a rank's slice."""
    specs = {}
    for mod_name, sub in model.named_modules():
        for leaf, _p in sub.named_parameters(recurse=False):
            spec = ()
            if isinstance(sub, Dense) and leaf == "weight" and sub.shard is not None:
                spec = (MODEL_AXIS, None) if sub.shard == "out" else (None, MODEL_AXIS)
            specs[f"{mod_name}.{leaf}" if mod_name else leaf] = spec
    return specs


def _sharded_dim(spec: tuple) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


class _GatherData(torch.autograd.Function):
    """Every data rank's rows concatenated in rank order; the backward pass
    sums every rank's gradient and keeps this rank's rows (a
    reduce-scatter, written as an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.shape[DATA_AXIS])]
        with trace_span("mesh_all_gather"):
            dist.all_gather(parts, x, group=mesh.data_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        g = grad.contiguous().clone()
        with trace_span("mesh_all_reduce"):
            dist.all_reduce(g, group=mesh.data_group)
        per = g.shape[0] // mesh.shape[DATA_AXIS]
        return g[mesh.data_index * per:(mesh.data_index + 1) * per], None


def gather_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` [rows, ...] of this data rank as the whole batch's rows."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return x
    return _GatherData.apply(x, mesh)


class _MeshStep:
    """What both trainers share: the module (cut over the model axis on a
    mesh), the AdamW, the batch's rows of this data rank, the gradient
    synchronization, and the gathered views of the parameters, gradients
    and moments. ``loss_of(rows)`` is the trainer's loss on this rank's
    rows of the batch (tensors on the device)."""

    def __init__(self, model: nn.Module, mesh: Optional[Mesh], learning_rate: float,
                 seed: int, device: DeviceLike) -> None:
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        init_params(model, torch.Generator().manual_seed(seed))
        self.specs = param_shardings(mesh, model)
        if self._n_model > 1:
            shard_model(model, mesh.model_group, self._n_model, mesh.model_index)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model, learning_rate)
        # the column-parallel layers' (replicated) biases: each rank's
        # gradient holds its slice only
        self._col_bias = [sub.bias for sub in self.model.modules()
                          if isinstance(sub, Dense) and sub.model_axis is not None
                          and sub.shard == "out"]

    @property
    def _n_model(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[MODEL_AXIS]

    @property
    def _n_data(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]

    def _rows(self, batch: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
        """This data rank's rows of every array of the batch, on the
        device."""
        n = len(batch[0])
        if n % self._n_data:
            raise ValueError(f"a batch of {n} does not split over {self._n_data} "
                             "data ranks")
        per = n // self._n_data
        lo = 0 if self.mesh is None else self.mesh.data_index * per
        out = []
        for a in batch:
            a = np.asarray(a)[lo:lo + per]
            dt = np.float32 if a.dtype.kind == "f" else np.int64
            out.append(torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(self.device))
        return tuple(out)

    def loss_of(self, rows: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        raise NotImplementedError

    def _sync_grads(self) -> None:
        """Column-parallel bias gradients summed over the model axis; then
        every gradient summed over the data axis and divided by n_data, in
        one flat float32 buffer a collective."""
        if self._n_model > 1 and self._col_bias:
            _all_reduce_flat([p.grad for p in self._col_bias], self.mesh.model_group)
        if self._n_data > 1:
            grads = [p.grad for p in self.model.parameters()]
            _all_reduce_flat(grads, self.mesh.data_group)
            for g in grads:
                g.div_(self._n_data)

    def loss_and_grads(self, batch: Sequence[np.ndarray]) -> torch.Tensor:
        """The whole batch's loss (a float32 scalar, the same on every
        rank); the parameters' ``.grad`` hold its synchronized gradient."""
        self.model.train()
        self.optimizer.zero_grad()
        loss = self.loss_of(self._rows(batch))
        loss.backward()
        self._sync_grads()
        return loss.detach()

    def train_step(self, batch: Sequence[np.ndarray]) -> float:
        loss = self.loss_and_grads(batch)
        self.optimizer.step()
        return float(loss)

    # -- the gathered views (collective on a mesh: every rank calls them) ----

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = _sharded_dim(self.specs[name])
        if dim is None or self._n_model == 1:
            return t.detach()
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self._n_model)]
        with trace_span("mesh_all_gather"):
            dist.all_gather(parts, t, group=self.mesh.model_group)
        return torch.cat(parts, dim=dim)

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim = _sharded_dim(self.specs[name])
        if dim is not None and self._n_model > 1:
            lo, hi = model_bounds(self.mesh, full.shape[dim])
            full = full.narrow(dim, lo, hi - lo)
        return full.to(self.device, torch.float32).clone()

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole (the model-axis shards gathered), by
        state-dict name, on the device."""
        return {n: self._full(n, p) for n, p in self.model.named_parameters()}

    @params.setter
    def params(self, state) -> None:
        """Load whole parameters (a state dict: ``convert.bert_state`` of a
        Flax tree or a checkpoint, or another trainer's ``params``); each
        rank keeps its slice."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(self._local(n, torch.as_tensor(state[n])))

    def grads(self) -> Dict[str, torch.Tensor]:
        """The synchronized gradients of the last ``loss_and_grads``, whole."""
        return {n: self._full(n, p.grad) for n, p in self.model.named_parameters()}

    @property
    def opt_state(self) -> dict:
        """AdamW's state as optax keeps it: ``count`` (steps taken) and the
        moments ``mu``, ``nu`` by parameter name, whole."""
        mu, nu, count = {}, {}, 0
        for n, p in self.model.named_parameters():
            st = self.optimizer.state.get(p)
            if st:
                count = int(st["step"])
                mu[n], nu[n] = st["exp_avg"], st["exp_avg_sq"]
            else:
                mu[n] = nu[n] = torch.zeros_like(p)
            mu[n], nu[n] = self._full(n, mu[n]), self._full(n, nu[n])
        return {"count": count, "mu": mu, "nu": nu}

    @opt_state.setter
    def opt_state(self, state: dict) -> None:
        count = int(state["count"])
        self.optimizer.state.clear()
        if count == 0:
            return
        for n, p in self.model.named_parameters():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": self._local(n, torch.as_tensor(state["mu"][n])),
                "exp_avg_sq": self._local(n, torch.as_tensor(state["nu"][n]))}


def _all_reduce_flat(tensors, group) -> None:
    """Sum ``tensors`` (float32) over ``group`` in place, in one call."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with trace_span("mesh_all_reduce"):
        dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


class ContrastiveTrainer(_MeshStep):
    """The bi-encoder trainer: ``train_step((q_ids, q_mask, d_ids, d_mask))``
    with numpy arrays [B, L] takes one AdamW step on InfoNCE and returns the
    loss. On a mesh every rank is handed the same batch."""

    def __init__(
        self,
        cfg: Optional[BertConfig] = None,
        mesh: Optional[Mesh] = None,
        learning_rate: float = 2e-5,
        temperature: float = 0.05,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg or BertConfig()
        self.temperature = temperature
        super().__init__(BiEncoder(self.cfg), mesh, learning_rate, seed, device)

    def loss_of(self, rows):
        q_ids, q_mask, d_ids, d_mask = rows
        q = gather_data(self.model(q_ids, q_mask), self.mesh)
        d = gather_data(self.model(d_ids, d_mask), self.mesh)
        return info_nce_loss(q, d, self.temperature)
