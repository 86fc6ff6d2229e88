"""Pointwise fine-tuning of the cross-encoder reranker.

Counterpart of ``hybridsearch_tpu/training/cross.py``: relevant and
non-relevant (query, doc) pairs scored by ``models/bert.py``
``CrossEncoder``, sigmoid binary cross-entropy on the logit (the ms-marco
cross-encoder recipe). On a mesh it runs the machinery of
``training/contrastive.py``: the batch split over the data axis, the
trunk's projections over the model axis, the logits gathered over the data
axis so every rank computes the whole batch's mean loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from hybridsearch_tpu_torch.models.bert import BertConfig, CrossEncoder
from hybridsearch_tpu_torch.parallel.mesh import Mesh
from hybridsearch_tpu_torch.training.contrastive import _MeshStep, gather_data
from hybridsearch_tpu_torch.utils.device import DeviceLike


def pointwise_bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid binary cross-entropy on relevance logits ([B] each), the
    mean over the batch."""
    return F.binary_cross_entropy_with_logits(logits.float(), labels.float())


def make_cross_train_step(model: CrossEncoder,
                          optimizer: torch.optim.Optimizer) -> Callable:
    """Returns ``train_step(batch) -> loss`` on one device; batch = (ids,
    mask, type_ids, labels) tensors on the model's device."""

    def train_step(batch):
        ids, mask, types, labels = batch
        optimizer.zero_grad(set_to_none=True)
        loss = pointwise_bce_loss(model(ids, mask, types), labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


class CrossEncoderTrainer(_MeshStep):
    """The (query, doc) relevance head's trainer: ``train_step((ids, mask,
    type_ids, labels))`` with numpy arrays ([B, L] and [B]) takes one AdamW
    step and returns the loss."""

    def __init__(
        self,
        cfg: Optional[BertConfig] = None,
        mesh: Optional[Mesh] = None,
        learning_rate: float = 2e-5,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> None:
        self.cfg = cfg or BertConfig()
        super().__init__(CrossEncoder(self.cfg), mesh, learning_rate, seed, device)

    def loss_of(self, rows):
        ids, mask, types, labels = rows
        logits = gather_data(self.model(ids, mask, types), self.mesh)
        return pointwise_bce_loss(logits, gather_data(labels, self.mesh))
