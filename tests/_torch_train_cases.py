"""Shared inputs and JAX-side references of the trainer tests
(tests/test_torch_training.py, tests/test_torch_training_mesh.py).

The tiny trunks are those of tests/test_concurrency_training.py. Batches
are made with numpy from a seed; the JAX trainers' own init is carried into
the port (``convert.bert_state`` of the unboxed, flattened Flax tree).

``grad_errors``: a gradient tensor's error is ||got - want|| / max(||want||,
GRAD_FLOOR * ||all of want||) (Frobenius). The floor keeps a gradient that
is zero in exact arithmetic, or nearly so, from dividing noise by noise:
the attention key's bias (softmax ignores a constant added to every key's
score) comes out at about 1e-11 of the whole gradient in float32, and the
classifier's bias (the mean of sigmoid(logit) - label over a balanced
batch) at about 1e-3 of it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import traverse_util
from flax.core import meta

from hybridsearch_tpu.models.bert import BertConfig as JConfig
from hybridsearch_tpu.training.contrastive import ContrastiveTrainer as JContrastive
from hybridsearch_tpu.training.contrastive import info_nce_loss as j_info_nce
from hybridsearch_tpu.training.cross import CrossEncoderTrainer as JCross
from hybridsearch_tpu.training.cross import pointwise_bce_loss as j_bce
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.models.bert import BertConfig
from hybridsearch_tpu_torch.training import ContrastiveTrainer, CrossEncoderTrainer

KINDS = ("contrastive", "cross")
CFGS = {
    "contrastive": dict(vocab_size=128, hidden_dim=32, num_layers=1, num_heads=2,
                        mlp_dim=64, max_position=32),
    "cross": dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
                  mlp_dim=64, max_position=16),
}
LR = 1e-3
TEMPERATURE = 0.05
GRAD_FLOOR = 1e-2
# the bounds of tests/test_torch_training.py's docstring
BF16_LOSS, F32_LOSS = 5e-3, 1e-5
BF16_GRAD, F32_GRAD = 0.15, 1e-4
UPDATE_RTOL, UPDATE_ATOL = 1e-6, 1e-7
STEP_ATOL = 1e-2 * LR


def make_batch(kind: str, seed: int, B: int = 8, L: int = 8):
    """A contrastive batch (q_ids, q_mask, d_ids, d_mask), the queries
    padded past 5 tokens; or a cross batch (ids, mask, types, labels): the
    halves typed 0 and 1, the last two tokens padding, labels alternating."""
    rng = np.random.default_rng(seed)
    V = CFGS[kind]["vocab_size"]
    if kind == "contrastive":
        q_mask = np.ones((B, L), np.int32)
        q_mask[:, 5:] = 0
        return (rng.integers(0, V, (B, L)).astype(np.int32), q_mask,
                rng.integers(0, V, (B, L)).astype(np.int32), np.ones((B, L), np.int32))
    types = np.concatenate([np.zeros((B, L // 2), np.int32),
                            np.ones((B, L - L // 2), np.int32)], axis=1)
    mask = np.ones((B, L), np.int32)
    mask[:, L - 2:] = 0
    labels = (np.arange(B) % 2).astype(np.float32)
    return rng.integers(0, V, (B, L)).astype(np.int32), mask, types, labels


def flat(tree) -> dict:
    """A Flax tree (boxed or not) as flat numpy arrays keyed
    "params/<path>"."""
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(meta.unbox(tree), sep="/").items()}


def tree(flat_values: dict):
    """Flat "params/..." arrays as a Flax tree."""
    return traverse_util.unflatten_dict({tuple(k.split("/")): v
                                         for k, v in flat_values.items()})


def torch_name(key: str) -> str:
    """The port's state-dict name of a flat Flax key."""
    return next(iter(convert.bert_state({key: np.zeros((1, 1))})))


def port_trainer(kind: str, dtype: str = "bfloat16", params=None, seed: int = 0):
    """The port's trainer of ``kind`` on the CPU, from ``params`` (flat
    Flax arrays) when given."""
    import torch

    cls = ContrastiveTrainer if kind == "contrastive" else CrossEncoderTrainer
    kw = {"temperature": TEMPERATURE} if kind == "contrastive" else {}
    tr = cls(cfg=BertConfig(**CFGS[kind], dtype=getattr(torch, dtype)),
             learning_rate=LR, seed=seed, device="cpu", **kw)
    if params is not None:
        tr.params = convert.bert_state(params)
    return tr


def jax_trainer(kind: str, dtype: str = "bfloat16", mesh=None):
    cfg = JConfig(**CFGS[kind], dtype=getattr(jnp, dtype))
    if kind == "contrastive":
        return JContrastive(cfg=cfg, mesh=mesh, learning_rate=LR, temperature=TEMPERATURE)
    return JCross(cfg=cfg, mesh=mesh, learning_rate=LR)


def jax_loss_fn(jt, kind: str, batch):
    arrs = tuple(jnp.asarray(b) for b in batch)
    if kind == "contrastive":
        def loss_fn(params):
            q = jt.model.apply(params, arrs[0], arrs[1])
            d = jt.model.apply(params, arrs[2], arrs[3])
            return j_info_nce(q, d, TEMPERATURE)
    else:
        def loss_fn(params):
            return j_bce(jt.model.apply(params, arrs[0], arrs[1], arrs[2]), arrs[3])
    return loss_fn


def jax_loss_and_grads(jt, kind: str, batch, params=None):
    """(loss, flat gradients) of JAX ``value_and_grad`` at ``params`` (the
    trainer's, unboxed, by default)."""
    params = meta.unbox(jt.params) if params is None else params
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn(jt, kind, batch)))(params)
    return float(loss), flat(grads)


def optax_updates(jt, params, grad_trees):
    """The params after optax applies ``grad_trees`` one step at a time from
    a fresh state (flat)."""
    state = jt.optimizer.init(params)
    for g in grad_trees:
        upd, state = jt.optimizer.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return flat(params)


def grad_errors(got: dict, want: dict) -> dict:
    """Each tensor's relative Frobenius error (see the module docstring);
    ``got`` and ``want`` keyed alike, numpy or tensors."""
    got = {k: np.asarray(v, np.float64) for k, v in got.items()}
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    total = np.sqrt(sum(float(np.sum(w * w)) for w in want.values()))
    return {k: float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), GRAD_FLOOR * total))
            for k, w in want.items()}
