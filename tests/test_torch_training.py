"""The port's trainers (hybridsearch_tpu_torch/training/) against the JAX
package's, on the CPU, one device.

Both sides start from the JAX trainer's own init, carried across with
``convert.bert_state``; inputs come from numpy with a seed
(tests/_torch_train_cases.py). Adam's first step moves each weight by
about ``lr * g / (|g| + eps)``, so a gradient that rounds to the other
sign in bfloat16 moves a weight by up to ``2 * lr`` whatever its size;
parity is therefore held in three parts, each with its own tolerance
(set in tests/_torch_train_cases.py):

- the loss and every gradient tensor against JAX ``value_and_grad``, at
  bfloat16 (the loss within ``BF16_LOSS`` of it, measured at most 1.2e-3;
  the relative Frobenius error per tensor within ``BF16_GRAD``, measured
  at most 0.068 over four batches of each trainer, at the attention
  value's bias, a sum over every token with much cancellation) and at
  float32 (``F32_LOSS``, ``F32_GRAD``; measured about 2e-6);
- the update rule: the port's AdamW fed JAX's own gradients for two steps
  gives optax's params to float32 rounding (``UPDATE_RTOL``,
  ``UPDATE_ATOL``; measured 3e-8);
- the whole step at ``cfg.dtype = float32`` on both sides: params within
  ``STEP_ATOL`` = 1e-2 * lr. Near a gradient component of about eps, Adam's
  first step turns the component's float32 rounding noise n into a weight
  change of about lr * n / eps; the key's bias (zero in exact arithmetic)
  and the MLP weights showed n up to about 4e-11 (weights off by at most
  3.6e-3 * lr, three batches of each trainer).

The train-state round trip is held bit for bit within the port.
"""

import numpy as np
import pytest
import torch
from flax.core import meta

import _torch_train_cases as cases
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.models.bert import BertConfig
from hybridsearch_tpu_torch.training import (
    ContrastiveTrainer,
    CrossEncoderTrainer,
    info_nce_loss,
    make_cross_train_step,
    make_train_step,
    pointwise_bce_loss,
)
from hybridsearch_tpu_torch.training.checkpoint import (
    load_encoder,
    restore_train_state,
    save_encoder_params,
    save_train_state,
)
from hybridsearch_tpu_torch.training.contrastive import param_shardings

from _torch_train_cases import (
    BF16_GRAD,
    BF16_LOSS,
    F32_GRAD,
    F32_LOSS,
    STEP_ATOL,
    UPDATE_ATOL,
    UPDATE_RTOL,
    port_trainer,
)


def _np(state):
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


@pytest.fixture(scope="module", params=cases.KINDS)
def kind(request):
    return request.param


def test_losses_match_optax():
    """InfoNCE and the pointwise BCE on the same inputs as the JAX
    package's losses."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    d = rng.standard_normal((12, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = info_nce_loss(torch.from_numpy(q), torch.from_numpy(d), 0.05)
    np.testing.assert_allclose(float(got), float(cases.j_info_nce(q, d, 0.05)),
                               rtol=1e-6)
    logits = (3 * rng.standard_normal(20)).astype(np.float32)
    labels = (rng.random(20) > 0.5).astype(np.float32)
    got = pointwise_bce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(cases.j_bce(logits, labels)), rtol=1e-6)


def test_param_shardings_match_flax_partition_specs(kind):
    """The port's spec of every parameter is ``nn.get_partition_spec`` of
    the JAX tree, transposed with the kernels."""
    import flax.linen as nn
    from flax import traverse_util

    jt = cases.jax_trainer(kind)
    want = {}
    for key, spec in traverse_util.flatten_dict(nn.get_partition_spec(jt.params),
                                                sep="/").items():
        spec = tuple(spec)
        want[cases.torch_name(key)] = spec[::-1] if key.endswith("kernel") else spec
    tr = port_trainer(kind)
    got = param_shardings(None, tr.model)
    assert got == want
    assert set(got) == {n for n, _p in tr.model.named_parameters()}
    assert sum(1 for s in got.values() if s) == 6 * cases.CFGS[kind]["num_layers"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_loss_and_grads_match_jax(kind, dtype):
    jt = cases.jax_trainer(kind, dtype)
    batch = cases.make_batch(kind, 1)
    want_loss, want = cases.jax_loss_and_grads(jt, kind, batch)
    tr = port_trainer(kind, dtype, cases.flat(jt.params))
    loss = tr.loss_and_grads(batch)
    tol_loss, tol_grad = (BF16_LOSS, BF16_GRAD) if dtype == "bfloat16" else (F32_LOSS,
                                                                             F32_GRAD)
    assert abs(float(loss) - want_loss) <= tol_loss * abs(want_loss)
    errs = cases.grad_errors(_np(tr.grads()), convert.bert_state(want))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol_grad, (worst, errs[worst])


def test_update_rule_matches_optax(kind):
    """Two AdamW steps fed JAX's gradients (the second taken at JAX's
    params after the first) give optax's params."""
    jt = cases.jax_trainer(kind)
    p0 = meta.unbox(jt.params)
    b1, b2 = cases.make_batch(kind, 1), cases.make_batch(kind, 2)
    loss_fn1, loss_fn2 = cases.jax_loss_fn(jt, kind, b1), cases.jax_loss_fn(jt, kind, b2)
    import jax

    g1 = jax.grad(loss_fn1)(p0)
    p1 = cases.optax_updates(jt, p0, [g1])
    g2 = jax.grad(loss_fn2)(cases.tree(p1))
    want = convert.bert_state(cases.optax_updates(jt, p0, [g1, g2]))
    tr = port_trainer(kind, params=cases.flat(p0))
    for g in (g1, g2):
        grads = convert.bert_state(cases.flat(g))
        for n, p in tr.model.named_parameters():
            p.grad = grads[n].clone()
        tr.optimizer.step()
    got = _np(tr.params)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w.numpy(), rtol=UPDATE_RTOL, atol=UPDATE_ATOL,
                                   err_msg=n)


def test_float32_step_matches_jax(kind):
    jt = cases.jax_trainer(kind, "float32")
    batch = cases.make_batch(kind, 3)
    tr = port_trainer(kind, "float32", cases.flat(jt.params))
    want_loss = jt.train_step(batch)
    loss = tr.train_step(batch)
    assert abs(loss - want_loss) <= F32_LOSS * abs(want_loss)
    want = convert.bert_state(cases.flat(jt.params))
    got = _np(tr.params)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w.numpy(), rtol=0, atol=STEP_ATOL, err_msg=n)


def test_adamw_state_carries_a_jax_train_state(kind):
    """A JAX run of two steps equals a JAX step followed by a port step
    from the carried params and ``convert.adamw_state`` (float32)."""
    jt = cases.jax_trainer(kind, "float32")
    b1, b2 = cases.make_batch(kind, 4), cases.make_batch(kind, 5)
    jt.train_step(b1)
    adam = jt.opt_state[0]
    carried = convert.adamw_state(adam.count, cases.flat(adam.mu), cases.flat(adam.nu))
    assert carried["count"] == 1
    tr = port_trainer(kind, "float32", cases.flat(jt.params))
    tr.opt_state = carried
    jt.train_step(b2)
    tr.train_step(b2)
    assert tr.opt_state["count"] == 2
    want = convert.bert_state(cases.flat(jt.params))
    got = _np(tr.params)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w.numpy(), rtol=0, atol=STEP_ATOL, err_msg=n)


def test_train_state_round_trip_takes_the_same_next_step(kind, tmp_path):
    """save_train_state -> restore_train_state into a fresh trainer (another
    seed): its next step equals the uninterrupted trainer's, bit for bit."""
    b1, b2 = cases.make_batch(kind, 6), cases.make_batch(kind, 7)
    tr = port_trainer(kind)
    tr.train_step(b1)
    save_train_state(str(tmp_path / "ck"), tr.params, tr.opt_state, step=1)
    params, opt_state, step = restore_train_state(str(tmp_path / "ck"))
    assert step == 1 and opt_state["count"] == 1
    fresh = port_trainer(kind, seed=5)
    fresh.params, fresh.opt_state = params, opt_state
    assert tr.train_step(b2) == fresh.train_step(b2)
    for (n, a), (_m, b) in zip(tr.params.items(), fresh.params.items()):
        assert torch.equal(a, b), n
    for key in ("mu", "nu"):
        for n, a in tr.opt_state[key].items():
            assert torch.equal(a, fresh.opt_state[key][n]), (key, n)


def test_encoder_checkpoint_read_by_both_packages(tmp_path):
    """save_encoder_params -> load_encoder serves the trainer's model bit for
    bit; the JAX package's MiniLMEncoder reads the same directory and encodes
    within the bf16 bound of tests/test_torch_models.py."""
    from hybridsearch_tpu.models.minilm import MiniLMEncoder as JEncoder
    from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder

    cfg = BertConfig(**cases.CFGS["contrastive"])
    tr = port_trainer("contrastive")
    tr.train_step(cases.make_batch("contrastive", 8))
    save_encoder_params(str(tmp_path / "ck"), tr.params, cfg)
    enc = load_encoder(str(tmp_path / "ck"), cfg=cfg, device="cpu")
    assert enc.weights_origin == "in-repo-trained" and enc.dim == cfg.hidden_dim
    texts = ["machine learning models", "pasta with garlic and olive oil", "a",
             "gradient descent optimizes the training loss quickly"]
    ref = MiniLMEncoder(cfg=cfg, device="cpu")
    ref.model = tr.model.eval()
    assert torch.equal(enc.encode(texts), ref.encode(texts))
    with pytest.raises(ValueError):
        load_encoder(str(tmp_path / "ck"), cfg=BertConfig(), device="cpu")
    jenc = JEncoder(checkpoint=str(tmp_path / "ck" / "encoder_params"))
    assert jenc.weights_origin == "in-repo-trained"
    np.testing.assert_allclose(enc.encode(texts).numpy(), jenc.encode(texts), rtol=0,
                               atol=1e-2)


def test_make_train_step_equals_the_trainer_step(kind):
    """The one-device step functions take the trainer's step (the same loss
    and params, bit for bit)."""
    batch = cases.make_batch(kind, 9)
    tr, other = port_trainer(kind), port_trainer(kind)
    loss = tr.train_step(batch)
    arrs = [torch.from_numpy(np.asarray(a, np.float32 if a.dtype.kind == "f" else np.int64))
            for a in batch]
    step = (make_train_step(other.model, other.optimizer, cases.TEMPERATURE)
            if kind == "contrastive" else make_cross_train_step(other.model, other.optimizer))
    assert float(step(arrs)) == loss
    for (n, a), (_m, b) in zip(tr.params.items(), other.params.items()):
        assert torch.equal(a, b), n


def test_contrastive_training_converges():
    """Loss decreases over a few steps on a tiny fixed batch (the JAX
    test's recipe)."""
    cfg = BertConfig(**cases.CFGS["contrastive"])
    tr = ContrastiveTrainer(cfg=cfg, learning_rate=1e-3, device="cpu")
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 128, (8, 8)).astype(np.int32), np.ones((8, 8), np.int32),
             rng.integers(0, 128, (8, 8)).astype(np.int32), np.ones((8, 8), np.int32))
    losses = [tr.train_step(batch) for _ in range(8)]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(x) for x in losses)


def test_cross_encoder_training_learns_separation():
    """Pointwise BCE drives relevant pairs' logits above irrelevant ones' on
    the JAX test's tiny separable task."""
    cfg = BertConfig(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64,
                     max_position=16)
    tr = CrossEncoderTrainer(cfg=cfg, learning_rate=3e-3, device="cpu")
    rng = np.random.default_rng(1)
    B, L = 16, 8
    types = np.concatenate([np.zeros((B, L // 2), np.int32),
                            np.ones((B, L // 2), np.int32)], axis=1)
    mask = np.ones((B, L), np.int32)

    def batch():
        qtok = rng.integers(5, 32, (B, 1)).astype(np.int32)
        labels = (np.arange(B) % 2).astype(np.float32)
        dtok = np.where(labels[:, None] > 0.5, qtok,
                        rng.integers(33, 60, (B, 1))).astype(np.int32)
        ids = np.concatenate([np.repeat(qtok, L // 2, 1), np.repeat(dtok, L // 2, 1)],
                             axis=1)
        return ids, mask, types, labels

    losses = [tr.train_step(batch()) for _ in range(30)]
    assert losses[-1] < losses[0]
    ids, m, t, labels = batch()
    with torch.no_grad():
        logits = tr.model(*(torch.from_numpy(a.astype(np.int64)) for a in (ids, m, t)))
    assert float(logits[labels > 0.5].mean()) > float(logits[labels < 0.5].mean())


def test_trainers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContrastiveTrainer(cfg=BertConfig(**cases.CFGS["contrastive"]))
