"""The trainers on the card: each one-device step against the port on the
CPU, the train-state round trip, and a data 2 x model 2 mesh of four gloo
ranks sharing the card against the one-device card step.

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_training.py

Parity with the JAX package is held on the CPU (tests/test_torch_training.py,
tests/test_torch_training_mesh.py); here the port on the card is held to
the port on the CPU on the same params and batch, with the bounds of those
tests: at bfloat16 the loss within 5e-3 of it and each gradient tensor's
relative Frobenius error (the denominator at least 1% of the whole
gradient's norm) within 0.15; at float32 the loss within 1e-5 and the
gradients within 1e-4. The round trip is bit for bit.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

CFGS = {
    "contrastive": dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
                        mlp_dim=128, max_position=32),
    "cross": dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
                  mlp_dim=128, max_position=32),
}
BOUNDS = {"bfloat16": (5e-3, 0.15), "float32": (1e-5, 1e-4)}
GRAD_FLOOR = 1e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _batch(kind, seed, B=16, L=24):
    rng = np.random.default_rng(seed)
    V = CFGS[kind]["vocab_size"]
    mask = np.ones((B, L), np.int32)
    mask[:, L - 5:] = 0
    if kind == "contrastive":
        return (rng.integers(0, V, (B, L)).astype(np.int32), mask,
                rng.integers(0, V, (B, L)).astype(np.int32), np.ones((B, L), np.int32))
    types = np.zeros((B, L), np.int32)
    types[:, L // 2:] = 1
    return (rng.integers(0, V, (B, L)).astype(np.int32), mask, types,
            (np.arange(B) % 2).astype(np.float32))


def _trainer(kind, dtype, device, mesh=None):
    from hybridsearch_tpu_torch.models.bert import BertConfig
    from hybridsearch_tpu_torch.training import ContrastiveTrainer, CrossEncoderTrainer

    cls = ContrastiveTrainer if kind == "contrastive" else CrossEncoderTrainer
    return cls(cfg=BertConfig(**CFGS[kind], dtype=getattr(torch, dtype)), mesh=mesh,
               learning_rate=1e-3, device=device)


def _errors(got, want):
    total = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    return {n: float(np.linalg.norm(got[n].astype(np.float64) - w)
                     / max(np.linalg.norm(w.astype(np.float64)), GRAD_FLOOR * total))
            for n, w in want.items()}


def _step(tr, batch):
    loss = float(tr.loss_and_grads(batch))
    return loss, {n: g.float().cpu().numpy() for n, g in tr.grads().items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["contrastive", "cross"])
def test_gpu_step_matches_the_cpu(kind, dtype):
    _need_card()
    card, cpu = _trainer(kind, dtype, "cuda"), _trainer(kind, dtype, "cpu")
    cpu.params = card.params  # the same seeded init, to be sure
    batch = _batch(kind, 1)
    loss, grads = _step(card, batch)
    want_loss, want = _step(cpu, batch)
    tol_loss, tol_grad = BOUNDS[dtype]
    assert abs(loss - want_loss) <= tol_loss * abs(want_loss)
    errs = _errors(grads, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol_grad, (worst, errs[worst])
    for p in card.model.parameters():
        assert p.device.type == "cuda"


@pytest.mark.parametrize("kind", ["contrastive", "cross"])
def test_gpu_train_state_round_trip_takes_the_same_next_step(kind, tmp_path):
    _need_card()
    from hybridsearch_tpu_torch.training.checkpoint import (
        restore_train_state,
        save_train_state,
    )

    tr = _trainer(kind, "bfloat16", "cuda")
    for seed in (2, 3):
        tr.train_step(_batch(kind, seed))
    save_train_state(str(tmp_path), tr.params, tr.opt_state, step=2)
    params, opt_state, step = restore_train_state(str(tmp_path))
    fresh = _trainer(kind, "bfloat16", "cuda")
    fresh.params, fresh.opt_state = params, opt_state
    nxt = _batch(kind, 4)
    assert step == 2 and tr.train_step(nxt) == fresh.train_step(nxt)
    for (n, a), b in zip(tr.params.items(), fresh.params.values()):
        assert torch.equal(a, b), n


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    _need_card()
    import _torch_mesh_worker as worker
    from hybridsearch_tpu_torch.convert import bert_flat
    from hybridsearch_tpu_torch.parallel.dryrun import launch

    inputs = {}
    for kind in ("contrastive", "cross"):
        init = _trainer(kind, "float32", "cpu")
        inputs[kind] = {"kind": kind, "cfg": CFGS[kind], "lr": 1e-3,
                        "params": bert_flat(init.model), "batch": _batch(kind, 5)}
    out = launch(worker.run_checks, 4, args=("training", inputs, "cuda"), device="cuda",
                 workdir=str(tmp_path_factory.mktemp("train4")), timeout_s=300)
    return inputs, out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["contrastive", "cross"])
def test_gpu_mesh_step_matches_the_one_device_step(mesh_results, kind, dtype):
    from hybridsearch_tpu_torch.convert import bert_state

    inputs, out = mesh_results
    for o in out:
        assert "error" not in o[kind], o[kind].get("error")
        assert o[kind][dtype]["loss"] == out[0][kind][dtype]["loss"]
    got = out[0][kind][dtype]
    tr = _trainer(kind, dtype, "cuda")
    tr.params = bert_state(inputs[kind]["params"])
    loss, want = _step(tr, inputs[kind]["batch"])
    tol_loss, tol_grad = BOUNDS[dtype]
    assert abs(got["loss"] - loss) <= tol_loss * abs(loss)
    errs = _errors(got["grads"], want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol_grad, (worst, errs[worst])
