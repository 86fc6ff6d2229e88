"""The port's trainers on a data 2 x model 2 mesh, on the CPU: against the
one-rank port step and against the JAX trainers on a 2 x 2 mesh of the
virtual CPU devices; and the trainer half of the port's dry run.

One spawned world of 4 gloo ranks runs every check of this module
(tests/_torch_mesh_worker.py ``CHECKS["training"]``); rank r sits at
(data r // 2, model r % 2), each data rank takes 4 of the batch's 8 rows
and each model rank one of the 2 heads and half of every projection. Both
trainers start from the JAX trainer's init (tests/_torch_train_cases.py).

Tolerances:

- mesh against the one-rank port: at float32 the loss within ``F32_LOSS``
  and the gathered gradients within ``F32_GRAD`` (relative Frobenius, as
  tests/test_torch_training.py), the parameters after the step within
  ``STEP_ATOL``; at bfloat16 the loss and gradients within the bf16 bounds
  of tests/test_torch_training.py: the row-parallel partial products are
  each rounded to bfloat16 before they are summed, where one device rounds
  the whole product once.
- mesh against JAX: the bf16 loss and gradients against ``value_and_grad``,
  the AdamW step fed JAX's gradients against optax, and the float32 step
  against ``ContrastiveTrainer`` / ``CrossEncoderTrainer`` on
  ``build_mesh(2, 2)``, with the bounds of tests/test_torch_training.py.
- every rank's loss, gradients and parameters are equal bit for bit.
"""

import pickle

import jax
import numpy as np
import pytest
from flax.core import meta

import _torch_mesh_worker as worker
import _torch_train_cases as cases
from hybridsearch_tpu.parallel.mesh import build_mesh as jbuild_mesh
from hybridsearch_tpu_torch import convert
from hybridsearch_tpu_torch.parallel.dryrun import launch
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

RANKS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, every rank's results): one 4-rank world runs every check."""
    inputs = {"dryrun": {"world": RANKS}}
    for kind in cases.KINDS:
        jt = cases.jax_trainer(kind, "float32")
        batch = cases.make_batch(kind, 11)
        _loss, grads = cases.jax_loss_and_grads(jt, kind, batch)
        inputs[kind] = {"kind": kind, "cfg": cases.CFGS[kind], "lr": cases.LR,
                        "params": cases.flat(jt.params), "batch": batch,
                        "jax_grads": grads}
    results = launch(worker.run_checks, RANKS, args=("training", inputs),
                     workdir=str(tmp_path_factory.mktemp("world")), timeout_s=240)
    return inputs, results


def _ranks(world, name):
    """Every rank's result of a check, each equal to rank 0's bit for bit
    but for its mesh coordinates and local shapes."""
    _inputs, results = world
    outs = [r[name] for r in results]
    for rank, o in enumerate(outs):
        assert "error" not in o, o.get("error")
        for key in o:
            if key not in ("coords", "local_shapes", "model", "data"):
                assert pickle.dumps(o[key]) == pickle.dumps(outs[0][key]), (rank, key)
    return outs


@pytest.fixture(scope="module", params=cases.KINDS)
def kind(request):
    return request.param


def test_ranks_sit_on_the_grid_and_hold_their_slices(world, kind):
    outs = _ranks(world, kind)
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    H, F = cases.CFGS[kind]["hidden_dim"], cases.CFGS[kind]["mlp_dim"]
    assert outs[0]["local_shapes"] == {
        "bert.layer_0.attention.query.weight": (H // 2, H),
        "bert.layer_0.mlp_out.weight": (H, F // 2)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mesh_step_matches_the_one_rank_step(world, kind, dtype):
    inputs, _results = world
    got = _ranks(world, kind)[0][dtype]
    inp = inputs[kind]
    tr = port_trainer(kind, dtype, inp["params"])
    loss = float(tr.loss_and_grads(inp["batch"]))
    want = {n: g.numpy() for n, g in tr.grads().items()}
    tr.optimizer.step()
    tol_loss, tol_grad = (BF16_LOSS, BF16_GRAD) if dtype == "bfloat16" else (F32_LOSS,
                                                                             F32_GRAD)
    assert abs(got["loss"] - loss) <= tol_loss * abs(loss)
    errs = cases.grad_errors(got["grads"], want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol_grad, (worst, errs[worst])
    if dtype == "float32":
        for n, p in tr.params.items():
            np.testing.assert_allclose(got["params"][n], p.numpy(), rtol=0, atol=STEP_ATOL,
                                       err_msg=n)


def test_mesh_loss_and_grads_match_jax(world, kind):
    inputs, _results = world
    got = _ranks(world, kind)[0]["bfloat16"]
    inp = inputs[kind]
    jt = cases.jax_trainer(kind, "bfloat16")
    want_loss, want = cases.jax_loss_and_grads(jt, kind, inp["batch"])
    assert abs(got["loss"] - want_loss) <= BF16_LOSS * abs(want_loss)
    errs = cases.grad_errors(got["grads"], convert.bert_state(want))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BF16_GRAD, (worst, errs[worst])


def test_mesh_update_rule_matches_optax(world, kind):
    inputs, _results = world
    got = _ranks(world, kind)[0]["update_rule"]
    inp = inputs[kind]
    jt = cases.jax_trainer(kind, "float32")
    p0 = meta.unbox(jt.params)
    g = cases.tree(inp["jax_grads"])
    want = convert.bert_state(cases.optax_updates(jt, p0, [g]))
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w.numpy(), rtol=UPDATE_RTOL, atol=UPDATE_ATOL,
                                   err_msg=n)


def test_mesh_float32_step_matches_the_jax_mesh_trainer(world, kind):
    inputs, _results = world
    got = _ranks(world, kind)[0]["float32"]
    jmesh = jbuild_mesh(n_data=2, n_model=2, devices=jax.devices()[:RANKS])
    jt = cases.jax_trainer(kind, "float32", mesh=jmesh)
    np.testing.assert_array_equal(cases.flat(jt.params)["params/bert/word_embeddings/embedding"],
                                  inputs[kind]["params"]["params/bert/word_embeddings/embedding"])
    want_loss = jt.train_step(inputs[kind]["batch"])
    assert abs(got["loss"] - want_loss) <= F32_LOSS * abs(want_loss)
    want = convert.bert_state(cases.flat(jt.params))
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n], w.numpy(), rtol=0, atol=STEP_ATOL,
                                   err_msg=n)


def test_dryrun_training_half(world):
    """The dry run's contrastive step on 4 ranks: a data 2 x model 2 mesh
    and a finite loss, equal on every rank."""
    outs = _ranks(world, "dryrun")
    assert (outs[0]["data"], outs[0]["model"]) == (2, 2)
    assert np.isfinite(outs[0]["loss"])
