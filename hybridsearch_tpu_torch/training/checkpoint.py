"""Train-state and encoder checkpoints.

Counterpart of ``hybridsearch_tpu/training/checkpoint.py``, whose files are
orbax trees. The port keeps its own:

  - the train state (``directory/train_state.pt``): the parameters, the
    AdamW moments and step count, and the step, by parameter name, written
    with ``torch.save`` (tensors only) and read back with
    ``weights_only=True``. The trainers' ``params`` and ``opt_state``
    gather the model-axis shards, so the file holds whole tensors and
    restores onto any mesh;
  - the serving checkpoint (``directory/encoder_params/``): the
    ``hst_params.npz`` + ``hst_config.json`` layout of
    ``models/minilm.py`` ``save_trained_checkpoint``, which both packages'
    ``MiniLMEncoder`` read.

On a mesh (``mesh=``) rank 0 writes and every rank waits for it.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from hybridsearch_tpu_torch.models.bert import BertConfig, BiEncoder
from hybridsearch_tpu_torch.utils.device import DeviceLike

TRAIN_STATE_FILE = "train_state.pt"
ENCODER_DIR = "encoder_params"


def _host(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32).clone()
            for k, v in tensors.items()}


def _write_on_rank0(mesh, write) -> None:
    if mesh is None or dist.get_rank() == 0:
        write()
    if mesh is not None:
        dist.barrier()


def save_train_state(directory: str, params: Mapping[str, torch.Tensor],
                     opt_state: dict, step: int = 0, mesh=None) -> None:
    """Persist params + optimizer state (a trainer's ``params`` and
    ``opt_state``) + step."""
    path = os.path.abspath(directory)

    def write():
        os.makedirs(path, exist_ok=True)
        torch.save({"params": _host(params),
                    "opt_state": {"count": torch.tensor(int(opt_state["count"])),
                                  "mu": _host(opt_state["mu"]),
                                  "nu": _host(opt_state["nu"])},
                    "step": torch.tensor(int(step))},
                   os.path.join(path, TRAIN_STATE_FILE))

    _write_on_rank0(mesh, write)


def restore_train_state(directory: str) -> Tuple[Dict[str, torch.Tensor], dict, int]:
    """(params, opt_state, step) as ``save_train_state`` wrote them; assign
    the first two to a trainer's ``params`` and ``opt_state``."""
    state = torch.load(os.path.join(os.path.abspath(directory), TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True)
    opt = state["opt_state"]
    return (state["params"], {"count": int(opt["count"]), "mu": opt["mu"],
                              "nu": opt["nu"]}, int(state["step"]))


def save_encoder_params(directory: str, params: Mapping[str, torch.Tensor],
                        cfg: Optional[BertConfig] = None, mesh=None) -> None:
    """Persist just the bi-encoder params (a ``ContrastiveTrainer``'s
    ``params``) as the serving checkpoint of architecture ``cfg``
    (``BertConfig()`` when None, as the JAX ``load_encoder`` assumes)."""
    from hybridsearch_tpu_torch.models.minilm import save_trained_checkpoint

    cfg = cfg or BertConfig()

    def write():
        model = BiEncoder(cfg)
        model.load_state_dict(_host(params), strict=True)
        save_trained_checkpoint(model, cfg, os.path.join(os.path.abspath(directory),
                                                         ENCODER_DIR),
                                note="training/checkpoint.py save_encoder_params")

    _write_on_rank0(mesh, write)


def load_encoder(directory: str, cfg: Optional[BertConfig] = None,
                 name: str = "finetuned-minilm", device: DeviceLike = None):
    """A ``MiniLMEncoder`` serving the saved params. The checkpoint's own
    config defines the architecture; a ``cfg`` given must agree with it."""
    from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder

    enc = MiniLMEncoder(name=name, device=device,
                        checkpoint=os.path.join(os.path.abspath(directory), ENCODER_DIR))
    if cfg is not None and (cfg.vocab_size, cfg.hidden_dim, cfg.num_layers,
                            cfg.num_heads, cfg.mlp_dim, cfg.max_position) != (
            enc.cfg.vocab_size, enc.cfg.hidden_dim, enc.cfg.num_layers,
            enc.cfg.num_heads, enc.cfg.mlp_dim, enc.cfg.max_position):
        raise ValueError(f"the checkpoint's architecture {enc.cfg} is not {cfg}")
    return enc
