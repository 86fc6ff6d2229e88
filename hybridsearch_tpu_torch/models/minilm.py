"""MiniLM bi-encoder / cross-encoder wrappers with checkpoint loading.

Counterpart of ``hybridsearch_tpu/models/minilm.py``: the reference's two
model roles (sentence embeddings, (query, doc) relevance) on the port's
trunk (``models/bert.py``). Weights resolve in this order:

1. a checkpoint directory: a native in-repo trained one (``hst_params.npz``
   + ``hst_config.json``, the JAX package's layout, read with numpy) or an
   HF one (``pytorch_model.bin`` read with ``torch.load(weights_only=True)``,
   or ``model.safetensors`` when the ``safetensors`` package is there);
2. a seeded random init (``models/bert.py`` ``init_params``).

``find_checkpoint`` takes its search dirs in order (``$HST_MODEL_DIR``,
``~/.cache/huggingface``, ``./models``) and, in each, reads its
``PROMOTED.json`` and then walks it before moving on: an explicit
``$HST_MODEL_DIR`` beats the repo's own promotion.

Both models run on ``device`` (the card unless the caller asks for the
CPU) and return float32 tensors there.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from hybridsearch_tpu_torch.convert import bert_flat, bert_state
from hybridsearch_tpu_torch.models.bert import (
    BertConfig,
    BiEncoder,
    CrossEncoder,
    init_params,
    trunk_flops,
)
from hybridsearch_tpu_torch.models.tokenizer import BertTokenizer, _bucket
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device

_WEIGHT_FILES = ("pytorch_model.bin", "model.safetensors", "hst_params.npz")


def _search_dirs() -> Tuple[str, ...]:
    """Checkpoint search roots, resolved at call time."""
    return (
        os.environ.get("HST_MODEL_DIR", ""),
        os.path.expanduser("~/.cache/huggingface"),
        "./models",
    )


def _has_weights(d: str) -> bool:
    return any(os.path.exists(os.path.join(d, f)) for f in _WEIGHT_FILES)


def _promoted(base: str, name: str) -> Optional[str]:
    """The checkpoint ``base/PROMOTED.json`` maps ``name`` to, if any. A key
    matches when either string contains the other, so "all-MiniLM-L6-v2"
    serves both ``find_checkpoint("MiniLM")`` and the full HF name without
    capturing the ms-marco cross-encoder."""
    pj = os.path.join(base, "PROMOTED.json")
    if not os.path.exists(pj):
        return None
    try:
        with open(pj) as f:
            promoted = json.load(f)
    except (OSError, ValueError):
        return None
    for key, rel in promoted.items():
        if key.lower() in name.lower() or name.lower() in key.lower():
            d = rel if os.path.isabs(rel) else os.path.join(base, rel)
            if os.path.isdir(d) and _has_weights(d):
                return d
    return None


def find_checkpoint(name: str) -> Optional[str]:
    """Locate a checkpoint directory holding weights for ``name``.

    ``HST_CKPT_DISCOVERY=0`` disables discovery (returns None). Each search
    dir, in order, is asked first for its promotion, then walked for a
    directory whose path contains ``name``."""
    if os.environ.get("HST_CKPT_DISCOVERY", "1") == "0":
        return None
    for base in _search_dirs():
        if not base or not os.path.isdir(base):
            continue
        d = _promoted(base, name)
        if d is not None:
            return d
        for root, _dirs, files in os.walk(base):
            if name.lower() in root.lower() and any(f in files for f in _WEIGHT_FILES):
                return root
    return None


# -- native (in-repo trained) checkpoints ---------------------------------------


def save_trained_checkpoint(params: Union[nn.Module, Mapping[str, np.ndarray]],
                            cfg: BertConfig, path: str, note: str = "") -> None:
    """Write a module (or flat ``"params/..."`` arrays) and its config as a
    native checkpoint, the layout the JAX package's
    ``load_trained_checkpoint`` reads."""
    flat = bert_flat(params) if isinstance(params, nn.Module) else dict(params)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "hst_params.npz"), **flat)
    meta = {"vocab_size": cfg.vocab_size, "hidden_dim": cfg.hidden_dim,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "mlp_dim": cfg.mlp_dim, "max_position": cfg.max_position,
            "type_vocab_size": cfg.type_vocab_size, "note": note}
    with open(os.path.join(path, "hst_config.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_trained_checkpoint(ckpt_dir: str) -> Tuple[Dict[str, np.ndarray], BertConfig]:
    """(flat ``"params/..."`` float32 arrays, BertConfig) of a native
    checkpoint directory."""
    with open(os.path.join(ckpt_dir, "hst_config.json")) as f:
        meta = json.load(f)
    meta.pop("note", None)
    cfg = BertConfig(**meta)
    with np.load(os.path.join(ckpt_dir, "hst_params.npz")) as z:
        flat = {k: np.asarray(z[k], dtype=np.float32) for k in z.files}
    return flat, cfg


def _is_native_checkpoint(ckpt_dir: Optional[str]) -> bool:
    return bool(ckpt_dir) and os.path.exists(os.path.join(ckpt_dir, "hst_params.npz"))


def checkpoint_dim(ckpt_dir: str) -> Optional[int]:
    """Embedding width of a checkpoint directory, or None if unknown. Reads
    only the small config json."""
    for fname, key in (("hst_config.json", "hidden_dim"),
                       ("config.json", "hidden_size")):
        p = os.path.join(ckpt_dir, fname)
        if os.path.exists(p):
            try:
                with open(p) as f:
                    return int(json.load(f)[key])
            except (OSError, ValueError, KeyError, TypeError):
                return None
    return None


def weights_available(name: str = "MiniLM") -> bool:
    return find_checkpoint(name) is not None


# -- HF checkpoints -------------------------------------------------------------


def convert_hf_bert(state_dict, cfg: BertConfig, prefix: str = "") -> dict:
    """An HF BERT state dict as the Flax trunk's parameter tree (numpy):
    torch ``[out, in]`` Linear weights become ``[in, out]`` kernels, as the
    JAX package lays them out (``bert_state`` takes them back)."""

    def g(key):
        for cand in (prefix + key, key, "bert." + key):
            if cand in state_dict:
                v = state_dict[cand]
                v = v.detach().cpu().numpy() if torch.is_tensor(v) else v
                return np.asarray(v, dtype=np.float32)
        raise KeyError(key)

    def lin(key):
        return {"kernel": g(key + ".weight").T, "bias": g(key + ".bias")}

    def ln(key):
        return {"scale": g(key + ".weight"), "bias": g(key + ".bias")}

    params = {
        "word_embeddings": {"embedding": g("embeddings.word_embeddings.weight")},
        "position_embeddings": {
            "embedding": g("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {
            "embedding": g("embeddings.token_type_embeddings.weight")},
        "embed_ln": ln("embeddings.LayerNorm"),
    }
    for i in range(cfg.num_layers):
        b = f"encoder.layer.{i}."
        params[f"layer_{i}"] = {
            "attention": {
                "query": lin(b + "attention.self.query"),
                "key": lin(b + "attention.self.key"),
                "value": lin(b + "attention.self.value"),
                "out": lin(b + "attention.output.dense"),
            },
            "attn_ln": ln(b + "attention.output.LayerNorm"),
            "mlp_in": lin(b + "intermediate.dense"),
            "mlp_out": lin(b + "output.dense"),
            "mlp_ln": ln(b + "output.LayerNorm"),
        }
    return params


def _read_state_dict(ckpt_dir: str) -> dict:
    """An HF checkpoint's tensors as numpy: ``model.safetensors`` when the
    ``safetensors`` package is importable, else ``pytorch_model.bin``."""
    sft_path = os.path.join(ckpt_dir, "model.safetensors")
    bin_path = os.path.join(ckpt_dir, "pytorch_model.bin")
    if os.path.exists(sft_path):
        try:
            from safetensors.numpy import load_file
        except ImportError:
            if not os.path.exists(bin_path):
                raise
        else:
            return load_file(sft_path)
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no weights in {ckpt_dir}")


def load_checkpoint_params(ckpt_dir: str, cfg: BertConfig, head: str = "none") -> dict:
    """An HF checkpoint dir's weights as the Flax-layout tree ``{"bert":
    ..., ["pooler", "classifier"]}`` (``head="cross"`` adds the cross-encoder
    head)."""
    sd = _read_state_dict(ckpt_dir)
    out = {"bert": convert_hf_bert(sd, cfg)}
    if head == "cross":
        def g(key):
            return np.asarray(sd[key], dtype=np.float32)

        out["pooler"] = {"kernel": g("bert.pooler.dense.weight").T,
                         "bias": g("bert.pooler.dense.bias")}
        out["classifier"] = {"kernel": g("classifier.weight").T,
                             "bias": g("classifier.bias")}
    return out


def _flatten(tree: dict, prefix: str = "params") -> Dict[str, np.ndarray]:
    """Nested Flax-layout dict -> flat ``"params/a/b/leaf"`` arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


# -- shared set-up ----------------------------------------------------------------


def _resolve(name: str, cfg: Optional[BertConfig], checkpoint: Optional[str],
             dim: int, max_seq_len: int, head: str):
    """(cfg, tokenizer, flat params or None, weights origin, checkpoint dir)
    as the JAX wrappers resolve them: an explicit ``cfg`` pins the
    architecture and disables discovery; a native checkpoint's config
    defines the width."""
    ckpt = checkpoint or (None if cfg is not None else find_checkpoint(name))
    flat = None
    origin = "random"
    if _is_native_checkpoint(ckpt):
        flat, cfg = load_trained_checkpoint(ckpt)
        origin = "in-repo-trained"
    vocab_file = os.path.join(ckpt, "vocab.txt") if ckpt else None
    tokenizer = BertTokenizer(
        vocab_path=vocab_file if vocab_file and os.path.exists(vocab_file) else None,
        vocab_size=cfg.vocab_size if cfg else 30522)
    cfg = cfg or BertConfig(vocab_size=tokenizer.vocab_size, hidden_dim=dim,
                            max_position=max(512, max_seq_len))
    if ckpt and flat is None:
        flat = _flatten(load_checkpoint_params(ckpt, cfg, head=head))
        origin = "hf"
    return cfg, tokenizer, flat, origin, ckpt


def _build(model: nn.Module, flat, seed: int, device: torch.device) -> nn.Module:
    """Load ``flat`` into ``model`` (strictly), or seed-initialise it on the
    CPU; then move it to ``device`` for inference."""
    if flat is not None:
        model.load_state_dict(bert_state(flat), strict=True)
    else:
        init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)


# -- bi-encoder -----------------------------------------------------------------


class MiniLMEncoder:
    """Batched sentence encoder (the ``Encoder`` protocol)."""

    def __init__(
        self,
        dim: int = 384,
        name: str = "all-MiniLM-L6-v2",
        max_seq_len: int = 256,
        cfg: Optional[BertConfig] = None,
        seed: int = 0,
        checkpoint: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.name = name
        self.cfg, self.tokenizer, flat, self.weights_origin, self.checkpoint = _resolve(
            name, cfg, checkpoint, dim, max_seq_len, head="none")
        self.pretrained = self.weights_origin != "random"
        # a checkpoint's weights define the width
        self.dim = self.cfg.hidden_dim if self.weights_origin == "in-repo-trained" else dim
        self.max_seq_len = min(max_seq_len, self.cfg.max_position)
        self.model = _build(BiEncoder(self.cfg), flat, seed, self.device)

    @torch.inference_mode()
    def encode(self, texts: Sequence[str], batch_size: int = 64) -> torch.Tensor:
        """[len(texts), dim] float32 unit rows on the encoder's device. The
        texts are length-sorted (by words) and cut into chunks of
        ``batch_size``; each chunk pads to its own sequence bucket and to a
        batch bucket (padded rows hold one unmasked pad token)."""
        n = len(texts)
        if not n:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        order = sorted(range(n), key=lambda i: len(texts[i].split()))
        ids_all, mask_all = self.tokenizer.batch_encode(texts, self.max_seq_len)
        ids_all = ids_all.astype(np.int64)
        lens = mask_all.sum(axis=1)
        out = []
        for i in range(0, n, batch_size):
            sel = order[i:i + batch_size]
            L = min(self.max_seq_len, _bucket(int(lens[sel].max()), 8))
            bs = _bucket_batch(len(sel))
            ids = np.zeros((bs, L), dtype=np.int64)
            mask = np.zeros((bs, L), dtype=np.int32)
            ids[:len(sel)] = ids_all[sel, :L]
            mask[:len(sel)] = mask_all[sel, :L]
            mask[len(sel):, 0] = 1  # avoid 0/0 in mean pooling
            emb = self.model(torch.from_numpy(ids).to(self.device),
                             torch.from_numpy(mask).to(self.device))
            out.append(emb[:len(sel)])
        emb = torch.cat(out)
        perm = torch.as_tensor(order, dtype=torch.int64, device=self.device)
        return torch.empty_like(emb).index_copy_(0, perm, emb)


# -- cross-encoder ------------------------------------------------------------------


class MiniLMCrossEncoder:
    """Batched (query, doc) scorer."""

    def __init__(
        self,
        name: str = "ms-marco-MiniLM-L-6-v2",
        dim: int = 384,
        max_seq_len: int = 256,
        cfg: Optional[BertConfig] = None,
        seed: int = 1,
        checkpoint: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.name = name
        self.cfg, self.tokenizer, flat, self.weights_origin, self.checkpoint = _resolve(
            name, cfg, checkpoint, dim, max_seq_len, head="cross")
        self.pretrained = self.weights_origin != "random"
        self.max_seq_len = min(max_seq_len, self.cfg.max_position)
        self.model = _build(CrossEncoder(self.cfg), flat, seed, self.device)

    @torch.inference_mode()
    def predict(self, pairs: Sequence[Tuple[str, str]], batch_size: int = 32,
                stats: Optional[dict] = None) -> torch.Tensor:
        """[len(pairs)] float32 relevance logits on the device.

        Every pair is tokenized first (memoized per text), then grouped by
        its own sequence bucket; each group goes through the trunk in
        dispatches of at most ``HST_CE_MAX_TOKENS`` tokens (131,072 by
        default; at least 8 and at least ``batch_size`` pairs up to 1,024),
        each padded to a batch bucket. ``stats`` accumulates padded tokens,
        pairs, dispatches and model FLOPs."""
        if not len(pairs):
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        enc = [self.tokenizer.encode_pair(a, b, self.max_seq_len) for a, b in pairs]
        pad_id = self.tokenizer.vocab.pad_id
        by_bucket: dict = {}
        for j, (e, _t) in enumerate(enc):
            by_bucket.setdefault(min(self.max_seq_len, _bucket_seq(len(e))), []).append(j)
        max_tok = int(os.environ.get("HST_CE_MAX_TOKENS", "131072"))
        out = torch.zeros(len(pairs), dtype=torch.float32, device=self.device)
        for S in sorted(by_bucket):
            sel_all = by_bucket[S]
            step = max(8, min(max(batch_size, 1024), max_tok // S))
            for i in range(0, len(sel_all), step):
                sel = sel_all[i:i + step]
                bs = _bucket_batch(len(sel))
                ids = np.full((bs, S), pad_id, dtype=np.int64)
                types = np.zeros((bs, S), dtype=np.int64)
                mask = np.zeros((bs, S), dtype=np.int32)
                for r, j in enumerate(sel):
                    e, t = enc[j]
                    ids[r, :len(e)] = e
                    types[r, :len(t)] = t
                    mask[r, :len(e)] = 1
                mask[len(sel):, 0] = 1  # all-pad rows: avoid 0/0 attention
                dev = self.device
                logits = self.model(torch.from_numpy(ids).to(dev),
                                    torch.from_numpy(mask).to(dev),
                                    torch.from_numpy(types).to(dev))
                out[torch.as_tensor(sel, dtype=torch.int64, device=dev)] = logits[:len(sel)]
                if stats is not None:
                    stats["tokens_padded"] = stats.get("tokens_padded", 0) + bs * S
                    stats["pairs"] = stats.get("pairs", 0) + len(sel)
                    stats["dispatches"] = stats.get("dispatches", 0) + 1
                    stats["flops"] = stats.get("flops", 0) + trunk_flops(self.cfg, bs * S, S)
        return out


def _bucket_batch(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _bucket_seq(n: int) -> int:
    """Power-of-two sequence bucket from 8 (the tokenizer's pad_multiple=8
    buckets)."""
    b = 8
    while b < n:
        b *= 2
    return b
