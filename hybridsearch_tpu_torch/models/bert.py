"""MiniLM-class transformer encoder (BERT architecture) in PyTorch.

Counterpart of ``hybridsearch_tpu/models/bert.py``. The modules carry the
Flax module names (``bert.layer_0.attention.query``, ``attn_ln``,
``mlp_in``...), so a state dict reads like the Flax parameter tree;
``convert.bert_state`` carries a Flax tree or an ``hst_params.npz`` across
(Flax ``[in, out]`` kernels become ``nn.Linear``'s ``[out, in]`` weights).

Parameters stay float32; activations run in ``BertConfig.dtype`` (bfloat16
by default) along the JAX trunk's flow:

- each embedding table is rounded to the activation dtype and
  ``word + pos + typ`` summed in it, left to right;
- the LayerNorms compute in float32; the embedding LayerNorm's output is
  cast back to the activation dtype, so layer 0's residual adds two
  activation-dtype tensors while every later one adds an activation-dtype
  tensor to a float32 one (float32 result);
- a dense layer casts its input and kernel to the activation dtype,
  multiplies, then adds the bias in that dtype;
- attention scores QK^T are accumulated in float32 and divided by
  sqrt(head_dim), masked keys set to float32's lowest value, softmax in
  float32, probabilities cast to the activation dtype for P.V;
- GELU is exact (erf); LayerNorm eps 1e-12;
- mean pooling, the L2 norm, and the cross-encoder's pooler and
  classifier run in float32.

The products are plain ``torch.matmul`` calls (no global precision flag is
touched: the port pins full float32 matmuls at import, and the trunk leaves
that alone).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # activation dtype (params stay fp32)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """The Flax initialisers' distributions, drawn from ``generator``:
    normal(0.02) trunk kernels, ``lecun_normal`` (truncated at two standard
    deviations) for the cross-encoder's pooler and classifier,
    normal(1/sqrt(H)) embeddings (``nn.Embed``'s default), zero biases,
    unit LayerNorm scales."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, Dense):
                if sub.lecun:
                    std = 1.0 / math.sqrt(sub.in_features) / _TRUNC_STD
                    nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                else:
                    sub.weight.normal_(0.0, 0.02, generator=generator)
                sub.bias.zero_()
            elif isinstance(sub, nn.Embedding):
                sub.weight.normal_(0.0, 1.0 / math.sqrt(sub.embedding_dim),
                                   generator=generator)
            elif isinstance(sub, nn.LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()


# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``,
    the product rounded to it, then the bias added in it. ``lecun`` marks
    a layer Flax initialises with its default ``lecun_normal``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 lecun: bool = False) -> None:
        super().__init__(in_features, out_features)
        self.act_dtype = dtype
        self.lecun = lecun

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.act_dtype
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


def _layer_norm(cfg: BertConfig, dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=cfg.layer_norm_eps)


def _ln32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``nn.LayerNorm(dtype=float32)``: computed and returned in float32."""
    return ln(x.float())


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_dim
        self.query = Dense(H, H, cfg.dtype)
        self.key = Dense(H, H, cfg.dtype)
        self.value = Dense(H, H, cfg.dtype)
        self.out = Dense(H, H, cfg.dtype)

    def heads(self, x: torch.Tensor):
        """(q, k, v), each [B, heads, L, head_dim] in the activation dtype."""
        cfg = self.cfg
        B, L, _H = x.shape

        def split(t):
            return t.reshape(B, L, cfg.num_heads, cfg.head_dim).transpose(1, 2)

        return split(self.query(x)), split(self.key(x)), split(self.value(x))

    def context(self, q, k, v, mask: torch.Tensor) -> torch.Tensor:
        """[B, heads, L, head_dim] attention context, as ``bert.py``
        computes it (scores in float32, probabilities in the activation
        dtype)."""
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(self.cfg.head_dim)
        neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(mask[:, None, None, :] <= 0, neg)
        probs = torch.softmax(scores, dim=-1).to(self.cfg.dtype)
        return torch.matmul(probs, v)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, H = x.shape
        ctx = self.context(*self.heads(x), mask)
        return self.out(ctx.transpose(1, 2).reshape(B, L, H))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.attn_ln = _layer_norm(cfg, cfg.hidden_dim)
        self.mlp_in = Dense(cfg.hidden_dim, cfg.mlp_dim, cfg.dtype)
        self.mlp_out = Dense(cfg.mlp_dim, cfg.hidden_dim, cfg.dtype)
        self.mlp_ln = _layer_norm(cfg, cfg.hidden_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = _ln32(self.attn_ln, x + self.attention(x, mask))
        h = nn.functional.gelu(self.mlp_in(x), approximate="none")
        return _ln32(self.mlp_ln, x + self.mlp_out(h))


class BertEncoder(nn.Module):
    """Trunk: embeddings + N transformer layers -> [B, L, H] states."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.position_embeddings = nn.Embedding(cfg.max_position, cfg.hidden_dim)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_dim)
        self.embed_ln = _layer_norm(cfg, cfg.hidden_dim)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerLayer(cfg))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        dt = self.cfg.dtype
        L = input_ids.shape[1]
        # rounding is elementwise: gather the rows, then round them
        word = self.word_embeddings.weight[input_ids].to(dt)
        pos = self.position_embeddings.weight[:L].to(dt)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        typ = self.token_type_embeddings.weight[token_type_ids].to(dt)
        x = _ln32(self.embed_ln, word + pos + typ).to(dt)
        for layer in self.layers():
            x = layer(x, attention_mask)
        return x


class BiEncoder(nn.Module):
    """Sentence embedding model: trunk + masked mean pooling + L2 norm."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        states = self.bert(input_ids, attention_mask)
        m = attention_mask[..., None].float()
        pooled = (states.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
        norm = (pooled * pooled).sum(dim=-1, keepdim=True).sqrt()
        return pooled / norm.clamp_min(1e-12)


class CrossEncoder(nn.Module):
    """(query, doc) relevance scorer: trunk + CLS pooler + regression head."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg)
        self.pooler = Dense(cfg.hidden_dim, cfg.hidden_dim, torch.float32, lecun=True)
        self.classifier = Dense(cfg.hidden_dim, 1, torch.float32, lecun=True)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: torch.Tensor,
    ) -> torch.Tensor:
        states = self.bert(input_ids, attention_mask, token_type_ids)
        pooled = torch.tanh(self.pooler(states[:, 0, :].float()))
        return self.classifier(pooled)[:, 0]


def trunk_flops(cfg: BertConfig, tokens: int, seq_len: int) -> int:
    """Model FLOPs of the trunk over ``tokens`` padded tokens at sequence
    length ``seq_len``: per token per layer 8H^2 (QKVO) + 4HF (MLP) + 4HL
    (scores and values), the count ``MiniLMCrossEncoder.predict``'s stats
    use; embeddings and heads are left out."""
    H, F = cfg.hidden_dim, cfg.mlp_dim
    return tokens * cfg.num_layers * (8 * H * H + 4 * H * F + 4 * H * seq_len)

