"""DeepSeek-V2(-Lite) decoder as a text embedder (no counterpart in the JAX package).

The trunk follows the DeepSeek-V2 paper (arXiv:2405.04434, section 2.1)
and the public ``modeling_deepseek.py``: multi-head latent attention
(MLA) without a query compression, YaRN rotary embeddings, one leading
dense SwiGLU layer, then mixture-of-experts layers of routed and shared
experts. It is used as LLM embedders use a decoder (E5-Mistral,
arXiv:2401.00368): EOS is appended, and a text's embedding is the EOS
position's hidden state after the final norm, at full width, L2-normalized.
There is no LM head.

For ``x = RMSNorm(h)`` a layer computes

- attention: ``q = W_q x`` split per head into ``q_nope`` and ``q_pe``;
  ``[c_kv | k_pe] = W_kva x`` (one ``k_pe`` shared by the heads);
  ``[k_nope | v] = W_kvb RMSNorm_kv(c_kv)`` per head; RoPE on ``q_pe``
  and ``k_pe`` after the public code's interleaved-to-halves permutation;
  causal softmax of ``q . k`` at ``qk_head_dim ** -0.5 * yarn_mscale(
  factor, mscale_all_dim) ** 2``; ``o = W_o (P v)``;
- the MLP: SwiGLU ``down(silu(gate x) * up x)`` on the first
  ``first_k_dense_replace`` layers; after them the MoE layer
  ``sum_i s_i * expert_i(x) + shared(x)`` over the top ``k`` of the
  float32 softmax router (``ops/moe.py``), ``shared`` one SwiGLU of width
  ``n_shared_experts * moe_intermediate_size``.

Precision: weights and activations in ``DeepseekV2Config.dtype``
(bfloat16 by default; the tests run float32). Products take their inputs
in that dtype and accumulate in float32 (the card's tensor cores; the
grouped expert product likewise). RMSNorm computes in float32 and rounds
its output once; so do ``silu * mul``, RoPE (float32 cos/sin) and the
weighted sum of a token's routed outputs (float32, the shared expert's
output added before the one rounding). The router's logits, softmax and
top-k run in float32 on float32 copies of its weights. Attention is
``scaled_dot_product_attention`` on the decompressed K and V (the card's
kernels keep the softmax in float32). The residual stream is in the
activation dtype; the final norm, pooling and the L2 norm are float32.

Tokens are packed: every token-wise product runs on the real tokens of a
chunk only; attention alone sees them padded ([B, L] with L a multiple of
8, right padding, so a causal mask keeps pad keys from every real query).
Pad tokens take no expert slot and never reach an MLP. A chunk's token
ids, positions and row maps reach the device in one non-blocking copy from
pinned memory, so nothing inside a layer waits for the card.

Tokenizer: whole words as ``models/tokenizer.py`` ``basic_tokenize``
splits them (lowercase, accents stripped, punctuation its own token; ASCII
text through one equivalent regular expression), each hashed with
``stable_token_hash`` into ``n_word_ids`` ordinary ids; BOS first, EOS
last, each a reserved id; a text is cut to ``max_tokens`` with both.

Weights load from a state dict under the public ``DeepseekV2ForCausalLM``
names (``model.layers.{i}.self_attn.q_proj.weight``, ...; ``lm_head`` is
not read). The experts' weights are stacked once at load ([E, 2I, H] gate
and up, [E, H, I] down).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hybridsearch_tpu_torch.models.tokenizer import _is_punctuation, basic_tokenize
from hybridsearch_tpu_torch.ops import moe
from hybridsearch_tpu_torch.text.extractor import stable_token_hash
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device
from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS, trace_span

PAD_MULTIPLE = 8  # a chunk's padded length is a multiple of this
MAX_CHUNK_TOKENS = 65536  # padded tokens of one chunk of ``encode``


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The published keys of DeepSeek-V2-Lite's ``config.json`` (defaults)
    and the embedder's own settings (tokenizer, chunking, dtype)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Mapping] = dataclasses.field(default_factory=lambda: {
        "type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707})
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    topk_method: str = "greedy"
    scoring_func: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    # the embedder's own
    bos_token_id: int = 100000
    eos_token_id: int = 100001
    n_word_ids: int = 100000
    max_tokens: int = 512
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "topk_method": self.topk_method != "greedy",
            "scoring_func": self.scoring_func != "softmax",
            "norm_topk_prob": bool(self.norm_topk_prob),
            "n_group": self.n_group != 1 or self.topk_group != 1,
            "rope_scaling": (self.rope_scaling is not None
                             and self.rope_scaling.get("type") != "yarn"),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"DeepseekV2Config: unsupported settings {bad}")
        if max(self.bos_token_id, self.eos_token_id) >= self.vocab_size or \
                self.n_word_ids > min(self.bos_token_id, self.eos_token_id):
            raise ValueError("BOS and EOS must be ids past the ordinary ones, "
                             "inside the vocabulary")

    @classmethod
    def from_dict(cls, d: Mapping, **overrides) -> "DeepseekV2Config":
        """The config from a ``config.json``-shaped mapping; keys that name
        no field (``model_type``, ``attention_bias``, ...) are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw.update(overrides)
        return cls(**kw)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


# -- YaRN --------------------------------------------------------------------

def yarn_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def rope_tables(cfg: DeepseekV2Config, n_positions: int,
                device: DeviceLike = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """([n_positions, rope_dim] cos, sin) in float32: YaRN's inverse
    frequencies (the linear ramp between ``beta_fast`` and ``beta_slow``),
    times ``yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)``."""
    dim, base = cfg.qk_rope_head_dim, float(cfg.rope_theta)
    exponent = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq = 1.0 / base ** exponent
    scale = 1.0
    rs = cfg.rope_scaling
    if rs is not None:
        factor = float(rs["factor"])
        orig = int(rs["original_max_position_embeddings"])
        low = max(math.floor(_yarn_correction_dim(rs["beta_fast"], dim, base, orig)), 0)
        high = min(math.ceil(_yarn_correction_dim(rs["beta_slow"], dim, base, orig)), dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
        keep = 1.0 - ramp  # the public code's inv_freq_mask, in its float32 steps
        freq = 1.0 / (factor * base ** exponent) * (1 - keep) + freq * keep
        scale = (yarn_mscale(factor, rs.get("mscale", 1))
                 / yarn_mscale(factor, rs.get("mscale_all_dim", 0)))
    t = torch.arange(n_positions, dtype=torch.float32)
    emb = torch.outer(t, freq).repeat(1, 2)
    return ((emb.cos() * scale).to(device), (emb.sin() * scale).to(device))


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``qk_head_dim ** -0.5``, times ``yarn_mscale(factor, mscale_all_dim) ** 2``."""
    s = cfg.qk_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs is not None and rs.get("mscale_all_dim"):
        m = yarn_mscale(float(rs["factor"]), rs["mscale_all_dim"])
        s = s * m * m
    return s


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on ``x`` [T, heads, d] at the tokens' tables ``cos``, ``sin``
    [T, d], after the interleaved-to-halves permutation; float32, rounded
    once to ``x``'s dtype."""
    T, h, d = x.shape
    xf = x.float().reshape(T, h, d // 2, 2).transpose(-1, -2).reshape(T, h, d)
    rot = torch.cat((-xf[..., d // 2:], xf[..., :d // 2]), dim=-1)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm in float32, rounded once to ``dtype`` (``x``'s by default)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * w.float()
    return y.to(dtype or x.dtype)


def swiglu_mlp(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate x) * up x)`` with ``w13`` = [gate; up] stacked."""
    h = (x @ w13.T).float()
    width = w2.shape[1]
    return (F.silu(h[:, :width]) * h[:, width:]).to(x.dtype) @ w2.T


# -- tokenizer ----------------------------------------------------------------

_PUNCT = "".join(chr(c) for c in range(128) if _is_punctuation(chr(c)))
_ASCII_WORDS = re.compile(r"[^\s" + re.escape(_PUNCT) + r"]+|[" + re.escape(_PUNCT) + r"]")


def words(text: str) -> List[str]:
    """``basic_tokenize``'s words of ``text`` (one regular expression for
    ASCII text: lowercase, whitespace splits, each punctuation mark a word)."""
    if text.isascii():
        return _ASCII_WORDS.findall(text.lower())
    return basic_tokenize(text)


class WordHashTokenizer:
    """Texts to id arrays: BOS, each word's ``stable_token_hash`` modulo
    ``n_word_ids``, EOS; cut to ``max_tokens`` ids with both. Each distinct
    word is hashed once (a memo of the words seen)."""

    def __init__(self, cfg: DeepseekV2Config) -> None:
        self.cfg = cfg
        self._ids: Dict[str, int] = {}

    def word_id(self, word: str) -> int:
        i = self._ids.get(word)
        if i is None:
            i = self._ids[word] = stable_token_hash(word) % self.cfg.n_word_ids
        return i

    def __call__(self, texts: Sequence[str]) -> List[np.ndarray]:
        cfg, keep = self.cfg, self.cfg.max_tokens - 2
        out = []
        for t in texts:
            ids = [self.word_id(w) for w in words(t)[:keep]]
            out.append(np.array([cfg.bos_token_id] + ids + [cfg.eos_token_id], np.int64))
        return out


# -- the trunk ----------------------------------------------------------------

def _public(i: int, name: str) -> str:
    return f"model.layers.{i}.{name}.weight"


class DeepseekV2Model:
    """The trunk's weights on one device, in the config's dtype, and its
    forward over packed chunks (``forward``)."""

    def __init__(self, cfg: DeepseekV2Config, embed: torch.Tensor, layers: List[dict],
                 norm: torch.Tensor) -> None:
        self.cfg, self.embed, self.layers, self.norm = cfg, embed, layers, norm
        self.device = embed.device
        self.scale = softmax_scale(cfg)
        self._rope: Tuple[torch.Tensor, torch.Tensor] = rope_tables(cfg, 0, self.device)

    @classmethod
    def from_state_dict(cls, cfg: DeepseekV2Config, sd: Mapping[str, torch.Tensor],
                        device: DeviceLike = None) -> "DeepseekV2Model":
        """The trunk from the public ``DeepseekV2ForCausalLM`` names (the
        first ``cfg.num_hidden_layers`` layers; ``lm_head`` is not read)."""
        dev = resolve_device(device)

        def get(name):
            return sd[name].to(dev, cfg.dtype)

        layers = []
        for i in range(cfg.num_hidden_layers):
            L = {"in_norm": get(_public(i, "input_layernorm")),
                 "post_norm": get(_public(i, "post_attention_layernorm")),
                 "q": get(_public(i, "self_attn.q_proj")),
                 "kva": get(_public(i, "self_attn.kv_a_proj_with_mqa")),
                 "kv_norm": get(_public(i, "self_attn.kv_a_layernorm")),
                 "kvb": get(_public(i, "self_attn.kv_b_proj")),
                 "o": get(_public(i, "self_attn.o_proj"))}
            if cfg.is_moe(i):
                e = "mlp.experts.{}.{}"
                n = cfg.n_routed_experts
                L["gate"] = sd[_public(i, "mlp.gate")].to(dev, torch.float32)
                L["w13"] = torch.stack([torch.cat([get(_public(i, e.format(j, "gate_proj"))),
                                                   get(_public(i, e.format(j, "up_proj")))])
                                        for j in range(n)])
                L["w2"] = torch.stack([get(_public(i, e.format(j, "down_proj")))
                                       for j in range(n)])
                mlp = "mlp.shared_experts"
            else:
                mlp = "mlp"
            L["mlp13"] = torch.cat([get(_public(i, f"{mlp}.gate_proj")),
                                    get(_public(i, f"{mlp}.up_proj"))])
            L["mlp2"] = get(_public(i, f"{mlp}.down_proj"))
            layers.append(L)
        return cls(cfg, get("model.embed_tokens.weight"), layers, get("model.norm.weight"))

    def rope(self, n_positions: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._rope[0].shape[0] < n_positions:
            self._rope = rope_tables(self.cfg, max(n_positions, 64), self.device)
        return self._rope

    def attention(self, L: dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  pad_rows: torch.Tensor, B: int, Lp: int) -> torch.Tensor:
        cfg = self.cfg
        T, nh = x.shape[0], cfg.num_attention_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q = (x @ L["q"].T).view(T, nh, dn + dr)
        c_kv, k_pe = (x @ L["kva"].T).split([cfg.kv_lora_rank, dr], dim=-1)
        kv = (rms_norm(c_kv, L["kv_norm"], cfg.rms_norm_eps) @ L["kvb"].T).view(T, nh, dn + dv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], dim=-1)
        k_pe = apply_rope(k_pe.reshape(T, 1, dr), cos, sin).expand(T, nh, dr)
        k = torch.cat([k_nope, k_pe], dim=-1)

        def padded(t):
            out = t.new_zeros((B * Lp,) + t.shape[1:]).index_copy_(0, pad_rows, t)
            return out.view(B, Lp, nh, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(padded(q), padded(k), padded(v), is_causal=True,
                                           scale=self.scale)
        o = o.transpose(1, 2).reshape(B * Lp, nh * dv).index_select(0, pad_rows)
        return o @ L["o"].T

    def mlp(self, i: int, L: dict, x: torch.Tensor) -> torch.Tensor:
        shared = swiglu_mlp(x, L["mlp13"], L["mlp2"])
        if not self.cfg.is_moe(i):
            return shared
        routed = moe.moe_layer(x, L["gate"], L["w13"], L["w2"], self.cfg.num_experts_per_tok)
        return (routed * self.cfg.routed_scaling_factor + shared.float()).to(x.dtype)

    def forward(self, ids: torch.Tensor, positions: torch.Tensor, pad_rows: torch.Tensor,
                last: torch.Tensor, B: int, Lp: int) -> torch.Tensor:
        """[B, H] float32 unit rows: the final-normed state at ``last`` of
        the packed tokens ``ids`` [T] at ``positions`` [T], whose rows in
        the [B * Lp] padded layout are ``pad_rows`` [T]."""
        cfg = self.cfg
        cos, sin = self.rope(Lp)
        cos, sin = cos.index_select(0, positions), sin.index_select(0, positions)
        h = self.embed.index_select(0, ids)
        for i, L in enumerate(self.layers):
            h = h + self.attention(L, rms_norm(h, L["in_norm"], cfg.rms_norm_eps), cos, sin,
                                   pad_rows, B, Lp)
            h = h + self.mlp(i, L, rms_norm(h, L["post_norm"], cfg.rms_norm_eps))
        pooled = rms_norm(h.index_select(0, last), self.norm, cfg.rms_norm_eps, torch.float32)
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def forward_chunk(model: DeepseekV2Model, lengths: np.ndarray,
                  index: torch.Tensor) -> torch.Tensor:
    """[len(lengths), H] embeddings of one chunk of texts whose token
    counts are ``lengths`` (host), from ``index`` (device int64: the
    packed token ids, their positions, their rows in the padded layout,
    each text's last token; ``chunk_index`` lays it out)."""
    T, B = int(lengths.sum()), len(lengths)
    Lp = _padded_length(lengths)
    ids, pos, rows, last = index[:T], index[T:2 * T], index[2 * T:3 * T], index[3 * T:3 * T + B]
    return model.forward(ids, pos, rows, last, B, Lp)


def _padded_length(lengths: np.ndarray) -> int:
    return -(-int(lengths.max()) // PAD_MULTIPLE) * PAD_MULTIPLE


def chunk_index(tokens: Sequence[np.ndarray], extra: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(lengths, [ids | positions | padded rows | last tokens | extra])
    of one chunk's id arrays, as ``forward_chunk`` reads them."""
    lengths = np.fromiter((len(t) for t in tokens), np.int64, len(tokens))
    ends = np.cumsum(lengths)
    starts = ends - lengths
    text = np.repeat(np.arange(len(tokens), dtype=np.int64), lengths)
    pos = np.arange(int(ends[-1]), dtype=np.int64) - starts[text]
    rows = text * _padded_length(lengths) + pos
    return lengths, np.concatenate([np.concatenate(tokens), pos, rows, ends - 1, extra])


def chunks(lengths: np.ndarray, batch_size: int, max_tokens: int) -> List[np.ndarray]:
    """Text indices in chunks: by length (stable), at most ``batch_size``
    texts and ``max_tokens`` padded tokens a chunk (a text longer than
    that alone)."""
    order = np.argsort(lengths, kind="stable")
    out: List[np.ndarray] = []
    lo = 0
    while lo < len(order):
        hi = lo + 1
        while hi < len(order) and hi - lo < batch_size:
            pad = -(-int(lengths[order[hi]]) // PAD_MULTIPLE) * PAD_MULTIPLE
            if pad * (hi - lo + 1) > max_tokens:
                break
            hi += 1
        out.append(order[lo:hi])
        lo = hi
    return out


class DeepseekV2Encoder:
    """The ``Encoder`` protocol over a DeepSeek-V2 trunk: ``encode(texts)``
    gives [n, hidden_size] float32 unit rows (EOS pooling, see the module
    docstring). Weights: ``state_dict`` (public names) or, without one,
    drawn from ``seed`` (normal(0, 0.02) matrices and embedding, unit
    norms: the family's ``initializer_range``)."""

    name = "deepseek-v2-encoder"

    def __init__(self, config: Optional[DeepseekV2Config] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 device: DeviceLike = None) -> None:
        self.cfg = config or DeepseekV2Config()
        self.device = resolve_device(device)
        self.dim = self.cfg.hidden_size
        if state_dict is None:
            state_dict = random_state_dict(self.cfg, seed, self.device)
        self.model = DeepseekV2Model.from_state_dict(self.cfg, state_dict, self.device)
        self.tokenizer = WordHashTokenizer(self.cfg)
        self.n_moe_layers = sum(self.cfg.is_moe(i) for i in range(self.cfg.num_hidden_layers))

    def encode(self, texts: Sequence[str], batch_size: int = 2048) -> torch.Tensor:
        """[len(texts), dim] float32 unit rows, in the texts' order: the
        texts sorted by length, in chunks of at most ``batch_size`` texts
        and ``MAX_CHUNK_TOKENS`` padded tokens."""
        out = torch.empty((len(texts), self.dim), dtype=torch.float32, device=self.device)
        if not len(texts):
            return out
        with trace_span("encoder.tokenize"):
            tokens = self.tokenizer(texts)
            lengths = np.fromiter((len(t) for t in tokens), np.int64, len(tokens))
            plan = []
            padded = 0
            for sel in chunks(lengths, batch_size, MAX_CHUNK_TOKENS):
                lens, index = chunk_index([tokens[j] for j in sel], sel)
                padded += len(sel) * _padded_length(lens)
                index = torch.from_numpy(index)
                if self.device.type == "cuda":
                    index = index.pin_memory()
                plan.append((lens, index.to(self.device, non_blocking=True)))
            n_tok = int(lengths.sum())
            for name, by in (("encoder_texts", len(texts)), ("encoder_tokens", n_tok),
                             ("encoder_tokens_padded", padded),
                             ("moe_tokens_routed", n_tok * self.n_moe_layers)):
                GLOBAL_COUNTERS.inc(name, by)
        with trace_span("encoder.forward"):
            for lens, index in plan:
                emb = forward_chunk(self.model, lens, index)
                out.index_copy_(0, index[-len(lens):], emb)
        return out


def random_state_dict(cfg: DeepseekV2Config, seed: int,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Seeded weights under the public names: normal(0, 0.02) for every
    matrix and the embedding, ones for every norm, in ``cfg.dtype``, drawn
    on ``device`` one tensor at a time in name order."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    sd: Dict[str, torch.Tensor] = {}
    for name, shape in state_shapes(cfg).items():
        if name.endswith("norm.weight") or name.endswith("layernorm.weight"):
            sd[name] = torch.ones(shape, dtype=cfg.dtype, device=dev)
        else:
            sd[name] = (torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
                        * 0.02).to(cfg.dtype)
    return sd


def state_shapes(cfg: DeepseekV2Config) -> Dict[str, Tuple[int, ...]]:
    """Every weight's public name and shape (``lm_head`` left out)."""
    H, nh = cfg.hidden_size, cfg.num_attention_heads
    shapes: Dict[str, Tuple[int, ...]] = {"model.embed_tokens.weight": (cfg.vocab_size, H)}
    for i in range(cfg.num_hidden_layers):
        shapes[_public(i, "input_layernorm")] = (H,)
        shapes[_public(i, "self_attn.q_proj")] = (nh * cfg.qk_head_dim, H)
        shapes[_public(i, "self_attn.kv_a_proj_with_mqa")] = (
            cfg.kv_lora_rank + cfg.qk_rope_head_dim, H)
        shapes[_public(i, "self_attn.kv_a_layernorm")] = (cfg.kv_lora_rank,)
        shapes[_public(i, "self_attn.kv_b_proj")] = (
            nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank)
        shapes[_public(i, "self_attn.o_proj")] = (H, nh * cfg.v_head_dim)
        shapes[_public(i, "post_attention_layernorm")] = (H,)
        if cfg.is_moe(i):
            I = cfg.moe_intermediate_size
            shapes[_public(i, "mlp.gate")] = (cfg.n_routed_experts, H)
            for j in range(cfg.n_routed_experts):
                for p, s in (("gate_proj", (I, H)), ("up_proj", (I, H)), ("down_proj", (H, I))):
                    shapes[_public(i, f"mlp.experts.{j}.{p}")] = s
            mlp, I = "mlp.shared_experts", I * cfg.n_shared_experts
        else:
            mlp, I = "mlp", cfg.intermediate_size
        for p, s in (("gate_proj", (I, H)), ("up_proj", (I, H)), ("down_proj", (H, I))):
            shapes[_public(i, f"{mlp}.{p}")] = s
    shapes["model.norm.weight"] = (H,)
    return shapes
