"""Plain float32 reference of the DeepSeek-V2 embedder, for the tests.

The same equations as ``hybridsearch_tpu_torch/models/deepseek_v2.py``
(DeepSeek-V2, arXiv:2405.04434, section 2.1; the public
``modeling_deepseek.py``), written once more in plain ``torch``: one text
at a time, float32 throughout, TF32 off, an explicit causal mask, the
router and each chosen expert token by token; no kernel, no cache, no
batching, no packing. It imports nothing of the port, nothing of the JAX
package and nothing of JAX.

Departures from the public code: the tokenizer. The published BPE file is
not in the repository, so a text's ids are its whole words (BERT's basic
tokenization: lowercase, accents stripped, each punctuation mark a word),
each one's 64-bit FNV-1a hash modulo ``n_word_ids``, between BOS and EOS,
cut to ``max_tokens`` ids with both. The embedding is the EOS position's
final-normed state, L2-normalized (an embedder's pooling; the public model
has an LM head instead, which is not used).

``cfg`` is a mapping of the published keys (``hidden_size``,
``kv_lora_rank``, ``rope_scaling``, ...) and the tokenizer's
(``bos_token_id``, ``eos_token_id``, ``n_word_ids``, ``max_tokens``);
``sd`` the weights under the public ``DeepseekV2ForCausalLM`` names.
"""

from __future__ import annotations

import math
import unicodedata
from typing import List, Mapping, Sequence

import torch

FNV_OFFSET, FNV_PRIME, MASK64 = 0xCBF29CE484222325, 0x100000001B3, (1 << 64) - 1


def fnv1a(word: str) -> int:
    h = FNV_OFFSET
    for b in word.encode("utf-8"):
        h = ((h ^ b) * FNV_PRIME) & MASK64
    return h


def _punctuation(ch: str) -> bool:
    cp = ord(ch)
    return (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126
            or unicodedata.category(ch).startswith("P"))


def words(text: str) -> List[str]:
    """BERT's basic tokenization: lowercase, NFD with combining marks
    dropped, whitespace splits, each punctuation mark its own word."""
    out, buf = [], []
    for ch in unicodedata.normalize("NFD", text.lower()):
        if unicodedata.category(ch) == "Mn":
            continue
        if ch.isspace() or _punctuation(ch):
            if buf:
                out.append("".join(buf))
                buf = []
            if not ch.isspace():
                out.append(ch)
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf))
    return out


def tokenize(cfg: Mapping, text: str) -> List[int]:
    ids = [fnv1a(w) % cfg["n_word_ids"] for w in words(text)][:cfg["max_tokens"] - 2]
    return [cfg["bos_token_id"]] + ids + [cfg["eos_token_id"]]


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_cos_sin(cfg: Mapping, n: int):
    """[n, rope_dim] cos and sin: YaRN (``modeling_deepseek.py``
    ``DeepseekV2YarnRotaryEmbedding``), float32."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def correction(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction(rs["beta_fast"])), 0)
    high = min(math.ceil(correction(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    freqs = torch.outer(torch.arange(n, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = yarn_mscale(factor, rs["mscale"]) / yarn_mscale(factor, rs["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def attention_scale(cfg: Mapping) -> float:
    m = yarn_mscale(float(cfg["rope_scaling"]["factor"]), cfg["rope_scaling"]["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every product of the forward: ``a @ b`` in float32 (a test may
    round its inputs here)."""
    return a @ b


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat((-x[..., d:], x[..., :d]), dim=-1)


def rope(x, cos, sin):
    """x [heads, L, d]: interleaved pairs to halves, then the rotation."""
    h, L, d = x.shape
    x = x.view(h, L, d // 2, 2).transpose(3, 2).reshape(h, L, d)
    return x * cos + rotate_half(x) * sin


def mlp(x, sd, prefix):
    g = mm(x, sd[prefix + ".gate_proj.weight"].float().T)
    u = mm(x, sd[prefix + ".up_proj.weight"].float().T)
    return mm(torch.nn.functional.silu(g) * u, sd[prefix + ".down_proj.weight"].float().T)


def layer(cfg: Mapping, sd, i: int, h: torch.Tensor) -> torch.Tensor:
    """One decoder layer on one text's states ``h`` [L, H]."""
    p = f"model.layers.{i}."
    eps, nh = cfg["rms_norm_eps"], cfg["num_attention_heads"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    W = lambda name: sd[p + name + ".weight"].float()  # noqa: E731
    L = h.shape[0]
    x = rms_norm(h, W("input_layernorm"), eps)
    q = mm(x, W("self_attn.q_proj").T).view(L, nh, dn + dr).transpose(0, 1)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = mm(x, W("self_attn.kv_a_proj_with_mqa").T)
    c, k_pe = ckv[:, :r], ckv[:, r:].reshape(1, L, dr)
    kv = mm(rms_norm(c, W("self_attn.kv_a_layernorm"), eps), W("self_attn.kv_b_proj").T)
    kv = kv.view(L, nh, dn + dv).transpose(0, 1)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = (t.to(h.device) for t in rope_cos_sin(cfg, L))
    q_pe, k_pe = rope(q_pe, cos, sin), rope(k_pe, cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(nh, L, dr)], dim=-1)
    scores = mm(qs, ks.transpose(1, 2)) * attention_scale(cfg)
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = mm(scores.softmax(dim=-1), v).transpose(0, 1).reshape(L, nh * dv)
    h = h + mm(o, W("self_attn.o_proj").T)

    x = rms_norm(h, W("post_attention_layernorm"), eps)
    moe = (cfg["n_routed_experts"] > 0 and i >= cfg["first_k_dense_replace"]
           and i % cfg["moe_layer_freq"] == 0)
    if not moe:
        return h + mlp(x, sd, p + "mlp")
    out = mlp(x, sd, p + "mlp.shared_experts")
    gate = W("mlp.gate")
    for t in range(L):
        s = mm(x[t:t + 1], gate.T)[0].softmax(dim=-1)
        w, ids = torch.topk(s, cfg["num_experts_per_tok"])
        for wj, e in zip(w.tolist(), ids.tolist()):
            y = mlp(x[t:t + 1], sd, p + f"mlp.experts.{e}")[0]
            out[t] = out[t] + wj * cfg["routed_scaling_factor"] * y
    return h + out


def embed_ids(cfg: Mapping, sd, ids: Sequence[int]) -> torch.Tensor:
    """[H] unit embedding of one text's ids."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        h = sd["model.embed_tokens.weight"].float()[torch.tensor(list(ids))]
        for i in range(cfg["num_hidden_layers"]):
            h = layer(cfg, sd, i, h)
        e = rms_norm(h[-1], sd["model.norm.weight"].float(), cfg["rms_norm_eps"])
        return e / e.norm()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def embed(cfg: Mapping, sd, texts: Sequence[str]) -> torch.Tensor:
    """[len(texts), H] float32 unit rows, one text at a time."""
    return torch.stack([embed_ids(cfg, sd, tokenize(cfg, t)) for t in texts])
