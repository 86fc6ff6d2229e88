"""Encoder kind ``deepseek_v2``: a DeepSeek-V2 decoder as a last-token
pooled embedder (the port's ``models/deepseek_v2.py`` ``DeepseekV2Encoder``).

The configuration gives the published model keys at its top level (the
catalog's ``config``, letter for letter, ``num_hidden_layers`` cut) and
the ``encoder`` block ``weight_seed``, ``initializer_range`` and the
tokenizer's ``bos_token_id``, ``eos_token_id``, ``n_word_ids`` and
``max_tokens``.

- ``draw``: every weight under the public ``DeepseekV2ForCausalLM`` names,
  bf16, on the device from ``weight_seed`` through one ``torch.Generator``:
  normal(0, ``initializer_range``) for the embedding and every matrix,
  drawn a layer at a time in one call (the names are views of it), ones
  for the norms. The harness hands them to the program and the reference
  alike.
- ``program``: ``DeepseekV2Encoder`` over those weights, bf16.
- ``Embedder``: the plain reference's embedding, written again here from
  the equations (DeepSeek-V2, arXiv:2405.04434, section 2.1; the public
  ``modeling_deepseek.py``): float32 throughout on the same bf16-valued
  weights, upcast a layer at a time, TF32 off; texts in blocks (sorted by
  length), every token-wise product over the block's real tokens alone,
  attention over the block right-padded with an explicit causal mask;
  the router in float32 and each expert's rows by a loop over the
  experts. Its tokenizer is its
  own copy (BERT's basic word split, FNV-1a of each word modulo
  ``n_word_ids``, BOS and EOS). It imports nothing of the program.

``precision="tf32"`` (the harness's control slot) computes the nearest
format below the configured bfloat16 instead: every product's inputs
rounded to float8 e4m3's 3 mantissa bits, exponent kept, the products
still in float32 with TF32 off. No measured run embeds with it.
"""

from __future__ import annotations

import math
import re
import unicodedata
from contextlib import contextmanager
from typing import Dict, List, Sequence

import numpy as np
import torch

from harness import textops

BLOCK_TOKENS = 32768  # padded tokens of one block of the reference's forward


def _model(cfg: dict) -> dict:
    """The model keys (top level) with the tokenizer's (``encoder``)."""
    e = cfg["encoder"]
    return dict(cfg, **{k: e[k] for k in ("bos_token_id", "eos_token_id", "n_word_ids",
                                         "max_tokens")})


def _is_moe(m: dict, i: int) -> bool:
    return (m["n_routed_experts"] > 0 and i >= m["first_k_dense_replace"]
            and i % m["moe_layer_freq"] == 0)


def _layer_shapes(m: dict, i: int) -> List:
    H, nh = m["hidden_size"], m["num_attention_heads"]
    p = f"model.layers.{i}."
    out = [(p + "self_attn.q_proj", (nh * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]), H)),
           (p + "self_attn.kv_a_proj_with_mqa", (m["kv_lora_rank"] + m["qk_rope_head_dim"], H)),
           (p + "self_attn.kv_b_proj", (nh * (m["qk_nope_head_dim"] + m["v_head_dim"]),
                                        m["kv_lora_rank"])),
           (p + "self_attn.o_proj", (H, nh * m["v_head_dim"]))]
    if _is_moe(m, i):
        I = m["moe_intermediate_size"]
        out.append((p + "mlp.gate", (m["n_routed_experts"], H)))
        for j in range(m["n_routed_experts"]):
            out += [(p + f"mlp.experts.{j}.gate_proj", (I, H)),
                    (p + f"mlp.experts.{j}.up_proj", (I, H)),
                    (p + f"mlp.experts.{j}.down_proj", (H, I))]
        mlp, I = p + "mlp.shared_experts", I * m["n_shared_experts"]
    else:
        mlp, I = p + "mlp", m["intermediate_size"]
    return out + [(mlp + ".gate_proj", (I, H)), (mlp + ".up_proj", (I, H)),
                  (mlp + ".down_proj", (H, I))]


def draw(cfg: dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    m, e = _model(cfg), cfg["encoder"]
    g = torch.Generator(device=dev)
    g.manual_seed(int(e["weight_seed"]))
    std = float(e["initializer_range"])
    H = m["hidden_size"]

    def normal(n: int) -> torch.Tensor:
        flat = torch.empty(n, dtype=torch.bfloat16, device=dev)
        step = 1 << 28  # float32 draws of at most 1 GiB at a time
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            flat[lo:hi] = torch.randn(hi - lo, generator=g, device=dev) * std
        return flat

    sd = {"model.embed_tokens.weight": normal(m["vocab_size"] * H).view(m["vocab_size"], H)}
    for i in range(m["num_hidden_layers"]):
        shapes = _layer_shapes(m, i)
        flat = normal(sum(math.prod(s) for _n, s in shapes))
        at = 0
        for name, s in shapes:
            sd[name + ".weight"] = flat[at:at + math.prod(s)].view(s)
            at += math.prod(s)
        p = f"model.layers.{i}."
        for name, n in (("input_layernorm", H), ("post_attention_layernorm", H),
                        ("self_attn.kv_a_layernorm", m["kv_lora_rank"])):
            sd[p + name + ".weight"] = torch.ones(n, dtype=torch.bfloat16, device=dev)
    sd["model.norm.weight"] = torch.ones(H, dtype=torch.bfloat16, device=dev)
    return sd


def program(cfg: dict, weights: Dict[str, torch.Tensor], dev: torch.device):
    from hybridsearch_tpu_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Encoder

    config = DeepseekV2Config.from_dict(_model(cfg), dtype=torch.bfloat16)
    return DeepseekV2Encoder(config, state_dict=weights, device=dev)


# -- the reference's own tokenizer ---------------------------------------------

def _punctuation(ch: str) -> bool:
    cp = ord(ch)
    return (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126
            or unicodedata.category(ch).startswith("P"))


_ASCII_PUNCT = "".join(chr(c) for c in range(128) if _punctuation(chr(c)))
_ASCII_WORDS = re.compile(r"[^\s" + re.escape(_ASCII_PUNCT) + r"]+|["
                          + re.escape(_ASCII_PUNCT) + r"]")


def words(text: str) -> List[str]:
    """BERT's basic split: lowercase, combining marks dropped (NFD),
    whitespace splits, each punctuation mark a word (one regular
    expression for ASCII text, which gives the same words)."""
    if text.isascii():
        return _ASCII_WORDS.findall(text.lower())
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


# -- the reference's forward ---------------------------------------------------

def round_e4m3_mantissa(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to 3 mantissa bits (float8 e4m3's; ties to
    even), exponent kept."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 20) & 1
    return ((bits + 0x7FFFF + lsb) & ~0xFFFFF).view(torch.float32)


@contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


class Embedder:
    """``embed(texts)``: [n, hidden_size] float32 unit rows on the weights'
    device."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.m, self.sd = _model(cfg), weights
        self.low = precision == "tf32"
        self.device = weights["model.norm.weight"].device
        self._ids: Dict[str, int] = {}
        m = self.m
        dim, base = m["qk_rope_head_dim"], float(m["rope_theta"])
        rs = m["rope_scaling"]
        factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

        def correction(rot):
            return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

        low = max(math.floor(correction(rs["beta_fast"])), 0)
        high = min(math.ceil(correction(rs["beta_slow"])), dim - 1)
        if low == high:
            high += 0.001
        exponent = torch.arange(0, dim, 2, dtype=torch.float32) / dim
        ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low),
                           0, 1)
        mask = 1.0 - ramp
        self.inv_freq = (1.0 / (factor * base ** exponent) * (1 - mask)
                         + 1.0 / (base ** exponent) * mask)
        self.rope_scale = (_yarn_mscale(factor, rs["mscale"])
                           / _yarn_mscale(factor, rs["mscale_all_dim"]))
        ms = _yarn_mscale(factor, rs["mscale_all_dim"])
        self.attn_scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5 * ms * ms

    # products: float32, inputs rounded to e4m3's mantissa under the control
    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return round_e4m3_mantissa(x) if self.low else x

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._in(a) @ b  # b: a weight, rounded once when upcast

    def _w(self, name: str) -> torch.Tensor:
        return self._in(self.sd[name + ".weight"].float())

    def tokenize(self, text: str) -> List[int]:
        m = self.m
        ids = []
        for w in words(text)[:m["max_tokens"] - 2]:
            i = self._ids.get(w)
            if i is None:
                i = self._ids[w] = textops.fnv1a(w) % m["n_word_ids"]
            ids.append(i)
        return [m["bos_token_id"]] + ids + [m["eos_token_id"]]

    def embed(self, texts: Sequence[str]) -> torch.Tensor:
        toks = [self.tokenize(t) for t in texts]
        lens = np.array([len(t) for t in toks], dtype=np.int64)
        order = np.argsort(lens, kind="stable")
        out = torch.empty((len(texts), self.m["hidden_size"]), dtype=torch.float32,
                          device=self.device)
        lo = 0
        with _no_tf32():
            while lo < len(order):
                L = int(lens[order[lo]])
                hi = lo + 1
                while hi < len(order) and (hi - lo + 1) * int(lens[order[hi]]) <= BLOCK_TOKENS:
                    hi += 1
                sel = order[lo:hi]
                out[torch.from_numpy(sel).to(self.device)] = self._block([toks[j] for j in sel])
                lo = hi
        return out

    def _block(self, toks: List[List[int]]) -> torch.Tensor:
        """[B, H] unit embeddings of one block of id lists. The hidden
        states are the block's real tokens, text after text ([T, H])."""
        m, dev = self.m, self.device
        B, L = len(toks), max(len(t) for t in toks)
        lens = torch.tensor([len(t) for t in toks], dtype=torch.int64, device=dev)
        ids = torch.from_numpy(np.concatenate([np.asarray(t, dtype=np.int64)
                                               for t in toks])).to(dev)
        real = torch.arange(L, device=dev)[None, :] < lens[:, None]  # [B, L]
        h = self.sd["model.embed_tokens.weight"][ids].float()
        freqs = torch.outer(torch.arange(L, dtype=torch.float32), self.inv_freq)
        emb = torch.cat((freqs, freqs), dim=-1)
        cos = (emb.cos() * self.rope_scale).to(dev)
        sin = (emb.sin() * self.rope_scale).to(dev)
        mask = torch.ones(L, L, dtype=torch.bool, device=dev).tril()[None, None] \
            & real[:, None, None, :]
        for i in range(m["num_hidden_layers"]):
            h = self._layer(i, h, real, cos, sin, mask)
        e = self._norm(h[torch.cumsum(lens, 0) - 1], self.sd["model.norm.weight"])
        return e / e.norm(dim=-1, keepdim=True)

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        eps = self.m["rms_norm_eps"]
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()

    def _swiglu(self, x, gate, up, down):
        return self._mm(torch.nn.functional.silu(self._mm(x, gate.T)) * self._mm(x, up.T),
                        down.T)

    def _layer(self, i, h, real, cos, sin, mask):
        m, p = self.m, f"model.layers.{i}."
        (B, L), H = real.shape, h.shape[1]
        nh, dn, dr, dv = (m["num_attention_heads"], m["qk_nope_head_dim"],
                          m["qk_rope_head_dim"], m["v_head_dim"])

        def padded(t):  # [T, d] real tokens -> [B, L, d], zeros at the pads
            out = t.new_zeros((B, L, t.shape[1]))
            out[real] = t
            return out

        x = self._norm(h, self.sd[p + "input_layernorm.weight"])
        q = padded(self._mm(x, self._w(p + "self_attn.q_proj").T)).view(B, L, nh, dn + dr)
        ckv = self._mm(x, self._w(p + "self_attn.kv_a_proj_with_mqa").T)
        c, k_pe = ckv[:, :m["kv_lora_rank"]], padded(ckv[:, m["kv_lora_rank"]:])
        kv = padded(self._mm(self._norm(c, self.sd[p + "self_attn.kv_a_layernorm.weight"]),
                             self._w(p + "self_attn.kv_b_proj").T)).view(B, L, nh, dn + dv)

        def rope(t):  # [B, heads, L, dr]: interleaved pairs to halves, rotated
            b, hh, ll, d = t.shape
            t = t.reshape(b, hh, ll, d // 2, 2).transpose(4, 3).reshape(b, hh, ll, d)
            rot = torch.cat((-t[..., d // 2:], t[..., :d // 2]), dim=-1)
            return t * cos + rot * sin

        q = q.transpose(1, 2)
        qs = torch.cat([q[..., :dn], rope(q[..., dn:])], dim=-1)
        kv = kv.transpose(1, 2)
        k_pe = rope(k_pe.reshape(B, 1, L, dr)).expand(B, nh, L, dr)
        ks = torch.cat([kv[..., :dn], k_pe], dim=-1)
        scores = (self._in(qs) @ self._in(ks).transpose(-1, -2)) * self.attn_scale
        probs = scores.masked_fill(~mask, float("-inf")).softmax(dim=-1)
        o = (self._in(probs) @ self._in(kv[..., dn:])).transpose(1, 2).reshape(B, L, nh * dv)
        h = h + self._mm(o[real], self._w(p + "self_attn.o_proj").T)

        x = self._norm(h, self.sd[p + "post_attention_layernorm.weight"])
        if not _is_moe(m, i):
            return h + self._swiglu(x, self._w(p + "mlp.gate_proj"), self._w(p + "mlp.up_proj"),
                                    self._w(p + "mlp.down_proj"))
        s = p + "mlp.shared_experts."
        out = self._swiglu(x, self._w(s + "gate_proj"), self._w(s + "up_proj"),
                           self._w(s + "down_proj"))
        scores = self._mm(x, self._w(p + "mlp.gate").T).softmax(dim=-1)
        w, ids = torch.topk(scores, m["num_experts_per_tok"], dim=-1)
        # each (token, slot) written once, then the slots summed in order
        slots = x.new_zeros((x.shape[0], ids.shape[1], H))
        for e in range(m["n_routed_experts"]):
            tok, slot = (ids == e).nonzero(as_tuple=True)
            if tok.numel():
                x_e = p + f"mlp.experts.{e}."
                y = self._swiglu(x[tok], self._w(x_e + "gate_proj"), self._w(x_e + "up_proj"),
                                 self._w(x_e + "down_proj"))
                slots[tok, slot] = y * (w[tok, slot] * m["routed_scaling_factor"])[:, None]
        return h + (out + slots.sum(dim=1))
