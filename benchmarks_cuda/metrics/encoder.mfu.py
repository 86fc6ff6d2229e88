"""encoder.mfu: the query encoder's model FLOPs in the traced window as a
share (%) of the window's seconds at the card's bf16 peak (989 TFLOP/s,
NVIDIA's H100 SXM data sheet, dense, at 700 W).

A chunk's model FLOPs, from each tapped ``models/deepseek_v2.py``
``forward_chunk`` call (the trunk's config and the chunk's real token
counts): 2 x the active parameters outside the embedding (every matrix
of every layer: the attention's four, the dense layer's MLP, on an MoE
layer the router, the ``num_experts_per_tok`` routed experts a token takes
and the shared experts) x the chunk's real tokens, plus QK^T and PV of
each head over each text's own causal pairs, L (L + 1) / 2 at its length
L. Pad tokens, norms, RoPE and the softmax count nothing."""

import numpy as np

BF16_FLOP_PER_S = 989e12
TAPS = {"forward_chunk": ("hybridsearch_tpu_torch.models.deepseek_v2", "forward_chunk")}


def active_params(cfg) -> int:
    """Matrix parameters a token uses, over every layer."""
    H, nh = cfg.hidden_size, cfg.num_attention_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    attn = (nh * qk * H + (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * H
            + nh * (cfg.qk_nope_head_dim + cfg.v_head_dim) * cfg.kv_lora_rank
            + H * nh * cfg.v_head_dim)
    total = 0
    for i in range(cfg.num_hidden_layers):
        if cfg.is_moe(i):
            I = cfg.moe_intermediate_size
            mlp = (cfg.n_routed_experts * H
                   + 3 * H * I * (cfg.num_experts_per_tok + cfg.n_shared_experts))
        else:
            mlp = 3 * H * cfg.intermediate_size
        total += attn + mlp
    return total


def chunk_flops(cfg, lengths) -> float:
    lengths = np.asarray(lengths, dtype=np.float64)
    pairs = float((lengths * (lengths + 1) / 2).sum())
    attn = (2.0 * cfg.num_attention_heads * pairs
            * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
            * cfg.num_hidden_layers)
    return 2.0 * active_params(cfg) * float(lengths.sum()) + attn


def read(run):
    calls = run.calls.get("forward_chunk")
    if not calls or run.profile is None or run.window_s <= 0:
        return None
    flops = sum(chunk_flops(args[0].cfg, args[1]) for args, _kw in calls)
    return 100.0 * flops / (run.window_s * BF16_FLOP_PER_S)
