"""Mixture-of-experts ops: the router and the grouped expert product.

No kernel of the JAX package backs these (it has no expert layer); they
serve ``models/deepseek_v2.py``'s MoE layers.

- ``route``: the router's logits ``x @ w_gate.T`` and their softmax in
  float32, then the top ``k`` experts of each token greedily (no group
  limit, no correction bias), their scores as the weights.
- ``expert_products``: every routed token's expert output
  ``down_e(silu(gate_e x) * up_e x)`` over tokens sorted by expert, the
  experts' row ranges given by ``offsets`` on the device. On the card it
  is one grouped product a projection (``torch._grouped_mm``: bf16 inputs,
  float32 accumulation, one launch for all experts) and ``silu * mul`` in
  float32 between them, rounded once to the activation dtype; on the CPU a
  plain loop over the experts, in the inputs' dtype. No host copy and no
  per-expert Python loop on the card.
- ``moe_layer``: a layer's routed part: route, sort the (token, slot)
  pairs by expert, ``expert_products``, and the weighted sum of each
  token's ``k`` outputs in float32. ``expert_products`` is looked up in
  this module's globals at each call, so a benchmark can wrap it.

The sort and the offsets run on the device (a stable ``argsort`` of the
expert ids, ``searchsorted`` for the ends), so a layer never waits for the
card; the outputs are put back in (token, slot) order by ``index_copy_``
(each row written once: deterministic) and summed over the slots in slot
order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from hybridsearch_tpu_torch.utils.tracing import trace_span


def route(x: torch.Tensor, w_gate: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """([T, k] int64 expert ids, [T, k] float32 weights) of ``x`` [T, H]
    under the router ``w_gate`` [E, H]: softmax of the float32 logits,
    the top ``k`` by score (largest first), the scores themselves as the
    weights (no renormalization)."""
    scores = (x.float() @ w_gate.float().T).softmax(dim=-1)
    weights, ids = torch.topk(scores, k, dim=-1)
    return ids, weights


def _swiglu(h: torch.Tensor, width: int, dtype: torch.dtype) -> torch.Tensor:
    """``silu(gate) * up`` of ``h`` = [gate | up], in float32, rounded once."""
    h = h.float()
    return (F.silu(h[:, :width]) * h[:, width:]).to(dtype)


def expert_products(x_sorted: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """[M, H] expert outputs of ``x_sorted`` [M, H], whose rows
    ``offsets[e - 1]:offsets[e]`` (``offsets`` [E] int32, cumulative row
    ends, ``offsets[-1] == M``) go to expert ``e``. ``w13`` [E, 2I, H] is
    each expert's gate and up projection stacked, ``w2`` [E, H, I] its down
    projection. An expert with no row costs nothing.

    On the card: ``torch._grouped_mm`` (bf16 only) or an error; on the CPU:
    a loop over the experts."""
    width = w2.shape[2]
    if x_sorted.is_cuda:
        if x_sorted.dtype != torch.bfloat16 or w13.dtype != torch.bfloat16:
            raise ValueError(f"expert_products: the card takes bf16, not "
                             f"{x_sorted.dtype} / {w13.dtype}")
        h = torch._grouped_mm(x_sorted, w13.transpose(-2, -1), offs=offsets)
        a = _swiglu(h, width, x_sorted.dtype)
        return torch._grouped_mm(a, w2.transpose(-2, -1), offs=offsets)
    out = x_sorted.new_empty((x_sorted.shape[0], w2.shape[1]))
    lo = 0
    for e, hi in enumerate(offsets.tolist()):
        if hi > lo:
            a = _swiglu(x_sorted[lo:hi] @ w13[e].T, width, x_sorted.dtype)
            out[lo:hi] = a @ w2[e].T
        lo = hi
    return out


def expert_offsets(sorted_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[E] int32 cumulative row ends of expert ids sorted ascending, on
    their device (no host copy)."""
    experts = torch.arange(n_experts, device=sorted_ids.device, dtype=sorted_ids.dtype)
    return torch.searchsorted(sorted_ids, experts, right=True, out_int32=True)


def moe_layer(x: torch.Tensor, w_gate: torch.Tensor, w13: torch.Tensor,
              w2: torch.Tensor, k: int) -> torch.Tensor:
    """[T, H] float32 routed output ``sum_i s_i * expert_i(x)`` of the
    tokens ``x`` [T, H] (real tokens only: every row takes ``k`` expert
    slots)."""
    T, H = x.shape
    with trace_span("moe.route"):
        ids, weights = route(x, w_gate, k)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        offsets = expert_offsets(flat[order], w_gate.shape[0])
        x_sorted = x.index_select(0, order // k)
    with trace_span("moe.experts"):
        y_sorted = expert_products(x_sorted, w13, w2, offsets)
        y = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
        return (y.view(T, k, H).float() * weights[..., None]).sum(dim=1)
