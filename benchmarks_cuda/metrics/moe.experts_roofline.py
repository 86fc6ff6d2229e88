"""moe.experts_roofline: the grouped expert product's share (%) of its
roofline in the traced window: the least time of each ``ops/moe.py``
``expert_products`` call over the device time of the operations it
launched (both grouped products and the ``silu * mul`` between them).

A call's least time is the larger of its operations over the bf16 peak
(989 TFLOP/s) and its bytes over 3.35 TB/s (NVIDIA's H100 SXM data sheet,
at 700 W). Operations: 2 M H 2I for gate and up, 2 M I H for down, M the
routed rows. Bytes, each read or written once: the sorted rows and the
output (M x H, bf16 each), the weights of every expert that took a row
(3 H I bf16 each), the offsets."""

import torch

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
TAPS = {"expert_products": ("hybridsearch_tpu_torch.ops.moe", "expert_products")}


def least_seconds(args, kwargs) -> float:
    x, w13, w2, offsets = args[:4]
    M, H = x.shape
    I = w2.shape[2]
    counts = torch.diff(offsets.long(), prepend=offsets.new_zeros(1).long())
    used = int((counts > 0).sum())
    flops = 6.0 * M * H * I
    nbytes = (2 * M * H * x.element_size() + used * 3 * H * I * w13.element_size()
              + offsets.numel() * offsets.element_size())
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def read(run):
    calls = run.calls.get("expert_products")
    if not calls or run.profile is None:
        return None
    device_s = run.profile.device_s.get("expert_products", 0.0)
    if device_s <= 0.0:
        return None
    return 100.0 * sum(least_seconds(a, kw) for a, kw in calls) / device_s
