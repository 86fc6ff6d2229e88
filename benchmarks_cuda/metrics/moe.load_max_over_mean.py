"""moe.load_max_over_mean: how unevenly the router loads the experts: per
tapped ``ops/moe.py`` ``expert_products`` call of the traced window (one
MoE layer of one chunk), the most-loaded expert's routed rows over the
mean over the experts, from the call's ``offsets``; averaged over the
calls. 1 is an even load; the grouped product waits on its largest
group."""

import torch

TAPS = {"expert_products": ("hybridsearch_tpu_torch.ops.moe", "expert_products")}


def read(run):
    calls = run.calls.get("expert_products")
    if not calls:
        return None
    ratios = []
    for args, _kw in calls:
        offsets = args[3].long().cpu()
        counts = torch.diff(offsets, prepend=torch.zeros(1, dtype=torch.long)).double()
        if counts.sum() > 0:
            ratios.append(float(counts.max() / counts.mean()))
    return sum(ratios) / len(ratios) if ratios else None
