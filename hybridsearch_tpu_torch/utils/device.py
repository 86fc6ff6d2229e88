"""Device selection for the port's entry points.

The default is the card. The CPU is used only when the caller asks for it
(the tests do); without a card the default raises instead of falling back.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hybridsearch_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
