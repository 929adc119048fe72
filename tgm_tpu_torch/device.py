"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card they raise; they never drop to the CPU on their own.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tgm_tpu_torch: a CUDA device was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
