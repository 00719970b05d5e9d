"""Where the port's tensors live: the card unless the caller says otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises when PyTorch sees no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: kwok_tpu_torch runs on the GPU unless "
                "device='cpu' is passed"
            )
        return torch.device("cuda")
    return torch.device(device)
