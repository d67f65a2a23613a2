"""Device selection for the port's entry points.

The card is the default: ``resolve_device(None)`` is ``cuda`` and raises
when no GPU is visible.  The CPU is used only when a caller asks for it
(``device="cpu"``, as the tests do) — never as a silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the first CUDA device (raises without one); otherwise
    the device the caller named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port's plain PyTorch paths on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype (bf16 models keep bf16 activations
    and KV; everything else runs in float32)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32
