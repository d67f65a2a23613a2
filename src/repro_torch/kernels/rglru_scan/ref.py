"""Plain PyTorch version of the linear-recurrence kernel: the sequential
loop of ``repro.kernels.rglru_scan.ref.rglru_scan_ref``."""
from __future__ import annotations

from typing import Optional

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1 of ``a, b [B, S, D]``,
    ``h_{-1} = h0`` (zeros by default); every ``h_t`` in ``a.dtype``."""
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype, device=a.device) if h0 is None else h0
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
