"""Plain PyTorch versions of the linear-recurrence kernel: the sequential
loop of ``repro.kernels.rglru_scan.ref.rglru_scan_ref``, and the kernel's
own decomposition of it into chunks, warps' step runs and carries."""
from __future__ import annotations

from typing import Optional

import torch

# csrc/rglru_scan.cu: steps of a chunk (8 warps x 4 steps) and steps a warp scans
CHUNK, STEPS_PER_WARP = 32, 4


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


def rglru_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor, chunk: int = CHUNK,
                           steps_per_warp: int = STEPS_PER_WARP) -> torch.Tensor:
    """The same recurrence in the kernel's order of operations.  S is cut
    into chunks of ``chunk`` steps and each chunk into runs of
    ``steps_per_warp`` steps, one a warp.  A run is scanned from a zero
    state, keeping each step's local state ``h_loc`` and the running
    product ``P`` of its decays.  The runs' last ``(P, h_loc)`` are folded
    in order into the carry ``c`` of the previous chunk (``c <- P c +
    h_loc``); a run's states are ``h = P * c_in + h_loc`` with ``c_in``
    the carry before its own fold.  Steps past S (the last chunk's tail)
    take decay 0 and input 0, as the kernel's zero-filled copies do, and
    are never returned."""
    if chunk % steps_per_warp:
        raise ValueError(f"chunk {chunk} is not whole runs of {steps_per_warp} steps")
    bsz, s, d = a.shape
    pad = -s % chunk
    if pad:
        a = torch.cat([a, a.new_zeros(bsz, pad, d)], 1)
        b = torch.cat([b, b.new_zeros(bsz, pad, d)], 1)
    runs = chunk // steps_per_warp
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    carry = a.new_zeros(bsz, d)
    for c0 in range(0, s + pad, chunk):
        h_loc, prod = [], []
        for w in range(runs):
            h, p = a.new_zeros(bsz, d), a.new_ones(bsz, d)
            for i in range(steps_per_warp):
                t = c0 + w * steps_per_warp + i
                h = a[:, t] * h + b[:, t]
                p = p * a[:, t]
                h_loc.append(h)
                prod.append(p)
        for w in range(runs):
            c_in = carry
            last = (w + 1) * steps_per_warp - 1
            carry = prod[last] * carry + h_loc[last]
            for i in range(w * steps_per_warp, (w + 1) * steps_per_warp):
                out[:, c0 + i] = prod[i] * c_in + h_loc[i]
    return out[:, :s]
