"""Plain PyTorch version of the int8 GEMM kernel.

Products of int8 values are at most 127*127 and a row sums at most
K * 16129 of them (9.1e7 at K = 5632), far below 2**53, so a float64
matmul is exact in any summation order — and unlike integer ``matmul``
it runs on both the CPU and the card.
"""
from __future__ import annotations

import torch


def int8_matmul_acc_ref(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 ``x [M, K]`` times int8 ``w_t [N, K]`` (K-contiguous weight)
    -> exact int32 accumulator ``[M, N]``."""
    return (x.to(torch.float64) @ w_t.to(torch.float64).t()).to(torch.int32)
