"""Plain PyTorch version of the int8 GEMM kernel.

Products of int8 values are at most 127*127 and a row sums at most
K * 16129 of them (9.1e7 at K = 5632), far below 2**53, so a float64
matmul is exact in any summation order — and unlike integer ``matmul``
it runs on both the CPU and the card.
"""
from __future__ import annotations

import torch


def int8_matmul_acc_ref(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 ``x [..., M, K]`` times int8 ``w_t [..., N, K]`` (K-contiguous
    weight) -> exact int32 accumulator ``[..., M, N]``."""
    return (x.to(torch.float64) @ w_t.to(torch.float64).transpose(-1, -2)).to(torch.int32)


def int8_batched_tiles(m: int, n: int, bm: int, max_bn: int) -> list:
    """The batched admission kernel's tiles of an ``[M, N]`` output: ``bm``
    rows by ``bn`` columns, N cut into the fewest tiles of at most
    ``max_bn`` columns, ``bn`` a multiple of 8 (the mma tile) as close to
    an even share as that allows, the last tiles cut at M and N.  Returns
    ``(rows, cols)`` slices, one a block."""
    tiles_n = _cdiv(n, max_bn)
    bn = _cdiv(_cdiv(n, tiles_n), 8) * 8
    return [(slice(m0, min(m, m0 + bm)), slice(n0, min(n, n0 + bn)))
            for m0 in range(0, m, bm) for n0 in range(0, n, bn)]


def int8_batched_tiles_ref(x: torch.Tensor, w_t: torch.Tensor, bm: int,
                           max_bn: int) -> tuple:
    """The batched admission kernel's tiling in plain PyTorch: int8 ``x [B,
    M, K]`` times ``w_t [B, N, K]`` computed tile by tile over
    :func:`int8_batched_tiles`, each tile over the whole K.  Returns the
    int32 accumulators ``[B, M, N]`` and how many tiles wrote each element
    (int32, same shape)."""
    b, m, _ = x.shape
    n = w_t.shape[1]
    out = torch.zeros((b, m, n), dtype=torch.int32)
    visits = torch.zeros((b, m, n), dtype=torch.int32)
    xf, wf = x.to(torch.float64), w_t.to(torch.float64)
    for rows, cols in int8_batched_tiles(m, n, bm, max_bn):
        out[:, rows, cols] = (xf[:, rows] @ wf[:, cols].transpose(-1, -2)).to(torch.int32)
        visits[:, rows, cols] += 1
    return out, visits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)
