"""Error-feedback int8 gradient compression for the pod-crossing all-reduce.

Port of ``repro.optim.grad_compress``.  At multi-pod scale the DP
all-reduce over the ``pod`` axis rides the slow inter-pod links, so each
leaf is quantized to int8 on a scale every member shares, with an
error-feedback residual (EF-SGD) so the compression bias vanishes over
steps.  Per leaf, over ``group`` (a process group; None is the world):

1. a MAX all-reduce of the local absmax of ``g + residual``;
2. shared-scale int8 codes, ``clip(round(gf / scale), -127, 127)``
   (``torch.round`` rounds half to even, as ``jnp.round`` does);
3. an int32 SUM all-reduce of the codes;
4. the sum dequantised and divided by the member count ``n``;
5. the new residual, ``gf`` less this member's own dequantised codes.

The arithmetic of steps 2, 4 and 5 is :func:`quantize`,
:func:`dequantize_sum` and :func:`residual`, pure functions, so they can
be held against the reference with no processes.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_util


class CompressorState(NamedTuple):
    residual: Any  # a tree matching the grads, float32


def compress_init(grads) -> CompressorState:
    return CompressorState(tree_util.map_leaves(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def quantize(gf: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes of float32 ``gf`` on the grid of the shared absmax
    ``amax``, the scale ``amax / 127``, 1 for an all-zero leaf)."""
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_sum(q_sum: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """The members' mean from the int32 sum of their codes."""
    return q_sum.to(torch.float32) * scale / n


def residual(gf: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """What this member's codes left out of ``gf``."""
    return gf - q.to(torch.float32) * scale


def compressed_psum(grads, group, state: CompressorState) -> Tuple[Any, CompressorState]:
    """int8-compressed mean over ``group`` with error feedback: returns
    (the mean of every member's ``grads`` in each leaf's dtype, the new
    state)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    outs, res = [], []
    for g, r in zip(tree_util.leaves(grads), tree_util.leaves(state.residual)):
        gf = g.to(torch.float32) + r
        amax = torch.max(torch.abs(gf))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        q, scale = quantize(gf, amax)
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, group=group)
        outs.append(dequantize_sum(q_sum, scale, n).to(g.dtype))
        res.append(residual(gf, q, scale))
    return (tree_util.unflatten(grads, outs),
            CompressorState(tree_util.unflatten(state.residual, res)))
