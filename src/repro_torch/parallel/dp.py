"""Sums over the data-parallel ranks, for a loss that must equal the
one-process loss.

Each rank of a sharded step runs ``Model.loss`` on its own batch rows.  A
mean over tokens is a sum over the data-parallel ranks divided by a
global count, and the MoE load-balance loss is a product of two such
means, so neither is a mean of per-rank losses.  :class:`DataParallel`
sums a tensor over the ranks that hold distinct rows (one all-reduce over
the world, the ranks off the first copy adding zeros, so no subgroup is
needed and each sum is of distinct terms only).  Its ``global_value``
gives a tensor the global value and the gradient of this rank's part of
it: summed over the data-parallel ranks, those gradients are the
gradient of the one-process loss.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch


class DataParallel:
    """The mesh axes the batch is split over.  ``coords``/``sizes`` are
    this rank's mesh coordinates and the mesh's axis sizes."""

    def __init__(self, axes: Sequence[str], sizes: Mapping[str, int],
                 coords: Mapping[str, int]):
        self.axes = tuple(axes)
        self.size = math.prod(sizes[a] for a in self.axes)
        # the first copy of this rank's rows: coordinate 0 off the DP axes
        self.first = all(coords[a] == 0 for a in sizes if a not in self.axes)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (detached) summed over the data-parallel ranks."""
        import torch.distributed as dist

        y = x.detach().clone() if self.first else torch.zeros_like(x)
        dist.all_reduce(y)
        return y

    @staticmethod
    def global_value(part: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """``value`` forward, ``part``'s gradient backward."""
        return _GlobalValue.apply(part, value)


class _GlobalValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, value):
        return value.detach().clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None

