"""OSSM — Optical Stochastic Signed Multiplier (paper Fig. 1).

Port of ``repro.core.ossm``.  One OSSM multiplies an activation by a
weight: both int8 operands split into sign and 7-bit magnitude, the
magnitudes become 128-bit streams (``core.bitstream``), the streams meet
in an optical AND gate whose photodetector charge over the window is
popcount(X & W), and XOR(sign_x, sign_w) steers the charge onto the
positive or negative rail.  With thermometer x bresenham pairing the
charge is round(m_x * m_w / 128); with LFSR pairing it is the classic
stochastic estimate.  These are the bit-exact functional models; the
serving path runs ``kernels.stoch_matmul`` on int8 codes, whose streams
come from a table of each magnitude's stream.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bitstream import STREAM_LEN, encode_signed, popcount
from repro_torch.core.quant import QTensor

# Default pairing: X thermometer (unary counter on the activation
# serializer), W bresenham (clock-divided weight stream) — deterministic SC.
X_GEN = "thermometer"
W_GEN = "bresenham"


class WeightCodes(NamedTuple):
    """A weight ``[K, N]`` as the OSSM array reads it, quantized once:
    ``quantize(w, axis=0)``'s codes transposed so K is contiguous, beside
    the per-output-channel scales and the generator whose streams the codes
    stand for (at phase 0 a code's stream is its magnitude's row of the
    generator's table, so the codes are all the kernel needs)."""

    q: torch.Tensor  # [N, K] int8
    scale: torch.Tensor  # [1, N] float32
    gen: str  # the weight streams' generator


def ossm_multiply(qx: torch.Tensor, qw: torch.Tensor, x_gen: str = X_GEN,
                  w_gen: str = W_GEN) -> torch.Tensor:
    """Elementwise signed stochastic product of int8 codes (broadcastable)
    in popcount units, int32: about ``qx * qw / 128``."""
    xs, sx = encode_signed(qx, x_gen)
    ws, sw = encode_signed(qw, w_gen)
    return popcount(xs & ws) * (sx * sw)


def ossm_expected(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The OSSM's mathematical expectation (no stream rounding)."""
    return qx.to(torch.int32) * qw.to(torch.int32)


def sc_dot(qx: torch.Tensor, qw: torch.Tensor, x_gen: str = X_GEN,
           w_gen: str = W_GEN) -> torch.Tensor:
    """Dot product over the last axis through OSSMs and an exact analog
    accumulation: the signed sum of per-lane popcounts."""
    return ossm_multiply(qx, qw, x_gen, w_gen).sum(-1, dtype=torch.int32)


def sc_matmul_value(xq: QTensor, wq: QTensor, x_gen: str = X_GEN,
                    w_gen: str = W_GEN) -> torch.Tensor:
    """Stochastic ``[..., K] @ [K, N]``, dequantized as
    ``((acc * 128) * xs) * ws`` — the reference's order, so float32 results
    are bit-identical.  Materializes ``[..., K, N]`` popcounts: the CPU
    oracle only."""
    prod = ossm_multiply(xq.q[..., :, None], wq.q[None, ...], x_gen, w_gen)  # [..., K, N]
    acc = prod.sum(-2, dtype=torch.int32)
    return acc.to(torch.float32) * STREAM_LEN * xq.scale * wq.scale
