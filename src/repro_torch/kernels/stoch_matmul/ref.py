"""Plain PyTorch version of the stochastic-matmul kernel.

Port of ``repro.kernels.stoch_matmul.ref``: AND the packed streams,
popcount, signed sum over K.  The reference unpacks every stream to 128
bits; this version counts the bits of each ANDed word instead (the same
integers) and walks N in chunks, so the ``[M, N, K, 4]`` intermediate of a
full-width ``lm_head`` never exists at once.  Slow by design; the kernel
must match it bit for bit.  The plain versions of the codes entries encode
their codes with ``bts_encode_ref`` first, as the kernel's table does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bitstream import STREAM_LEN, encode_signed, popcount
from repro_torch.core.ossm import W_GEN, X_GEN
from repro_torch.core.quant import QTensor
from repro_torch.kernels.bts_encode.ref import bts_encode_ref

_CHUNK = 1 << 25  # AND-ed words per step of the walk over N


def stoch_matmul_packed_ref(xs: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                            sw: torch.Tensor) -> torch.Tensor:
    """Kernel layout: ``xs [..., M, K, 4]``, ``sx [..., M, K]``, ``ws [..., N,
    K, 4]``, ``sw [..., N, K]`` (K-contiguous) -> int32 ``[..., M, N]``."""
    m, k = sx.shape[-2:]
    n = sw.shape[-2]
    lead = sx.shape[:-2]
    out = torch.empty(*lead, m, n, dtype=torch.int32, device=xs.device)
    step = max(1, _CHUNK // max(1, lead.numel() * m * k * 4))
    xw, xsg = xs[..., :, None, :, :], sx.to(torch.int32)[..., :, None, :]
    for n0 in range(0, n, step):
        pc = popcount(xw & ws[..., None, n0:n0 + step, :, :])  # [..., M, s, K]
        sgn = xsg * sw[..., None, n0:n0 + step, :].to(torch.int32)
        out[..., n0:n0 + step] = (pc * sgn).sum(-1, dtype=torch.int32)
    return out


def stoch_matmul_codes_ref(xq: torch.Tensor, ws: torch.Tensor, sw: torch.Tensor,
                           x_gen: str = X_GEN) -> torch.Tensor:
    """int8 codes ``xq [M, K]`` against streams ``ws [N, K, 4]`` and signs
    ``sw [N, K]`` -> int32 ``[M, N]``."""
    xs, sx = bts_encode_ref(xq, x_gen)
    return stoch_matmul_packed_ref(xs, sx, ws, sw)


def stoch_matmul_codes_batched_ref(xq: torch.Tensor, wq_t: torch.Tensor, x_gen: str = X_GEN,
                                   w_gen: str = W_GEN) -> torch.Tensor:
    """int8 codes ``xq [B, M, K]`` against int8 codes ``wq_t [B, N, K]`` ->
    int32 ``[B, M, N]``."""
    xs, sx = bts_encode_ref(xq, x_gen)
    ws, sw = bts_encode_ref(wq_t, w_gen)
    return stoch_matmul_packed_ref(xs, sx, ws, sw)


def encode_operands(xq: torch.Tensor, wq: torch.Tensor, x_gen: str = X_GEN,
                    w_gen: str = W_GEN) -> Tuple[torch.Tensor, ...]:
    """int8 ``[M, K]`` x ``[K, N]`` -> kernel layout (xs, sx, ws, sw)."""
    xs, sx = encode_signed(xq, x_gen)
    ws, sw = encode_signed(wq.t(), w_gen)  # [N, K, 4]
    return xs, sx.to(torch.int8), ws, sw.to(torch.int8)


def stoch_matmul_ref(xq: QTensor, wq: QTensor, x_gen: str = X_GEN,
                     w_gen: str = W_GEN) -> torch.Tensor:
    """Quantized operands -> dequantized float32, end to end."""
    xs, sx, ws, sw = encode_operands(xq.q, wq.q, x_gen, w_gen)
    acc = stoch_matmul_packed_ref(xs, sx, ws, sw)
    return acc.to(torch.float32) * STREAM_LEN * xq.scale * wq.scale
