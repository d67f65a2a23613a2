"""Plain PyTorch version of the stochastic-matmul kernel.

Port of ``repro.kernels.stoch_matmul.ref``: AND the packed streams,
popcount, signed sum over K.  The reference unpacks every stream to 128
bits; this version counts the bits of each ANDed word instead (the same
integers) and walks N in chunks, so the ``[M, N, K, 4]`` intermediate of a
full-width ``lm_head`` never exists at once.  Slow by design; the kernel
must match it bit for bit.  The plain version of the codes x streams
entry encodes its codes with ``core.bitstream.encode_signed`` first, as
the kernel's table does (at -128 too, where ``bts_encode`` differs).  :func:`stoch_gemm_codes_ref` is the plain version of the
binary tensor-core kernel (``csrc/stoch_gemm_sm90.cu``, codes against
codes): its arithmetic, sign planes and ``same - opp``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bitstream import STREAM_LEN, encode_signed, popcount, unpack_bits
from repro_torch.core.ossm import W_GEN, X_GEN
from repro_torch.core.quant import QTensor

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
    xs, sx = encode_signed(xq, x_gen)
    return stoch_matmul_packed_ref(xs, sx.to(torch.int8), ws, sw)


def sign_planes(q: torch.Tensor, generator: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes ``[...]`` -> their sign planes ``(P, N)``, each ``[..., 4]``
    int32 words: the code's stream (``encode_signed``'s, phase 0; at -128
    the reference's wrapped one) in ``P`` when the code is not negative and
    in ``N`` when it is, zeros in the other."""
    words, _ = encode_signed(q.to(torch.int8), generator)
    neg = (q < 0)[..., None]
    zero = torch.zeros_like(words)
    return torch.where(neg, zero, words), torch.where(neg, words, zero)


def signed_bits(generator: str, device=None) -> torch.Tensor:
    """``[256, 128]`` float32: row ``c + 128`` is ``bits(P) - bits(N)`` of
    code ``c``'s sign planes, the code's stream as +1 (``c >= 0``) or -1
    bits (``c < 0``)."""
    p, n = sign_planes(torch.arange(-128, 128, device=device), generator)
    return (unpack_bits(p) - unpack_bits(n)).to(torch.float32)


_BITS_CHUNK = 1 << 26  # expanded weight bits per step of the walk over N


def stoch_gemm_codes_ref(xq: torch.Tensor, wq_t: torch.Tensor, x_gen: str = X_GEN,
                         w_gen: str = W_GEN) -> torch.Tensor:
    """int8 codes ``xq [..., M, K]`` against int8 codes ``wq_t [..., N, K]``
    -> int32 ``[..., M, N]``, in the binary tensor-core kernel's
    arithmetic: each code's sign planes, ``same - opp`` of a weight row
    ``[P_w | N_w]`` against ``[P_x | N_x]`` and ``[N_x | P_x]``.  Summed
    over the 128 bits of each code, ``same - opp`` is the product of the
    planes' signed bits, ``(P_x - N_x) . (P_w - N_w)``, which this version
    takes as one float32 product of the operands' expanded bits (``[..., M,
    128 K]``; the weight's ``[..., s, 128 K]`` a chunk of N at a time).
    Its sums are integers below 2^24 (``|C| <= 128 K``), so float32 holds
    them exactly."""
    m, k = xq.shape[-2:]
    n = wq_t.shape[-2]
    lead = xq.shape[:-2]
    tx, tw = signed_bits(x_gen, xq.device), signed_bits(w_gen, xq.device)
    xb = tx[xq.to(torch.int64) + 128].reshape(*lead, m, k * STREAM_LEN)
    out = torch.empty(*lead, m, n, dtype=torch.int32, device=xq.device)
    step = max(1, _BITS_CHUNK // max(1, lead.numel() * k * STREAM_LEN))
    for n0 in range(0, n, step):
        w = wq_t[..., n0:n0 + step, :]
        wb = tw[w.to(torch.int64) + 128].reshape(*lead, w.shape[-2], k * STREAM_LEN)
        out[..., n0:n0 + step] = torch.matmul(xb, wb.transpose(-1, -2)).round().to(torch.int32)
    return out


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
