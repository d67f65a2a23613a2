"""8-bit sign-magnitude quantization — ASTRA's operand format (paper §III).

Port of ``repro.core.quant``: symmetric int8 in [-127, 127] (the -128 code
is unused, as in sign-magnitude hardware), per-output-channel weight
scales, per-tensor activation scales.  ``torch.round`` rounds half to
even exactly like ``jnp.round``, so codes and scales are bit-identical to
the reference on the same float32 inputs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

MAG_MAX = 127  # 7-bit magnitude
STREAM_LEN = 128  # bits per stochastic stream (paper: 128-bit + sign)


class QTensor(NamedTuple):
    """Quantized tensor: int8 values + float32 scale (broadcastable)."""

    q: torch.Tensor  # int8, in [-127, 127]
    scale: torch.Tensor  # float32, broadcastable to q.shape


def _safe_scale(amax: torch.Tensor) -> torch.Tensor:
    amax = amax.to(torch.float32)
    return torch.where(amax > 0, amax / MAG_MAX, torch.ones_like(amax))


@functools.lru_cache(maxsize=4096)
def _device_scale(scale: float, device: torch.device) -> torch.Tensor:
    """A static (calibrated) scale as a float32 tensor on ``device``, made
    once: built from the Python float at every call it would be a
    host-to-card copy that makes the host wait for the card, at every
    quantized GEMM."""
    return torch.tensor(scale, dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, axis: Optional[int] = None,
             scale: Optional[torch.Tensor] = None) -> QTensor:
    """Symmetric int8 quantization.

    ``axis=None`` -> per-tensor scale; ``axis=k`` -> per-channel reduced
    along ``k`` (the scale keeps dims for broadcasting).  ``scale``
    overrides the dynamic absmax (static calibrated activation scales).
    """
    xf = x.to(torch.float32)
    if scale is None:
        if axis is None:
            amax = xf.abs().amax()
        else:
            amax = xf.abs().amax(dim=axis, keepdim=True)
        scale = _safe_scale(amax)
    elif isinstance(scale, (int, float)):
        scale = _device_scale(float(scale), xf.device)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=xf.device)
    q = torch.clamp(torch.round(xf / scale), -MAG_MAX, MAG_MAX).to(torch.int8)
    return QTensor(q, scale)


def int8_matmul_exact(xq: QTensor, wq: QTensor) -> torch.Tensor:
    """Integer matmul + dequant: ``[..., K] @ [K, N]`` — the expectation of
    ASTRA's stochastic computation.  Runs the int8 kernel's plain version
    (exact int32 accumulators); dequantizes as ``(acc * xs) * ws``, the
    reference's order, so the float32 result matches it bit for bit."""
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    lead = xq.q.shape[:-1]
    acc = int8_matmul_acc_ref(xq.q.reshape(-1, xq.q.shape[-1]), wq.q.t())
    acc = acc.reshape(*lead, wq.q.shape[-1])
    return (acc.to(torch.float32) * xq.scale) * wq.scale
