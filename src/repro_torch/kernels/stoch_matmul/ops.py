"""Public wrappers of the stochastic-matmul kernel: checks, launch, counter.

Port of ``repro.kernels.stoch_matmul.ops``.  ``stoch_matmul_packed`` is the
launch point (and carries the launch counter): packed streams and signs of
both operands, K-contiguous, in int32 accumulators; an optional leading
batch dimension runs independent products in one launch.  The reference
pads to block multiples; the kernel masks ragged edges itself.
``stoch_matmul`` takes quantized activations and a weight's cached streams
(``core.ossm.WeightStreams``), encodes the activations with ``bts_encode``
and dequantizes as ``((acc * 128) * xs) * ws``, the reference's order.
On CPU tensors the wrappers run the plain versions (``ref.py``); on CUDA
tensors they launch ``csrc/stoch_matmul.cu`` or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bitstream import N_WORDS, STREAM_LEN
from repro_torch.core.ossm import X_GEN, WeightStreams
from repro_torch.core.quant import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.bts_encode.ops import bts_encode
from repro_torch.kernels.stoch_matmul.ref import stoch_matmul_packed_ref

_BK = 16  # the kernel's K step; split-K chunks are multiples of it
# (BM, BN) of the kernel's two tile configurations, indexed by ``cfg``
_TILES = {0: (8, 128), 1: (64, 64)}


def _lib():
    fn = _build.load("stoch_matmul").stoch_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def split_plan(m: int, n: int, k: int, n_sm: int, batch: int = 1):
    """(tile config, K positions per split, number of splits).  M <= 8
    (decode) takes the 8-row tile; K is split when the output tiles of all
    ``batch`` products cannot give every SM four blocks."""
    cfg = 0 if m <= 8 else 1
    bm, bn = _TILES[cfg]
    return (cfg, *_build.split_k(batch * -(-m // bm) * -(-n // bn), k, _BK, 4 * n_sm))


def stoch_matmul_packed(xs: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                        sw: torch.Tensor) -> torch.Tensor:
    """``xs [(B,) M, K, 4]`` int32 streams, ``sx [(B,) M, K]`` int8 signs,
    ``ws [(B,) N, K, 4]``, ``sw [(B,) N, K]`` -> int32 ``[(B,) M, N]``:
    ``sum_k sx * sw * popcount(xs & ws)``."""
    tensors = (xs, sx, ws, sw)
    if all(t.device.type == "cpu" for t in tensors):
        return stoch_matmul_packed_ref(xs, sx, ws, sw)
    if any(t.device != xs.device for t in tensors) or xs.device.type != "cuda":
        raise ValueError("stoch_matmul_packed: operands on "
                         f"{sorted({str(t.device) for t in tensors})}; all must be on one "
                         "CUDA device (or all on the CPU)")
    if (xs.dtype, sx.dtype, ws.dtype, sw.dtype) != (torch.int32, torch.int8) * 2:
        raise TypeError("stoch_matmul_packed takes int32 streams and int8 signs, got "
                        f"{[t.dtype for t in tensors]}")
    batched = sx.dim() == 3
    if (sx.dim() not in (2, 3) or sw.dim() != sx.dim() or xs.shape != (*sx.shape, N_WORDS)
            or ws.shape != (*sw.shape, N_WORDS) or sx.shape[-1] != sw.shape[-1]
            or (batched and sx.shape[0] != sw.shape[0])):
        raise ValueError(f"stoch_matmul_packed: shapes {[tuple(t.shape) for t in tensors]} "
                         "are not [(B,) M, K, 4], [(B,) M, K], [(B,) N, K, 4], [(B,) N, K]")
    # the kernel reads 16-byte words: contiguous, 16-byte aligned starts
    xs, sx, ws, sw = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                      else t.clone(memory_format=torch.contiguous_format) for t in tensors)
    b = sx.shape[0] if batched else 1
    m, k = sx.shape[-2:]
    n = sw.shape[-2]
    cfg, kps, splits = split_plan(m, n, k, _build.sm_count(xs.device.index), b)
    if b * splits > 65535:  # gridDim.z
        raise ValueError(f"stoch_matmul_packed: batch {b} x {splits} K splits exceeds the grid")
    out = (torch.zeros if splits > 1 else torch.empty)(
        (*sx.shape[:-2], m, n), dtype=torch.int32, device=xs.device)
    if out.numel() == 0:
        return out
    rc = _lib()(xs.data_ptr(), sx.data_ptr(), ws.data_ptr(), sw.data_ptr(), out.data_ptr(),
                b, m, n, k, kps, splits, cfg, torch.cuda.current_stream(xs.device).cuda_stream)
    _build.check(rc, "stoch_matmul_packed")
    stoch_matmul_packed.launches += 1
    return out


stoch_matmul_packed.launches = 0


def stoch_matmul(xq: QTensor, w: WeightStreams, x_gen: str = X_GEN) -> torch.Tensor:
    """Quantized ``xq [M, K]`` through the OSSM array against a weight's
    cached streams (``[N, K]``, scale ``[1, N]``) -> dequantized float32
    ``[M, N]``."""
    xs, sx = bts_encode(xq.q, x_gen)
    acc = stoch_matmul_packed(xs, sx, w.words, w.sign)
    return acc.to(torch.float32) * STREAM_LEN * xq.scale * w.scale
