"""Public wrapper of the int8 GEMM kernel: checks, launch, dequantization.

``int8_gemm`` is the launch point (and carries the launch counter);
``int8_matmul_t`` takes the weight pre-transposed ``[N, K]`` as the model
caches it, so both operands are K-contiguous.  Dequantization is
``(acc * xs) * ws`` in float32, the reference's order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

_BK = 64  # the kernel's K step; split-K chunks are multiples of it
# (BM, BN) of the kernel's two tile configurations, indexed by ``cfg``
_TILES = {0: (16, 64), 1: (64, 128)}


def _lib():
    lib = _build.load("int8_matmul")
    fn = lib.int8_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(m: int, n: int, k: int, n_sm: int):
    """(tile config, K elements per split, number of splits).

    Small M (decode) takes the 16-row tile.  When the M x N tiles alone
    cannot give every SM two blocks, K is split across more blocks whose
    int32 partial sums meet by atomic add — integer addition is exact in
    any order, so the result stays bit-identical."""
    cfg = 0 if m <= 16 else 1
    bm, bn = _TILES[cfg]
    blocks = -(-m // bm) * -(-n // bn)
    splits = 1
    if blocks < 2 * n_sm:
        splits = max(1, min(-(-2 * n_sm // blocks), -(-k // (2 * _BK))))
    kps = -(-k // splits)
    kps = -(-kps // _BK) * _BK
    return cfg, kps, -(-k // kps)


def int8_gemm(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 ``x [M, K]`` x int8 ``w_t [N, K]`` -> int32 ``[M, N]``."""
    if x.device.type == "cpu" and w_t.device.type == "cpu":
        return int8_matmul_acc_ref(x, w_t)
    if x.device.type != "cuda" or w_t.device != x.device:
        raise ValueError(f"int8_gemm: operands on {x.device} and {w_t.device}; "
                         "both must be on the same CUDA device (or both on the CPU)")
    if x.dtype != torch.int8 or w_t.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 operands, got {x.dtype} and {w_t.dtype}")
    if x.dim() != 2 or w_t.dim() != 2 or x.shape[1] != w_t.shape[1]:
        raise ValueError(f"int8_gemm: shapes {tuple(x.shape)} x {tuple(w_t.shape)} "
                         "are not [M, K] x [N, K]")
    # the kernel reads 16-byte vectors: contiguous, 16-byte aligned starts
    x, w_t = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
              else t.clone(memory_format=torch.contiguous_format) for t in (x, w_t))
    m, k = x.shape
    n = w_t.shape[0]
    cfg, kps, splits = split_plan(m, n, k, _sm_count(x.device.index))
    out = (torch.zeros if splits > 1 else torch.empty)((m, n), dtype=torch.int32,
                                                        device=x.device)
    if m == 0 or n == 0:
        return out
    rc = _lib()(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), m, n, k, kps, splits, cfg,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def int8_matmul_t(xq: QTensor, wq_t: QTensor) -> torch.Tensor:
    """``xq [M, K]`` x pre-transposed ``wq_t [N, K]`` (scale ``[1, N]``)
    -> dequantized float32 ``[M, N]``."""
    acc = int8_gemm(xq.q, wq_t.q)
    return (acc.to(torch.float32) * xq.scale) * wq_t.scale
