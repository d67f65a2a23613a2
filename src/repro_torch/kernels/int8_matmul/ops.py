"""Public wrapper of the int8 GEMM kernel: checks, launch, dequantization.

``int8_gemm`` is the launch point of one product and ``int8_gemm_batched``
of a batch of independent products in one launch (the attention qk/pv
products of every slot and KV head under a quantized plan); each carries
its own launch counter.  ``int8_matmul_t`` takes the weight pre-transposed
``[N, K]`` as the model caches it, so both operands are K-contiguous.
Dequantization is ``(acc * xs) * ws`` in float32, the reference's order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

_BK = 64  # the kernel's K step; split-K chunks are multiples of it
# (BM, BN) of the kernel's two tile configurations, indexed by ``cfg``
_TILES = {0: (16, 64), 1: (64, 128)}


def _lib():
    lib = _build.load("int8_matmul")
    fn = lib.int8_gemm_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def split_plan(m: int, n: int, k: int, n_sm: int, batch: int = 1):
    """(tile config, K elements per split, number of splits).  Small M
    (decode) takes the 16-row tile; K is split when the output tiles of
    all ``batch`` products cannot give every SM two blocks."""
    cfg = 0 if m <= 16 else 1
    bm, bn = _TILES[cfg]
    return (cfg, *_build.split_k(batch * -(-m // bm) * -(-n // bn), k, _BK, 2 * n_sm))


def _launch(x: torch.Tensor, w_t: torch.Tensor, what: str) -> torch.Tensor:
    """Checks and one launch over ``x [B, M, K]``, ``w_t [B, N, K]``."""
    if x.device.type != "cuda" or w_t.device != x.device:
        raise ValueError(f"{what}: operands on {x.device} and {w_t.device}; "
                         "both must be on the same CUDA device (or both on the CPU)")
    if x.dtype != torch.int8 or w_t.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 operands, got {x.dtype} and {w_t.dtype}")
    # the kernel reads 16-byte vectors: contiguous, 16-byte aligned starts
    x, w_t = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
              else t.clone(memory_format=torch.contiguous_format) for t in (x, w_t))
    b, m, k = x.shape
    n = w_t.shape[1]
    cfg, kps, splits = split_plan(m, n, k, _build.sm_count(x.device.index), b)
    if b * splits > 65535:  # gridDim.z
        raise ValueError(f"{what}: batch {b} x {splits} K splits exceeds the grid")
    out = (torch.zeros if splits > 1 else torch.empty)((b, m, n), dtype=torch.int32,
                                                        device=x.device)
    if out.numel() == 0:
        return out
    rc = _lib()(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), b, m, n, k, kps, splits, cfg,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, what)
    return out


def int8_gemm(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 ``x [M, K]`` x int8 ``w_t [N, K]`` -> int32 ``[M, N]``."""
    if x.dim() != 2 or w_t.dim() != 2 or x.shape[1] != w_t.shape[1]:
        raise ValueError(f"int8_gemm: shapes {tuple(x.shape)} x {tuple(w_t.shape)} "
                         "are not [M, K] x [N, K]")
    if x.device.type == "cpu" and w_t.device.type == "cpu":
        return int8_matmul_acc_ref(x, w_t)
    out = _launch(x[None], w_t[None], "int8_gemm")[0]
    if out.numel():
        int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def int8_gemm_batched(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 ``x [B, M, K]`` x int8 ``w_t [B, N, K]`` -> int32 ``[B, M, N]``:
    B independent products in one launch."""
    if (x.dim() != 3 or w_t.dim() != 3 or x.shape[0] != w_t.shape[0]
            or x.shape[2] != w_t.shape[2]):
        raise ValueError(f"int8_gemm_batched: shapes {tuple(x.shape)} x {tuple(w_t.shape)} "
                         "are not [B, M, K] x [B, N, K]")
    if x.device.type == "cpu" and w_t.device.type == "cpu":
        return int8_matmul_acc_ref(x, w_t)
    out = _launch(x, w_t, "int8_gemm_batched")
    if out.numel():
        int8_gemm_batched.launches += 1
    return out


int8_gemm_batched.launches = 0


def int8_matmul_t(xq: QTensor, wq_t: QTensor) -> torch.Tensor:
    """``xq [M, K]`` x pre-transposed ``wq_t [N, K]`` (scale ``[1, N]``)
    -> dequantized float32 ``[M, N]``."""
    acc = int8_gemm(xq.q, wq_t.q)
    return (acc.to(torch.float32) * xq.scale) * wq_t.scale
