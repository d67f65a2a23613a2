"""Public wrapper of the linear-recurrence kernel: checks, launch, counter.

Port of ``repro.kernels.rglru_scan.ops.rglru_scan``.  The reference pads
``B`` and ``S`` to its block and chunk sizes (decay 1, input 0); the
kernel scans 32-channel tiles of a batch row in chunks of 32 steps, one
run of 4 steps a warp, carries folded across runs and chunks
(``ref.rglru_scan_chunked_ref``), and checks its own bounds, so any
``B``, ``S`` and ``D`` go in as they are.  On a CPU tensor the wrapper
runs the plain loop (``ref.rglru_scan_ref``); on a CUDA tensor it
launches ``csrc/rglru_scan.cu`` or raises.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def _lib():
    fn = _build.load("rglru_scan").rglru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (decays in (0, 1]), ``b`` (driven inputs) ``[B, S, D]`` ->
    every state ``h [B, S, D]`` of ``h_t = a_t * h_{t-1} + b_t``, ``h_{-1}
    = 0``, in ``a.dtype``."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "one [B, S, D] shape")
    if b.device != a.device:
        raise ValueError(f"rglru_scan: b on {b.device}, a on {a.device}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan kernel takes float32 a and b, got {a.dtype}/{b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    bsz, s, d = a.shape
    rc = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, d,
                torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "rglru_scan")
    rglru_scan.launches += 1
    rglru_scan.lengths[s] += 1
    return out


rglru_scan.launches = 0
rglru_scan.lengths = collections.Counter()
