"""Public wrapper of the linear-recurrence kernel: checks, launch, counter.

Port of ``repro.kernels.rglru_scan.ops.rglru_scan``.  The reference pads
``B`` and ``S`` to its block and chunk sizes (decay 1, input 0); the
kernel scans 32-channel tiles of a batch row in chunks of 32 steps, one
run of 4 steps a warp, carries folded across runs and chunks
(``ref.rglru_scan_chunked_ref``), and checks its own bounds, so any
``B``, ``S`` and ``D`` go in as they are.  On a CPU tensor the wrapper
runs the plain loop (``ref.rglru_scan_ref``); on a CUDA tensor it
launches ``csrc/rglru_scan.cu`` or raises.

The scan has a gradient.  With grad enabled and an input that requires
it, the wrapper runs as :class:`RGLRUScan`, whose backward is the same
recurrence run backwards: ``g_t = dh_t + a_{t+1} g_{t+1}`` is the
forward scan of the time-reversed ``dh`` with the decays shifted by one
step (``a_S = 0``), so it is one more launch of the same kernel (the
plain loop on the CPU); then ``db_t = g_t`` and ``da_t = g_t h_{t-1}``
(``h_{-1} = 0``).  Backward launches are counted with the others and
also apart (``backward_launches``).
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


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One scan: the plain loop on the CPU, one counted launch on the card."""
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


class RGLRUScan(torch.autograd.Function):
    """The scan with its reverse-scan backward (module docstring)."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh: torch.Tensor):
        a, h = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)  # a_{t+1}, a_S = 0
        before = rglru_scan.launches
        g = _scan(a_next.flip(1), dh.to(a.dtype).flip(1)).flip(1)
        rglru_scan.backward_launches += rglru_scan.launches - before
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return g * h_prev, g


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (decays in (0, 1]), ``b`` (driven inputs) ``[B, S, D]`` ->
    every state ``h [B, S, D]`` of ``h_t = a_t * h_{t-1} + b_t``, ``h_{-1}
    = 0``, in ``a.dtype``; differentiable in ``a`` and ``b``."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "one [B, S, D] shape")
    if b.device != a.device:
        raise ValueError(f"rglru_scan: b on {b.device}, a on {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b)
    return _scan(a, b)


rglru_scan.launches = rglru_scan.backward_launches = 0
rglru_scan.lengths = collections.Counter()
