"""Public flash-attention wrapper: GQA folding, checks, launch counter.

Port of ``repro.kernels.flash_attention.ops.flash_attention``.  The G =
Hq / Hkv query heads of a KV head are rows of one ``[G * Sq, D]`` block
(row ``r`` is query position ``r % Sq``, the reference kernel's fold
period ``q_len``), so each K/V tile is read once per group and K/V are
never repeated.  The reference pads Sq and Sk to its tile sizes; the
kernel masks its own ragged edges instead, so any Sq and Sk go in as they
are, and the wrapper raises where the reference raises: non-causal
attention over keys that are not a multiple of the reference's key tile
``REF_BK`` (the reference cannot mask padded keys without the causal
mask).

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches ``csrc/flash_attention.cu`` or raises.  The
kernel returns the output in the query dtype, already divided by the
softmax denominator.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels._build import HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype code
REF_BK = 128  # the reference's default key tile, whose padding it refuses non-causally


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] -> [B, Hq, Sq, D] in q.dtype.
    Query ``i`` sees key ``j`` when ``j <= i`` (causal) and ``i - j <
    window`` (``window > 0``); ``softcap > 0`` caps logits before the mask."""
    refuse_grad("flash_attention", q, k, v)
    b, hq, sq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} KV heads")
    if not causal and sk % REF_BK:
        raise NotImplementedError("non-causal padding unsupported; pad inputs to block size")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash attention kernel built for head dims {HEAD_DIMS}, "
                                  f"got {d}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * hkv,
                (hq // hkv) * sq, sk, d, sq, int(causal), int(window), d ** -0.5,
                float(softcap), DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
