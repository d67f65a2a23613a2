"""Public paged-attention wrappers: GQA grouping, dtypes, launch counters.

Port of ``repro.kernels.paged_attention.ops`` (decode and causal suffix
prefill; the dense-cache variant comes with the dense layout).  Queries
arrive in the model's ``[B, H, ...]`` head layout and are folded into
per-KV-head row groups (row ``g * q_len + i``), cast to the pool dtype;
the kernel returns the float32 output already divided by the softmax
denominator, and the wrapper returns it in the query dtype.

On a CPU tensor each wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches ``csrc/paged_attention.cu`` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_decode_ref, paged_prefill_ref

HEAD_DIMS = (16, 64)  # head dims the kernel is instantiated for
POOL_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    fn = _build.load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_pool(k_pool: torch.Tensor, v_pool: torch.Tensor) -> None:
    if k_pool.dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV pools arrive with kv_quant (ROADMAP queue 1): the kernel's "
            "per-head dequantizing branch is not ported yet")
    if k_pool.dtype not in POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged attention takes float32/bfloat16 pools, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")


def _launch(qg, k_pool, v_pool, table, lens, *, causal: bool, q_len: int,
            softcap: float) -> torch.Tensor:
    """qg [B, KVH, R, hd] in pool dtype -> normalized float32 [B, KVH, R, hd]."""
    dev = qg.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("table", table), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"paged attention: {name} on {t.device}, queries on {dev}")
    b, kvh, r, hd = qg.shape
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"paged attention kernel built for head dims "
                                  f"{HEAD_DIMS}, got {hd}")
    if k_pool.shape[1] != kvh or k_pool.shape[3] != hd or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged attention: pool {tuple(k_pool.shape)} does not fit "
                         f"queries {tuple(qg.shape)}")
    # the kernel reads 16-byte vectors: contiguous, 16-byte aligned starts
    qg, k_pool, v_pool = (t.contiguous() if t.data_ptr() % 16 == 0 and t.is_contiguous()
                          else t.clone(memory_format=torch.contiguous_format)
                          for t in (qg, k_pool, v_pool))
    table = table.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty((b, kvh, r, hd), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = _lib()(qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
                lens.data_ptr(), out.data_ptr(), b, kvh, r, hd, k_pool.shape[2],
                table.shape[1], q_len, int(causal), hd ** -0.5, float(softcap),
                int(k_pool.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "paged_attention")
    return out


def paged_attention_decode(q, k_pool, v_pool, table, kv_len, *, softcap: float = 0.0):
    """q [B, H, hd] (one token per slot) against pooled K/V through
    ``table [B, W]``; keys at positions >= ``kv_len[b]`` are invisible and
    ``kv_len == 0`` gives zeros.  Returns [B, H, hd] in ``q.dtype``."""
    _check_pool(k_pool, v_pool)
    b, h, hd = q.shape
    kvh = k_pool.shape[1]
    qd = q.to(k_pool.dtype)
    if q.device.type == "cpu":
        return paged_decode_ref(qd, k_pool, v_pool, table, kv_len,
                                softcap=softcap).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device {q.device}")
    o = _launch(qd.reshape(b, kvh, h // kvh, hd), k_pool, v_pool, table, kv_len,
                causal=False, q_len=1, softcap=softcap)
    paged_attention_decode.launches += 1
    return o.reshape(b, h, hd).to(q.dtype)


def paged_attention_prefill(q, k_pool, v_pool, table, start, *, softcap: float = 0.0):
    """Causal suffix attention with pooled past: query ``(b, i)`` of
    ``q [B, H, S, hd]`` sits at absolute position ``start[b] + i`` and sees
    every pooled position up to it (its prefix blocks plus its own freshly
    written suffix).  Padded suffix rows compute values callers discard.
    Returns [B, H, S, hd] in ``q.dtype``."""
    _check_pool(k_pool, v_pool)
    b, h, s, hd = q.shape
    kvh = k_pool.shape[1]
    qd = q.to(k_pool.dtype)
    if q.device.type == "cpu":
        return paged_prefill_ref(qd, k_pool, v_pool, table, start,
                                 softcap=softcap).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_prefill: unsupported device {q.device}")
    o = _launch(qd.reshape(b, kvh, (h // kvh) * s, hd), k_pool, v_pool, table, start,
                causal=True, q_len=s, softcap=softcap)
    paged_attention_prefill.launches += 1
    return o.reshape(b, h, s, hd).to(q.dtype)


paged_attention_decode.launches = 0
paged_attention_prefill.launches = 0
