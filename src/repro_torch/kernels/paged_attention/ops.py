"""Public paged-attention wrappers: GQA grouping, dtypes, launch counters.

Port of ``repro.kernels.paged_attention.ops``: decode and causal suffix
prefill through the block table, and decode over dense per-slot caches
(:func:`dense_attention_decode`, the reference's ``dense_attention_kernel``).
Queries arrive in the model's ``[B, H, ...]`` head layout and are folded
into per-KV-head row groups (row ``g * q_len + i``), cast to the pool
dtype — or to float32 for an int8 pool, whose blocks the kernels
dequantize with the per-KV-head ``k_scale``/``v_scale`` as they stream
them.  Every kernel writes its output already divided by the softmax
denominator, in the caller's query dtype (the prefill kernels in the
kernel's query dtype, which the wrapper casts).

On a CPU tensor each wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernels or raises.  Decode on both layouts
launches ``csrc/decode.cu``: one split kernel over
:func:`decode_split_plan`'s ranges of each (slot, KV head)'s keys, read
from the dense cache or through the block table, then a merge.  The
causal suffix prefill launches ``csrc/paged_prefill.cu`` (``wgmma`` tiles
for a bf16 pool, float32 FMA tiles for float32 and int8 pools).  Each
wrapper's ``launches`` counts every call that launched; the paged
wrappers' ``int8_launches`` count the launches on int8 pools among them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels._build import HEAD_DIMS
from repro_torch.kernels.paged_attention.ref import (
    dense_decode_ref, paged_decode_ref, paged_prefill_ref,
)

# pool dtype -> the kernel's dtype code (q is float32 for int8 pools)
POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the dtypes the decode merge writes: its code
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _prefill_lib():
    fn = _build.load("paged_prefill").paged_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _decode_lib():
    fn = _build.load("decode").decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


DECODE_CHUNK = 16  # keys per chunk of the decode kernel: the unit its splits are cut in
DECODE_WAVES = 2  # blocks per SM the split plan aims for


def decode_split_plan(b: int, kvh: int, s: int, n_sm: int) -> int:
    """Ranges each (slot, KV head)'s ``s`` key positions (a dense cache's
    length, or the block table's ``W * BS``) are split into for decode,
    from shapes alone (the host never reads ``kv_len``): enough that the
    ``b * kvh * splits`` blocks fill the ``n_sm`` SMs about
    ``DECODE_WAVES`` times, never more than ``s`` has ``DECODE_CHUNK``-key
    chunks, at least one.  On the device each block takes its share of
    the live keys ``[0, kv_len)`` in whole chunks."""
    want = -(-DECODE_WAVES * n_sm // max(1, b * kvh))
    return max(1, min(want, -(-s // DECODE_CHUNK)))


def _prepare(q, k_pool, v_pool, k_scale, v_scale):
    """Check the pools; returns (queries in the kernel's dtype, k_scale,
    v_scale), the scales as float32 ``[KVH]`` for an int8 pool and None
    for a float one (whose kernel ignores them, as the reference's does)."""
    if k_pool.dtype not in POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged attention takes float32/bfloat16/int8 pools, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if k_pool.dtype != torch.int8:
        return q.to(k_pool.dtype), None, None
    if k_scale is None or v_scale is None:
        raise ValueError("int8 KV pool needs calibrated k_scale/v_scale")
    kvh = k_pool.shape[1]
    scales = [torch.as_tensor(s, dtype=torch.float32, device=q.device).reshape(-1)
              for s in (k_scale, v_scale)]
    if any(s.shape != (kvh,) for s in scales):
        raise ValueError(f"paged attention: scales {[tuple(s.shape) for s in scales]} "
                         f"for {kvh} KV heads")
    return q.to(torch.float32), *scales


def _operands(qg, k_pool, v_pool, table, lens, k_scale, v_scale):
    """Check a paged call's operands against its grouped queries ``qg [B,
    KVH, R, hd]`` (devices, head dim, pool shape); returns them as the
    kernels take them: 16-byte aligned queries and pools, an int32
    ``table``, contiguous scales (``lens`` is cast at the launch)."""
    dev = qg.device
    named = (("k_pool", k_pool), ("v_pool", v_pool), ("table", table), ("lens", lens),
             ("k_scale", k_scale), ("v_scale", v_scale))
    for name, t in named:
        if t is not None and t.device != dev:
            raise ValueError(f"paged attention: {name} on {t.device}, queries on {dev}")
    _, kvh, _, hd = qg.shape
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"paged attention kernels built for head dims "
                                  f"{HEAD_DIMS}, got {hd}")
    if k_pool.shape[1] != kvh or k_pool.shape[3] != hd or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged attention: pool {tuple(k_pool.shape)} does not fit "
                         f"queries {tuple(qg.shape)}")
    ks, vs = (None if s is None else s.contiguous() for s in (k_scale, v_scale))
    return (_build.aligned(qg), _build.aligned(k_pool), _build.aligned(v_pool),
            table.to(torch.int32).contiguous(), ks, vs)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(fn, k) -> None:
    fn.launches += 1
    if k.dtype == torch.int8:
        fn.int8_launches += 1


def _decode(fn, qg, k, v, kv_len, s: int, out_dtype, softcap: float, table=None,
            k_scale=None, v_scale=None) -> torch.Tensor:
    """One decode launch, counted on ``fn``: ``qg [B, KVH, G, hd]`` in the
    kernel's query dtype against ``s`` key positions per (slot, KV head),
    of dense caches ``k/v [B, KVH, S, hd]`` (``table`` None) or of pools
    ``[NB, KVH, BS, hd]`` read through ``table [B, W]`` (``s = W * BS``).
    Returns the normalized output ``[B, KVH, G, hd]`` in ``out_dtype``:
    the split kernel over :func:`decode_split_plan`'s ranges, then the
    merge."""
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"decode attention writes float32/bfloat16 outputs, got {out_dtype}")
    b, kvh, g, hd = qg.shape
    dev = qg.device
    out = torch.empty((b, kvh, g, hd), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    qg, k, v = _build.aligned(qg), _build.aligned(k), _build.aligned(v)
    splits = decode_split_plan(b, kvh, s, _build.sm_count(dev.index))
    # each split's (o, m, l), which the merge turns into the output
    part_o = torch.empty((b, kvh, g, splits, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((2, b, kvh, g, splits), dtype=torch.float32, device=dev)
    bs, w = (0, 0) if table is None else (k.shape[2], table.shape[1])
    lens = kv_len.to(torch.int32).contiguous()
    rc = _decode_lib()(qg.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), _ptr(table),
                       _ptr(k_scale), _ptr(v_scale), part_o.data_ptr(), part_ml[0].data_ptr(),
                       part_ml[1].data_ptr(), out.data_ptr(),
                       b, kvh, g, hd, s, bs, w, splits, hd ** -0.5, float(softcap),
                       POOL_DTYPES[k.dtype], OUT_DTYPES[out_dtype],
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "decode")
    _count(fn, k)
    return out


def paged_attention_decode(q, k_pool, v_pool, table, kv_len, k_scale=None, v_scale=None, *,
                           softcap: float = 0.0):
    """q [B, H, hd] (one token per slot) against pooled K/V through
    ``table [B, W]``; keys at positions >= ``kv_len[b]`` are invisible and
    ``kv_len == 0`` gives zeros.  An int8 pool needs its per-KV-head
    ``k_scale``/``v_scale`` ``[KVH]``.  Returns [B, H, hd] in ``q.dtype``
    (float32 or bfloat16 on the card)."""
    refuse_grad("paged_attention_decode", q, k_pool, v_pool, k_scale, v_scale)
    qd, ks, vs = _prepare(q, k_pool, v_pool, k_scale, v_scale)
    b, h, hd = q.shape
    kvh = k_pool.shape[1]
    if q.device.type == "cpu":
        return paged_decode_ref(qd, k_pool, v_pool, table, kv_len, softcap=softcap,
                                k_scale=ks, v_scale=vs).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device {q.device}")
    qg, k_pool, v_pool, table, ks, vs = _operands(
        qd.reshape(b, kvh, h // kvh, hd), k_pool, v_pool, table, kv_len, ks, vs)
    o = _decode(paged_attention_decode, qg, k_pool, v_pool, kv_len,
                table.shape[1] * k_pool.shape[2], q.dtype, softcap, table, ks, vs)
    return o.reshape(b, h, hd)


def paged_attention_prefill(q, k_pool, v_pool, table, start, k_scale=None, v_scale=None, *,
                            softcap: float = 0.0):
    """Causal suffix attention with pooled past: query ``(b, i)`` of
    ``q [B, H, S, hd]`` sits at absolute position ``start[b] + i`` and sees
    every pooled position up to it (its prefix blocks plus its own freshly
    written suffix).  Padded suffix rows compute values callers discard.
    Scales as in :func:`paged_attention_decode`.  Returns [B, H, S, hd] in
    ``q.dtype``."""
    refuse_grad("paged_attention_prefill", q, k_pool, v_pool, k_scale, v_scale)
    qd, ks, vs = _prepare(q, k_pool, v_pool, k_scale, v_scale)
    b, h, s, hd = q.shape
    kvh = k_pool.shape[1]
    if q.device.type == "cpu":
        return paged_prefill_ref(qd, k_pool, v_pool, table, start, softcap=softcap,
                                 k_scale=ks, v_scale=vs).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_prefill: unsupported device {q.device}")
    qg, k_pool, v_pool, table, ks, vs = _operands(
        qd.reshape(b, kvh, (h // kvh) * s, hd), k_pool, v_pool, table, start, ks, vs)
    o = torch.empty_like(qg)  # the normalized output, in the kernel's query dtype
    if o.numel():
        start = start.to(torch.int32).contiguous()
        rc = _prefill_lib()(qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                            table.data_ptr(), start.data_ptr(), _ptr(ks), _ptr(vs), o.data_ptr(),
                            b, k_pool.shape[0], kvh, qg.shape[2], hd, k_pool.shape[2],
                            table.shape[1], s, hd ** -0.5, float(softcap),
                            POOL_DTYPES[k_pool.dtype],
                            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "paged_prefill")
        _count(paged_attention_prefill, k_pool)
    return o.reshape(b, h, s, hd).to(q.dtype)


def dense_attention_decode(q, k, v, kv_len, *, softcap: float = 0.0):
    """q [B, H, hd] (one token per slot) against dense per-slot caches
    ``k/v [B, KVH, S, hd]``: keys at positions >= ``kv_len[b]`` are
    invisible and ``kv_len == 0`` gives zeros.  q is cast to the cache
    dtype first, as the reference's wrapper casts it.  Returns [B, H, hd]
    in ``q.dtype`` (float32 or bfloat16 on the card)."""
    refuse_grad("dense_attention_decode", q, k, v)
    b, h, hd = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"dense attention: caches {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit queries {tuple(q.shape)}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"dense attention takes float32/bfloat16 caches, got "
                        f"{k.dtype}/{v.dtype}")
    kvh, s = k.shape[1], k.shape[2]
    qd = q.to(k.dtype)
    if q.device.type == "cpu":
        return dense_decode_ref(qd, k, v, kv_len, softcap=softcap).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"dense_attention_decode: unsupported device {q.device}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"dense attention kernel built for head dims "
                                  f"{HEAD_DIMS}, got {hd}")
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"dense attention: {name} on {t.device}, queries on {q.device}")
    o = _decode(dense_attention_decode, qd.reshape(b, kvh, h // kvh, hd), k, v, kv_len, s,
                q.dtype, softcap)
    return o.reshape(b, h, hd)


paged_attention_decode.launches = paged_attention_decode.int8_launches = 0
paged_attention_prefill.launches = paged_attention_prefill.int8_launches = 0
dense_attention_decode.launches = 0
