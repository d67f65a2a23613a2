"""Plain PyTorch version of the paged-attention kernel.

Port of ``repro.kernels.paged_attention.ref``: deliberately gather-then-
mask (``pool[table]`` -> dense logical view -> masked softmax in float32),
the memory-hungry formulation the kernel streams away.
"""
from __future__ import annotations

import torch


def _gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [n_blocks, KVH, bs, hd], table [B, W] -> [B, KVH, W*bs, hd]."""
    b, w = table.shape
    g = pool[table.long()]  # [B, W, KVH, bs, hd]
    return g.movedim(2, 1).reshape(b, pool.shape[1], -1, pool.shape[3])


def _softcap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def _masked_attn(qg, k, v, mask, scale, softcap):
    """qg [B,KVH,G,Sq,hd], k/v [B,KVH,L,hd], mask [B,Sq,L] -> [B,KVH,G,Sq,hd]."""
    qg, k, v = (x.to(torch.float32) for x in (qg, k, v))
    s = _softcap(torch.einsum("bhgsd,bhld->bhgsl", qg, k) * scale, softcap)
    m = mask[:, None, None]
    s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m, p, torch.zeros_like(p))
    denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bhgsl,bhld->bhgsd", p / denom, v)


def paged_decode_ref(q, k_pool, v_pool, table, kv_len, *, softcap=0.0):
    """q [B, H, hd] -> [B, H, hd] float32: keys at positions >= kv_len[b]
    are invisible; kv_len == 0 yields zeros (matching the kernel)."""
    b, h, hd = q.shape
    kvh = k_pool.shape[1]
    k = _gather(k_pool, table)
    v = _gather(v_pool, table)
    kv_len = kv_len.to(q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, None] < kv_len[:, None, None]
    qg = q.reshape(b, kvh, h // kvh, 1, hd)
    o = _masked_attn(qg, k, v, mask, hd ** -0.5, softcap).reshape(b, h, hd)
    return torch.where(kv_len[:, None, None] > 0, o, torch.zeros_like(o))


def paged_prefill_ref(q, k_pool, v_pool, table, start, *, softcap=0.0):
    """q [B, H, S, hd] -> [B, H, S, hd] float32: causal against absolute
    positions ``start[b] + i`` over the gathered context view."""
    b, h, s, hd = q.shape
    kvh = k_pool.shape[1]
    k = _gather(k_pool, table)
    v = _gather(v_pool, table)
    q_pos = start.to(q.device)[:, None] + torch.arange(s, device=q.device)[None]
    mask = q_pos[:, :, None] >= torch.arange(k.shape[2], device=q.device)[None, None]
    qg = q.reshape(b, kvh, h // kvh, s, hd)
    return _masked_attn(qg, k, v, mask, hd ** -0.5, softcap).reshape(b, h, s, hd)
