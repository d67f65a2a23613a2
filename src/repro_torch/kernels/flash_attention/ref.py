"""Plain PyTorch version of the flash-attention kernel.

The reference kernel's arithmetic (``repro.kernels.flash_attention.kernel``)
in one pass instead of a stream of key tiles: float32 scores scaled by
``D ** -0.5``, the logit softcap ``tanh(s / c) * c`` before the mask,
masked scores at -1e30, the fully-masked-row guard (``m_safe``), ``p``
rounded to V's dtype before the PV product (bf16 for bf16 inputs), the
denominator summed from the unrounded ``p`` and the output divided by
``max(l, 1e-30)`` in float32, then cast to the query dtype.  Query row
``i`` sits at position ``i`` (the kernel's fold period ``q_len`` = Sq),
so causal means key position <= i and ``window > 0`` adds ``i - k <
window``.  GQA groups the ``Hq / Hkv`` query heads of a KV head without
repeating K/V.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] -> [B, Hq, Sq, D] in q.dtype."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) * (d ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(b, hq, sq, d).to(q.dtype)
